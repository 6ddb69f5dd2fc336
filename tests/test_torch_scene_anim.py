"""Port parity: ABSM animation, scene-graph propagation and skinning of
fyrox_tpu_torch against fyrox_tpu on the flagship character."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.animation import machine as jmachine
from fyrox_tpu.animation import player as jplayer
from fyrox_tpu.animation import skinning as jskinning
from fyrox_tpu.animation import track as jtrack
from fyrox_tpu.models import character as jchar
from fyrox_tpu.scene import graph as jgraph
from fyrox_tpu.scene import init_state as jinit
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.animation import machine as tmachine
from fyrox_tpu_torch.animation import player as tplayer
from fyrox_tpu_torch.animation import skinning as tskinning
from fyrox_tpu_torch.animation import track as ttrack
from fyrox_tpu_torch.models import character as tchar
from fyrox_tpu_torch.scene import graph as tgraph
from fyrox_tpu_torch.scene import init_state as tinit

torch.set_num_threads(2)

W, TICKS, DT = 3, 30, 1.0 / 60.0


def _run_param(tick):
    """The `run` rule per world: world 0 never runs; world 1 runs from
    tick 8 on; world 2 runs during ticks 8-17, so its machine blends
    walk→run and, once that 0.3 s blend settles, back towards walk."""
    return np.array([False, tick >= 8, 8 <= tick < 18])[:, None]


@pytest.fixture(scope="module")
def rollouts():
    jsb, jaset, jmt, bones, (verts, idx4, w4) = jchar.build_character_scene(
        n_bones=12, n_verts=400, seed=3)
    tsb, taset, tmt, _, _ = tchar.build_character_scene(
        n_bones=12, n_verts=400, seed=3)
    jtpl, ttpl = jsb.build(), tsb.build()

    jstep = jax.jit(lambda s, a, m, p: _jax_tick(jtpl, jaset, jmt, s, a, m,
                                                 p))
    js = jgraph.update_hierarchical_data(jinit(jtpl, W), jtpl)
    ja = jtrack.init_animation_state(jaset, W)
    jm = jmachine.init_machine_state(jmt, W)
    ts = tinit(ttpl, W, device="cpu")
    ta = ttrack.init_animation_state(taset, W, device="cpu")
    tm = tmachine.init_machine_state(tmt, W, device="cpu")
    out = []
    for tick in range(TICKS):
        p = _run_param(tick)
        js, ja, jm = jstep(js, ja, jm, jnp.asarray(p))
        ts, ta, tm = _torch_tick(ttpl, taset, tmt, ts, ta, tm,
                                 torch.as_tensor(p))
        out.append((jax.tree_util.tree_map(np.asarray, (js, ja, jm)),
                    convert.to_numpy((ts, ta, tm))))
    skin = jskinning.SkinTemplate(
        bones=np.asarray(bones, np.int32),
        inv_bind=np.linalg.inv(np.asarray(jgraph.update_hierarchical_data(
            jinit(jtpl, 1), jtpl).globals_[0])[bones]).astype(np.float32),
        vertices=verts, bone_indices=idx4, bone_weights=w4)
    return out, skin, convert.skin_template(skin)


def _jax_tick(tpl, aset, mt, s, a, m, p):
    a, m, pos, rot, scl = jplayer.step_absm(aset, mt, a, m, p, s.position,
                                            s.rotation, s.scale, DT)
    s = s._replace(position=pos, rotation=rot, scale=scl)
    return jgraph.step(s, tpl, DT), a, m


def _torch_tick(tpl, aset, mt, s, a, m, p):
    a, m, pos, rot, scl = tplayer.step_absm(aset, mt, a, m, p, s.position,
                                            s.rotation, s.scale, DT)
    s = s._replace(position=pos, rotation=rot, scale=scl)
    return tgraph.step(s, tpl, DT), a, m


def test_machine_blends_mid_rollout(rollouts):
    out, _, _ = rollouts
    blends = np.stack([o[0][2].blend for o in out])          # [T,W]
    current = np.stack([o[0][2].current for o in out])
    # world 2 blends walk→run, then back towards walk; world 0 never moves
    assert (blends[:, 2] < 1.0).any() and (blends[:, 0] == 1.0).all()
    assert current[12, 2] == 1 and current[-1, 2] == 0
    for (jx, tx) in out:
        np.testing.assert_array_equal(jx[2].current, tx[2].current)
        np.testing.assert_array_equal(jx[2].source, tx[2].source)
        # blend clocks accumulate dt/duration in float32 in both packages
        np.testing.assert_allclose(jx[2].blend, tx[2].blend, atol=1e-6)
        np.testing.assert_allclose(jx[1].time, tx[1].time, atol=1e-6)


@pytest.mark.parametrize("field", ["position", "rotation", "scale",
                                   "globals_"])
def test_local_poses_and_globals_match(rollouts, field):
    out, _, _ = rollouts
    for tick, (jx, tx) in enumerate(out):
        # float32 curve sampling, nlerp blends and a chain of up to 12
        # 4x4 compositions evaluated in two op orders
        np.testing.assert_allclose(getattr(jx[0], field),
                                   getattr(tx[0], field), rtol=0, atol=1e-5,
                                   err_msg=f"{field} at tick {tick}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_overwrite_matches(seed):
    """AnimationPlayer overwrite: the last enabled clip with a track wins."""
    from fyrox_tpu.animation import pose as jpose
    from fyrox_tpu_torch.animation import pose as tpose
    rng = np.random.default_rng(seed)
    w, a, n = 3, 4, 7
    vals = [rng.standard_normal((w, a, n, d)).astype(np.float32)
            for d in (3, 4, 3)]
    masks = [rng.random((a, n)) < 0.5 for _ in range(3)]
    enabled = rng.random((w, a)) < 0.6
    cur = [rng.standard_normal((w, n, d)).astype(np.float32)
           for d in (3, 4, 3)]
    ref = jpose.apply_overwrite(
        jpose.PoseSet(*map(jnp.asarray, vals + masks)), jnp.asarray(enabled),
        *map(jnp.asarray, cur))
    got = tpose.apply_overwrite(
        tpose.PoseSet(*map(torch.as_tensor, vals + masks)),
        torch.as_tensor(enabled), *map(torch.as_tensor, cur))
    # a selection, no arithmetic: equal bit for bit
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_skinned_vertices_match(rollouts):
    out, jskin, tskin = rollouts
    jx, tx = out[-1]
    ref = jskinning.skin_positions_dense(
        jskinning.bone_matrices(jnp.asarray(jx[0].globals_), jskin), jskin)
    got = tskinning.skin_positions_dense(
        tskinning.bone_matrices(torch.as_tensor(tx[0].globals_), tskin),
        tskin)
    # [V,B] @ [W,B,12] in float32 (different summation order), applied to
    # coordinates of order 1
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=0,
                               atol=1e-4)
