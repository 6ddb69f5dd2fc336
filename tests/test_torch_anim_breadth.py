"""Port parity: the animation breadth of fyrox_tpu_torch against fyrox_tpu
on the same inputs, made with numpy from a seed: the plain AnimationPlayer
(player.step_player), root motion (animation/rootmotion.py,
player.step_player_root_motion and the engine's body drive), blend spaces
(animation/blendspace.py and blend-space machine states), layered machines
(player.step_absm_layered), blend shapes and gather skinning
(animation/skinning.py) and sprite sheets (animation/spritesheet.py).

Tolerances: weights 1e-6, poses 1e-5, skinned positions 1e-5, frames and
UV rectangles exact."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.animation import (AnimationSetBuilder as JSetBuilder,
                                 MachineBuilder as JMachineBuilder)
from fyrox_tpu.animation import blendspace as jbs
from fyrox_tpu.animation import machine as jmachine
from fyrox_tpu.animation import player as jplayer
from fyrox_tpu.animation import pose as jpose
from fyrox_tpu.animation import rootmotion as jrm
from fyrox_tpu.animation import skinning as jskinning
from fyrox_tpu.animation import spritesheet as jsheet
from fyrox_tpu.animation import track as jtrack
from fyrox_tpu.engine import Engine as JEngine
from fyrox_tpu.physics import shapes as jshapes
from fyrox_tpu.physics import world as jworld
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.animation import AnimationSetBuilder, MachineBuilder
from fyrox_tpu_torch.animation import blendspace as tbs
from fyrox_tpu_torch.animation import machine as tmachine
from fyrox_tpu_torch.animation import player as tplayer
from fyrox_tpu_torch.animation import pose as tpose
from fyrox_tpu_torch.animation import rootmotion as trm
from fyrox_tpu_torch.animation import skinning as tskinning
from fyrox_tpu_torch.animation import spritesheet as tsheet
from fyrox_tpu_torch.animation import track as ttrack
from fyrox_tpu_torch.engine import Engine as TEngine
from fyrox_tpu_torch.physics import shapes as tshapes
from fyrox_tpu_torch.physics import world as tworld
from fyrox_tpu_torch.scene import SceneBuilder as TSceneBuilder

torch.set_num_threads(2)

DT = 1.0 / 60.0
N_NODES = 6


def lin(keys):
    return [dict(time=float(t), value=float(v)) for t, v in keys]


def _t(x, dtype=None):
    t = torch.as_tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), b.numpy() if isinstance(
        b, torch.Tensor) else b, rtol=0, atol=atol)


def _both(build):
    """build(builder_cls) with each package's AnimationSetBuilder."""
    return build(JSetBuilder), build(AnimationSetBuilder)


def _random_set(cls, seed=0, clips=3, loop=(True, True, False),
                speed=(1.0, -0.7, 1.3)):
    """Clips overlapping on nodes, with position, rotation and scale
    tracks of random keys (lengths 0.6-1.2 s; one reversed, one not
    looping)."""
    rng = np.random.default_rng(seed)
    b = cls()
    for c in range(clips):
        length = float(rng.uniform(0.6, 1.2))
        cid = b.add_clip(f"c{c}", length=length, speed=speed[c],
                         looping=loop[c])
        times = np.linspace(0.0, length, 5)
        for node in rng.choice(N_NODES, 4, replace=False):
            node = int(node)
            kind = int(rng.integers(0, 3))
            keys = [lin(zip(times, rng.uniform(-1, 1, 5))) for _ in range(3)]
            if kind == 0:
                b.add_position_track(cid, node, keys)
            elif kind == 1:
                b.add_rotation_track(cid, node, keys)
            else:
                keys = [lin(zip(times, rng.uniform(0.5, 1.5, 5)))
                        for _ in range(3)]
                b.add_scale_track(cid, node, keys)
    return b.build()


def _pose0(w, seed=1):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (w, N_NODES, 3)).astype(np.float32)
    r = rng.standard_normal((w, N_NODES, 4)).astype(np.float32)
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    s = rng.uniform(0.5, 1.5, (w, N_NODES, 3)).astype(np.float32)
    return p, r, s


# ------------------------------------------------------------ plain player

@pytest.fixture(scope="module")
def player_run():
    """40 ticks of step_player, 3 worlds with different enabled clips."""
    jaset, taset = _both(_random_set)
    enabled = np.array([[True, True, True], [True, False, True],
                        [False, True, False]])
    ja = jtrack.init_animation_state(jaset, 3)._replace(
        enabled=jnp.asarray(enabled))
    ta = ttrack.init_animation_state(taset, 3, device="cpu",
                                     enabled=None)._replace(
        enabled=_t(enabled))
    p, r, s = _pose0(3)
    jp, jr, js = map(jnp.asarray, (p, r, s))
    tp, tr, ts = map(_t, (p, r, s))
    step = jax.jit(lambda a, p, r, s: jplayer.step_player(jaset, a, p, r, s,
                                                          DT))
    out = []
    for _ in range(40):
        ja, jp, jr, js = step(ja, jp, jr, js)
        ta, tp, tr, ts = tplayer.step_player(taset, ta, tp, tr, ts, DT)
        out.append(((ja.time, jp, jr, js), (ta.time, tp, tr, ts)))
    return out


@pytest.mark.parametrize("k,name", [(0, "time"), (1, "position"),
                                    (2, "rotation"), (3, "scale")])
def test_step_player_matches(player_run, k, name):
    """Sample at the current times, overwrite with enabled clips (the last
    enabled clip with a track wins), advance the clocks (a reversed clip
    and a clamped one among them)."""
    for jv, tv in player_run:
        _close(jv[k], tv[k], 1e-5)


def test_step_player_last_enabled_clip_wins():
    def build(cls):
        b = cls()
        for c in range(2):
            cid = b.add_clip(f"c{c}", length=1.0)
            b.add_position_track(cid, 1, [lin([(0, c + 1), (1, c + 1)])] * 3)
        return b.build()

    _, taset = _both(build)
    a = ttrack.init_animation_state(taset, 2, device="cpu")._replace(
        enabled=_t([[True, True], [True, False]]))
    p, r, s = (torch.zeros(2, 3, 3), torch.zeros(2, 3, 4),
               torch.ones(2, 3, 3))
    _, p, _, _ = tplayer.step_player(taset, a, p, r, s, DT)
    assert p[:, 1, 0].tolist() == [2.0, 1.0]
    assert p[:, 0].abs().sum() == 0


# ------------------------------------------------------------- root motion

def _walk(cls, loop=True, speed=1.0):
    """Root (node 0) walks 0→2 on z, bobs on y and turns 90° about y over
    1 s; node 1 has its own track, which extraction leaves alone."""
    b = cls()
    c = b.add_clip("walk", length=1.0, looping=loop, speed=speed)
    b.add_position_track(c, 0, [lin([(0, 0), (1, 0.3)]), lin([(0, 0), (1, 0.1)]),
                                lin([(0, 0), (1, 2.0)])])
    b.add_position_track(c, 1, [lin([(0, 5), (1, 5)]), lin([(0, 0), (1, 1)]),
                                lin([(0, 0), (1, 0)])])
    b.add_rotation_track(c, 0, [lin([(0, 0), (1, 0)]),
                                lin([(0, 0), (1, np.pi / 2)]),
                                lin([(0, 0), (1, 0)])])
    c2 = b.add_clip("side", length=0.7, looping=True)
    b.add_position_track(c2, 0, [lin([(0, 0), (0.7, 1.0)]),
                                 lin([(0, 0), (0.7, 0)]),
                                 lin([(0, 0), (0.7, 0)])])
    return b.build()


RM_CASES = {
    "looping": dict(loop=True, speed=1.0, ignore_rotations=False),
    "reversed": dict(loop=True, speed=-1.0, ignore_rotations=False),
    "non-looping": dict(loop=False, speed=1.0, ignore_rotations=True),
}


@pytest.fixture(scope="module", params=list(RM_CASES))
def rm_run(request):
    """18 ticks of 1/12 s (across the clips' wraps) of
    extract_root_motion, then 18 of step_player_root_motion, both
    packages."""
    case = RM_CASES[request.param]
    jaset, taset = _both(lambda cls: _walk(cls, case["loop"], case["speed"]))
    st = dict(node=0, ignore_y=True,
              ignore_rotations=case["ignore_rotations"])
    jrmd = jrm.build_root_motion(jaset, jrm.RootMotionSettings(**st))
    trmd = trm.build_root_motion(taset, trm.RootMotionSettings(**st))
    w = 2
    ja = jtrack.init_animation_state(jaset, w)
    ta = ttrack.init_animation_state(taset, w, device="cpu")
    jst = jrm.init_root_motion_state(jrmd, w)
    tst = trm.init_root_motion_state(trmd, w, device="cpu")
    extract = []
    for _ in range(18):
        js_, ts_ = jtrack.sample_tracks(jaset, ja), ttrack.sample_tracks(
            taset, ta)
        ja2 = jtrack.tick_times(jaset, ja, 1 / 12)
        ta2 = ttrack.tick_times(taset, ta, 1 / 12)
        jst, jdp, jdr, jpin = jrm.extract_root_motion(
            jrmd, jaset, js_, ja.time, ja2.time, jst)
        tst, tdp, tdr, tpin = trm.extract_root_motion(
            trmd, taset, ts_, ta.time, ta2.time, tst)
        extract.append(((jst, jdp, jdr, jpin), (tst, tdp, tdr, tpin)))
        ja, ta = ja2, ta2
    p, r, s = _pose0(w, seed=4)
    jp, jr, jsc = map(jnp.asarray, (p, r, s))
    tp, tr, tsc = map(_t, (p, r, s))
    ja = jtrack.init_animation_state(jaset, w)
    ta = ttrack.init_animation_state(taset, w, device="cpu")
    jst = jrm.init_root_motion_state(jrmd, w)
    tst = trm.init_root_motion_state(trmd, w, device="cpu")
    player = []
    for _ in range(18):
        ja, jst, jp, jr, jsc, jd = jplayer.step_player_root_motion(
            jaset, jrmd, ja, jst, jp, jr, jsc, 1 / 12)
        ta, tst, tp, tr, tsc, td = tplayer.step_player_root_motion(
            taset, trmd, ta, tst, tp, tr, tsc, 1 / 12)
        player.append(((jp, jr, jsc, jd, ja.time), (tp, tr, tsc, td,
                                                    ta.time)))
    return jrmd, trmd, extract, player


def test_build_root_motion_matches(rm_run):
    jrmd, trmd, _, _ = rm_run
    want = convert.root_motion(jrmd)
    for f in ("pos_track", "rot_track"):
        np.testing.assert_array_equal(getattr(trmd, f), getattr(want, f))
    for f in ("pos_cycle_start", "pos_cycle_end", "rot_cycle_start",
              "rot_cycle_end", "pos_slice_start", "rot_slice_start"):
        np.testing.assert_allclose(getattr(trmd, f), getattr(want, f),
                                   rtol=0, atol=1e-7)


def test_extract_root_motion_matches(rm_run):
    """Deltas, running state and the pinned samples at every tick, across
    the wrap (the remainder carried to the next frame)."""
    for (jst, jdp, jdr, jpin), (tst, tdp, tdr, tpin) in rm_run[2]:
        _close(jdp, tdp, 1e-6)
        _close(jdr, tdr, 1e-6)
        for a, b in zip(jst, tst):
            _close(a, b, 1e-6)
        for kind in jpin:
            _close(jpin[kind][2], tpin[kind][2], 1e-6)


def test_step_player_root_motion_matches(rm_run):
    for jv, tv in rm_run[3]:
        for a, b in zip(jv, tv):
            _close(a, b, 1e-5)


def test_root_motion_total_over_a_wrap():
    """The looping walk's extracted z over 18 ticks of 1/12 s is 17
    frames' worth (the first delta is zero) with no jump at the seam."""
    _, taset = _both(_walk)
    trmd = trm.build_root_motion(taset, trm.RootMotionSettings(node=0))
    a = ttrack.init_animation_state(taset, 1, device="cpu")
    st = trm.init_root_motion_state(trmd, 1, device="cpu")
    total = torch.zeros(3)
    for _ in range(18):
        smp = ttrack.sample_tracks(taset, a)
        a2 = ttrack.tick_times(taset, a, 1 / 12)
        st, dp, _, _ = trm.extract_root_motion(trmd, taset, smp, a.time,
                                               a2.time, st)
        total += dp[0, 0]
        a = a2
    np.testing.assert_allclose(total.numpy(), [0.3 * 17 / 12, 0.0,
                                               2.0 * 17 / 12], atol=1e-4)


def test_blend_root_motion_matches():
    rng = np.random.default_rng(7)
    pa, pb = rng.standard_normal((2, 3, 2, 3)).astype(np.float32)
    ra, rb = rng.standard_normal((2, 3, 2, 4)).astype(np.float32)
    ra /= np.linalg.norm(ra, axis=-1, keepdims=True)
    rb /= np.linalg.norm(rb, axis=-1, keepdims=True)
    wgt = rng.uniform(0, 1, 3).astype(np.float32)
    for w in (0.3, wgt):
        jw = w if isinstance(w, float) else jnp.asarray(w)[:, None]
        tw = w if isinstance(w, float) else _t(w)[:, None]
        jp, jr = jrm.blend_root_motion((jnp.asarray(pa), jnp.asarray(ra)),
                                       (jnp.asarray(pb), jnp.asarray(rb)), jw)
        tp, tr = trm.blend_root_motion((_t(pa), _t(ra)), (_t(pb), _t(rb)),
                                       tw)
        _close(jp, tp, 1e-6)
        _close(jr, tr, 1e-6)


def _walker(lib):
    """tests/test_blendspace_rootmotion.py:218-260: a capsule character
    whose root clip walks +x at 1.2 m/s, on a halfspace, dense; root
    motion drives the body. lib: (SceneBuilder, AnimationSetBuilder,
    rootmotion, PhysicsBuilder, BodyType, shapes, Engine)."""
    sbc, abc, rm, pbc, bt, sh, eng = lib
    sb = sbc()
    root = sb.add_pivot("char_root", position=(0, 0.9, 0))
    ab = abc()
    walk = ab.add_clip("walk", length=1.0, looping=True)
    ab.add_position_track(walk, node=root,
                          keys_xyz=[lin([(0, 0), (1, 1.2)]),
                                    lin([(0, 0), (1, 0)]),
                                    lin([(0, 0), (1, 0)])])
    aset = ab.build()
    rmd = rm.build_root_motion(aset, rm.RootMotionSettings(node=root))
    pb = pbc()
    g = pb.add_body(body_type=bt.STATIC)
    pb.add_collider(g, sh.HALFSPACE, [0, 0, 0])
    body = pb.add_body(node=root, position=(0, 0.9, 0),
                       lock_rotation=(0, 0, 0))
    pb.add_collider(body, sh.CAPSULE, [0.4, 0.3])
    pt = pb.build(broadphase="dense")
    return eng(template=sb.build(), physics=pt, animations=aset,
               root_motion=rmd, root_motion_body=body), body, g


def test_engine_root_motion_walks_the_body():
    """120 ticks: the port's body positions equal the JAX engine's within
    1e-5 at every tick; the body walks ~1.2 m/s and stands on the
    ground."""
    je, body, g = _walker((JSceneBuilder, JSetBuilder, jrm,
                           jworld.PhysicsBuilder, jworld.BodyType, jshapes,
                           JEngine))
    te, _, _ = _walker((TSceneBuilder, AnimationSetBuilder, trm,
                        tworld.PhysicsBuilder, tworld.BodyType, tshapes,
                        TEngine))
    js, ts = je.init_state(2), te.init_state(2, device="cpu")
    assert ts.animation.rootmotion is not None
    step = jax.jit(je.step)
    worst = 0.0
    for _ in range(120):
        js, ts = step(js), te.step(ts)
        worst = max(worst, float(np.abs(np.asarray(js.physics.position)
                                        - ts.physics.position.numpy()).max()))
    assert worst <= 1e-5, worst
    x = float(ts.physics.position[0, body, 0])
    y = float(ts.physics.position[0, body, 1])
    assert 1.8 < x < 2.6 and 0.55 < y < 0.8, (x, y)
    assert abs(float(ts.physics.position[0, g, 1])) < 1e-5


# ------------------------------------------------------------ blend spaces

def _clips(cls):
    """Three 1 s clips moving node 0 to x=1 / y=1 / z=1."""
    b = cls()
    for axis in range(3):
        c = b.add_clip(f"c{axis}", length=1.0)
        keys = [lin([(0.0, 0.0), (1.0, 0.0)]) for _ in range(3)]
        keys[axis] = lin([(0.0, 0.0), (1.0, 1.0)])
        b.add_position_track(c, 0, keys)
    return b.build()


SPACES = {
    "triangle": ([[0, 0], [1, 0], [0, 1]], [0, 1, 2]),
    "square": ([[0, 0], [1, 0], [1, 1], [0, 1]], [0, 1, 2, 0]),
    "cloud": (np.random.default_rng(3).uniform(-1, 1, (7, 2)).tolist(),
              [0, 1, 2, 0, 1, 2, 0]),
    "two-point": ([[0, 0], [1, 0]], [0, 1]),
    "one-point": ([[0.5, 0.5]], [2]),
}
XY = np.array([[0.25, 0.25],    # inside
               [1.0, 0.0],      # at a vertex
               [2.0, -1.0],     # outside, beyond a vertex (clamped)
               [0.5, -3.0],     # outside, below an edge
               [0.75, 0.3],
               [-0.3, 0.8]], np.float32)


@pytest.mark.parametrize("space", list(SPACES))
def test_sample_weights_match(space):
    pts, clips = SPACES[space]
    jb, tb = jbs.build_blend_space(pts, clips), tbs.build_blend_space(
        pts, clips)
    np.testing.assert_array_equal(jb.triangles, tb.triangles)
    xy = np.concatenate([XY, np.random.default_rng(0).uniform(
        -1.5, 1.5, (40, 2)).astype(np.float32)])
    ji, jw = jbs.sample_weights(jb, jnp.asarray(xy))
    ti, tw = tbs.sample_weights(tb, _t(xy))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    _close(jw, tw, 1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-6)


def test_sample_weights_documented_cases():
    """Inside: barycentric; at a vertex: all weight there; beyond a
    vertex: clamped to it; below an edge: the projection."""
    tb = tbs.build_blend_space(*SPACES["triangle"])
    idx, w = tbs.sample_weights(tb, _t(XY[:4]))
    got = np.zeros((4, 3))
    for r in range(4):
        for k in range(3):
            got[r, idx[r, k]] += float(w[r, k])
    np.testing.assert_allclose(got, [[0.5, 0.25, 0.25], [0, 1, 0], [0, 1, 0],
                                     [0.5, 0.5, 0]], atol=1e-5)


def _poses(aset_pair, w, t=0.5):
    jaset, taset = aset_pair
    ja = jtrack.init_animation_state(jaset, w)
    ja = ja._replace(time=jnp.full_like(ja.time, t))
    ta = ttrack.init_animation_state(taset, w, device="cpu")
    ta = ta._replace(time=torch.full_like(ta.time, t))
    return (jpose.build_poses(jaset, jtrack.sample_tracks(jaset, ja), 1),
            tpose.build_poses(taset, ttrack.sample_tracks(taset, ta), 1))


@pytest.mark.parametrize("space", ["triangle", "cloud", "two-point"])
def test_blendspace_pose_matches(space):
    jp, tp = _poses(_both(_clips), len(XY))
    pts, clips = SPACES[space]
    jout = jbs.blendspace_pose(jbs.build_blend_space(pts, clips),
                               jnp.asarray(XY), jp)
    tout = tbs.blendspace_pose(tbs.build_blend_space(pts, clips), _t(XY), tp)
    for a, b in zip(jout, tout):
        _close(a, b, 1e-5)


def _bs_machine(cls, space):
    mb = cls()
    run = mb.add_parameter("run")
    s0 = mb.add_state("idle", clip=0)
    s1 = mb.add_state("locomotion", blendspace=space)
    mb.set_entry_state(s0)
    mb.add_transition(s0, s1, run, duration=0.2)
    return mb.build()


def test_machine_blend_space_state_matches():
    """A machine whose second state is a blend space, mid-transition and
    settled, evaluated with a sampling point (and without one, where the
    state takes its clip list, as Engine.step passes none)."""
    pts, clips = SPACES["square"]
    jmt = _bs_machine(JMachineBuilder, jbs.build_blend_space(pts, clips))
    tmt = _bs_machine(MachineBuilder, tbs.build_blend_space(pts, clips))
    cmt = convert.machine_template(jmt)
    assert [i for i, _ in cmt.state_spaces] == [i for i, _ in
                                                tmt.state_spaces] == [1]
    np.testing.assert_array_equal(cmt.state_spaces[0][1].triangles,
                                  tmt.state_spaces[0][1].triangles)
    w = len(XY)
    jp, tp = _poses(_both(_clips), w)
    jms = jmachine.init_machine_state(jmt, w)
    tms = tmachine.init_machine_state(tmt, w, device="cpu")
    params = np.arange(w)[:, None] % 2 == 0
    for _ in range(8):
        jms = jmachine.update_machine(jmt, jms, jnp.asarray(params), DT)
        tms = tmachine.update_machine(tmt, tms, _t(params), DT)
        for sampling in (XY, None):
            jout = jmachine.evaluate_pose(
                jmt, jms, jp, None if sampling is None
                else jnp.asarray(sampling))
            tout = tmachine.evaluate_pose(
                tmt, tms, tp, None if sampling is None else _t(sampling))
            for a, b in zip(jout, tout):
                _close(a, b, 1e-5)


# ---------------------------------------------------------- layered machine

UPPER = np.array([False, False, False, True, True, True])


def _layer_set(cls):
    """walk: +x on every node; wave: +y on every node; run: +z."""
    b = cls()
    for name, axis in (("walk", 0), ("wave", 1), ("run", 2)):
        c = b.add_clip(name, length=1.0, looping=True)
        for n in range(N_NODES):
            keys = [lin([(0, 0), (1, 0)]) for _ in range(3)]
            keys[axis] = lin([(0, 0.2 * n), (1, 1.0 + 0.1 * n)])
            b.add_position_track(c, n, keys)
    return b.build()


def _layered(mb_cls, mod, weight_param, sampling_space):
    lower = mb_cls()
    go = lower.add_parameter("go")
    s0 = lower.add_state("walk", clip=0)
    s1 = lower.add_state("run", clip=2)
    lower.set_entry_state(s0)
    lower.add_transition(s0, s1, go, duration=0.25)
    upper = mb_cls()
    w0 = upper.add_state("wave", clip=1)
    upper.add_state("mix", blendspace=sampling_space)
    upper.set_entry_state(w0)
    upper.add_transition(w0, 1, 0, duration=0.1)
    return mod.LayeredMachine(layers=[
        mod.LayerSpec(machine=lower.build()),
        mod.LayerSpec(machine=upper.build(), mask=UPPER, weight=0.8,
                      weight_param=weight_param, sampling_param=0)])


@pytest.mark.parametrize("weight_param", [-1, 0])
def test_step_absm_layered_matches(weight_param):
    """Two layers: the lower walks then blends to run on a bool rule; the
    upper waves over a bone mask, then blends to a blend-space state
    sampled at a point parameter; its weight is fixed (0.8) or a float
    parameter that differs by world. Masked-off nodes keep the lower
    layer."""
    w = 3
    jaset, taset = _both(_layer_set)
    pts, clips = SPACES["triangle"]
    jlm = _layered(JMachineBuilder, jmachine, weight_param,
                   jbs.build_blend_space(pts, clips))
    tlm = _layered(MachineBuilder, tmachine, weight_param,
                   tbs.build_blend_space(pts, clips))
    clm = convert.layered_machine(jlm)
    np.testing.assert_array_equal(clm.layers[1].mask, tlm.layers[1].mask)
    jprm = jmachine.make_parameters(w, bools=1, floats=1, points=1)
    tprm = tmachine.make_parameters(w, bools=1, floats=1, points=1,
                                    device="cpu")
    floats = np.array([[0.0], [0.5], [1.0]], np.float32)
    points = np.array([[[0.2, 0.2]], [[0.9, 0.05]], [[-1.0, 2.0]]],
                      np.float32)
    jprm = jprm._replace(floats=jnp.asarray(floats),
                         points=jnp.asarray(points))
    tprm = tprm._replace(floats=_t(floats), points=_t(points))
    ja = jtrack.init_animation_state(jaset, w)
    ta = ttrack.init_animation_state(taset, w, device="cpu")
    jst = jmachine.init_layered_state(jlm, w)
    tst = tmachine.init_layered_state(tlm, w, device="cpu")
    p, r, s = _pose0(w, seed=9)
    jp, jr, jsc = map(jnp.asarray, (p, r, s))
    tp, tr, tsc = map(_t, (p, r, s))
    jstep = jax.jit(lambda *a: jplayer.step_absm_layered(jaset, jlm, *a, DT))
    for tick in range(24):
        bools = np.array([[tick >= 4], [tick >= 10], [False]])
        jprm = jprm._replace(bools=jnp.asarray(bools))
        tprm = tprm._replace(bools=_t(bools))
        ja, jst, jp, jr, jsc = jstep(ja, jst, jprm, jp, jr, jsc)
        ta, tst, tp, tr, tsc = tplayer.step_absm_layered(
            taset, tlm, ta, tst, tprm, tp, tr, tsc, DT)
        for a, b in zip((jp, jr, jsc), (tp, tr, tsc)):
            _close(a, b, 1e-5)
        for ja_, ta_ in zip(jst, tst):
            np.testing.assert_array_equal(np.asarray(ja_.current),
                                          ta_.current.numpy())
            _close(ja_.blend, ta_.blend, 1e-6)
    # masked-off (lower-body) nodes carry no +y wave
    assert tp[:, :3, 1].abs().max() < 1e-6


# ---------------------------------------------------------------- skinning

@pytest.fixture(scope="module")
def skin_inputs():
    rng = np.random.default_rng(11)
    b, v, w = 7, 300, 3
    idx = rng.integers(0, b, (v, 4)).astype(np.int32)
    wts = rng.uniform(0.1, 1, (v, 4)).astype(np.float32)
    wts /= wts.sum(-1, keepdims=True)
    skin = jskinning.SkinTemplate(
        bones=np.arange(b, dtype=np.int32),
        inv_bind=np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        vertices=rng.uniform(-1, 1, (v, 3)).astype(np.float32),
        bone_indices=idx, bone_weights=wts)
    mats = np.tile(np.eye(4, dtype=np.float32), (w, b, 1, 1))
    mats[:, :, :3, :] += rng.uniform(-0.3, 0.3, (w, b, 3, 4)).astype(
        np.float32)
    return skin, convert.skin_template(skin), mats


def test_skin_positions_gather_matches(skin_inputs):
    jskin, tskin, mats = skin_inputs
    want = jskinning.skin_positions_gather(jnp.asarray(mats), jskin)
    got = tskinning.skin_positions_gather(_t(mats), tskin)
    _close(want, got, 1e-5)
    dense = tskinning.skin_positions_dense(_t(mats), tskin)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=1e-5)


def test_apply_blend_shapes_matches():
    rng = np.random.default_rng(12)
    verts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    deltas = rng.uniform(-0.1, 0.1, (5, 200, 3)).astype(np.float32)
    weights = rng.uniform(0, 100, (4, 5)).astype(np.float32)
    want = jskinning.apply_blend_shapes(verts, deltas, jnp.asarray(weights))
    got = tskinning.apply_blend_shapes(verts, deltas, _t(weights))
    _close(want, got, 1e-5)
    # full weight (100 %) of one shape is base + that shape's deltas
    one = np.zeros((1, 5), np.float32)
    one[0, 2] = 100.0
    np.testing.assert_allclose(
        tskinning.apply_blend_shapes(_t(verts), _t(deltas), _t(one))[0],
        verts + deltas[2], rtol=0, atol=1e-6)


# ------------------------------------------------------------- sprite sheet

@pytest.mark.parametrize("kw", [
    dict(columns=4, rows=3, fps=12.0),
    dict(columns=5, rows=2, fps=7.5, first_frame=2, last_frame=8),
    dict(columns=3, rows=3, fps=10.0, looping=False)])
def test_spritesheet_frames_and_uvs_equal(kw):
    jsh, tsh = jsheet.SpriteSheetAnimation(**kw), tsheet.SpriteSheetAnimation(
        **kw)
    time = np.linspace(-0.5, 4.0, 97).astype(np.float32)
    jf = jsheet.current_frame(jsh, jnp.asarray(time))
    tf = tsheet.current_frame(tsh, _t(time))
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jsheet.frame_uv_rect(jsh, jf)),
                                  tsheet.frame_uv_rect(tsh, tf).numpy())
