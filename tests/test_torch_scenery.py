"""Port parity: heightfield / trimesh scenery (fyrox_tpu_torch.physics.
scenery), the terrain node (scene/terrain.py) and the staged slab step
with hulls and a heightfield, against fyrox_tpu on the CPU.

The same numpy-seeded inputs go through both packages: each shape's
sample points, the heightfield and trimesh routines at random poses and a
box resting flat on a flat heightfield (four corners at one depth: XLA
top_k's order), the terrain's sampling and mesh, and one cold staged-slab
step of a small hull + heightfield scene (the JAX slab step takes the
staged XLA path off TPU). Single evaluations are held to 1e-5.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

import chip_smoke
from fyrox_tpu.physics import narrowphase as jnarrow
from fyrox_tpu.physics import scenery as jsc
from fyrox_tpu.physics import world as jworld
from fyrox_tpu.physics.world import PhysicsBuilder as JPhysicsBuilder
from fyrox_tpu.scene import terrain as jterrain
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.physics import narrowphase as tnarrow
from fyrox_tpu_torch.physics import scenery as tsc
from fyrox_tpu_torch.physics import shapes as sh
from fyrox_tpu_torch.physics import world as tworld
from fyrox_tpu_torch.physics.world import PhysicsBuilder
from fyrox_tpu_torch.scene import terrain as tterrain

torch.set_num_threads(2)

DT = 1.0 / 60.0
TOL = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, name, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol, err_msg=name)


def _poses(rng, w, p, spread=1.0):
    pos = (rng.normal(size=(w, p, 3)) * spread).astype(np.float32)
    rot = Rotation.random(w * p, random_state=int(rng.integers(1 << 30)))
    return pos, rot.as_matrix().reshape(w, p, 3, 3).astype(np.float32)


@pytest.mark.parametrize("kind", [sh.BALL, sh.CAPSULE, sh.CUBOID, sh.CONVEX])
def test_sample_points_match(kind):
    rng = np.random.default_rng(kind)
    pos, rot = _poses(rng, 2, 7)
    params = np.zeros((2, 7, 6), np.float32)
    params[..., :3] = rng.uniform(0.1, 0.4, (2, 7, 3))
    hull = None
    if kind == sh.CONVEX:
        verts = rng.normal(size=(1, 7, 32, 3)).astype(np.float32) * 0.2
        vmask = np.arange(32)[None, None] < rng.integers(4, 32, (1, 7, 1))
        hull = (verts, vmask)
    js, jr = jsc.sample_points_for(kind, jnp.asarray(params), pos, rot,
                                   hull=hull)
    ts, tr = tsc.sample_points_for(kind, _t(params), _t(pos), _t(rot),
                                   hull=None if hull is None
                                   else tuple(map(_t, hull)))
    _close(ts, js, "samples")
    _close(tr.expand(js.shape[:-2]) if tr.dim() else tr, jr, "radius")


def _field(rng, res=9, flat=False):
    h = np.zeros((res, res), np.float32) if flat else \
        rng.uniform(-0.3, 0.3, (res, res)).astype(np.float32)
    return h


@pytest.mark.parametrize("case", ["random", "flat_box"])
def test_points_heightfield_matches(case):
    """Random samples over a random field; and a box resting flat on a
    flat field, whose four bottom corners tie exactly in depth."""
    rng = np.random.default_rng(7)
    w, p = 2, 9
    pos_h, rot_h = _poses(rng, w, p, 0.2)
    heights = _field(rng, flat=case == "flat_box")[None, None].repeat(p, 1)
    sx = np.full((1, p), 4.0, np.float32)
    sz = np.full((1, p), 3.0, np.float32)
    if case == "flat_box":
        pos_h[:] = 0.0
        rot_h[:] = np.eye(3, dtype=np.float32)
        params = np.zeros((1, p, 6), np.float32)
        params[..., :3] = 0.2
        pos_a = np.zeros((w, p, 3), np.float32)
        pos_a[..., 0] = rng.uniform(-1, 1, (w, p))
        pos_a[..., 1] = 0.19
        samples = np.asarray(jsc.sample_points_for(
            sh.CUBOID, jnp.asarray(params),
            pos_a, np.broadcast_to(np.eye(3, dtype=np.float32),
                                   (w, p, 3, 3)))[0])
        radius = np.zeros((w, p), np.float32)
    else:
        samples = (rng.normal(size=(w, p, 5, 3)) * 1.2).astype(np.float32)
        radius = rng.uniform(0.0, 0.3, (w, p)).astype(np.float32)
    pred = np.full((w, p), 0.05, np.float32)
    args = (samples, radius, pos_h, rot_h, heights, sx, sz, pred)
    jo = jax.jit(jsc.points_heightfield)(*args)
    to = tsc.points_heightfield(*map(_t, args))
    assert np.asarray(jo[3]).any()
    for name, a, b in zip(("normal", "points", "depth"), jo, to):
        _close(b, a, name)
    np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
    if case == "flat_box":
        # the dense routine's 4 deepest of the 8 corners, in XLA's order
        ranges = [((sh.CUBOID, sh.HEIGHTFIELD), 0, p)]
        col_hf = np.zeros(2, np.int32)
        scn = (heights[0, :1], np.array([[4.0, 3.0]], np.float32), col_hf,
               None, None, None, np.zeros(p, np.int32), np.ones(p, np.int32))
        a = [params, pos_a, np.broadcast_to(np.eye(3, dtype=np.float32),
                                            (w, p, 3, 3)).copy(),
             np.zeros((1, p, 6), np.float32), pos_h, rot_h]
        jf = jnarrow.generate_contacts_flat(ranges, *map(jnp.asarray, a),
                                            pred=jnp.asarray(pred),
                                            scenery_ctx=scn)
        tf = tnarrow.generate_contacts_flat(ranges, *map(_t, a), pred=_t(pred),
                                            scenery_ctx=scn)
        for k in ("point", "depth", "active"):
            np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]), k)


def test_points_trimesh_matches():
    rng = np.random.default_rng(11)
    w, p = 2, 6
    pos_m, rot_m = _poses(rng, w, p, 0.2)
    tris = np.zeros((1, p, 16, 3, 3), np.float32)
    tris[..., :10, :, :] = rng.normal(size=(1, p, 10, 3, 3)) * 0.8
    tris[..., :4, :, :] = chip_smoke.RAMP
    mask = np.arange(16)[None, None] < 10
    mask = np.broadcast_to(mask, (1, p, 16)).copy()
    samples = (rng.normal(size=(w, p, 8, 3)) * 0.8).astype(np.float32)
    radius = np.full((w, p), 0.04, np.float32)
    pred = np.full((w, p), 0.3, np.float32)
    args = (samples, radius, pos_m, rot_m, tris, mask, pred)
    # eager JAX rounds as PyTorch does: a normal is the direction from the
    # closest surface point to a sample, and near the surface XLA's fused
    # multiply-adds move it by up to 3e-5 (measured)
    with jax.disable_jit():
        jo = jsc.points_trimesh(*args)
    to = tsc.points_trimesh(*map(_t, args))
    assert np.asarray(jo[3]).any()
    for name, a, b in zip(("normal", "points", "depth"), jo, to):
        _close(b, a, name)
    np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))


def test_terrain_matches():
    """Terrain sampling, normals, ball contacts, hf_sample and the render
    mesh against the JAX package's."""
    rng = np.random.default_rng(2)
    h = chip_smoke.hills(17, 8.0, amp=0.5)
    jt = jterrain.Terrain(h, size_x=8.0, size_z=6.0, origin=(1.0, 0.2, -2.0))
    tt = tterrain.Terrain(h, size_x=8.0, size_z=6.0, origin=(1.0, 0.2, -2.0))
    x = rng.uniform(0.0, 10.0, 64).astype(np.float32)
    z = rng.uniform(-3.0, 5.0, 64).astype(np.float32)
    _close(tterrain.sample_height(tt, _t(x), _t(z)),
           jterrain.sample_height(jt, x, z), "height")
    _close(tterrain.terrain_normal(tt, _t(x), _t(z)),
           jterrain.terrain_normal(jt, x, z), "normal")
    c = np.stack([x, rng.uniform(0.0, 0.8, 64), z], -1).astype(np.float32)
    r = np.full(64, 0.3, np.float32)
    jo = jterrain.terrain_ball_contacts(jt, c, r, pred=0.05)
    to = tterrain.terrain_ball_contacts(tt, _t(c), _t(r), pred=0.05)
    for name, a, b in zip(("normal", "point", "depth"), jo[:3], to[:3]):
        _close(b, a, name)
    np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
    _close(tsc.hf_sample(_t(h), _t(8.0), _t(6.0), _t(x - 5), _t(z)),
           jsc.hf_sample(h, 8.0, 6.0, x - 5, z), "hf_sample")
    jm, tm = jt.to_mesh(), tt.to_mesh()
    for f in ("positions", "normals", "uvs", "triangles"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), f)


# ---- one cold staged-slab step ---------------------------------------------

def test_cold_slab_step_matches():
    """A 16-body hull + heightfield + trimesh pile (chip_smoke.
    terrain_pile, hull clouds at every 8th + 2, the ramp) built with
    broadphase="slab": the JAX slab
    step (jitted; the staged XLA path) over 26 ticks, then one step of the
    port from that state with the warm starts zeroed (cold), against JAX's
    from the same: positions within 1e-5, contact point identities
    equal."""
    scene = dict(n_bodies=16, res=9, size=6.0, ramp=True,
                 kinds={2: sh.CONVEX})
    jpb = chip_smoke.terrain_pile(JPhysicsBuilder(), **scene)
    tpb = chip_smoke.terrain_pile(PhysicsBuilder(), **scene)
    jt, tt = jpb.build(broadphase="slab"), tpb.build(broadphase="slab")
    assert tt.grid is not None and tt.hulls is not None
    js = jworld.init_physics_state(jpb, jt, 2)
    js = js._replace(position=js.position.at[1].add(0.01))
    step = jax.jit(lambda s: jworld.step_physics(s, jt, DT))
    for _ in range(26):
        js = step(js)
    zero = jnp.zeros_like(js.warm_n)
    js = js._replace(warm_n=zero, warm_t1=zero, warm_t2=zero)
    ts = convert.physics_state(jax.tree_util.tree_map(np.asarray, js),
                               device="cpu")
    jn = jax.tree_util.tree_map(np.asarray, step(js))
    tn = tworld.step_physics(ts, tt, DT)
    assert (jn.warm_pair >= 0).sum() > 8
    np.testing.assert_array_equal(tn.warm_pair.numpy(), jn.warm_pair)
    for f in ("position", "rotation"):
        _close(getattr(tn, f), getattr(jn, f), f)
    _close(tn.linvel, jn.linvel, "linvel", 1e-4)


def test_trimesh_normals_on_an_unturned_ramp_follow_unfused_rounding():
    """A ramp sloping along x has normals with z = 0 exactly, where the
    solver's tangent basis switches branch (n_z >= 0): the last bit of n_z
    picks the branch. The port's normals there equal the JAX package's
    run without jit bit for bit (the jitted JAX step fuses multiply-adds
    and parts from both; ROADMAP queue 3). The test and chip scenes turn
    their ramp for that reason."""
    c, s = np.cos(-np.pi / 6), np.sin(-np.pi / 6)
    unturn = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    ramp = (chip_smoke.RAMP.astype(np.float64) @ unturn.T).astype(np.float32)
    rng = np.random.default_rng(5)
    xz = rng.uniform(-0.4, 1.4, (1, 1, 24, 2))
    y = 0.1 - 0.2 * (xz[..., 0] + 0.5) + rng.uniform(0.001, 0.03, xz.shape[:-1])
    samples = np.stack([xz[..., 0], y, xz[..., 1] * 1.4], -1).astype(np.float32)
    tris = ramp[None, None]
    args = (samples, np.full((1, 1), 0.04, np.float32), np.zeros((1, 1, 3),
            np.float32), np.eye(3, dtype=np.float32)[None, None], tris,
            np.ones((1, 1, 4), bool), np.full((1, 1), 0.05, np.float32))
    with jax.disable_jit():
        jo = jsc.points_trimesh(*args)
    to = tsc.points_trimesh(*map(_t, args))
    assert np.abs(np.asarray(jo[0])[..., 2]).max() < 1e-5
    for name, a, b in zip(("normal", "points", "depth", "active"), jo, to):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
