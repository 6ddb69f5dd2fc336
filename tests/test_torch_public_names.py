"""Port parity: the public names of ported modules that PR-by-PR slices
left out (``core.aabb``, ``core.frustum``, ``core.quat``,
``core.transform``, ``scene.camera``, ``scene.graph.world_bounding_boxes``,
``io.fbx.load_fbx_scene``) against the JAX package's on the CPU, and a
check that every name the JAX package exports (each subpackage's and each
module's ``__all__``) exists in the port, but for the Pallas modules,
``platform.py`` and the TPU-layout helpers that are not ported.

Inputs are numpy arrays from seeds, handed to both packages. Bars: exact
where a function only selects, compares or moves values (boxes, corners,
identities, tests); within 1e-6 (1e-5 for transcendental chains such as
slerp and face_towards) where it sums products, whose association and
FMA contraction differ between XLA and PyTorch. Boolean tests are held
on inputs kept away from their boundaries.
"""
import importlib
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fyrox_tpu.core import aabb as jaabb
from fyrox_tpu.core import frustum as jfrustum
from fyrox_tpu.core import quat as jquat
from fyrox_tpu.core import transform as jtfm
from fyrox_tpu.scene import camera as jcamera
from fyrox_tpu_torch.core import aabb, frustum, quat
from fyrox_tpu_torch.core import transform as tfm
from fyrox_tpu_torch.scene import camera

torch.set_num_threads(2)
CPU = "cpu"


def T(x):
    return torch.as_tensor(np.array(x))


def eq(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            eq(g, w)
        return
    w = np.asarray(want)
    assert got.shape == w.shape and got.numpy().dtype == w.dtype
    np.testing.assert_array_equal(got.numpy(), w)


def near(got, want, atol=1e-6):
    w = np.asarray(want)
    assert got.shape == w.shape
    np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=atol)


def boxes(rng, n=64):
    lo = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    return lo, lo + rng.uniform(0.1, 1.5, (n, 3)).astype(np.float32)


def test_aabb_names_match_jax():
    rng = np.random.default_rng(0)
    a_lo, a_hi = boxes(rng)
    b_lo, b_hi = boxes(rng)
    pts = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    cloud = rng.uniform(-3, 3, (4, 16, 3)).astype(np.float32)
    rad = rng.uniform(0.05, 1.0, 64).astype(np.float32)
    eq(aabb.invalid((2, 5), device=CPU), jaabb.invalid((2, 5)))
    eq(aabb.unit(device=CPU), jaabb.unit())
    eq(aabb.from_points(T(cloud)), jaabb.from_points(jnp.asarray(cloud)))
    eq(aabb.from_points(T(cloud), axis=0),
       jaabb.from_points(jnp.asarray(cloud), axis=0))
    for fn in ("center", "half_extents", "volume"):
        eq(getattr(aabb, fn)(T(a_lo), T(a_hi)),
           getattr(jaabb, fn)(jnp.asarray(a_lo), jnp.asarray(a_hi)))
    eq(aabb.union(T(a_lo), T(a_hi), T(b_lo), T(b_hi)),
       jaabb.union(*map(jnp.asarray, (a_lo, a_hi, b_lo, b_hi))))
    inv = aabb.invalid((64,), device=CPU)
    eq(aabb.union(*inv, T(b_lo), T(b_hi)), (T(b_lo), T(b_hi)))
    got = aabb.contains_point(T(a_lo), T(a_hi), T(pts))
    eq(got, jaabb.contains_point(*map(jnp.asarray, (a_lo, a_hi, pts))))
    got = aabb.intersects_aabb(T(a_lo), T(a_hi), T(b_lo), T(b_hi))
    eq(got, jaabb.intersects_aabb(*map(jnp.asarray, (a_lo, a_hi, b_lo,
                                                     b_hi))))
    assert 0 < int(got.sum()) < 64
    got = aabb.intersects_sphere(T(a_lo), T(a_hi), T(pts), T(rad))
    eq(got, jaabb.intersects_sphere(*map(jnp.asarray,
                                         (a_lo, a_hi, pts, rad))))
    assert 0 < int(got.sum()) < 64
    eq(aabb.corners(T(a_lo), T(a_hi)),
       jaabb.corners(jnp.asarray(a_lo), jnp.asarray(a_hi)))


def view_projections(rng, n=4):
    eye = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    look = np.asarray(jcamera.look_at_rh(
        jnp.asarray(eye), jnp.zeros(3, jnp.float32),
        jnp.asarray([0.0, 1.0, 0.0], jnp.float32)))
    proj = np.asarray(jcamera.perspective(1.1, 1.3, 0.1, 20.0))
    return (proj @ look).astype(np.float32)


def test_frustum_names_match_jax():
    rng = np.random.default_rng(1)
    planes = np.asarray(jfrustum.from_view_projection(
        jnp.asarray(view_projections(rng))))[:, None]      # [4, 1, 6, 4]
    pts = rng.uniform(-4, 4, (4, 128, 3)).astype(np.float32)
    rad = rng.uniform(0.05, 1.5, (4, 128)).astype(np.float32)
    d = (planes[..., :3] * pts[..., None, :]).sum(-1) + planes[..., 3]
    keep = np.abs(d).min(-1) > 1e-3           # away from every plane
    got = frustum.contains_point(T(planes), T(pts))
    want = np.asarray(jfrustum.contains_point(jnp.asarray(planes),
                                              jnp.asarray(pts)))
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])
    assert 0 < int(got.sum()) < got.numel()
    keep = np.abs(d + rad[..., None]).min(-1) > 1e-3
    got = frustum.intersects_sphere(T(planes), T(pts), T(rad))
    want = np.asarray(jfrustum.intersects_sphere(
        jnp.asarray(planes), jnp.asarray(pts), jnp.asarray(rad)))
    np.testing.assert_array_equal(got.numpy()[keep], want[keep])
    assert 0 < int(got.sum()) < got.numel()


def unit_quats(rng, n=64):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_names_match_jax():
    rng = np.random.default_rng(2)
    a, b = unit_quats(rng), unit_quats(rng)
    b[:4] = a[:4]                              # nearly parallel: nlerp
    b[4:8] = -a[4:8]                           # opposite signs
    t = rng.uniform(0, 1, 64).astype(np.float32)
    axis = rng.standard_normal((64, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(-3, 3, 64).astype(np.float32)
    m = rng.standard_normal((64, 3, 3)).astype(np.float32)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    pts = rng.standard_normal((64, 5, 3)).astype(np.float32)
    eq(quat.identity((3, 2), device=CPU), jquat.identity((3, 2)))
    eq(quat.inverse(T(a)), jquat.inverse(jnp.asarray(a)))
    near(quat.from_axis_angle(T(axis), T(ang)),
         jquat.from_axis_angle(jnp.asarray(axis), jnp.asarray(ang)))
    near(quat.from_axis_angle(T(axis[0]), 0.7),
         jquat.from_axis_angle(jnp.asarray(axis[0]), 0.7))
    near(quat.slerp(T(a), T(b), T(t)),
         jquat.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)),
         atol=1e-5)
    near(quat.slerp(T(a), T(b), 0.25),
         jquat.slerp(jnp.asarray(a), jnp.asarray(b), 0.25), atol=1e-5)
    near(quat.angle(T(a)), jquat.angle(jnp.asarray(a)), atol=1e-5)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    near(quat.face_towards(T(d), T(np.array([0.0, 1.0, 0.0], np.float32))),
         jquat.face_towards(jnp.asarray(d), jnp.asarray([0.0, 1.0, 0.0])),
         atol=1e-5)
    near(quat.mtv(T(m), T(v)), jquat.mtv(jnp.asarray(m), jnp.asarray(v)))
    near(quat.mvb(T(m), T(pts)), jquat.mvb(jnp.asarray(m), jnp.asarray(pts)))


def test_transform_names_match_jax():
    rng = np.random.default_rng(3)
    t = rng.standard_normal((5, 3)).astype(np.float32)
    s = rng.uniform(0.2, 2, (5, 3)).astype(np.float32)
    eq(tfm.mat4_identity((2, 3), device=CPU), jtfm.mat4_identity((2, 3)))
    eq(tfm.make_translation(T(t)), jtfm.make_translation(jnp.asarray(t)))
    eq(tfm.make_scale(T(s)), jtfm.make_scale(jnp.asarray(s)))
    p = rng.standard_normal((5, 3)).astype(np.float32)
    near(tfm.transform_point(tfm.make_translation(T(t)), T(p)),
         np.asarray(p + t))


@pytest.mark.parametrize("ortho", [False, True], ids=["perspective",
                                                      "ortho"])
def test_camera_names_match_jax(ortho):
    rng = np.random.default_rng(4)
    q = unit_quats(rng, 4)
    g = np.asarray(jtfm.compose_trs(
        jnp.asarray(rng.uniform(-5, 5, (4, 3)).astype(np.float32)),
        jnp.asarray(q), jnp.ones((4, 3), jnp.float32)))
    kw = dict(ortho=ortho, vertical_size=3.0 if ortho else None)
    got = camera.view_projection(T(g), 1.2, 1.5, 0.1, 50.0, **kw)
    want = jcamera.view_projection(jnp.asarray(g), 1.2, 1.5, 0.1, 50.0,
                                   **kw)
    near(got, want, atol=1e-5)
    near(camera.camera_frustums(got), jcamera.camera_frustums(want),
         atol=1e-5)


def scene(lib, rng_seed=5):
    """A small hierarchy of meshes (a cube under a moved, turned parent)
    built with either package's builders."""
    rng = np.random.default_rng(rng_seed)
    sb = lib.SceneBuilder()
    root = sb.add_mesh(lib.make_cube(1.0), position=(1.0, 0.5, -2.0),
                       rotation=(0.0, 0.38268343, 0.0, 0.9238795))
    for i in range(3):
        sb.add_mesh(lib.make_sphere(0.4, slices=6, stacks=6),
                    position=tuple(rng.uniform(-2, 2, 3)), parent=root)
    sb.add_light("directional")
    return sb.build()


def test_world_bounding_boxes_match_jax():
    import types
    from fyrox_tpu.render import make_cube as jcube, make_sphere as jsphere
    from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
    from fyrox_tpu.scene import graph as jgraph, init_state as jinit
    from fyrox_tpu_torch.render import make_cube, make_sphere
    from fyrox_tpu_torch.scene import SceneBuilder, graph, init_state
    jt = scene(types.SimpleNamespace(SceneBuilder=JSceneBuilder,
                                     make_cube=jcube, make_sphere=jsphere))
    tt = scene(types.SimpleNamespace(SceneBuilder=SceneBuilder,
                                     make_cube=make_cube,
                                     make_sphere=make_sphere))
    js = jgraph.update_hierarchical_data(jinit(jt, 2), jt)
    ts = graph.update_hierarchical_data(init_state(tt, 2, device=CPU), tt)
    got = graph.world_bounding_boxes(ts, tt)
    want = jgraph.world_bounding_boxes(js, jt)
    for g, w in zip(got, want):
        near(g, w, atol=1e-5)
    assert got[0].shape == (2, tt.num_nodes, 3)


def test_load_fbx_scene_matches_jax(tmp_path):
    from fyrox_tpu.io import fbx as jfbx
    from fyrox_tpu_torch.io import fbx
    from fyrox_tpu_torch.models import make_character_fbx
    data = make_character_fbx(n_bones=5, n_verts=120)
    path = tmp_path / "character.fbx"
    path.write_bytes(data)
    for src in (data, str(path)):
        sb, names = fbx.load_fbx_scene(src)
        jsb, jnames = jfbx.load_fbx_scene(src)
        assert names == jnames and len(names) >= 5
        got, want = sb.build(), jsb.build()
        assert got.num_nodes == want.num_nodes
        for f in ("parent", "node_type", "init_position", "init_rotation",
                  "init_scale", "local_bbox_min", "local_bbox_max"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)


JAX_ROOT = pathlib.Path(jaabb.__file__).parents[1]
# not ported (ROADMAP.md, "Do not port"): the Pallas kernels' modules, the
# TPU platform tooling, planes.py's TPU-layout helpers and slab2.supports
NOT_PORTED = {
    "fyrox_tpu.physics.planes": {"v3", "mul3", "qrotate_inv", "rot9_mul",
                                 "stack_last", "unstack_last"},
    "fyrox_tpu.physics.slab2": {"supports"}}


def _jax_modules(packages):
    """fyrox_tpu's packages (or its plain modules) by dotted name, without
    the Pallas modules and platform.py."""
    out = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        rel = path.relative_to(JAX_ROOT.parent).with_suffix("")
        if path.name.startswith("pallas_") or path.name == "platform.py":
            continue
        if (path.name == "__init__.py") == packages:
            out.append(".".join(rel.parts[:-1] if packages else rel.parts))
    return out


@pytest.mark.parametrize("packages", [True, False],
                         ids=["subpackages", "modules"])
def test_every_exported_jax_name_exists_in_the_port(packages):
    missing = {}
    for name in _jax_modules(packages):
        names = getattr(importlib.import_module(name), "__all__", None)
        if not names:
            continue
        port = importlib.import_module(name.replace("fyrox_tpu",
                                                    "fyrox_tpu_torch", 1))
        lost = [n for n in names if not hasattr(port, n)
                and n not in NOT_PORTED.get(name, ())
                and not n.startswith("pallas_") and n != "platform"]
        if lost:
            missing[name] = lost
    assert missing == {}
    assert len(_jax_modules(packages)) > (10 if packages else 100)
