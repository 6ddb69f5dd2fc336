"""Port parity: the deferred + CSM render path (fyrox_tpu_torch/render; K5
tile raster) against the JAX package's Pallas path on the CPU.

The JAX side runs as its own tests run it: ``rasterize_pallas(...,
interpret=True)`` and ``RenderConfig(use_pallas=True,
pallas_interpret=True)``. The port takes its plain versions (CPU tensors).
Inputs are made with numpy from seeds and handed to both packages; the
JAX templates are carried into the port with ``convert``.

Rounding: XLA contracts multiply-adds into FMAs where PyTorch rounds every
product, so float results differ in the last bits (the bars below say by
how much, and why). Where a triangle's back-face determinant is itself
rounding noise (a zero-area triangle, or a face seen exactly edge-on), the
two packages may decide its validity differently; the whole-frame test
uses generic orientations so that every triangle is decided with margin,
and integer results (binning, demand, caps) are then held equal.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.render import (RenderConfig as JRenderConfig,
                              build_render_template as jbuild_rt,
                              make_cube as jcube, make_plane as jplane,
                              make_sphere as jsphere,
                              render_frame_demand as jrender_demand)
from fyrox_tpu.render import lighting as jlighting
from fyrox_tpu.render import pallas_raster as jpr
from fyrox_tpu.render import raster as jraster
from fyrox_tpu.render import shadows as jshadows
from fyrox_tpu.render.shadows import CsmConfig as JCsmConfig
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu.scene import camera as jcamera
from fyrox_tpu.scene import graph as jgraph
from fyrox_tpu.scene import init_state as jinit
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.render import (CsmConfig, RenderConfig,
                                    build_render_template, lighting,
                                    make_cube, make_plane, make_sphere,
                                    render_frame, render_frame_demand,
                                    shadows, tile_raster)
from fyrox_tpu_torch.render.raster import GBuffer
from fyrox_tpu_torch.scene import SceneBuilder, camera

torch.set_num_threads(2)

TILT = (np.sin(np.pi / 3), 0.0, 0.0, np.cos(np.pi / 3))
LOOK_DOWN = (np.sin(np.pi / 8), 0.0, 0.0, np.cos(np.pi / 8))


def random_tris(rng, t=64):
    """tests/test_pallas_raster.py::random_tris, as numpy."""
    centers = rng.uniform(-1, 1, (t, 1, 3)) * np.array([1.0, 1.0, 0])
    offs = rng.uniform(-0.15, 0.15, (t, 3, 3)) * np.array([1, 1, 0])
    depth = rng.uniform(0.2, 0.9, (t, 1, 1))
    v = centers + offs
    w = 1.0 / (1 - depth * 0.5)
    clip = np.concatenate([v[..., :2] * w,
                           np.broadcast_to(depth, (t, 3, 1)) * w,
                           np.broadcast_to(w, (t, 3, 1))], -1).astype(
        np.float32)
    attrs = {k: rng.uniform(0, 1, (t, 3, c)).astype(np.float32)
             for k, c in [("albedo", 3), ("normal", 3), ("position", 3),
                          ("material", 2), ("emission", 3)]}
    return clip, attrs


# ---------------------------------------------------------------- features


@pytest.mark.parametrize("cull", [True, False])
def test_features_match_jax(cull):
    clip, _ = random_tris(np.random.default_rng(0))
    valid = np.ones(clip.shape[0], bool)
    valid[::7] = False
    f1, b1, o1 = jpr._tri_features_h(jnp.asarray(clip), jnp.asarray(valid),
                                     64, 128, backface_cull=cull)
    f2, b2, o2 = tile_raster.tri_features_h(torch.as_tensor(clip),
                                            torch.as_tensor(valid), 64, 128,
                                            backface_cull=cull)
    f1, f2 = np.asarray(f1), f2.numpy()
    np.testing.assert_array_equal(np.asarray(o1), o2.numpy())
    # 1e-6 of the size of the products that make each coefficient (the
    # triangle's largest screen column entry squared, times its largest
    # |z| or |w|, at least 1): XLA fuses the cross products' a*b - c*d into
    # FMAs where PyTorch rounds each product, and the sums cancel (S's x
    # and y coefficients are ~0), so a bar relative to each value would
    # measure cancellation, not the port
    x, y, z, w = (clip[..., i] for i in range(4))
    cols = np.stack([(0.5 * x + 0.5 * w) * 128, (0.5 * w - 0.5 * y) * 64, w],
                    -1)
    scale = (np.abs(cols).max((1, 2)) ** 2
             * np.maximum(1.0, np.abs(clip[..., 2:]).max((1, 2))))
    err = np.abs(f1[:, :15] - f2[:, :15]).max(1)
    assert (err <= 1e-6 * scale).all(), (err / scale).max()
    np.testing.assert_array_equal(f1[:, 15], f2[:, 15])
    # the bbox is u / w and v / w of the same columns: a few ulps of pixel
    # coordinates (up to ~1e2 here)
    np.testing.assert_allclose(np.asarray(b1), b2.numpy(), rtol=1e-6,
                               atol=1e-4)


# ----------------------------------------------------------------- binning


@pytest.mark.parametrize("k", [56, 16])       # headroom, and overflow
@pytest.mark.parametrize("mode", ["cumsum", "topk"])
def test_binning_matches_jax(k, mode):
    """ids, valid slots, counts and demand equal as integers, on the same
    bboxes (the JAX package's), with and without overflow (K = 16 on 32 x
    128 tiles, as tests/test_pallas_raster.py:46); the port's one binning
    against both of the JAX package's modes."""
    clip, _ = random_tris(np.random.default_rng(9), t=60)
    _, bbox, ok = jpr._tri_features_h(jnp.asarray(clip),
                                      jnp.ones(60, bool), 64, 128)
    jpr.demand_trace_start()
    ids, valid, count = jpr._bin_triangles(bbox, ok, 64, 128, 32, 128, k,
                                           mode=mode)
    (jdemand, jcap), = jpr.demand_trace_stop()
    tids, tcount, tdemand = tile_raster.bin_triangles(
        torch.tensor(np.asarray(bbox))[None],
        torch.tensor(np.asarray(ok))[None], 64, 128, 32, 128, k)
    count = np.asarray(count).reshape(-1)
    np.testing.assert_array_equal(tcount[0].numpy(), count)
    tvalid = np.arange(k)[None, :] < tcount[0].numpy()[:, None]
    np.testing.assert_array_equal(tvalid, np.asarray(valid).reshape(-1, k))
    np.testing.assert_array_equal(tids[0].numpy(),
                                  np.asarray(ids).reshape(-1, k))
    assert int(tdemand[0]) == int(jdemand)
    assert (int(jdemand) >= k) == (k == 16)


# -------------------------------------------------- rasterize_tiled vs JAX


@pytest.mark.parametrize("size", [(64, 128), (32, 32)])
@pytest.mark.parametrize("depth_only", [False, True])
def test_rasterize_tiled_matches_rasterize_pallas(size, depth_only):
    """32 x 32 runs on 8 x 32 tiles; both sizes bin at K = 160 (cap) and
    draw the random_tris scene of the JAX raster tests, two-sided in the
    depth-only case as the shadow passes draw."""
    h, w = size
    clip, attrs = random_tris(np.random.default_rng(0))
    tc = torch.as_tensor(clip)[None]
    if depth_only:
        z1 = np.asarray(jpr.rasterize_pallas(
            jnp.asarray(clip), {}, h, w, k_per_tile=160, interpret=True,
            depth_only=True, backface_cull=False, bin_mode="cumsum"))
        z2 = tile_raster.rasterize_tiled(tc, {}, h, w, k_per_tile=160,
                                         depth_only=True,
                                         backface_cull=False)[0].numpy()
        m1, m2 = z1 < 1e8, z2 < 1e8
    else:
        g1 = jpr.rasterize_pallas(
            jnp.asarray(clip), {n: jnp.asarray(v) for n, v in attrs.items()},
            h, w, k_per_tile=160, interpret=True, bin_mode="cumsum")
        g2 = tile_raster.rasterize_tiled(
            tc, {n: torch.as_tensor(v)[None] for n, v in attrs.items()}, h,
            w, k_per_tile=160)
        m1, m2 = np.asarray(g1.mask), g2.mask[0].numpy()
        z1, z2 = np.asarray(g1.depth), g2.depth[0].numpy()
    # the reference's own bars (tests/test_pallas_raster.py:36-44)
    assert (m1 == m2).mean() >= 0.999
    both = m1 & m2
    assert both.sum() > 40
    np.testing.assert_allclose(z1[both], z2[both], atol=2e-5)
    if not depth_only:
        np.testing.assert_allclose(np.asarray(g1.albedo)[both],
                                   g2.albedo[0].numpy()[both], atol=1e-4)
        assert g2.depth.shape == (1, h, w) and g2.albedo.shape == (1, h, w, 3)


def test_tiny_scene_pads_rows():
    """Fewer triangles than one chunk of 8 (row padding, as :439-444)."""
    clip, attrs = random_tris(np.random.default_rng(4), t=3)
    g = tile_raster.rasterize_tiled(
        torch.as_tensor(clip)[None],
        {n: torch.as_tensor(v) for n, v in attrs.items()}, 32, 128)
    g1 = jpr.rasterize_pallas(jnp.asarray(clip),
                              {n: jnp.asarray(v) for n, v in attrs.items()},
                              32, 128, interpret=True)
    assert int(g.mask.sum()) > 0
    np.testing.assert_array_equal(g.mask[0].numpy(), np.asarray(g1.mask))


def test_two_launch_variants_agree():
    """The depth-only variant returns the full variant's depth."""
    clip, attrs = random_tris(np.random.default_rng(2))
    tc = torch.as_tensor(clip)[None].expand(2, -1, -1, -1)
    g = tile_raster.rasterize_tiled(
        tc, {n: torch.as_tensor(v) for n, v in attrs.items()}, 64, 128)
    z = tile_raster.rasterize_tiled(tc, {}, 64, 128, depth_only=True)
    assert torch.equal(g.depth, z)


# ------------------------------------- camera, frustum, aabb, transforms


def test_camera_frustum_aabb_match_jax():
    """The small matrix helpers of the frame, on seeded random inputs."""
    from fyrox_tpu.core import aabb as jaabb, frustum as jfrustum
    from fyrox_tpu.core import quat as jquat, transform as jtfm
    from fyrox_tpu_torch.core import aabb, frustum, transform as tfm
    rng = np.random.default_rng(5)
    q = rng.standard_normal((6, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    g = np.zeros((6, 4, 4), np.float32)
    g[:, :3, :3] = np.asarray(jquat.to_mat3(jnp.asarray(q, jnp.float32)))
    g[:, :3, 3] = rng.uniform(-5, 5, (6, 3))
    g[:, 3, 3] = 1.0
    jg, tg = jnp.asarray(g), torch.as_tensor(g)
    pairs = [
        (jcamera.perspective(1.2, 1.5, 0.05, 100.0),
         camera.perspective(1.2, 1.5, 0.05, 100.0)),
        (jcamera.orthographic(5.0, 1.5, 0.05, 100.0),
         camera.orthographic(5.0, 1.5, 0.05, 100.0)),
        (jcamera.view_matrix(jg), camera.view_matrix(tg)),
        (jfrustum.from_view_projection(jg), frustum.from_view_projection(tg)),
    ]
    pts = rng.uniform(-2, 2, (6, 3)).astype(np.float32)
    pairs.append((jtfm.transform_point(jg, jnp.asarray(pts)),
                  tfm.transform_point(tg, torch.as_tensor(pts))))
    pairs.append((jtfm.transform_vector(jg, jnp.asarray(pts)),
                  tfm.transform_vector(tg, torch.as_tensor(pts))))
    lo, hi = -np.abs(pts), np.abs(pts) + 0.1
    jbox = jaabb.transform(jnp.asarray(lo), jnp.asarray(hi), jg)
    tbox = aabb.transform(torch.as_tensor(lo), torch.as_tensor(hi), tg)
    pairs += list(zip(jbox, tbox))
    # a few float32 roundings in other orders (XLA fuses multiply-adds)
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-5)
    planes = frustum.from_view_projection(tg)
    box = (torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(
        frustum.intersects_aabb(planes[:, None], *box).numpy(),
        np.asarray(jfrustum.intersects_aabb(
            jfrustum.from_view_projection(jg)[:, None], jnp.asarray(lo),
            jnp.asarray(hi))))


# ------------------------------------------------------------------ scenes


def _bench_like(builder, plane, cube, sphere, n_obj=8, generic=False):
    """bench_render.py's scene with n_obj objects. `generic` gives every
    triangle a back-face determinant far from rounding noise: the cubes
    turn by seeded rotations, the spheres lose their zero-area pole
    triangles and the light tilts about a generic axis."""
    sb = builder()
    sb.add_mesh(plane(40.0, albedo=(0.5, 0.5, 0.5)), name="ground")
    rng = np.random.default_rng(0)
    rot = np.random.default_rng(7)
    for i in range(n_obj):
        x, z = rng.uniform(-10, 10, 2)
        if i % 2:
            q = rot.standard_normal(4) if generic else None
            sb.add_mesh(cube(1.0, albedo=(0.7, 0.3, 0.2)),
                        position=(x, 0.5, z),
                        rotation=None if q is None else q / np.linalg.norm(q))
        else:
            m = sphere(0.5, slices=8, stacks=8, albedo=(0.2, 0.4, 0.7))
            if generic:
                p = m.positions[m.triangles]
                area = np.linalg.norm(np.cross(p[:, 1] - p[:, 0],
                                               p[:, 2] - p[:, 0]), axis=-1)
                m.triangles = m.triangles[area > 1e-6]
            sb.add_mesh(m, position=(x, 0.5, z))
    if generic:
        axis = np.array([1.0, 0.3, 0.2]) / np.linalg.norm([1.0, 0.3, 0.2])
        tilt = tuple(np.append(axis * np.sin(0.55), np.cos(0.55)))
    else:
        tilt = TILT
    sb.add_light("directional", rotation=tilt, intensity=2.0)
    sb.add_camera("cam", position=(0, 8.0, -14.0), rotation=LOOK_DOWN)
    return sb.build()


def _jax_state(t, n_worlds, seed=1):
    """JAX WorldState with the camera jittered per world (seeded)."""
    st = jinit(t, n_worlds)
    cam = int(t.cameras["node"][0])
    pos = np.array(st.position)
    pos[:, cam] += np.random.default_rng(seed).uniform(
        -0.5, 0.5, (n_worlds, 3)).astype(np.float32)
    st = jgraph.update_hierarchical_data(st._replace(
        position=jnp.asarray(pos)), t)
    return st, convert.scene_state(jax.tree_util.tree_map(np.asarray, st),
                                   device="cpu")


def test_builders_and_render_template_match_jax():
    """The port's builders and build_render_template give the JAX
    package's templates, array for array, on the bench scene."""
    jt = _bench_like(JSceneBuilder, jplane, jcube, jsphere, n_obj=64)
    tt = _bench_like(SceneBuilder, make_plane, make_cube, make_sphere,
                     n_obj=64)
    jrt, trt = jbuild_rt(jt), build_render_template(tt)
    assert trt.num_triangles == 4482 and trt.positions.shape == (3364, 3)
    for f in trt.__dataclass_fields__:
        a, b = getattr(jrt, f), getattr(trt, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
        else:
            assert a == b, f
    np.testing.assert_array_equal(jt.local_bbox_min, tt.local_bbox_min)
    np.testing.assert_array_equal(jt.local_bbox_max, tt.local_bbox_max)
    for k in jt.lights:
        np.testing.assert_array_equal(np.asarray(jt.lights[k]),
                                      tt.lights[k], err_msg=k)
    conv = convert.render_template(jrt)
    for f in trt.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(conv, f)),
                                      np.asarray(getattr(trt, f)))


# ------------------------------------------------------------------ shadows


@pytest.fixture(scope="module")
def shadow_inputs():
    """The bench scene's geometry and light (8 objects), 2 worlds."""
    jt = _bench_like(JSceneBuilder, jplane, jcube, jsphere)
    st, tst = _jax_state(jt, 2)
    rt = jbuild_rt(jt)
    g = np.asarray(st.globals_)
    vg = g[:, rt.vert_node]
    wpos = np.einsum("wvij,vj->wvi", vg[..., :3, :3],
                     rt.positions) + vg[..., :3, 3]
    tri_pos = wpos[:, rt.triangles].astype(np.float32)      # [W, T, 3, 3]
    cam = g[:, rt.camera_node]
    view = np.asarray(jax.vmap(jcamera.view_matrix)(jnp.asarray(cam)))
    li = int(rt.light_node[0])
    ldir = g[:, li, :3, 2]
    return jt, rt, tri_pos, view, ldir


def test_fit_cascades_match_jax(shadow_inputs):
    _, rt, _, view, ldir = shadow_inputs
    cfg = JCsmConfig()
    j = np.stack([np.asarray(jshadows.fit_cascades(
        jnp.asarray(view[w]), rt.fov_y, 1.0, rt.z_near, 100.0,
        jnp.asarray(ldir[w]), cfg)) for w in range(2)])
    t = shadows.fit_cascades(torch.as_tensor(view), rt.fov_y, 1.0,
                             rt.z_near, 100.0, torch.as_tensor(ldir),
                             CsmConfig()).numpy()
    # 1e-5 of each matrix's largest entry: two 4x4 products and an affine
    # inverse, summed in other orders
    scale = np.abs(j).max((-1, -2), keepdims=True)
    assert (np.abs(j - t) <= 1e-5 * scale).all()


def test_cascade_depths_match_jax_with_tuple_budget(shadow_inputs):
    """render_cascade_depths with the bench's per-cascade budgets: the
    port culls each cascade, pads and runs one depth-only pass over all
    worlds x cascades; the JAX package's batched launch per world."""
    _, rt, tri_pos, view, ldir = shadow_inputs
    budget, k, size = (0.05, 1.0, 0.75), 424, 64
    vps = shadows.fit_cascades(torch.as_tensor(view), rt.fov_y, 1.0,
                               rt.z_near, 100.0, torch.as_tensor(ldir))
    foot = []
    z2 = shadows.render_cascade_depths(
        torch.as_tensor(tri_pos), vps, size, k_per_tile=k,
        tri_budget=budget, footprint=foot).numpy()
    # the kept set equals the JAX package's only while the in-footprint
    # count stays below the budget (both keep every in-footprint triangle)
    assert len(foot) == 2 and all(int(n.max()) < b for n, b in foot)
    for w in range(2):
        z1 = np.asarray(jshadows.render_cascade_depths(
            jnp.asarray(tri_pos[w]), jnp.asarray(vps[w].numpy()), size,
            use_pallas=True, pallas_interpret=True, k_per_tile=k,
            tri_budget=budget, bin_mode="cumsum"))
        m1, m2 = z1 < 1e8, z2[w] < 1e8
        # the raster bars above: coverage on >= 99.9 % of texels, depth
        # within 2e-5 where both hit
        assert (m1 == m2).mean() >= 0.999 and m1.sum() > 1000
        both = m1 & m2
        np.testing.assert_allclose(z1[both], z2[w][both], atol=2e-5)


# ----------------------------------------------------------------- lighting


def test_shade_matches_jax():
    """All three light kinds, a CSM-like visibility, two worlds."""
    rng = np.random.default_rng(3)
    w, h, wd = 2, 16, 24

    def u(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    gb = dict(depth=u(w, h, wd), albedo=u(w, h, wd, 3, lo=0),
              normal=u(w, h, wd, 3), position=u(w, h, wd, 3, lo=-3, hi=3),
              material=u(w, h, wd, 2, lo=0), emission=u(w, h, wd, 3, lo=0,
                                                          hi=0.1),
              mask=rng.uniform(size=(w, h, wd)) > 0.2)
    kind = np.array([2, 0, 1], np.int32)
    pos, d = u(w, 3, 3, lo=-4, hi=4), u(w, 3, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    static = dict(color=u(3, 3, lo=0.2), intensity=u(3, lo=0.5, hi=2),
                  radius=u(3, lo=3, hi=8), cos_hotspot=u(3, lo=0.8, hi=0.9),
                  cos_falloff=u(3, lo=0.5, hi=0.7))
    enabled = np.array([[True, True, False], [True, True, True]])
    vis = u(w, h, wd, lo=0, hi=1)
    cam = u(w, 3, lo=-5, hi=5)
    ref = []
    for wi in range(w):
        lights = jlighting.LightSet(
            kind=kind, position=jnp.asarray(pos[wi]),
            direction=jnp.asarray(d[wi]), enabled=jnp.asarray(enabled[wi]),
            **{k: jnp.asarray(v) for k, v in static.items()})
        g = jraster.GBuffer(**{k: jnp.asarray(v[wi]) for k, v in gb.items()})
        ref.append(np.asarray(jlighting.shade(
            g, lights, jnp.asarray(cam[wi]), ambient=(0.05, 0.05, 0.05),
            shadow_fn=lambda li, p, wi=wi: (jnp.asarray(vis[wi]) if li == 0
                                            else None))))
    lights = lighting.LightSet(
        kind=kind, position=torch.as_tensor(pos),
        direction=torch.as_tensor(d), enabled=torch.as_tensor(enabled),
        **{k: torch.as_tensor(v) for k, v in static.items()})
    got = lighting.shade(
        GBuffer(**{k: torch.as_tensor(v) for k, v in gb.items()}), lights,
        torch.as_tensor(cam), ambient=(0.05, 0.05, 0.05),
        shadow_fn=lambda li, p: torch.as_tensor(vis) if li == 0 else None)
    # 2e-5 relative + 1e-6: the GGX chain (a normalisation, a quotient of
    # products, pow(., 5)) in another rounding order; colors are O(1)
    np.testing.assert_allclose(got.numpy(), np.stack(ref), rtol=2e-5,
                               atol=1e-6)


# -------------------------------------------------------------- whole frame


def test_render_frame_demand_matches_jax():
    """render_frame_demand on a small bench scene (8 objects, generic
    orientations, 2 worlds with jittered cameras, 32 x 32, 3-cascade CSM
    at 64 x 64): color, per-pass demand and caps against the JAX package's
    Pallas path. Budget 0 (no cull): the JAX audit unrolls the cascades
    and bins each at min(cap, T), the batched launch the port runs bins
    them together at the same cap, so the caps coincide."""
    jt = _bench_like(JSceneBuilder, jplane, jcube, jsphere, generic=True)
    st, tst = _jax_state(jt, 2)
    jrt = jbuild_rt(jt)
    common = dict(width=32, height=32, k_per_tile=424, csm_k_per_tile=896)
    jcolor, jdem, jcaps = jrender_demand(st, jt, jrt, JRenderConfig(
        use_pallas=True, pallas_interpret=True, bin_mode="cumsum",
        csm=JCsmConfig(map_size=64), **common))
    cfg = RenderConfig(csm=CsmConfig(map_size=64), **common)
    color, dem, caps = render_frame_demand(
        tst, convert.scene_template(jt), convert.render_template(jrt), cfg)
    assert caps == [int(k) for k in jcaps] and len(caps) == 4
    np.testing.assert_array_equal(dem.numpy(), np.asarray(jdem))
    assert (dem.numpy() > 0).all() and all(
        int(d) < k for d, k in zip(dem.numpy().max(0), caps))
    jcolor = np.asarray(jcolor)
    assert not np.array_equal(jcolor[0], jcolor[1])
    # colors are O(0.5): 99.9 % of the values within 1e-4 and every value
    # within 2e-3. The chain of products and sums above rounds in other
    # orders (and XLA fuses multiply-adds), which moves a pixel on a
    # triangle's edge a little more; a PCF sample whose depth compare
    # flipped would move a pixel by 1/9 of its light (~0.05), and none may
    err = np.abs(color.numpy() - jcolor)
    assert (err <= 1e-4).mean() >= 0.999 and err.max() <= 2e-3, err.max()
    # render_frame gives the audited frame
    again, gbuf = render_frame(tst, convert.scene_template(jt),
                               convert.render_template(jrt), cfg)
    assert torch.equal(again, color) and gbuf.mask.any()


def test_render_frame_with_bench_budgets_runs_two_passes():
    """The bench's per-cascade budgets through the whole frame: one camera
    pass and one batched cascade pass, at the caps the frame binned with."""
    tt = _bench_like(SceneBuilder, make_plane, make_cube, make_sphere)
    from fyrox_tpu_torch.scene import graph, init_state
    st = graph.update_hierarchical_data(init_state(tt, 2, device="cpu"), tt)
    rt = build_render_template(tt)
    foot = []
    color, dem, caps = render_frame_demand(
        st, tt, rt, RenderConfig(width=32, height=32, k_per_tile=424,
                                 csm_k_per_tile=896,
                                 cascade_tri_budget=(0.05, 1.0, 0.75),
                                 csm=CsmConfig(map_size=64)), footprint=foot)
    t = rt.num_triangles
    assert caps == [424, -(-t // 8) * 8, -(-t // 8) * 8, -(-t // 8) * 8]
    assert [b for _, b in foot] == [-(-int(t * 0.05) // 8) * 8,
                                    -(-int(t * 0.75) // 8) * 8]
    assert torch.isfinite(color).all() and color.shape == (2, 32, 32, 3)
    assert color.abs().sum() > 0


# ------------------------------------------------------------------- scope


@pytest.mark.parametrize("feature", [
    dict(occlusion=True), dict(spot_shadows=True), dict(point_shadows=True),
    dict(light_shafts=True), dict(skybox=object()),
    dict(sky_zenith=(0.1, 0.2, 0.3)), dict(raster_mode="clipped"),
    dict(edge_mode="mxu")])
def test_off_slice_config_raises(feature):
    tt = _bench_like(SceneBuilder, make_plane, make_cube, make_sphere,
                     n_obj=2)
    from fyrox_tpu_torch.scene import graph, init_state
    st = graph.update_hierarchical_data(init_state(tt, 1, device="cpu"), tt)
    with pytest.raises(NotImplementedError):
        render_frame(st, tt, build_render_template(tt),
                     RenderConfig(width=32, height=32, **feature))


@pytest.mark.parametrize("case", ["texture", "transparent", "sprite",
                                  "decal", "rectangle", "lod"])
def test_off_slice_scene_raises(case):
    if case in ("texture", "transparent"):
        sb = SceneBuilder()
        kw = ({"albedo_texture": np.ones((4, 4, 3), np.float32)}
              if case == "texture" else {"alpha": 0.5})
        sb.add_mesh(make_cube(1.0, **kw))
        with pytest.raises(NotImplementedError):
            build_render_template(sb.build())
        return
    sb = JSceneBuilder()
    sb.add_mesh(jcube(1.0))
    if case == "sprite":
        sb.add_sprite()
    elif case == "decal":
        sb.add_decal()
    elif case == "rectangle":
        sb.add_rectangle()
    else:
        sb.add_lod_group([(0.0, 1.0, [0])])
    jt = sb.build()
    with pytest.raises(NotImplementedError):
        convert.scene_template(jt)
        convert.render_template(jbuild_rt(jt))


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """visibility() on a non-CPU tensor launches the kernel or raises:
    here the kernel library is asked for, and its absence raises."""
    from fyrox_tpu_torch import kernels
    calls = []

    def no_library():
        calls.append(1)
        raise kernels.KernelBuildError("no nvcc here")

    monkeypatch.setattr(kernels, "library", no_library)
    feats = torch.zeros((1, 8, 16))
    ids = torch.zeros((1, 1, 8), dtype=torch.int32)
    count = torch.ones((1, 1), dtype=torch.int32)
    with pytest.raises(kernels.KernelBuildError):
        tile_raster._visibility_cuda(feats, ids, count, 8, 128, 8, 128)
    assert calls and tile_raster.launches("full") == 0
    with pytest.raises(ValueError):
        tile_raster.visibility(feats.to("meta"), ids.to("meta"),
                               count.to("meta"), 8, 128, 8, 128)
