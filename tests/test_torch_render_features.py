"""Port parity: the features of render_frame beyond the bench frame
(fyrox_tpu_torch/render) against the JAX package on the CPU: the frames
with textures, HZB occlusion, the transparent pass or decals, and the
modules of every feature (textures, spot / point maps, occlusion, the
skybox, light shafts, the transparent pass).

The JAX side runs as its own tests run it, ``RenderConfig(use_pallas=True,
pallas_interpret=True, bin_mode="cumsum")``; the port takes its plain
versions (CPU tensors). Scenes are ``chip_smoke.features_scene`` built
with each package's builders (the JAX template carried into the port by
``convert``), at 2 worlds whose cameras are jittered from a seed, 32 x 32,
in the scene's `generic` form: every triangle's back-face test is decided
with margin, so the integer demand and caps are held equal. The cascades
take no budget (0.0): the JAX audit bins budgeted cascades one by one, the
port's batched launch at one cap. Whole frames: 99.9 % of the colour
values within 1e-4 and every value within 2e-3 (XLA fuses multiply-adds
where PyTorch rounds each product; a PCF sample whose compare flipped
would move a pixel by ~0.05). The modules: 1e-5, 1e-6 for the light
matrices, equal for the integer and boolean results.

test_torch_render_lights.py, test_torch_render_scene.py and
test_torch_render_clip.py take the helpers of this file and hold the other
features' frames.
"""
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from fyrox_tpu import render as jrender
from fyrox_tpu.render import lighting as jlighting
from fyrox_tpu.render import occlusion as jocc
from fyrox_tpu.render import shadows as jshadows
from fyrox_tpu.render import skybox as jsky
from fyrox_tpu.render import texture as jtex
from fyrox_tpu.render import transparent as jtransp
from fyrox_tpu.render import volumetric as jvol
from fyrox_tpu.render.shadows import CsmConfig as JCsmConfig
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu.scene import graph as jgraph
from fyrox_tpu.scene import init_state as jinit
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.render import (CsmConfig, RenderConfig, lighting,
                                    occlusion, render_frame_demand, shadows,
                                    skybox, texture, transparent, volumetric)

torch.set_num_threads(2)

JLIB = types.SimpleNamespace(
    SceneBuilder=JSceneBuilder, make_plane=jrender.make_plane,
    make_cube=jrender.make_cube, make_sphere=jrender.make_sphere,
    Texture=jtex.Texture, Material=jtex.Material, SkyBox=jsky.SkyBox,
    gradient_faces=jsky.gradient_faces)
TLIB = chip_smoke.render_lib()
# small sizes of the features frame's maps
SMALL = dict(spot_shadow_size=64, point_shadow_size=32, occlusion_size=32,
             cascade_tri_budget=0.0)


def scene(features, n_obj=8, n_worlds=2, seed=1):
    """(JAX template, JAX state, port template, port state) of the generic
    features scene with `features`: n_worlds worlds whose cameras are
    jittered by ±0.5 m from `seed`."""
    jt = chip_smoke.features_scene(JLIB, frozenset(features), n_obj=n_obj,
                                   tex_size=32, n_sprites=4, generic=True)
    st = jinit(jt, n_worlds)
    cam = int(jt.cameras["node"][0])
    pos = np.array(st.position)
    pos[:, cam] += np.random.default_rng(seed).uniform(
        -0.5, 0.5, (n_worlds, 3)).astype(np.float32)
    st = jgraph.update_hierarchical_data(st._replace(
        position=jnp.asarray(pos)), jt)
    tst = convert.scene_state(jax.tree_util.tree_map(np.asarray, st),
                              device="cpu")
    return jt, st, convert.scene_template(jt), tst


def configs(features, size=32, **extra):
    """The JAX and the port's RenderConfig of `features` (SMALL maps)."""
    jkw = chip_smoke.features_config(JLIB, frozenset(features), size)
    tkw = chip_smoke.features_config(TLIB, frozenset(features), size)
    jkw.update(SMALL, **extra)
    tkw.update(SMALL, **extra)
    return (jrender.RenderConfig(use_pallas=True, pallas_interpret=True,
                                 bin_mode="cumsum",
                                 csm=JCsmConfig(map_size=32), **jkw),
            RenderConfig(csm=CsmConfig(map_size=32), **tkw))


def assert_frame_close(color, jcolor):
    """The whole-frame bar: 99.9 % of the values within 1e-4, every value
    within 2e-3."""
    err = np.abs(np.asarray(color) - np.asarray(jcolor))
    assert (err <= 1e-4).mean() >= 0.999 and err.max() <= 2e-3, (
        err.max(), (err <= 1e-4).mean())


def frame_matches_jax(features, **extra):
    """render_frame_demand of the features scene in both packages: colour
    at the whole-frame bar, demand and caps equal, no pass at its cap,
    the worlds different. Returns the port's (color, demand, caps) and
    the templates."""
    jt, st, tt, tst = scene(features)
    jcfg, cfg = configs(features, **extra)
    jrt = jrender.build_render_template(jt)
    jcolor, jdem, jcaps = jrender.render_frame_demand(st, jt, jrt, jcfg)
    rt = convert.render_template(jrt)
    color, dem, caps = render_frame_demand(tst, tt, rt, cfg)
    jcolor = np.asarray(jcolor)
    assert caps == [int(k) for k in jcaps]
    np.testing.assert_array_equal(dem.numpy(), np.asarray(jdem))
    assert all(int(d) < k for d, k in zip(dem.numpy().max(0), caps))
    assert not np.array_equal(jcolor[0], jcolor[1])
    assert np.isfinite(jcolor).all() and color.shape == jcolor.shape
    assert_frame_close(color.numpy(), jcolor)
    return color, dem, caps, tt, rt


# ------------------------------------------------- each feature's frame


# passes of the audit beyond the camera pass
_EXTRA_PASSES = {"occlusion": 1, "spot": 4, "point": 9}


def feature_frame(feature):
    """One feature of render_frame alone over the bench scene: the spot
    and point maps beside the directional light's CSM (shadows on), every
    other feature with shadows off (the CSM's own frame is
    test_torch_render.py's; all features together are
    test_torch_render_scene.py's)."""
    shadows_on = feature in ("spot", "point")
    out = frame_matches_jax([feature], shadows=shadows_on)
    assert len(out[2]) == 1 + _EXTRA_PASSES.get(feature, 0)
    return out


@pytest.mark.parametrize("feature", ["textures", "occlusion", "transparent",
                                     "decals"])
def test_feature_frame_matches_jax(feature):
    color, dem, caps, tt, rt = feature_frame(feature)
    if feature == "textures":
        assert rt.tex_array.shape == (2, 32, 32, 4)
        assert (rt.tri_tex >= 0).sum() == 2 + 4 * 12
    if feature == "transparent":
        assert rt.tr_tri.shape == (8,) and np.allclose(rt.tr_alpha, 0.4)
    if feature == "decals":
        assert rt.decal_node.shape == (2,)


# --------------------------------------------------------------- textures


def test_texture_sampling_matches_jax():
    """sample_bilinear / sample_array_bilinear (wrapping uvs), at 1e-5."""
    rng = np.random.default_rng(0)
    tex = rng.uniform(0, 1, (8, 8, 4)).astype(np.float32)
    arr = rng.uniform(0, 1, (3, 8, 8, 4)).astype(np.float32)
    uv = rng.uniform(-1.0, 2.0, (2, 5, 7, 2)).astype(np.float32)
    tid = rng.integers(0, 3, (2, 5, 7)).astype(np.int32)
    np.testing.assert_allclose(
        texture.sample_bilinear(torch.as_tensor(tex),
                                torch.as_tensor(uv)).numpy(),
        np.asarray(jtex.sample_bilinear(jnp.asarray(tex), jnp.asarray(uv))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        texture.sample_array_bilinear(torch.as_tensor(arr),
                                      torch.as_tensor(tid),
                                      torch.as_tensor(uv)).numpy(),
        np.asarray(jtex.sample_array_bilinear(jnp.asarray(arr),
                                              jnp.asarray(tid),
                                              jnp.asarray(uv))),
        rtol=1e-5, atol=1e-5)


def test_texture_host_side_matches_jax(tmp_path):
    """resize_bilinear, Texture.from_array's mips, Material bindings and
    load_texture's PPM decoder: numpy, equal. A file that is not PPM goes
    to PIL (absent here or not, never silently)."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (12, 20, 3)).astype(np.float32)
    np.testing.assert_array_equal(texture.resize_bilinear(img, 16),
                                  jtex.resize_bilinear(img, 16))
    t, jt_ = texture.Texture.from_array(img), jtex.Texture.from_array(img)
    assert len(t.mips) == len(jt_.mips) and t.size == jt_.size
    for a, b in zip(t.mips, jt_.mips):
        np.testing.assert_array_equal(a, b)
    m = texture.Material().bind("diffuseTexture", t).set_property("k", 2.0)
    assert m.textures["diffuseTexture"] is t and m.properties == {"k": 2.0}
    path = tmp_path / "t.ppm"
    data = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    path.write_bytes(b"P6\n7 5\n255\n" + data.tobytes())
    got, want = texture.load_texture(str(path)), jtex.load_texture(str(path))
    np.testing.assert_array_equal(got.base, want.base)
    assert got.base.shape == (5, 7, 4)
    bad = tmp_path / "t.xyz"
    bad.write_bytes(b"not an image")
    with pytest.raises(Exception):
        texture.load_texture(str(bad))


# ----------------------------------------------------- spot / point maps


def _light_poses(rng, w=2):
    pos = rng.uniform(-3, 3, (w, 3)).astype(np.float32)
    d = rng.standard_normal((w, 3)).astype(np.float32)
    d[0] = (0.0, -1.0, 0.0)             # straight down: the x-axis up
    return pos, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_spot_and_point_vps_match_jax():
    """spot_vp and point_vps (+ _look_at, _perspective_from), batched over
    worlds, against the JAX package's per-light calls at 1e-6 (relative
    to each matrix's largest entry)."""
    rng = np.random.default_rng(2)
    pos, d = _light_poses(rng)
    cf = np.float32(np.cos(0.6))
    got = shadows.spot_vp(torch.as_tensor(pos), torch.as_tensor(d),
                          torch.tensor(cf), z_far=20.0).numpy()
    want = np.stack([np.asarray(jshadows.spot_vp(
        jnp.asarray(pos[w]), jnp.asarray(d[w]), jnp.asarray(cf),
        z_far=20.0)) for w in range(2)])
    scale = np.abs(want).max((-1, -2), keepdims=True)
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    got = shadows.point_vps(torch.as_tensor(pos), z_far=15.0).numpy()
    want = np.stack([np.asarray(jshadows.point_vps(jnp.asarray(pos[w]),
                                                   z_far=15.0))
                     for w in range(2)])
    assert got.shape == (2, 6, 4, 4)
    scale = np.abs(want).max((-1, -2), keepdims=True)
    assert (np.abs(got - want) <= 1e-6 * scale).all()


def test_map_and_point_visibility_match_jax():
    """map_visibility (3 x 3 PCF) and point_visibility on the same maps
    and light matrices, at 1e-5."""
    rng = np.random.default_rng(3)
    pos, d = _light_poses(rng)
    svp = np.stack([np.asarray(jshadows.spot_vp(
        jnp.asarray(pos[w]), jnp.asarray(d[w]), jnp.float32(0.7),
        z_far=20.0)) for w in range(2)])
    pvp = np.stack([np.asarray(jshadows.point_vps(jnp.asarray(pos[w]),
                                                  z_far=15.0))
                    for w in range(2)])
    smap = rng.uniform(0.9, 1.0, (2, 16, 16)).astype(np.float32)
    pmap = rng.uniform(0.9, 1.0, (2, 6, 16, 16)).astype(np.float32)
    wp = (pos[:, None, None] + rng.uniform(-6, 6, (2, 9, 11, 3))).astype(
        np.float32)
    got = shadows.map_visibility(torch.as_tensor(wp), torch.as_tensor(svp),
                                 torch.as_tensor(smap)).numpy()
    want = np.stack([np.asarray(jshadows.map_visibility(
        jnp.asarray(wp[w]), jnp.asarray(svp[w]), jnp.asarray(smap[w])))
        for w in range(2)])
    assert 0 < (want < 1).mean() < 1
    np.testing.assert_allclose(got, want, atol=1e-5)
    got = shadows.point_visibility(
        torch.as_tensor(wp), torch.as_tensor(pos), torch.as_tensor(pvp),
        torch.as_tensor(pmap)).numpy()
    want = np.stack([np.asarray(jshadows.point_visibility(
        jnp.asarray(wp[w]), jnp.asarray(pos[w]), jnp.asarray(pvp[w]),
        jnp.asarray(pmap[w]))) for w in range(2)])
    assert 0 < (want < 1).mean() < 1
    np.testing.assert_allclose(got, want, atol=1e-5)


# -------------------------------------------------------------- occlusion


def test_hzb_and_occlusion_visible_match_jax():
    """build_hzb and occlusion_visible on a prepass with a near wall over
    half the view and boxes in front of it, behind it and crossing the
    near plane: equal."""
    rng = np.random.default_rng(4)
    depth = np.full((2, 32, 32), 1e9, np.float32)
    depth[:, :, :16] = rng.uniform(0.3, 0.5, (2, 32, 16))
    lo = rng.uniform(-4, 4, (2, 40, 3)).astype(np.float32)
    lo[..., 2] = rng.uniform(-30, 3, (2, 40))
    hi = lo + rng.uniform(0.1, 2.0, (2, 40, 3)).astype(np.float32)
    from fyrox_tpu.scene import camera as jcam
    proj = np.asarray(jcam.perspective(1.2, 1.0, 0.1, 50.0))
    vp = np.stack([proj, proj @ np.diag([1.0, 1.0, 1.0, 1.0]).astype(
        np.float32)])
    vp[1, 0, 3] = 0.3
    got = occlusion.build_hzb(torch.as_tensor(depth))
    want = [jocc.build_hzb(jnp.asarray(depth[w])) for w in range(2)]
    assert len(got) == len(want[0]) == 6
    for lvl, g in enumerate(got):
        np.testing.assert_array_equal(
            g.numpy(), np.stack([np.asarray(p[lvl]) for p in want]))
    vis = occlusion.occlusion_visible(torch.as_tensor(lo), torch.as_tensor(hi),
                                      torch.as_tensor(vp), got, 32, 32).numpy()
    jvis = np.stack([np.asarray(jocc.occlusion_visible(
        jnp.asarray(lo[w]), jnp.asarray(hi[w]), jnp.asarray(vp[w]), want[w],
        32, 32)) for w in range(2)])
    np.testing.assert_array_equal(vis, jvis)
    assert 0 < jvis.mean() < 1


# ---------------------------------------------- skybox and light shafts


def _cameras(rng, w=2):
    q = rng.standard_normal((w, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    from fyrox_tpu.core import quat as jquat
    g = np.zeros((w, 4, 4), np.float32)
    g[:, :3, :3] = np.asarray(jquat.to_mat3(jnp.asarray(q, jnp.float32)))
    g[:, :3, 3] = rng.uniform(-5, 5, (w, 3))
    g[:, 3, 3] = 1.0
    return g


def test_skybox_matches_jax():
    """gradient_faces (numpy, equal) and apply_skybox on random cameras
    and coverage, at 1e-5."""
    rng = np.random.default_rng(5)
    faces = skybox.gradient_faces((0.1, 0.2, 0.6), (0.8, 0.7, 0.6), size=8)
    np.testing.assert_array_equal(faces, np.asarray(jsky.gradient_faces(
        (0.1, 0.2, 0.6), (0.8, 0.7, 0.6), size=8)))
    faces = rng.uniform(0, 1, (6, 8, 8, 3)).astype(np.float32)
    cam = _cameras(rng)
    color = rng.uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 12, 16)) < 0.3
    got = skybox.apply_skybox(torch.as_tensor(color), torch.as_tensor(mask),
                              skybox.SkyBox(faces), torch.as_tensor(cam),
                              1.2, 16 / 12).numpy()
    want = np.stack([np.asarray(jsky.apply_skybox(
        jnp.asarray(color[w]), jnp.asarray(mask[w]), jsky.SkyBox(faces),
        jnp.asarray(cam[w]), 1.2, 16 / 12)) for w in range(2)])
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert len(np.unique(want[~mask].reshape(-1, 3), axis=0)) > 20


def test_light_shafts_match_jax():
    """light_shafts for a light in front of the camera and one behind it,
    at 1e-5."""
    rng = np.random.default_rng(6)
    color = rng.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 16, 24)) < 0.5
    lclip = np.array([[0.2, -0.3, 0.5, 2.0], [0.1, 0.1, 0.5, -1.0]],
                     np.float32)
    lcol = np.array([1.0, 0.8, 0.5], np.float32)
    got = volumetric.light_shafts(
        torch.as_tensor(color), torch.as_tensor(mask),
        torch.as_tensor(lclip), torch.as_tensor(lcol)).numpy()
    want = np.stack([np.asarray(jvol.light_shafts(
        jnp.asarray(color[w]), jnp.asarray(mask[w]), jnp.asarray(lclip[w]),
        jnp.asarray(lcol))) for w in range(2)])
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (want[0] > color[0]).any() and np.array_equal(want[1], color[1])


# ------------------------------------------------------ transparent pass


def test_composite_transparent_matches_jax():
    """Weighted blended OIT of 11 random triangles (more than one chunk,
    one behind the eye, some behind the opaque depth) lit by the three
    light kinds, at 1e-5."""
    rng = np.random.default_rng(7)
    w, h, wd, t = 2, 12, 16, 11
    v = rng.uniform(-1, 1, (w, t, 1, 2)) + rng.uniform(-0.6, 0.6,
                                                         (w, t, 3, 2))
    depth = rng.uniform(-0.5, 0.9, (w, t, 1, 1))
    wc = rng.uniform(0.5, 2.0, (w, t, 3, 1))
    wc[:, 3, 0] = -0.5
    clip = np.concatenate([v * wc, np.broadcast_to(depth, (w, t, 3, 1)) * wc,
                           wc], -1).astype(np.float32)
    attrs = {k: rng.uniform(-1, 1, (w, t, 3, 3)).astype(np.float32)
             for k in ("albedo", "normal", "position")}
    attrs["albedo"] = np.abs(attrs["albedo"])
    alpha = rng.uniform(0.2, 0.8, t).astype(np.float32)
    valid = rng.uniform(size=(w, t)) < 0.9
    opaque = rng.uniform(0, 1, (w, h, wd, 3)).astype(np.float32)
    odepth = rng.uniform(-0.2, 1.0, (w, h, wd)).astype(np.float32)
    omask = rng.uniform(size=(w, h, wd)) < 0.6
    kind = np.array([2, 0, 1], np.int32)
    lpos = rng.uniform(-2, 2, (w, 3, 3)).astype(np.float32)
    ldir = rng.standard_normal((w, 3, 3)).astype(np.float32)
    ldir /= np.linalg.norm(ldir, axis=-1, keepdims=True)
    static = dict(color=rng.uniform(0.3, 1, (3, 3)).astype(np.float32),
                  intensity=np.array([1.0, 2.0, 3.0], np.float32),
                  radius=np.array([5.0, 6.0, 8.0], np.float32),
                  cos_hotspot=np.array([0.9, 0.9, 0.9], np.float32),
                  cos_falloff=np.array([0.6, 0.6, 0.6], np.float32))
    enabled = np.array([[True, True, True], [True, False, True]])
    cam = rng.uniform(-3, 3, (w, 3)).astype(np.float32)
    want = []
    for wi in range(w):
        lights = jlighting.LightSet(
            kind=kind, position=jnp.asarray(lpos[wi]),
            direction=jnp.asarray(ldir[wi]),
            enabled=jnp.asarray(enabled[wi]),
            **{k: jnp.asarray(v) for k, v in static.items()})
        want.append(np.asarray(jtransp.composite_transparent(
            jnp.asarray(opaque[wi]), jnp.asarray(odepth[wi]),
            jnp.asarray(omask[wi]), jnp.asarray(clip[wi]),
            {k: jnp.asarray(a[wi]) for k, a in attrs.items()},
            jnp.asarray(alpha), h, wd, lights=lights,
            cam_pos=jnp.asarray(cam[wi]), ambient=(0.05, 0.05, 0.05),
            tri_valid=jnp.asarray(valid[wi]))))
    lights = lighting.LightSet(
        kind=kind, position=torch.as_tensor(lpos),
        direction=torch.as_tensor(ldir), enabled=torch.as_tensor(enabled),
        **{k: torch.as_tensor(v) for k, v in static.items()})
    got = transparent.composite_transparent(
        torch.as_tensor(opaque), torch.as_tensor(odepth),
        torch.as_tensor(omask), torch.as_tensor(clip),
        {k: torch.as_tensor(a) for k, a in attrs.items()},
        torch.as_tensor(alpha), h, wd, lights=lights,
        cam_pos=torch.as_tensor(cam), ambient=(0.05, 0.05, 0.05),
        tri_valid=torch.as_tensor(valid)).numpy()
    want = np.stack(want)
    assert np.abs(want - opaque).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-5)
