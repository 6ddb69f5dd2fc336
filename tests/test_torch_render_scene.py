"""Port parity of render_frame's scene payloads against the JAX package on
the CPU: sprites, LOD groups and rectangles each alone, sprite-only scenes,
render_frames_chunked, and the builders, templates and conversions of the
features scene field for field. The helpers, bars and inputs are
test_torch_render_features.py's."""
import numpy as np
import pytest
import torch

import chip_smoke
from fyrox_tpu import render as jrender
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.render import (CsmConfig, RenderConfig,
                                    build_render_template, render_frame,
                                    render_frames_chunked)
from fyrox_tpu_torch.scene import graph, init_state

from test_torch_render_features import JLIB, TLIB, feature_frame


@pytest.mark.parametrize("feature", ["sprites", "lod", "rectangles"])
def test_feature_frame_matches_jax(feature):
    color, dem, caps, tt, rt = feature_frame(feature)
    if feature == "sprites":
        assert rt.sprite_node.shape == (4,)
    if feature == "lod":
        # the seeded jitter puts world 0's camera past the threshold (the
        # far sphere) and world 1's inside it (the near cube)
        assert rt.lod_obj.shape == (2,)
    if feature == "rectangles":
        assert rt.tex_array.shape[0] == 1 and (rt.tri_tex >= 0).sum() == 4


def test_render_frames_chunked_equals_render_frame():
    """render_frames_chunked over groups of 2 of 4 worlds gives
    render_frame's colour and G-buffer, bit for bit (the textured
    G-buffer's uvt included); a batch that does not divide raises."""
    t = chip_smoke.features_scene(TLIB, chip_smoke.FEATURES_FRAME, n_obj=8,
                                  tex_size=32, n_sprites=4)
    st = graph.update_hierarchical_data(init_state(t, 4, device="cpu"), t)
    pos = st.position.clone()
    pos[:, :, 0] += torch.arange(4.0)[:, None] * 0.1
    st = graph.update_hierarchical_data(st._replace(position=pos), t)
    rt = build_render_template(t)
    cfg = RenderConfig(csm=CsmConfig(map_size=32), **dict(
        chip_smoke.features_config(TLIB, size=32), spot_shadow_size=32,
        point_shadow_size=16, occlusion_size=16))
    color, gbuf = render_frame(st, t, rt, cfg)
    c2, g2 = render_frames_chunked(st, t, rt, cfg, world_chunk=2)
    assert torch.equal(color, c2) and gbuf.uvt is not None
    for a, b in zip(gbuf, g2):
        assert torch.equal(a, b)
    assert not torch.equal(color[0], color[1])
    with pytest.raises(ValueError):
        render_frames_chunked(st, t, rt, cfg, world_chunk=3)


def test_features_builders_templates_and_convert_match_jax():
    """The features scene at full width from each package's builders: the
    scene templates (sprites, decals, rectangles, LOD groups) and
    build_render_template's every field equal; convert carries the JAX
    templates (textures, materials, skyboxes) into the port's equal to
    the port's own, and a texture two meshes share stays one layer."""
    jt = chip_smoke.features_scene(JLIB)
    tt = chip_smoke.features_scene(TLIB)
    for f in ("parent", "node_type", "payload", "init_position",
              "init_rotation", "init_scale", "local_bbox_min",
              "local_bbox_max"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), f)
    for kind in ("sprites", "decals", "rectangles", "lights", "cameras"):
        a, b = getattr(jt, kind), getattr(tt, kind)
        assert set(a) == set(b) and len(a["node"]), kind
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k], kind + k)
    assert jt.extras["lod_groups"] == tt.extras["lod_groups"]
    jrt, trt = jrender.build_render_template(jt), build_render_template(tt)
    conv = convert.render_template(jrt)
    from_conv = build_render_template(convert.scene_template(jt))
    assert trt.tex_array.shape == (2, 256, 256, 4)
    for f in trt.__dataclass_fields__:
        want = getattr(jrt, f)
        for got in (getattr(trt, f), getattr(conv, f),
                    getattr(from_conv, f)):
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(np.asarray(want), got, f)
            else:
                assert want == got, f
    ct = convert.scene_template(jt)
    mats = [m.material for m in ct.meshes if m.material is not None]
    assert len(mats) == 4 and all(m is mats[0] for m in mats)
    assert (mats[0].textures["diffuseTexture"] is ct.meshes[0].albedo_texture
            is ct.rect_textures[0])
    sky = convert.skybox(JLIB.SkyBox(JLIB.gradient_faces((0, 0, 1),
                                                         (1, 1, 1), 4)))
    np.testing.assert_array_equal(sky.faces, TLIB.gradient_faces(
        (0, 0, 1), (1, 1, 1), 4))


def test_sprite_only_scene_template_matches_jax():
    """A scene of sprites and no mesh packs an empty mesh and renders its
    billboards (pipeline.py:229-245)."""
    jsb, tsb = JLIB.SceneBuilder(), TLIB.SceneBuilder()
    for sb in (jsb, tsb):
        for i in range(3):
            sb.add_sprite(position=(i - 1.0, 1.0, 0.0), size=0.4,
                          color=(1.0, 0.5 * i, 0.2))
        sb.add_camera("cam", position=(0.0, 1.0, -4.0))
    jrt = jrender.build_render_template(jsb.build())
    t = tsb.build()
    trt = build_render_template(t)
    for f in trt.__dataclass_fields__:
        want, got = getattr(jrt, f), getattr(trt, f)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(want, got, f)
        else:
            assert want == got, f
    st = graph.update_hierarchical_data(init_state(t, 1, device="cpu"), t)
    color, gbuf = render_frame(st, t, trt, RenderConfig(width=32, height=32))
    assert trt.num_triangles == 0 and gbuf.mask.sum() > 20


def test_frames_after_the_first_copy_nothing_from_the_host(monkeypatch):
    """The host tables (texture array, big-occluder mask from
    np.quantile, LOD, transparent and light tables) and every small
    constant of a frame are made on its first frame and cached: a later
    frame of either raster mode, with the sky gradient, adds no entry to
    the constant cache and calls neither torch.tensor, torch.as_tensor
    nor np.quantile, as a captured frame must copy nothing from the
    host."""
    from fyrox_tpu_torch import _util
    t = chip_smoke.features_scene(TLIB, chip_smoke.FEATURES_FRAME, n_obj=4,
                                  tex_size=16, n_sprites=2)
    st = graph.update_hierarchical_data(init_state(t, 2, device="cpu"), t)
    rt = build_render_template(t)
    kw = dict(chip_smoke.features_config(TLIB, size=32),
              sky_zenith=(0.1, 0.2, 0.5), sky_horizon=(0.7, 0.7, 0.7),
              spot_shadow_size=32, point_shadow_size=16, occlusion_size=16)
    cfgs = [RenderConfig(csm=CsmConfig(map_size=32), raster_mode=m, **kw)
            for m in ("homogeneous", "clipped")]
    for cfg in cfgs:
        render_frame(st, t, rt, cfg)
    cfgs.append(cfgs[0]._replace(skybox=None))
    render_frame(st, t, rt, cfgs[-1])
    n = len(_util._CONST_CACHE)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(torch, "tensor", spy("tensor", torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", spy("as_tensor",
                                                torch.as_tensor))
    monkeypatch.setattr(np, "quantile", spy("quantile", np.quantile))
    for cfg in cfgs:
        render_frame(st, t, rt, cfg)
    assert len(_util._CONST_CACHE) == n and not calls, calls
