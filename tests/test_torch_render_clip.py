"""Port parity of the clipped raster mode against the JAX package on the
CPU: raster.clip_near (Sutherland-Hodgman at w = 1e-4, 2T rows),
tile_raster.tri_features (the screen-affine rows), visibility_plain's
affine walk (the plain version of K5's affine variant) against
``_visibility_pallas(homogeneous=False, interpret=True)``,
``rasterize_tiled(mode="clipped")`` against ``rasterize_pallas(mode=
"clipped")``, and the clipped frame (its camera pass and occlusion prepass
on the affine variant).

Bars: the clip and the features at 1e-6 relative / 1e-4 absolute, as
test_torch_render.py's features (XLA fuses multiply-adds where PyTorch
rounds each product); visibility and rasters as the JAX package's own
raster tests hold them (z within 2e-5 where both cover, the winners equal
there, coverage equal on 99.9 % of pixels); the frame at
test_torch_render_features.py's whole-frame bar.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fyrox_tpu.render import pallas_raster as jpr
from fyrox_tpu.render import raster as jraster
from fyrox_tpu_torch.render import raster, tile_raster

from test_torch_render_features import feature_frame

torch.set_num_threads(2)


def crossing_tris(rng, t=96):
    """Random clip-space triangles, a third with one vertex and a sixth
    with two behind the near plane, with per-vertex attributes."""
    v = rng.uniform(-1, 1, (t, 1, 2)) + rng.uniform(-0.3, 0.3, (t, 3, 2))
    depth = rng.uniform(0.1, 0.9, (t, 1, 1))
    w = rng.uniform(0.6, 2.0, (t, 3, 1))
    w[::3, 0] = rng.uniform(-1.0, -0.1, (len(w[::3]), 1))
    w[1::6, 1] = rng.uniform(-1.0, -0.1, (len(w[1::6]), 1))
    w[1::6, 0] = rng.uniform(-1.0, -0.1, (len(w[1::6]), 1))
    clip = np.concatenate([v * w, np.broadcast_to(depth, (t, 3, 1)) * w, w],
                          -1).astype(np.float32)
    attrs = {k: rng.uniform(0, 1, (t, 3, c)).astype(np.float32)
             for k, c in [("albedo", 3), ("normal", 3), ("position", 3),
                          ("material", 2), ("emission", 3)]}
    return clip, attrs


def test_clip_near_matches_jax():
    rng = np.random.default_rng(0)
    clip, attrs = crossing_tris(rng)
    valid = rng.uniform(size=clip.shape[0]) < 0.9
    jv, ja, jok = jraster.clip_near(
        jnp.asarray(clip), {k: jnp.asarray(a) for k, a in attrs.items()},
        jnp.asarray(valid))
    tv, ta, tok = raster.clip_near(
        torch.as_tensor(clip)[None],
        {k: torch.as_tensor(a) for k, a in attrs.items()},
        torch.as_tensor(valid)[None])
    np.testing.assert_array_equal(tok[0].numpy(), np.asarray(jok))
    assert 0.2 < np.asarray(jok)[96:].mean() < 0.5     # one behind
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-4)
    for k in attrs:
        np.testing.assert_allclose(ta[k][0].numpy(), np.asarray(ja[k]),
                                   rtol=1e-6, atol=1e-4)
    # the cut vertices lie on w = 1e-4 up to the lerp's rounding (|dw| < 3)
    assert (tv[0, :, :, 3].numpy()[np.asarray(jok)] >= 1e-4 - 1e-6).all()


@pytest.mark.parametrize("cull", [True, False])
def test_tri_features_match_jax(cull):
    rng = np.random.default_rng(1)
    clip, _ = crossing_tris(rng)
    cv, _, cok = jraster.clip_near(jnp.asarray(clip), {},
                                   jnp.ones(clip.shape[0], bool))
    f1, b1, o1 = jpr._tri_features(cv, cok, 64, 128, backface_cull=cull)
    f2, b2, o2 = tile_raster.tri_features(torch.as_tensor(np.array(cv)),
                                          torch.as_tensor(np.array(cok)),
                                          64, 128, backface_cull=cull)
    np.testing.assert_array_equal(np.asarray(o1), o2.numpy())
    assert np.asarray(o1).sum() > 50
    f1, f2 = np.asarray(f1), f2.numpy()
    assert f2.shape == (192, 16) and not f2[:, 10:].any()
    ok = np.asarray(o1)
    np.testing.assert_allclose(f2[ok], f1[ok], rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(f2[:, 9], f1[:, 9])
    np.testing.assert_allclose(b2.numpy(), np.asarray(b1), rtol=1e-6,
                               atol=1e-4)


def _binned(seed, h, w, k, cull=True):
    """The JAX package's clipped feature rows and bins of crossing_tris."""
    clip, _ = crossing_tris(np.random.default_rng(seed), t=120)
    cv, _, cok = jraster.clip_near(jnp.asarray(clip), {},
                                   jnp.ones(clip.shape[0], bool))
    feats, bbox, ok = jpr._tri_features(cv, cok, h, w, backface_cull=cull)
    ids, _, count = jpr._bin_triangles(bbox, ok, h, w, 8, min(128, w), k,
                                       mode="cumsum")
    return feats, ids, count


@pytest.mark.parametrize("depth_only", [False, True])
def test_affine_visibility_matches_pallas(depth_only):
    """visibility_plain(affine=True) against the JAX kernel's screen-affine
    branch in interpret mode, on the same rows and bins."""
    h, w, k = 32, 128, 240
    feats, ids, count = _binned(2, h, w, k, cull=not depth_only)
    out = jpr._visibility_pallas(feats, ids, count, h, w, 8, 128, k,
                                 interpret=True, depth_only=depth_only,
                                 homogeneous=False)
    got = tile_raster.visibility_plain(
        torch.as_tensor(np.array(feats))[None],
        torch.as_tensor(np.array(ids)).reshape(1, -1, k),
        torch.as_tensor(np.array(count)).reshape(1, -1), h, w, 8, 128,
        depth_only=depth_only, affine=True)
    z1 = np.asarray(out if depth_only else out[0])
    z2 = (got if depth_only else got[0])[0].numpy()
    m1, m2 = z1 < 1e8, z2 < 1e8
    np.testing.assert_array_equal(m1, m2)
    assert m1.mean() > 0.3
    np.testing.assert_allclose(z1[m1], z2[m1], atol=2e-5)
    if not depth_only:
        idx1, idx2 = np.asarray(out[1]), got[1][0].numpy()
        np.testing.assert_array_equal(idx1[m1], idx2[m1])
        for a, b in ((out[2], got[2]), (out[3], got[3])):
            np.testing.assert_allclose(np.asarray(a)[m1], b[0].numpy()[m1],
                                       atol=1e-4)


@pytest.mark.parametrize("depth_only", [False, True])
def test_rasterize_tiled_clipped_matches_rasterize_pallas(depth_only):
    """The whole clipped pass: clip, features, bins, K5's affine plain
    version and the 1/w-corrected attribute pass, at 32 x 128."""
    h, w = 32, 128
    clip, attrs = crossing_tris(np.random.default_rng(3))
    tc = torch.as_tensor(clip)[None]
    if depth_only:
        z1 = np.asarray(jpr.rasterize_pallas(
            jnp.asarray(clip), {}, h, w, k_per_tile=200, interpret=True,
            depth_only=True, backface_cull=False, bin_mode="cumsum",
            mode="clipped"))
        z2 = tile_raster.rasterize_tiled(tc, {}, h, w, k_per_tile=200,
                                         depth_only=True, backface_cull=False,
                                         mode="clipped")[0].numpy()
        m1, m2 = z1 < 1e8, z2 < 1e8
    else:
        g1 = jpr.rasterize_pallas(
            jnp.asarray(clip), {n: jnp.asarray(v) for n, v in attrs.items()},
            h, w, k_per_tile=200, interpret=True, bin_mode="cumsum",
            mode="clipped")
        demand = []
        g2 = tile_raster.rasterize_tiled(
            tc, {n: torch.as_tensor(v) for n, v in attrs.items()}, h, w,
            k_per_tile=200, mode="clipped", demand=demand)
        assert demand[0][1] == 192       # min(200, 2T) in chunks of 8
        m1, m2 = np.asarray(g1.mask), g2.mask[0].numpy()
        z1, z2 = np.asarray(g1.depth), g2.depth[0].numpy()
    np.testing.assert_array_equal(m1, m2)
    assert m1.mean() > 0.2
    np.testing.assert_allclose(z1[m1], z2[m1], atol=2e-5)
    if not depth_only:
        for name in ("albedo", "material"):
            np.testing.assert_allclose(np.asarray(getattr(g1, name))[m1],
                                       getattr(g2, name)[0].numpy()[m1],
                                       atol=1e-4)


def test_clipped_frame_matches_jax():
    """raster_mode="clipped" alone over the bench scene (the camera pass
    on K5's affine variant; the 40 m ground reaches behind the camera, so
    the clip cuts it): colour, demand and caps as the homogeneous
    features' frames. The clipped depth-only pass (the occlusion
    prepass's) is held above, test_rasterize_tiled_clipped_matches_
    rasterize_pallas[True]."""
    color, dem, caps, tt, rt = feature_frame("clipped")
    # the camera pass bins the 2T clipped rows
    assert caps == [-(-2 * rt.num_triangles // 8) * 8]


def test_clipped_mode_runs_the_affine_variant(monkeypatch):
    """The clipped frame's K5 calls: the prepass and the camera pass ask
    for the affine variant, the cascades for the 2DH one; an unknown mode
    raises."""
    calls = []
    dispatch = tile_raster.visibility

    def spy(*args, **kw):
        calls.append((kw.get("depth_only", False), kw.get("affine", False)))
        return dispatch(*args, **kw)

    monkeypatch.setattr(tile_raster, "visibility", spy)
    clip, attrs = crossing_tris(np.random.default_rng(4), t=16)
    tc = torch.as_tensor(clip)[None]
    tile_raster.rasterize_tiled(tc, {}, 8, 128, depth_only=True,
                                mode="clipped")
    tile_raster.rasterize_tiled(
        tc, {n: torch.as_tensor(v) for n, v in attrs.items()}, 8, 128,
        mode="clipped")
    tile_raster.rasterize_tiled(tc, {}, 8, 128, depth_only=True)
    assert calls == [(True, True), (False, True), (True, False)]
    with pytest.raises(ValueError):
        tile_raster.rasterize_tiled(tc, {}, 8, 128, mode="wireframe")
