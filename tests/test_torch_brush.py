"""Port parity: terrain brush strokes and chunked terrain of
fyrox_tpu_torch against fyrox_tpu's on the CPU.

apply_stroke in every mode with a circle and with a transformed
rectangle, stroke_opacity's falloff and add_chunked_terrain's meshes and
LOD groups go through both packages on the same seeded inputs; the brush
is held to 1e-6 (float32 in the same order of operations), the builder's
host arrays equal.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fyrox_tpu import render as jrender
from fyrox_tpu.scene import SceneBuilder as JSceneBuilder
from fyrox_tpu.scene import brush as jbrush
from fyrox_tpu.scene import terrain as jterrain
from fyrox_tpu_torch import render
from fyrox_tpu_torch.scene import SceneBuilder, graph, init_state
from fyrox_tpu_torch.scene import brush as tbrush
from fyrox_tpu_torch.scene import terrain as tterrain

torch.set_num_threads(2)

SHAPES = {
    "circle": dict(shape="circle", radius=5.5),
    "rect": dict(shape="rect", width=9.0, length=3.0,
                 transform=((0.8, -0.6), (0.6, 0.8))),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mode", ["raise", "assign", "flatten", "smooth"])
def test_apply_stroke_matches_jax(mode, shape):
    """A three-stamp stroke over a 40 x 48 random height map (cell 0.5,
    origin offset), soft edge and alpha 0.7: the result within 1e-6 of
    the JAX package's, and the stroke changed the map."""
    rng = np.random.default_rng(3)
    h = rng.normal(0, 1, (40, 48)).astype(np.float32)
    kw = dict(SHAPES[shape], mode=mode, amount=1.5, value=-2.0,
              kernel_radius=2, hardness=0.3, alpha=0.7)
    pts = [(6.0, 8.0), (9.5, 9.0), (13.0, 12.5)]
    args = dict(cell_size=0.5, origin=(-2.0, 1.0))
    want = np.asarray(jbrush.apply_stroke(jnp.asarray(h),
                                          jbrush.Brush(**kw), pts, **args))
    got = tbrush.apply_stroke(torch.tensor(h), tbrush.Brush(**kw), pts,
                              **args)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.abs(want - h).max() > 0.1


def test_stroke_opacity_matches_jax():
    """stroke_opacity of a hard and a soft circle and of a rotated
    rectangle: within 1e-6, with texels at 0, in between and at 1."""
    pts = [(16.0, 16.0), (18.0, 15.0)]
    for kw in (dict(radius=8.0, hardness=0.0),
               dict(radius=4.0, hardness=1.0, alpha=0.5),
               dict(SHAPES["rect"], hardness=0.5)):
        want = np.asarray(jbrush.stroke_opacity((32, 32), jbrush.Brush(**kw),
                                                pts))
        got = tbrush.stroke_opacity((32, 32), tbrush.Brush(**kw), pts,
                                    device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert (want == 0).any() and (want > 0).any()


def _chunked(lib_sb, lib_terrain):
    rng = np.random.default_rng(1)
    hts = rng.normal(0, 0.3, (17, 25)).astype(np.float32)
    sb = lib_sb()
    terr = lib_terrain.Terrain(hts, size_x=48.0, size_z=32.0,
                               origin=(-24.0, 0.0, -16.0))
    pairs = lib_terrain.add_chunked_terrain(sb, terr, chunks=(3, 2),
                                            lod_split=0.2, decimate=4)
    sb.add_light("directional", rotation=(0.5, 0.0, 0.0, 0.866))
    sb.add_camera("cam", position=(0.0, 6.0, -20.0),
                  rotation=(0.2, 0.0, 0.0, 0.98), z_near=0.1, z_far=100.0)
    return pairs, sb.build()


def test_chunked_terrain_matches_jax():
    """add_chunked_terrain on a 17 x 25 map in 3 x 2 chunks: the same node
    pairs, meshes (positions, normals, uvs, triangles) and LOD groups as
    the JAX package's; each chunk's hi mesh is finer than its lo one; the
    chunks' meshes cover the whole rectangle; the render templates' LOD
    tables equal; the port renders a frame of it."""
    tp, tt = _chunked(SceneBuilder, tterrain)
    jp, jt = _chunked(JSceneBuilder, jterrain)
    assert tp == jp and len(tp) == 6
    assert tt.extras["lod_groups"] == jt.extras["lod_groups"]
    assert len(tt.meshes) == len(jt.meshes) == 12
    for tm, jm in zip(tt.meshes, jt.meshes):
        for f in ("positions", "normals", "uvs", "triangles"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                          err_msg=f)
    for hi, lo in tp:
        assert (tt.meshes[tt.payload[hi]].positions.shape[0]
                > tt.meshes[tt.payload[lo]].positions.shape[0])
    pos = np.concatenate([tt.meshes[tt.payload[h]].positions for h, _ in tp])
    assert pos[:, 0].min() == -24.0 and abs(pos[:, 0].max() - 24.0) < 1e-5
    trt, jrt = render.build_render_template(tt), jrender.build_render_template(
        jt)
    for f in ("lod_obj", "lod_begin", "lod_end"):
        np.testing.assert_array_equal(getattr(trt, f), getattr(jrt, f),
                                      err_msg=f)
    assert len(trt.lod_obj) == 12
    st = graph.update_hierarchical_data(init_state(tt, 1, device="cpu"), tt)
    color, _ = render.render_frame(
        st, tt, trt, render.RenderConfig(width=32, height=32, shadows=False))
    assert color.shape == (1, 32, 32, 3) and bool(torch.isfinite(color).all())
