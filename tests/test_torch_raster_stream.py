"""Port parity: the streaming rasterizer ``render.raster.rasterize`` (plain
PyTorch, no kernel) against the JAX package's ``raster.rasterize`` (plain
XLA) on the CPU, and the captured frame's entry against ``render_frame``
on CPU tensors.

Inputs are numpy arrays from a seed, handed to both packages. The JAX
function runs as XLA compiles it ("jit": its scan body is one program)
and op by op (``jax.disable_jit()``, "eager"). Bars: the coverage masks
equal but for knife-edge pixels; depth within 1e-6 and every attribute
within 1e-5 where both packages hit. A knife-edge pixel is one whose
centre lies on an edge or a depth tie to the rounding level: XLA's CPU
backend contracts multiply-adds into FMAs (PyTorch rounds each product),
so an edge test or the nearest triangle may flip there. They are counted
and held to at most KNIFE_EDGES of the 1,024 pixels an image (``ROADMAP.md``
queue 3). One case is held looser: near-clipped triangles against the
compiled JAX function. ``clip_near`` puts a clipped vertex on w = 1e-4,
10⁴ times the screen's size away, and XLA's FMAs in its lerp move that
vertex by an ulp of such a coordinate: depth and attributes then part by
up to ~6e-4 (CLIPPED_JIT), where the op-by-op function agrees at the
tight bars.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.render import raster as jraster
from fyrox_tpu_torch.render import raster

torch.set_num_threads(2)

SIZE = 32
CHUNK = 16
KNIFE_EDGES = 2      # pixels of 1,024 an image where the packages part
CLIPPED_JIT = 1e-3   # depth and attributes, near-clipped, compiled JAX


def stream_scene(seed=0, t=50, crossing=False):
    """t jittered triangles in clip space (generic: no edge through a
    pixel centre by construction), both windings; with `crossing`, a
    quarter of them reach behind the camera (w < 0), so the near clip
    cuts them. Per-vertex albedo, normal, position, material, emission."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-0.9, 0.9, (t, 1, 2))
    offs = rng.uniform(-0.35, 0.35, (t, 3, 2))
    w = rng.uniform(0.6, 3.0, (t, 1, 1)) + rng.uniform(-0.05, 0.05, (t, 3, 1))
    if crossing:
        w[: t // 4, 0, 0] = rng.uniform(-1.0, -0.2, t // 4)
    xy = (centres + offs) * w
    # a perspective's depth row (near 0.1, far 100): z = a w + b, so NDC z
    # = a + b / w reaches -1 at w = 0.1 and a clipped vertex is culled
    z = (100.1 * w - 20.0) / 99.9
    clip = np.concatenate([xy, z, w], -1).astype(np.float32)
    attrs = {name: rng.uniform(-1, 1, (t, 3, c)).astype(np.float32)
             for name, c in (("albedo", 3), ("normal", 3), ("position", 3),
                             ("material", 2), ("emission", 3))}
    valid = rng.uniform(size=t) > 0.1
    return clip, attrs, valid


def both(clip, attrs, valid, mode="jit", **kw):
    def jax_side():
        return jraster.rasterize(
            jnp.asarray(clip), {k: jnp.asarray(v) for k, v in attrs.items()},
            SIZE, SIZE, tri_valid=jnp.asarray(valid), chunk=CHUNK, **kw)

    if mode == "eager":
        with jax.disable_jit():
            jg = jax_side()
    else:
        jg = jax_side()
    tg = raster.rasterize(torch.as_tensor(clip),
                          {k: torch.as_tensor(v) for k, v in attrs.items()},
                          SIZE, SIZE, tri_valid=torch.as_tensor(valid),
                          chunk=CHUNK, **kw)
    return jg, tg


def held(jg, tg, depth_tol=1e-6, attr_tol=1e-5):
    """(knife-edge pixels, pixels hit): masks, depth and attributes at
    the given bars."""
    jm, tm = np.asarray(jg.mask), tg.mask.numpy()
    jd, td = np.asarray(jg.depth), tg.depth.numpy()
    # a pixel where coverage or the winner flips: mask or depth parts
    edge = (jm != tm) | (jm & tm & (np.abs(jd - td) > depth_tol))
    assert edge.sum() <= KNIFE_EDGES, np.argwhere(edge)
    both_hit = jm & tm & ~edge
    for name in ("depth", "albedo", "normal", "position", "material",
                 "emission"):
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        tol = depth_tol if name == "depth" else attr_tol
        np.testing.assert_allclose(b[both_hit], a[both_hit], rtol=0,
                                   atol=tol, err_msg=name)
    assert (td[~tm] == 1e9).all()
    return int(edge.sum()), int(both_hit.sum())


@pytest.mark.parametrize("near_clip,cull,mode", [
    (True, True, "jit"), (True, True, "eager"), (True, False, "jit"),
    (True, False, "eager"), (False, True, "jit"), (False, False, "jit")],
    ids=["clip-cull-jit", "clip-cull-eager", "clip-no-cull-jit",
         "clip-no-cull-eager", "no-clip-cull-jit", "no-clip-no-cull-jit"])
def test_rasterize_matches_jax(near_clip, cull, mode):
    clip, attrs, valid = stream_scene(seed=3, crossing=near_clip)
    jg, tg = both(clip, attrs, valid, mode=mode, backface_cull=cull,
                  near_clip=near_clip)
    loose = near_clip and mode == "jit"
    _, hit = held(jg, tg, *((CLIPPED_JIT, CLIPPED_JIT) if loose else ()))
    assert hit > 100                    # a scene, not an empty image


def test_rasterize_batches_images_and_static_attributes():
    """A leading image axis renders each image as the JAX function does
    one; static [T, 3, C] attributes serve every image; the uvt channel
    rides along where given."""
    clips, valids = [], []
    for seed in (5, 6):
        clip, attrs, valid = stream_scene(seed=seed, crossing=True)
        clips.append(clip)
        valids.append(valid)
    attrs["uvt"] = np.random.default_rng(9).uniform(
        0, 1, attrs["albedo"].shape[:2] + (4,)).astype(np.float32)
    tg = raster.rasterize(torch.as_tensor(np.stack(clips)),
                          {k: torch.as_tensor(v) for k, v in attrs.items()},
                          SIZE, SIZE, tri_valid=torch.as_tensor(
                              np.stack(valids)), chunk=CHUNK)
    assert tg.depth.shape == (2, SIZE, SIZE) and tg.uvt.shape == (
        2, SIZE, SIZE, 4)
    for i in range(2):
        jg = jraster.rasterize(
            jnp.asarray(clips[i]),
            {k: jnp.asarray(v) for k, v in attrs.items()}, SIZE, SIZE,
            tri_valid=jnp.asarray(valids[i]), chunk=CHUNK)
        one = raster.GBuffer(*(None if x is None else x[i] for x in tg))
        held(jg, one, CLIPPED_JIT, CLIPPED_JIT)
        np.testing.assert_allclose(
            one.uvt.numpy()[np.asarray(jg.mask)],
            np.asarray(jg.uvt)[np.asarray(jg.mask)], atol=CLIPPED_JIT)


def test_captured_frame_takes_render_frame_on_the_cpu():
    """CapturedFrame on CPU tensors is render_frame: the same colour and
    G-buffer, bit for bit, and no graph is made."""
    import chip_smoke
    from fyrox_tpu_torch.render import (CapturedFrame, CsmConfig,
                                        RenderConfig, build_render_template,
                                        render_frame)
    from fyrox_tpu_torch.scene import graph, init_state
    lib = chip_smoke.render_lib()
    t = chip_smoke.features_scene(lib, frozenset({"sprites", "decals"}),
                                  n_obj=4, n_sprites=2)
    st = graph.update_hierarchical_data(init_state(t, 2, device="cpu"), t)
    rt = build_render_template(t)
    cfg = RenderConfig(width=32, height=32, csm=CsmConfig(map_size=32))
    frame = CapturedFrame(t, rt, cfg)
    color, gbuf = frame(st)
    want_color, want_gbuf = render_frame(st, t, rt, cfg)
    assert torch.equal(color, want_color) and not frame.graphs
    for got, want in zip(gbuf, want_gbuf):
        assert (got is None and want is None) or torch.equal(got, want)
