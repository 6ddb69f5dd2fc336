"""Port parity: post-processing (``render.post``) and SSAO
(``render.ssao``) against the JAX package's on the CPU.

Inputs are numpy arrays from seeds, handed to both packages. Bars:
elementwise chains within 1e-5 relative (XLA contracts multiply-adds
into FMAs, PyTorch rounds each product); the box blur within 1e-5 of the
image's scale (both take a running sum, in other association orders);
the LUT grade within 1e-5. SSAO truncates each sample's screen position
to a pixel, so a sample on a pixel border may read the neighbour's
surface: at most SSAO_FLIPS of 256 pixels may differ, the rest within
1e-5; its hemisphere kernel is the same numpy draw.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fyrox_tpu.render import post as jpost
from fyrox_tpu.render import raster as jraster
from fyrox_tpu.render import ssao as jssao
from fyrox_tpu.scene import camera as jcamera
from fyrox_tpu_torch.render import post, raster, ssao

torch.set_num_threads(2)

SSAO_FLIPS = 4


def hdr(seed, shape=(2, 16, 16, 3)):
    """HDR colours with a bright spot per image (the bloom pass's input)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 1.2, shape)
    c[..., 5:8, 6:9, :] += 4.0
    return c.astype(np.float32)


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_tonemap_exposure_and_bloom_match_jax():
    c = hdr(0)
    close(post.tonemap_aces(torch.as_tensor(c)),
          jpost.tonemap_aces(jnp.asarray(c)))
    close(post.auto_exposure(torch.as_tensor(c), 0.2),
          jpost.auto_exposure(jnp.asarray(c), 0.2))
    for radius in (1, 4):
        close(post._blur_separable(torch.as_tensor(c), radius),
              jpost._blur_separable(jnp.asarray(c), radius), atol=1e-5)
        close(post.bloom(torch.as_tensor(c), 1.0, 0.35, radius),
              jpost.bloom(jnp.asarray(c), 1.0, 0.35, radius), atol=1e-5)


def test_color_grading_and_fxaa_match_jax():
    rng = np.random.default_rng(1)
    ldr = rng.uniform(-0.1, 1.1, (2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(post.identity_lut(8), jpost.identity_lut(8))
    lut = (jpost.identity_lut(8) ** 1.7).astype(np.float32)
    close(post.color_grading(torch.as_tensor(ldr), lut, 0.7),
          jpost.color_grading(jnp.asarray(ldr), lut, 0.7), atol=1e-5)
    close(post.color_grading(torch.as_tensor(ldr), torch.as_tensor(lut)),
          jpost.color_grading(jnp.asarray(ldr), lut), atol=1e-5)
    edged = np.clip(ldr, 0, 1)
    edged[:, :, 8:] = 0.0                       # a hard vertical edge
    got = post.fxaa(torch.as_tensor(edged)).numpy()
    close(got, jpost.fxaa(jnp.asarray(edged)))
    assert np.abs(got - edged).max() > 0.1


@pytest.mark.parametrize("case", ["default", "lut-no-auto", "no-bloom-fxaa"])
def test_post_process_matches_jax(case):
    c = hdr(2)
    kw = dict(default={},
              **{"lut-no-auto": dict(auto_exposure=False, exposure=0.6,
                                     color_grading_lut=(
                                         jpost.identity_lut(8) ** 0.8
                                     ).astype(np.float32),
                                     color_grading_amount=0.5)},
              **{"no-bloom-fxaa": dict(bloom_strength=0.0, use_fxaa=False,
                                       gamma=1.8)})[case]
    got = post.post_process(torch.as_tensor(c), post.PostConfig(**kw))
    want = jpost.post_process(jnp.asarray(c), jpost.PostConfig(**kw))
    close(got, want, atol=1e-5)
    g = got.numpy()
    assert g.min() >= 0.0 and g.max() <= 1.0 and g.std() > 0.05


def ssao_scene(seed=3, size=16):
    """A G-buffer of a stepped floor seen from a camera above it: stored
    positions on the surface the camera sees, normals up or facing the
    camera, ~90 % covered."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size]
    step = np.where(xs > size // 2, 0.4, 0.0)
    pos = np.stack([(xs - size / 2) * 0.1, step + rng.uniform(
        -0.02, 0.02, (size, size)), (ys - size / 2) * 0.1], -1)
    nrm = np.zeros_like(pos)
    nrm[..., 1] = 1.0
    nrm[:, size // 2] = [-1.0, 0.0, 0.0]       # the step's face
    f = dict(depth=rng.uniform(-1, 1, (size, size)),
             albedo=np.ones((size, size, 3)), normal=nrm, position=pos,
             material=np.zeros((size, size, 2)),
             emission=np.zeros((size, size, 3)),
             mask=rng.uniform(size=(size, size)) < 0.9)
    f = {k: v if v.dtype == bool else v.astype(np.float32)
         for k, v in f.items()}
    eye = np.array([0.0, 2.5, -1.5], np.float32)
    view = np.asarray(jcamera.look_at_rh(jnp.asarray(eye),
                                         jnp.zeros(3, jnp.float32),
                                         jnp.asarray([0.0, 1.0, 0.0])))
    proj = np.asarray(jcamera.perspective(1.0, 1.0, 0.05, 50.0))
    return f, (proj @ view).astype(np.float32), eye


def test_compute_ssao_matches_jax():
    from fyrox_tpu.render.ssao import _hemisphere_kernel as jkernel
    np.testing.assert_array_equal(ssao._hemisphere_kernel(8, 0),
                                  jkernel(8, 0))
    f, vp, eye = ssao_scene()
    cfg = dict(num_samples=8, radius=0.5, bias=0.02, power=1.5, seed=0)
    want = np.asarray(jssao.compute_ssao(
        jraster.GBuffer(**{k: jnp.asarray(v) for k, v in f.items()}),
        jnp.asarray(vp), jnp.asarray(eye), jssao.SsaoConfig(**cfg)))
    # two worlds: the image and its copy, one camera each
    gb = raster.GBuffer(**{k: torch.as_tensor(np.stack([v, v]))
                           for k, v in f.items()})
    got = ssao.compute_ssao(gb, torch.as_tensor(np.stack([vp, vp])),
                            torch.as_tensor(np.stack([eye, eye])),
                            ssao.SsaoConfig(**cfg)).numpy()
    assert got.shape == (2, 16, 16)
    np.testing.assert_array_equal(got[0], got[1])
    flips = np.abs(got[0] - want) > 1e-5
    assert flips.sum() <= SSAO_FLIPS, flips.sum()
    assert want.min() < 0.9 and (want[~f["mask"]] == 1.0).all()
