"""Port parity: the reflection probes (``render.probe``) against the JAX
package's ``render.probe`` on the CPU.

Inputs are numpy arrays from seeds, handed to both packages. Bars: the
capture's faces come from the streaming rasterizer, and the room's
triangles that pass beside the probe are near-clipped: against the
compiled JAX function they part by up to ~0.02 and flip a few winners
(XLA's FMAs at a clipped vertex 10⁴ screens away; ``ROADMAP.md`` queue 3),
so the capture is held to the JAX function run op by op
(``jax.disable_jit()``), within 1e-6. The image-space functions hold
every value within 1e-5 (reductions over six faces or a few hundred
texels in another order; XLA's FMAs); the cube lookup is nearest-texel,
so a reflected ray on a texel border may pick its neighbour: at most
LOOKUP_FLIPS pixels of 256 may differ.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fyrox_tpu.render import mesh as jmesh
from fyrox_tpu.render import probe as jprobe
from fyrox_tpu.render import raster as jraster
from fyrox_tpu_torch.render import probe, raster, skybox

torch.set_num_threads(2)

LOOKUP_FLIPS = 2        # pixels of 16 x 16
ROUGH = (0.1, 0.3, 0.6, 1.0)


def room(seed=0):
    """Six cubes around the probe (at the origin) and a floor quad: world
    triangle positions [T, 3, 3] and per-vertex attributes."""
    rng = np.random.default_rng(seed)
    cube = jmesh.make_cube(1.0)
    pos, nrm = [], []
    for c in rng.uniform(-4, 4, (6, 3)) + np.array([0, 0, 0]):
        c = c + np.sign(c) * 1.5                  # keep the probe outside
        pos.append(cube.positions[cube.triangles] + c)
        nrm.append(cube.normals[cube.triangles])
    floor = np.array([[[-6, -2, -6], [6, -2, 6], [6, -2, -6]],
                      [[-6, -2, -6], [-6, -2, 6], [6, -2, 6]]], np.float32)
    pos.append(floor)
    nrm.append(np.tile([0, 1, 0], (2, 3, 1)).astype(np.float32))
    tris = np.concatenate(pos).astype(np.float32)
    t = tris.shape[0]
    attrs = dict(albedo=rng.uniform(0, 1, (t, 3, 3)),
                 normal=np.concatenate(nrm), position=tris,
                 material=rng.uniform(0, 1, (t, 3, 2)),
                 emission=rng.uniform(0, 0.3, (t, 3, 3)))
    return tris, {k: np.asarray(v, np.float32) for k, v in attrs.items()}


def gbuffer(seed, h=16, w=16, lead=()):
    """A numpy G-buffer of unit normals, positions, albedo and material
    (roughness spread over the levels and past both ends), ~80 % covered."""
    rng = np.random.default_rng(seed)
    shape = lead + (h, w)
    n = rng.standard_normal(shape + (3,))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    f = dict(depth=rng.uniform(-1, 1, shape),
             albedo=rng.uniform(0, 1, shape + (3,)), normal=n,
             position=rng.uniform(-2, 2, shape + (3,)),
             material=np.stack([rng.uniform(0, 1, shape),
                                rng.uniform(0.0, 1.1, shape)], -1),
             emission=np.zeros(shape + (3,)),
             mask=rng.uniform(size=shape) < 0.8)
    return {k: v if v.dtype == bool else v.astype(np.float32)
            for k, v in f.items()}


def jgb(f):
    return jraster.GBuffer(**{k: jnp.asarray(v) for k, v in f.items()})


def tgb(f):
    return raster.GBuffer(**{k: torch.as_tensor(v) for k, v in f.items()})


def test_capture_and_irradiance_match_jax():
    tris, attrs = room()
    pos = np.array([0.3, 0.2, -0.1], np.float32)
    with jax.disable_jit():
        jf = np.asarray(jprobe.capture_probe(
            jnp.asarray(tris), {k: jnp.asarray(v) for k, v in attrs.items()},
            jnp.asarray(pos), face_size=16, chunk=32))
    tf = probe.capture_probe(
        torch.as_tensor(tris), {k: torch.as_tensor(v)
                                for k, v in attrs.items()},
        torch.as_tensor(pos), face_size=16, chunk=32).numpy()
    assert tf.shape == jf.shape == (6, 16, 16, 3)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-6)
    assert (np.abs(jf).sum(-1) > 0).mean() > 0.3        # the room shows
    np.testing.assert_allclose(
        probe.face_irradiance(torch.as_tensor(jf)).numpy(),
        np.asarray(jprobe.face_irradiance(jnp.asarray(jf))), atol=1e-6)


@pytest.mark.parametrize("boxed", [False, True], ids=["all", "probe-box"])
def test_apply_probe_ambient_matches_jax(boxed):
    f = gbuffer(1)
    rng = np.random.default_rng(2)
    color = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    irr = rng.uniform(0, 2, (6, 3)).astype(np.float32)
    inv = (np.diag([0.3, 0.4, 0.25, 1.0]).astype(np.float32) if boxed
           else None)
    want = np.asarray(jprobe.apply_probe_ambient(
        jnp.asarray(color), jgb(f), jnp.asarray(irr), strength=1.5,
        probe_inv=None if inv is None else jnp.asarray(inv)))
    got = probe.apply_probe_ambient(
        torch.as_tensor(color), tgb(f), torch.as_tensor(irr), strength=1.5,
        probe_inv=None if inv is None else torch.as_tensor(inv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - color).max() > 0.1


def test_prefilter_and_texel_dirs_match_jax():
    faces = np.random.default_rng(3).uniform(0, 2, (6, 8, 8, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(probe.face_texel_dirs(8),
                                  jprobe.face_texel_dirs(8))
    want = np.asarray(jprobe.prefilter_specular(jnp.asarray(faces), ROUGH,
                                                out_size=4))
    got = probe.prefilter_specular(torch.as_tensor(faces), ROUGH,
                                   out_size=4).numpy()
    assert got.shape == (4, 6, 4, 4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("boxed", [False, True], ids=["all", "probe-box"])
def test_apply_probe_specular_matches_jax(boxed):
    f = gbuffer(4)
    rng = np.random.default_rng(5)
    color = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    pre = rng.uniform(0, 2, (4, 6, 4, 4, 3)).astype(np.float32)
    cam = np.array([0.5, 3.0, -4.0], np.float32)
    inv = (np.diag([0.3, 0.4, 0.25, 1.0]).astype(np.float32) if boxed
           else None)
    want = np.asarray(jprobe.apply_probe_specular(
        jnp.asarray(color), jgb(f), jnp.asarray(cam), jnp.asarray(pre),
        ROUGH, strength=0.8,
        probe_inv=None if inv is None else jnp.asarray(inv)))
    got = probe.apply_probe_specular(
        torch.as_tensor(color), tgb(f), torch.as_tensor(cam),
        torch.as_tensor(pre), ROUGH, strength=0.8,
        probe_inv=None if inv is None else torch.as_tensor(inv)).numpy()
    flips = np.any(np.abs(got - want) > 1e-5, -1)
    assert flips.sum() <= LOOKUP_FLIPS, flips.sum()
    assert np.abs(got - color).max() > 0.05


def test_sample_cube_and_batched_specular_match_jax():
    """The cube lookup is skybox.sample_cube, the JAX package's
    _sample_cube; a leading world axis (one camera a world) renders each
    world as the JAX function does one image."""
    rng = np.random.default_rng(6)
    faces = rng.uniform(0, 1, (6, 8, 8, 3)).astype(np.float32)
    dirs = rng.standard_normal((64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        skybox.sample_cube(torch.as_tensor(faces),
                           torch.as_tensor(dirs)).numpy(),
        np.asarray(jprobe._sample_cube(jnp.asarray(faces),
                                       jnp.asarray(dirs))))
    f = gbuffer(7, lead=(2,))
    pre = rng.uniform(0, 2, (4, 6, 4, 4, 3)).astype(np.float32)
    cams = rng.uniform(-3, 3, (2, 3)).astype(np.float32)
    color = np.zeros((2, 16, 16, 3), np.float32)
    got = probe.apply_probe_specular(
        torch.as_tensor(color), tgb(f), torch.as_tensor(cams),
        torch.as_tensor(pre), ROUGH).numpy()
    for i in range(2):
        want = np.asarray(jprobe.apply_probe_specular(
            jnp.asarray(color[i]), jgb({k: v[i] for k, v in f.items()}),
            jnp.asarray(cams[i]), jnp.asarray(pre), ROUGH))
        flips = np.any(np.abs(got[i] - want) > 1e-5, -1)
        assert flips.sum() <= LOOKUP_FLIPS, flips.sum()
