"""Port parity: core math (quaternions, transforms, curves) of
fyrox_tpu_torch against fyrox_tpu.core on the same random inputs."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fyrox_tpu.core import curve as jcurve
from fyrox_tpu.core import quat as jquat
from fyrox_tpu.core import transform as jtfm
from fyrox_tpu_torch.core import curve as tcurve
from fyrox_tpu_torch.core import quat as tquat
from fyrox_tpu_torch.core import transform as ttfm

torch.set_num_threads(2)

# float32 elementwise math evaluated by two libraries: agreement to a few
# ulps of values of order 1
ATOL = 1e-6


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["mul", "rotate", "to_mat3", "nlerp",
                                  "normalize", "conjugate"])
def test_quat_ops_match(name):
    rng = np.random.default_rng(1)
    a, b = _quats(rng, 64), _quats(rng, 64)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    t = rng.uniform(0, 1, 64).astype(np.float32)
    args = {"mul": (a, b), "rotate": (a, v), "to_mat3": (a,),
            "nlerp": (a, b, t), "normalize": (3.0 * a,), "conjugate": (a,)}
    args = args[name]
    ref = getattr(jquat, name)(*(jnp.asarray(x) for x in args))
    got = getattr(tquat, name)(*(torch.as_tensor(x) for x in args))
    _close(ref, got)


def test_from_euler_and_from_mat3_match():
    rng = np.random.default_rng(2)
    e = rng.uniform(-3, 3, (3, 128)).astype(np.float32)
    ref = jquat.from_euler(*(jnp.asarray(x) for x in e))
    got = tquat.from_euler(*(torch.as_tensor(x) for x in e))
    _close(ref, got)
    m = np.asarray(jquat.to_mat3(ref))
    _close(jquat.from_mat3(jnp.asarray(m)), tquat.from_mat3(
        torch.as_tensor(m)))


def _trs(rng, n):
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    scl = rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32)
    return pos, _quats(rng, n), scl


def test_compose_invert_decompose_match():
    rng = np.random.default_rng(3)
    pos, rot, scl = _trs(rng, 64)
    ref = jtfm.compose_trs(jnp.asarray(pos), jnp.asarray(rot),
                           jnp.asarray(scl))
    got = ttfm.compose_trs(torch.as_tensor(pos), torch.as_tensor(rot),
                           torch.as_tensor(scl))
    _close(ref, got)
    m = np.asarray(ref)
    # a 3x3 inverse through two LAPACK paths: relative error of a few ulps
    # times the matrix condition number (scales within [0.5, 2])
    _close(jtfm.invert_affine(jnp.asarray(m)),
           ttfm.invert_affine(torch.as_tensor(m)), atol=1e-5)
    for r, g in zip(jtfm.decompose_mat4(jnp.asarray(m)),
                    ttfm.decompose_mat4(torch.as_tensor(m))):
        _close(r, g)
    m2 = np.asarray(jtfm.compose_trs(*(jnp.asarray(x)
                                       for x in _trs(rng, 64))))
    _close(jtfm.mat4_mul(jnp.asarray(m), jnp.asarray(m2)),
           ttfm.mat4_mul(torch.as_tensor(m), torch.as_tensor(m2)), atol=1e-5)


def test_local_matrix_with_pivots_matches():
    rng = np.random.default_rng(4)
    pos, rot, scl = _trs(rng, 32)
    extra = dict(pre_rotation=_quats(rng, 32), post_rotation=_quats(rng, 32),
                 rotation_offset=rng.standard_normal((32, 3)).astype(
                     np.float32),
                 scaling_pivot=rng.standard_normal((32, 3)).astype(
                     np.float32))
    ref = jtfm.local_matrix(jtfm.Transform(
        jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(scl),
        **{k: jnp.asarray(v) for k, v in extra.items()}))
    got = ttfm.local_matrix(ttfm.Transform(
        torch.as_tensor(pos), torch.as_tensor(rot), torch.as_tensor(scl),
        **{k: torch.as_tensor(v) for k, v in extra.items()}))
    _close(ref, got, atol=1e-5)


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_curve_sampling_matches(kind):
    rng = np.random.default_rng(10 + kind)
    curves = []
    for c in range(12):
        n = int(rng.integers(0, 6))
        times = np.sort(rng.uniform(0, 2, n))
        curves.append([dict(time=float(tt), value=float(rng.normal()),
                            kind=kind, lt=float(rng.normal()),
                            rt=float(rng.normal())) for tt in times])
    jc = jcurve.pack_curves(curves)
    tc = tcurve.pack_curves(curves)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b)
    t = rng.uniform(-0.5, 2.5, (5, 12)).astype(np.float32)
    _close(jcurve.sample(jc, jnp.asarray(t)),
           tcurve.sample(tc, torch.as_tensor(t)), atol=1e-5)
