"""Counter-based threefry2x32 random numbers in PyTorch integer ops.

The port's copy of the JAX package's random streams (threefry2x32 keys with
``jax_threefry_partitionable`` on): ``prng_key`` / ``fold_in`` / ``split``
derive keys, ``uniform`` / ``normal`` draw from them. A key is a pair of
uint32 words held in int64 tensors of the same shape (PyTorch has no full
uint32 arithmetic); every word stays in [0, 2^32). The bits equal JAX's bit
for bit, so uniform draws are the same floats up to XLA's fused
multiply-add (an ulp); normal draws take XLA's own inverse error function
(M. Giles' single-precision polynomial), within an ulp of JAX's where
``torch.erfinv`` differs by ~1e-5 in the tails.

Everything is tensor code on the keys' device with no host read: a key
derived from a step counter held in a device tensor advances when a
captured CUDA graph replays, where a ``torch.Generator``'s state would
not.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "split", "random_bits",
           "uniform", "normal", "erf_inv"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block (20 rounds) of key (k1, k2) over counters
    (x1, x2); all int64 tensors of uint32 words, broadcast together.
    Returns the two output words."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _MASK
    x2 = (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device):
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits: the words
    (0, seed)."""
    z = torch.zeros((), dtype=torch.int64, device=device)
    return z, z + (int(seed) & _MASK)


def fold_in(key, data):
    """``jax.random.fold_in``: data (a Python int or an integer tensor that
    broadcasts against the key's words) hashed into the key."""
    k1, k2 = key
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _MASK
    else:
        data = int(data) & _MASK
    return threefry2x32(k1, k2, torch.zeros_like(k1), k2 * 0 + data)


def split(key, num: int):
    """``jax.random.split(key, num)`` (partitionable): key i hashes the
    counter (0, i). Returns words of shape key.shape + (num,)."""
    k1, k2 = key
    i = torch.arange(num, dtype=torch.int64, device=k1.device)
    return threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(i), i)


def random_bits(key, n: int):
    """32 random bits for each of n flat positions (row-major over the
    draw's shape), per key: key.shape + (n,) int64 words. Counters run
    (0, i) for i < n < 2^32."""
    k1, k2 = key
    i = torch.arange(n, dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None], torch.zeros_like(i),
                          i)
    return y1 ^ y2


def _unit_floats(bits):
    """Bits → floats in [0, 1): the top 23 bits as a mantissa of [1, 2),
    minus 1 (jax.random.uniform's float32 path)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for each
    key: key.shape + shape float32."""
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    bits = random_bits(key, n)
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _unit_floats(bits) * float(hi - lo) + float(lo)
    f = torch.clamp(f, min=float(lo))
    return f.reshape(bits.shape[:-1] + shape)


# M. Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011),
# single precision: the coefficients XLA's ErfInv uses for float32
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x):
    """Inverse error function of float32 x in [-1, 1], as XLA computes it
    (``lax.erf_inv``): a degree-9 polynomial in w - 2.5 (w = -log(1 - x²)
    < 5) or sqrt(w) - 3, times x; ±inf at ±1."""
    w = -torch.log1p(-x * x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(central, _ERFINV_CENTRAL[0], _ERFINV_TAIL[0])
    for c, t in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = torch.where(central, c, t) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, p * x)


def normal(key, shape):
    """``jax.random.normal(key, shape)`` (float32) for each key: sqrt(2) ·
    erf_inv of a uniform draw on (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return erf_inv(u) * float(np.float32(np.sqrt(2.0)))
