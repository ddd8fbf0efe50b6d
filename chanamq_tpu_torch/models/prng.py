"""The reference's random numbers without JAX: threefry-2x32 in numpy.

The reference draws its default forecaster from ``jax.random``
(``init_params(jax.random.PRNGKey(0), cfg)``). This module reproduces the
three calls that draw uses, in numpy only, so the port starts from the
same model:

- ``key(seed)``: ``jax.random.PRNGKey(seed)``, uint32 ``[hi, lo]``;
- ``split(key, n)``: ``jax.random.split(key, n)``, ``[n, 2]`` uint32, bit
  for bit;
- ``normal(key, shape)``: ``jax.random.normal(key, shape)`` in float32,
  within a few float32 ulp (see below).

Checked against JAX 0.9.0 with ``jax_threefry_partitionable=True`` (its
default), the form in which a draw of n values hashes the counts
``(0, arange(n))`` of the flat row-major index. A JAX that draws the
older, non-partitionable way gives other numbers.

``normal`` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
``[nextafter(-1, 0), 1)`` from the top 23 bits of each word, as
``jax.random.normal`` computes it, and erfinv is XLA's float32 Giles
polynomial in XLA's order of operations. XLA's own ``log1p`` inside
erfinv is not a correctly rounded one, so about one value in a hundred
differs from JAX's in the last bits (within 4 float32 ulp); everything
before erfinv is exact.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_F32 = np.float32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(k1, k2, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """Threefry-2x32 with 20 rounds (Salmon et al., the form of
    ``jax._src.prng.threefry2x32``): the key words ``k1``, ``k2`` and the
    count words ``x0``, ``x1`` (uint32 arrays of one shape) to two uint32
    output words."""
    ks = (_U32(k1), _U32(k2), _U32(k1) ^ _U32(k2) ^ _PARITY)
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2**64)``: uint32
    ``[seed >> 32, seed & 0xffffffff]``."""
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed {seed} is not in [0, 2**64)")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=_U32)


def _hash(k: np.ndarray, n: int) -> tuple:
    """Both output words of ``k`` over the counts ``(0, arange(n))``."""
    k = np.asarray(k, _U32)
    if k.shape != (2,):
        raise ValueError(f"a key is uint32 [2], got shape {k.shape}")
    counts = np.arange(n, dtype=_U32)
    return threefry2x32(k[0], k[1], np.zeros_like(counts), counts)


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)``: ``n`` new keys, uint32 ``[n, 2]``."""
    return np.stack(_hash(k, n), axis=1)


def _bits(k: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.bits(k, shape)`` for 32-bit words."""
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2**32:
        raise ValueError(f"{n} values need counts past 32 bits")
    b0, b1 = _hash(k, n)
    return (b0 ^ b1).reshape(shape)


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"),
# the constants of its two branches from the highest power down
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv, operation by operation in float32. Each
    step of the polynomial is one fused multiply-add, as XLA's CPU code
    contracts it (a product of two float32 values is exact in float64, so
    the sum rounded once to float32 is the fused result but for rare
    double roundings). log1p is rounded correctly, which XLA's is not."""
    x = np.asarray(x, _F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p((x * -x).astype(np.float64)).astype(_F32)
        small = w < _F32(5.0)
        w = np.where(small, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
        p = np.where(small, _F32(_ERFINV_SMALL[0]), _F32(_ERFINV_LARGE[0]))
        w64 = w.astype(np.float64)
        for lo, hi in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
            c = np.where(small, _F32(lo), _F32(hi)).astype(np.float64)
            p = (c + p.astype(np.float64) * w64).astype(_F32)
        out = p * x
        return np.where(np.abs(x) == _F32(1.0), x * _F32(np.inf), out)


def uniform(k: np.ndarray, shape: tuple, lo: float, hi: float) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, lo, hi)``."""
    lo, hi = _F32(lo), _F32(hi)
    bits = (_bits(k, tuple(shape)) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(_F32) - _F32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal(k: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.normal(k, shape)`` in float32."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    u = uniform(k, shape, lo, 1.0)
    return _F32(np.sqrt(2.0)) * erfinv(u)
