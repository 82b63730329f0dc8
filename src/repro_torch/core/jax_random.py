"""The reference's random weights, drawn in torch: JAX's threefry2x32
PRNG (``jax_threefry_partitionable``, the default of the JAX release
the reference runs on) with its ``PRNGKey``, ``split`` and ``normal``.

A key is a (2,) uint32 pair held in an int64 tensor.  ``split(key, n)``
hashes the counters 0..n-1 under the key; ``normal(key, shape, dtype)``
hashes the counters 0..size-1, keeps the mantissa bits of a uniform
draw in [nextafter(-1, 0), 1) and maps it through the same f32
``erf_inv`` polynomial as XLA (M. Giles' single-precision
approximation), times sqrt(2).  The key tree, the uniform draws and the
bf16 rounding points are the reference's bit for bit; ``erf_inv`` uses
torch's ``log1p`` and ``sqrt`` where XLA uses its own approximations,
so an f32 weight can differ from the reference's by a few ulps (3 at
most in the shapes checked by the tests).

Used by :meth:`repro_torch.models.model.LM.init_reference`, so that a
seed gives the port the reference's ``LM.init(PRNGKey(seed))`` weights
without importing JAX.  Sampling with JAX's generators (``categorical``,
``randint``, ``fold_in``) is not here (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# erf_inv's polynomial coefficients, w < 5 and w >= 5 (f32).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_CHUNK = 1 << 24


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def _threefry(key: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter pairs (x1, x2) under
    ``key``, on int64 tensors holding uint32 values."""
    k1, k2 = int(key[0]), int(key[1])
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _MASK
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def split(key: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``jax.random.split(key, n)`` as a list of n keys."""
    count = torch.arange(n, dtype=torch.int64)
    b1, b2 = _threefry(key, count >> 32, count & _MASK)
    return [torch.stack([b1[i], b2[i]]) for i in range(n)]


def _bits(key: torch.Tensor, start: int, n: int, device) -> torch.Tensor:
    """32 random bits for the flat positions start..start+n-1 of a draw."""
    count = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b1, b2 = _threefry(key, count >> 32, count & _MASK)
    return b1 ^ b2


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` polynomial (|x| < 1)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.full_like(x, _ERFINV_LT5[0]),
                    torch.full_like(x, _ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, torch.full_like(x, a), torch.full_like(x, b)) + \
            p * w
    return p * x


def _normal_chunk(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
        u = fb.view(torch.float32) - 1.0
        lo = float(np.nextafter(np.float32(-1), np.float32(0)))
        u = torch.clamp(u * (1.0 - lo) + lo, min=lo)
        return _erf_inv(u) * math.sqrt(2)
    if dtype == torch.bfloat16:
        # 8 random bits (JAX draws 8 for a 7-bit mantissa); every op
        # rounds to bf16 as XLA's bf16 ops do, erf_inv runs in f32.
        fb = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16)
        one = torch.ones((), dtype=torch.bfloat16, device=bits.device)
        u = fb.view(torch.bfloat16) - one
        lo = torch.tensor(-0.99609375, dtype=torch.bfloat16,
                          device=bits.device)
        u = torch.maximum(u * (one - lo) + lo, lo)
        e = _erf_inv(u.to(torch.float32)).to(torch.bfloat16)
        return e * torch.tensor(math.sqrt(2), dtype=torch.bfloat16,
                                device=bits.device)
    raise ValueError(f"normal: dtype {dtype} not supported")


def normal(key: torch.Tensor, shape, dtype=torch.float32,
           device=None, scale: float | None = None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` [times ``scale``, as the
    reference multiplies it: the scale rounded to ``dtype`` first], drawn
    on ``device`` in chunks of 2^24 values."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for s0 in range(0, n, _CHUNK):
        m = min(_CHUNK, n - s0)
        out[s0:s0 + m] = _normal_chunk(_bits(key, s0, m, device), dtype)
    if scale is not None:
        out = out * torch.tensor(scale, dtype=dtype, device=device)
    return out.reshape(shape)
