"""JAX's threefry2x32 PRNG written in torch (``jax_threefry_partitionable``,
the default of the JAX release the reference runs on): the reference's
random weights and its seeded sampling streams, without importing JAX.

A key is a uint32 pair held in the last axis (size 2) of an int64
tensor; the sampling functions take a batch of keys (N, 2) and draw one
row each, on the keys' device, without a Python loop over rows.

* ``prng_key`` / ``prng_keys``, ``split``, ``fold_in``: the key tree.
  ``fold_in(key, data)`` hashes the counter pair (0, data) under the
  key, as ``jax.random.fold_in`` does for 32-bit data.
* ``random_bits``: 32 bits for the flat positions 0..n-1 of a draw (the
  counter pair (0, j), the two output words XORed).
* ``uniform``: those bits' top 23 as the mantissa of [1, 2), minus 1,
  scaled to [minval, maxval) and floored at minval, in f32 (a span of 1
  here, so the scale is exact).
* ``gumbel`` (mode "low"): ``-log(-log(uniform(tiny, 1)))``;
  ``categorical``: the argmax of gumbel noise plus the logits.
* ``randint``: int32 in [minval, maxval) from two words a value (the two
  halves of ``split(key)``), reduced as XLA reduces them in uint32.
* ``normal``: the mantissa bits of a uniform draw in
  [nextafter(-1, 0), 1) through the same f32 ``erf_inv`` polynomial as
  XLA (M. Giles' single-precision approximation), times sqrt(2).

The key tree, the bits, the uniform draws, ``randint`` and the bf16
rounding points are the reference's bit for bit.  ``erf_inv`` and
``gumbel`` use torch's ``log1p``, ``log`` and ``sqrt`` where XLA uses
its own approximations, so an f32 weight can differ from the
reference's by a few ulps (3 at most in the shapes checked by the
tests), and a gumbel value likewise: a categorical draw then differs
only where two candidates' noisy logits lie within those ulps.

Used by :meth:`repro_torch.models.model.LM.init_reference` (a seed gives
the reference's ``LM.init(PRNGKey(seed))`` weights) and by
:mod:`repro_torch.serving.sampler` (the reference's per-request,
per-position sampling keys).
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
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed (a negative one as
    its uint32 pattern)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def prng_keys(seeds: torch.Tensor) -> torch.Tensor:
    """``PRNGKey(uint32(seed))`` for every seed of an integer tensor:
    keys of shape ``seeds.shape + (2,)`` on the seeds' device."""
    lo = seeds.to(torch.int64) & _MASK
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def _threefry(key: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter pairs (x1, x2) under
    ``key`` (..., 2), on int64 tensors holding uint32 values; the key's
    leading axes broadcast against the counters'."""
    k1, k2 = key[..., 0], key[..., 1]
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


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for 32-bit data: keys (..., 2)
    and data of the keys' leading shape (or a Python int)."""
    lo = torch.as_tensor(data, dtype=torch.int64,
                         device=key.device) & _MASK
    b1, b2 = _threefry(key, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def _bits(key: torch.Tensor, start: int, n: int, device) -> torch.Tensor:
    """32 random bits for the flat positions start..start+n-1 of a draw;
    a batch of keys (N, 2) gives (N, n)."""
    count = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b1, b2 = _threefry(key.to(device)[..., None, :], count >> 32,
                       count & _MASK)
    return b1 ^ b2


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key of (N, 2):
    (N, n) int64 holding the uint32 values."""
    return _bits(keys, 0, n, keys.device)


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for
    each key of (N, 2): (N, n) f32.  The bounds are rounded to f32 first,
    as the reference converts them.  Bit for bit where ``maxval -
    minval`` rounds to 1 (the draws here: [0, 1) and [tiny, 1)); for other
    spans XLA's CPU contracts the scale and shift into one FMA."""
    fb = ((random_bits(keys, n) >> 9) | 0x3F800000).to(torch.int32)
    u = fb.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32, mode="low")`` for each key
    of (N, 2): ``-log(-log(u))`` of a uniform draw in [tiny, 1)."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(keys, n, tiny, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, row)`` for each key of (N, 2) and
    row of ``logits`` (N, V) f32: the argmax of gumbel noise plus the
    logits (first index on a tie), (N,) int64."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for a
    key (2,) or a batch of keys (..., 2): two words a value, the higher
    from ``split(key)[0]`` and the lower from ``split(key)[1]``, reduced
    into the span with uint32 arithmetic as XLA does (the multiplier
    2^32 mod span wraps).  Bounds inside the int32 range."""
    n = math.prod(shape)
    halves = []
    for i in range(2):
        ctr = torch.full(key.shape[:-1], i, dtype=torch.int64,
                         device=key.device)
        b1, b2 = _threefry(key, torch.zeros_like(ctr), ctr)
        halves.append(_bits(torch.stack([b1, b2], dim=-1), 0, n,
                            key.device))
    span = max(maxval - minval, 1) & _MASK
    mult = ((1 << 16) % span) ** 2 & _MASK
    mult %= span
    off = ((halves[0] % span) * mult & _MASK) + halves[1] % span
    off = (off & _MASK) % span
    return (minval + off).to(torch.int32).reshape(key.shape[:-1]
                                                  + tuple(shape))


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
