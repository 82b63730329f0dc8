"""Seeded sampling for the paged serving engine, on the device.

The engine hands the batched logits and per-slot parameter vectors to
:func:`sample_tokens`; only the sampled tokens cross back to the host.
The functions are the reference's (``repro.serving.sampler``), with
JAX's threefry streams written in torch (:mod:`repro_torch.core.jax_random`):

  * the key for the token at stream index ``pos`` (prompt + generated,
    0-based) is ``fold_in(PRNGKey(seed), pos)``, a pure function of
    (request, position): a request samples the same stream whatever
    shares its step, however its prefill was chunked, and after a
    preemption replays it;
  * so speculative decode stays lossless under sampling: a draft is kept
    iff it equals the token this sampler draws at its position;
  * ``temperature == 0`` returns the argmax of the repetition-penalized
    logits (top-k and top-p are skipped).

Filter pipeline (HF convention): repetition penalty -> temperature ->
top-k -> top-p -> categorical.  Both truncation filters run off one
descending stable argsort and the draw happens in sorted space, as in
the reference.  The repetition-penalty context is a per-row presence
bitmask over the vocab; a verify step widens it per position with
:func:`step_presence`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import jax_random as jr

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (host-side, hashable)."""
    temperature: float = 0.0      # 0 => greedy argmax
    top_k: int = 0                # 0 => disabled
    top_p: float = 1.0            # 1 => disabled
    repetition_penalty: float = 1.0
    seed: int = 0

    def __post_init__(self):
        assert self.temperature >= 0.0, self.temperature
        assert self.top_k >= 0, self.top_k
        assert 0.0 < self.top_p <= 1.0, self.top_p
        assert self.repetition_penalty > 0.0, self.repetition_penalty


GREEDY = SamplingParams()


def branch_seed(seed: int, branch: int) -> int:
    """Seed of branch ``branch`` of a parallel-sampling group:
    ``randint(fold_in(PRNGKey(seed), branch), (), 0, INT32_MAX)``, so
    branch b samples exactly the stream of a request submitted with that
    seed.  Branch 0 keeps the base seed."""
    if branch == 0:
        return int(seed)
    key = jr.fold_in(jr.prng_key(seed), int(branch))
    return int(jr.randint(key, (), 0, INT32_MAX))


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis as int32 (first index on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def apply_repetition_penalty(logits, presence, penalty):
    """HF-style repetition penalty: seen tokens' logits shrink toward 0.
    logits (N, V) f32; presence (N, V) bool; penalty (N,) f32."""
    pen = penalty[:, None]
    hit = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(presence, hit, logits)


def _k_eff(top_k, v: int):
    """top_k per row with 0 (disabled) read as the whole vocab."""
    return torch.where(top_k > 0, top_k.clamp(1, v),
                       torch.full_like(top_k, v)).to(torch.int64)


def apply_top_k(logits, top_k):
    """Mask logits strictly below the k-th largest (ties at the k-th
    value are all kept).  top_k (N,) int32; 0 disables the filter."""
    srt = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, _k_eff(top_k, logits.shape[-1])[:, None] - 1)
    return torch.where(logits >= kth, logits, NEG_INF)


def _softmax(x):
    """``jax.nn.softmax``: exp(x - max) over its sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


SCAN_BLOCK = 16


def _cumsum(x):
    """``jnp.cumsum`` over the last axis in XLA's CPU order: a running
    sum within blocks of 16, the block totals scanned the same way and
    each block's exclusive prefix added to its elements, all in f32.  It
    sets where top-p cuts a row when the mass before a token lies within
    an ulp of ``top_p``; ``torch.cumsum`` sums in another order (and in
    f64 on the CPU)."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, dim=-1)
    pad = (-n) % SCAN_BLOCK
    xb = torch.nn.functional.pad(x, (0, pad)).unflatten(
        -1, (-1, SCAN_BLOCK))
    inner = _cumsum(xb)
    outer = _cumsum(inner[..., -1])
    excl = torch.nn.functional.pad(outer[..., :-1], (1, 0))
    return (inner + excl[..., None]).flatten(-2)[..., :n]


def _nucleus(slog, top_p):
    """Keep a sorted row's prefix while the mass strictly before a token
    is below top_p (the top-1 token always survives)."""
    probs = _softmax(slog)
    excl = _cumsum(probs) - probs
    return excl < top_p[:, None]


def apply_top_p(logits, top_p):
    """Nucleus filter: keep the smallest prefix of the sorted
    distribution whose mass reaches ``top_p`` (the token that crosses
    the threshold is kept)."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    keep_sorted = _nucleus(torch.gather(logits, -1, order), top_p)
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, logits, NEG_INF)


def sample_tokens(logits, presence, seeds, positions, temperature, top_k,
                  top_p, repetition_penalty):
    """Sample one token per row, all arguments batched over N rows on
    one device: logits (N, V); presence (N, V) bool; seeds, positions
    (N,) int32; temperature, top_p, repetition_penalty (N,) f32; top_k
    (N,) int32.  Returns (N,) int32; rows with ``temperature == 0``
    return the argmax of the penalized logits.

    Top-k is rank-based here (an exact tie at the k-th rank keeps the
    stably-first k entries), and the categorical index maps back through
    the sort's permutation, as in the reference."""
    logits = apply_repetition_penalty(logits.to(torch.float32), presence,
                                      repetition_penalty)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    v = logits.shape[-1]
    temp = temperature[:, None]
    scaled = logits / torch.where(temp > 0, temp, torch.ones_like(temp))
    order = torch.argsort(-scaled, dim=-1, stable=True)
    slog = torch.gather(scaled, -1, order)
    rank = torch.arange(v, device=logits.device)[None]
    slog = torch.where(rank < _k_eff(top_k, v)[:, None], slog, NEG_INF)
    slog = torch.where(_nucleus(slog, top_p), slog, NEG_INF)
    keys = jr.fold_in(jr.prng_keys(seeds), positions)
    idx = jr.categorical(keys, slog)
    sampled = torch.gather(order, -1, idx[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def step_presence(base, tokens):
    """Per-position context bitmask for a K-token verify step.

    base (B, V) bool: every token of the slot's stream up to and
    including the step's carry token.  tokens (B, K): the step's inputs;
    position i's context adds draft inputs 1..i.  Returns (B, K, V)."""
    b, k = tokens.shape
    oh = torch.zeros((b, k, base.shape[-1]), dtype=torch.bool,
                     device=base.device)
    oh.scatter_(2, tokens.to(torch.int64)[..., None], True)
    oh[:, 0] = False                 # the carry token is in base already
    return base[:, None, :] | (torch.cumsum(oh, dim=1) > 0)
