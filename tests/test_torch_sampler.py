"""The port's sampler and JAX's threefry streams in torch, against
``jax.random`` and the reference's ``repro.serving.sampler`` on seeded
grids (CPU).

* Integer work and bits exactly: ``fold_in``, the random bits, the
  uniform draw's bits, ``randint``, ``branch_seed`` (negative and large
  seeds included) and ``categorical``.
* ``gumbel`` within 4 ulps of max(|g|, 1): XLA's CPU ``log`` and torch's
  differ by an ulp, which near g = 0 (u near 1/e) is many ulps of g
  itself but never more than an ulp at the logits' scale, where the
  noise is added.
* The filters and ``step_presence`` exactly, and ``sample_tokens`` token
  for token, at V 512 and V 153,600 with ties.  Top-p keeps the same set
  wherever the mass before a token lies more than 1e-6 from ``top_p``:
  the two packages' exponentials differ by an ulp, so a boundary closer
  than that may move (the nucleus's running sum itself is XLA's order,
  bit for bit, ``sampler._cumsum``).
* The reference's own numpy-oracle checks (``tests/test_sampling_spec.py``
  part (c)) on the port's functions.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.serving import sampler as jS
from repro_torch.core import jax_random as jr
from repro_torch.serving import sampler as S
from test_sampling_spec import _np_top_k, _np_top_p
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEEDS = np.array([0, 1, 7, 314, 1234, 2 ** 31 - 1, -1, -5, -2 ** 31, 99991],
                 np.int64)
POS = np.array([0, 3, 17, 5, 100, 2047, 1, 9, 153599, 64], np.int64)
TINY = float(jnp.finfo(jnp.float32).tiny)


def _jkeys():
    return [jax.random.fold_in(jax.random.PRNGKey(np.uint32(s & 0xFFFFFFFF)),
                               int(p)) for s, p in zip(SEEDS, POS)]


def _tkeys():
    return jr.fold_in(jr.prng_keys(torch.tensor(SEEDS)), torch.tensor(POS))


def test_fold_in_and_bits_match_jax():
    want = np.stack([np.asarray(k) for k in _jkeys()])
    keys = _tkeys()
    np.testing.assert_array_equal(keys.numpy().astype(np.uint32), want)
    n = 1000
    bits = np.stack([np.asarray(jax.random.bits(k, (n,), jnp.uint32))
                     for k in _jkeys()])
    np.testing.assert_array_equal(
        jr.random_bits(keys, n).numpy().astype(np.uint32), bits)
    for lo, hi in ((0.0, 1.0), (TINY, 1.0)):
        u = np.stack([np.asarray(jax.random.uniform(k, (n,), jnp.float32,
                                                    lo, hi))
                      for k in _jkeys()])
        got = jr.uniform(keys, n, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), u.view(np.int32))


def test_gumbel_within_ulps_and_categorical_exact():
    n = 4096
    want = np.stack([np.asarray(jax.random.gumbel(k, (n,), jnp.float32,
                                                  mode="low"))
                     for k in _jkeys()])
    got = jr.gumbel(_tkeys(), n).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) / ulp).max() <= 4
    rng = np.random.default_rng(5)
    for v in (512, 153600):
        lg = (rng.standard_normal((len(SEEDS), v)) * 3).astype(np.float32)
        lg[:, 10] = lg[:, 11]
        want = [int(jax.random.categorical(k, lg[i]))
                for i, k in enumerate(_jkeys())]
        got = jr.categorical(_tkeys(), torch.tensor(lg)).tolist()
        assert got == want, v


def test_randint_and_branch_seed_match_jax():
    imax = int(jnp.iinfo(jnp.int32).max)
    for s in (0, 1, 7, 314, -1, -5, 2 ** 31 - 1, -2 ** 31, 2 ** 32 - 1):
        for b in (1, 2, 3, 7, 100, 2 ** 31 - 1):
            key = jax.random.fold_in(
                jax.random.PRNGKey(int(s) & 0xFFFFFFFF), b)
            want = int(jax.random.randint(key, (), 0, imax))
            assert S.branch_seed(s, b) == want == jS.branch_seed(s, b)
        assert S.branch_seed(s, 0) == s
    key = jax.random.PRNGKey(5)
    for lo, hi in ((0, 10), (-7, 3), (0, imax), (-2 ** 31, imax), (5, 5),
                   (3, 1)):
        want = np.asarray(jax.random.randint(key, (37,), lo, hi))
        np.testing.assert_array_equal(
            jr.randint(jr.prng_key(5), (37,), lo, hi).numpy(), want)


def _inputs(rng, n, v):
    lg = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    lg[:, 5] = lg[:, 7]                      # ties, at and off the top
    lg[0, :3] = lg[0].max() + 1.0
    return dict(
        logits=lg, presence=rng.random((n, v)) < 0.05,
        seeds=rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32),
        positions=rng.integers(0, 4096, n).astype(np.int32),
        temperature=rng.choice([0.0, 0.5, 0.8, 1.3], n).astype(np.float32),
        top_k=rng.choice([0, 1, 2, 50, v + 3], n).astype(np.int32),
        top_p=rng.choice([1.0, 0.95, 0.5, 0.01], n).astype(np.float32),
        repetition_penalty=rng.choice([1.0, 1.1, 0.8], n)
        .astype(np.float32))


def _margin(logits, top_p):
    """For each entry, how far the mass strictly before it (f64, over the
    row's stable descending order) lies from the row's top_p."""
    order = np.argsort(-logits, axis=-1, kind="stable")
    s = np.take_along_axis(logits, order, -1).astype(np.float64)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    gap = np.abs(np.cumsum(p, -1) - p - top_p[:, None].astype(np.float64))
    out = np.empty_like(gap)
    np.put_along_axis(out, order, gap, -1)
    return out


@pytest.mark.parametrize("v", [512, 153600])
def test_filters_match_reference(v):
    rng = np.random.default_rng(v)
    a = _inputs(rng, 16 if v > 512 else 64, v)
    lg, tl = a["logits"], torch.tensor(a["logits"])
    want = np.asarray(jS.apply_repetition_penalty(
        jnp.asarray(lg), jnp.asarray(a["presence"]),
        jnp.asarray(a["repetition_penalty"])))
    got = S.apply_repetition_penalty(tl, torch.tensor(a["presence"]),
                                     torch.tensor(a["repetition_penalty"]))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jS.apply_top_k(jnp.asarray(lg),
                                     jnp.asarray(a["top_k"])))
    np.testing.assert_array_equal(
        S.apply_top_k(tl, torch.tensor(a["top_k"])).numpy(), want)
    want = np.asarray(jS.apply_top_p(jnp.asarray(lg),
                                     jnp.asarray(a["top_p"])))
    got = S.apply_top_p(tl, torch.tensor(a["top_p"])).numpy()
    moved = got != want
    assert (_margin(lg, a["top_p"])[moved] < 1e-6).all()
    # The running sum of the nucleus in XLA's order, bit for bit.
    x = (rng.random((3, v)) ** 8).astype(np.float32)
    np.testing.assert_array_equal(
        S._cumsum(torch.tensor(x)).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)))
    base = rng.random((4, v)) < 0.01
    toks = rng.integers(0, v, (4, 5)).astype(np.int32)
    toks[1, 2] = toks[1, 3]
    np.testing.assert_array_equal(
        S.step_presence(torch.tensor(base), torch.tensor(toks)).numpy(),
        np.asarray(jS.step_presence(jnp.asarray(base), jnp.asarray(toks))))


@pytest.mark.parametrize("v", [512, 153600])
def test_sample_tokens_matches_reference(v):
    """Token for token on seeded logits; a row may differ only where a
    chosen token sits at the top-p boundary (after the penalty,
    temperature and top-k): the mass before it within 1e-6 of top_p."""
    rng = np.random.default_rng(v + 1)
    a = _inputs(rng, 16 if v > 512 else 128, v)
    want = np.asarray(jS.sample_tokens(*(jnp.asarray(x) for x in a.values())))
    got = S.sample_tokens(*(torch.tensor(x) for x in a.values())).numpy()
    assert got.dtype == np.int32
    pen = S.apply_repetition_penalty(
        torch.tensor(a["logits"]), torch.tensor(a["presence"]),
        torch.tensor(a["repetition_penalty"])).numpy()
    temp = a["temperature"]
    scaled = S.apply_top_k(torch.tensor(
        pen / np.where(temp > 0, temp, 1)[:, None]),
        torch.tensor(a["top_k"])).numpy()
    rows = np.arange(len(got))
    margin = _margin(scaled, a["top_p"])
    near = ((margin[rows, got] < 1e-6) | (margin[rows, want] < 1e-6)) & \
        (temp > 0)
    moved = got != want
    assert not (moved & ~near).any(), (np.nonzero(moved)[0], near)


# --------------------- the reference's numpy-oracle checks, on the port
def test_top_k_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((8, 37)).astype(np.float32) * 3
    k = np.array([0, 1, 2, 5, 17, 36, 37, 400], np.int32)
    got = S.apply_top_k(torch.tensor(logits), torch.tensor(k)).numpy()
    np.testing.assert_allclose(got, _np_top_k(logits, k))
    for i, kk in enumerate([37, 1, 2, 5, 17, 36, 37, 37]):
        assert int(np.sum(got[i] > S.NEG_INF)) == kk


def test_top_p_mass_truncation_matches_numpy_oracle():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 41)).astype(np.float32) * 2
    p = np.array([0.1, 0.3, 0.5, 0.9, 0.999, 1.0], np.float32)
    got = S.apply_top_p(torch.tensor(logits), torch.tensor(p)).numpy()
    np.testing.assert_allclose(got, _np_top_p(logits, p), atol=1e-6)
    for i in range(len(p)):
        keep = got[i] > S.NEG_INF
        probs = np.exp(logits[i] - logits[i].max())
        probs /= probs.sum()
        kept_mass = probs[keep].sum()
        assert kept_mass >= min(p[i], 1.0) - 1e-6
        if keep.sum() > 1:
            smallest = np.argmin(np.where(keep, probs, np.inf))
            assert kept_mass - probs[smallest] < p[i]
    assert got[0].max() > S.NEG_INF


def test_repetition_penalty_matches_numpy_oracle():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 19)).astype(np.float32)
    presence = rng.random((4, 19)) < 0.4
    pen = np.array([1.0, 1.2, 2.0, 0.8], np.float32)
    got = S.apply_repetition_penalty(torch.tensor(logits),
                                     torch.tensor(presence),
                                     torch.tensor(pen)).numpy()
    want = np.where(presence, np.where(logits > 0, logits / pen[:, None],
                                       logits * pen[:, None]), logits)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_greedy_ignores_filters_and_matches_argmax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((5, 23)).astype(np.float32)
    n = len(logits)
    zeros = torch.zeros((n,), dtype=torch.int32)
    toks = S.sample_tokens(
        torch.tensor(logits), torch.zeros((n, 23), dtype=torch.bool), zeros,
        zeros, torch.zeros((n,)), torch.full((n,), 1, dtype=torch.int32),
        torch.full((n,), 0.01), torch.ones((n,))).numpy()
    np.testing.assert_array_equal(toks, logits.argmax(-1))


def test_sample_key_is_position_and_seed_only():
    """The same (seed, position, logits) row samples the same token in any
    batch slot and batch size."""
    rng = np.random.default_rng(4)
    row = rng.standard_normal(101).astype(np.float32)

    def draw(rows, idx):
        n = len(rows)
        return int(S.sample_tokens(
            torch.tensor(np.stack(rows)), torch.zeros((n, 101),
                                                      dtype=torch.bool),
            torch.full((n,), 42, dtype=torch.int32),
            torch.full((n,), 7, dtype=torch.int32), torch.full((n,), 0.9),
            torch.zeros((n,), dtype=torch.int32), torch.ones((n,)),
            torch.ones((n,)))[idx])

    other = [rng.standard_normal(101).astype(np.float32) for _ in range(7)]
    solo = draw([row], 0)
    assert draw([row] + other, 0) == solo
    assert draw(other[:3] + [row] + other[3:], 3) == solo


def test_step_presence_accumulates_draft_inputs():
    """Position i's context = base | inputs 1..i (the carry token is in
    the base already)."""
    base = np.zeros((1, 10), bool)
    base[0, 9] = True
    tokens = np.array([[3, 5, 5, 2]], np.int32)
    got = S.step_presence(torch.tensor(base), torch.tensor(tokens)).numpy()
    want = np.zeros((4, 10), bool)
    for i in range(4):
        want[i, 9] = True
        for j in range(1, i + 1):
            want[i, tokens[0, j]] = True
    np.testing.assert_array_equal(got[0], want)
