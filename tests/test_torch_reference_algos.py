"""The paper's attention oracles (``core/reference.py``: Alg. 1, Alg. 2,
the Eq. (1) merge and Fig. 2's block-parallel attention) and the port's
impl ``fa2`` against the reference, in f32 on numpy inputs from a seed.

Tolerance: 1e-6 of each output's largest magnitude (f32 on both sides;
the einsum and sum orders of torch and XLA differ), m included, and the
rows that saw no key (m = NEG_INF) the same.  The port's
``multihead_attention(impl="fa2")`` runs the FA-2 kernels (their plain
versions on the CPU), the reference's the jnp ``fa2_attention`` loop:
forward and the gradient of q, k and v held the same way.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import reference as jref
from repro.kernels import ops as jops
from repro_torch.core import reference as tref
from repro_torch.kernels import ops as tops
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-6


def _close(got, want, rel=REL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, f"{name}: {err:.3g} relative"


def _qkv(seed, lead=(2, 3), lq=40, lkv=72, d=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(lead + (n, d)).astype(np.float32)
            for n in (lq, lkv, lkv)]


def _both(fn_t, fn_j, arrays, **kw):
    return (fn_t(*(torch.from_numpy(a) for a in arrays), **kw),
            fn_j(*(jnp.asarray(a) for a in arrays), **kw))


@pytest.mark.parametrize("causal", [False, True])
def test_exact_and_lazy_attention(causal):
    qkv = _qkv(0)
    for name in ("exact_attention", "lazy_attention"):
        got, want = _both(getattr(tref, name), getattr(jref, name), qkv,
                          causal=causal)
        _close(got, want, name=name)
    got, want = _both(tref.lazy_attention, jref.lazy_attention, qkv,
                      scale=0.3)
    _close(got, want, name="lazy scale")


def _partial_close(got, want, name):
    m, jm = got.m.numpy(), np.asarray(want.m)
    empty = jm == tref.NEG_INF
    np.testing.assert_array_equal(m == tref.NEG_INF, empty, err_msg=name)
    _close(m[~empty], jm[~empty], name=name + " m")
    _close(got.l, want.l, name=name + " l")
    _close(got.o, want.o, name=name + " o")


FA2_CASES = {
    "plain": dict(block=32),
    "causal": dict(causal=True, block=32),
    "padded_tail": dict(causal=True, block=64),           # 72 keys
    "kv_offset": dict(causal=True, kv_offset=16, block=32),
    "q_offset": dict(causal=True, kv_offset=32, q_offset=8, block=16),
    "scale": dict(scale=0.25, block=128),
}


@pytest.mark.parametrize("case", sorted(FA2_CASES))
def test_fa2_partial_block_semantics(case):
    qkv = _qkv(1)
    got, want = _both(tref.fa2_partial, jref.fa2_partial, qkv,
                      **FA2_CASES[case])
    _partial_close(got, want, case)


def test_fa2_partial_mask_and_fully_masked_block():
    """An irregular mask whose whole second block (keys 16-31) is masked
    for every query, and one query row masked everywhere: its m stays
    NEG_INF and its l and o stay 0."""
    q, k, v = _qkv(2)
    rng = np.random.default_rng(3)
    mask = rng.random(q.shape[:-1] + (k.shape[-2],)) < 0.6
    mask[..., 16:32] = False
    mask[..., 5, :] = False
    got = tref.fa2_partial(*(torch.from_numpy(a) for a in (q, k, v)),
                           mask=torch.from_numpy(mask), block=16)
    want = jref.fa2_partial(*(jnp.asarray(a) for a in (q, k, v)),
                            mask=jnp.asarray(mask), block=16)
    _partial_close(got, want, "mask")
    assert (got.m.numpy()[..., 5] == tref.NEG_INF).all()
    assert (got.l.numpy()[..., 5] == 0).all() and \
        (got.o.numpy()[..., 5, :] == 0).all()
    # A causal span whose last three blocks (keys 32-71) lie wholly in
    # the future of every query (rows 20-27).
    got, want = _both(tref.fa2_partial, jref.fa2_partial, _qkv(4, lq=8),
                      causal=True, kv_offset=0, q_offset=20, block=16)
    _partial_close(got, want, "future blocks")


@pytest.mark.parametrize("causal", [False, True])
def test_fa2_attention_merge_and_blockparallel(causal):
    qkv = _qkv(5, lkv=96)
    got, want = _both(tref.fa2_attention, jref.fa2_attention, qkv,
                      causal=causal, block=32)
    _close(got, want, name="fa2_attention")
    for nb in (2, 4):
        got, want = _both(tref.blockparallel_attention,
                          jref.blockparallel_attention, qkv, num_blocks=nb,
                          causal=causal)
        _close(got, want, name=f"blockparallel {nb}")
    # merge_many over partials of disjoint spans.
    q, k, v = qkv
    parts_t = [tref.fa2_partial(*(torch.from_numpy(a) for a in (
        q, k[..., s:s + 32, :], v[..., s:s + 32, :])), kv_offset=s)
        for s in (0, 32, 64)]
    parts_j = [jref.fa2_partial(*(jnp.asarray(a) for a in (
        q, k[..., s:s + 32, :], v[..., s:s + 32, :])), kv_offset=s)
        for s in (0, 32, 64)]
    _partial_close(tref.merge_many(parts_t), jref.merge_many(parts_j),
                   "merge_many")


@pytest.mark.parametrize("lq,lkv", [(160, 160), (96, 224)])
def test_impl_fa2_forward_and_gradient_match_reference(lq, lkv):
    """(B 2, H 4 over Hkv 2, d 64), causal, lengths that pad to the block
    (the reference's jnp FA-2 takes a block of min(128, Lkv))."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, lq, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, lkv, 2, 64)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jops.multihead_attention(q, k, v, impl="fa2", causal=True)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tops.multihead_attention(tq, tk, tv, impl="fa2", causal=True)
    torch.sum(out * torch.from_numpy(g)).backward()
    _close(out, jout, name="forward")
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        _close(t.grad, j, name=f"d{name}")
