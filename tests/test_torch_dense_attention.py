"""The port's dense attention kernels' plain versions against the
reference's Pallas kernels (interpret mode on the CPU), on the same
numpy inputs from a seed.

Tolerances:
* FA-2 forward O and LSE: 2e-5 (f32 math on both sides; only the
  summation order differs).
* FA-2 dq/dk/dv: 1e-4 on f32 inputs.  On bf16 inputs the gradients are
  rounded to bf16 on both sides, so a value that lands near a rounding
  boundary may round one bf16 step apart: held to 1e-4 + one bf16 ulp
  (rtol 2^-7, the ulp at the bottom of a binade).
* H-FA forward: 1e-6, the reference's own kernel-vs-tile-oracle
  tolerance (``tests/test_kernels.py``).
* ``multihead_attention`` through autograd vs ``jax.grad`` of the
  reference's ``ops.multihead_attention`` (GQA 8:2, length 100 padded
  to 128): outputs and grads 1e-4 on fa2; on hfa_pallas outputs 1e-5
  and grads 1e-4 (the gradient runs through the same tile oracle with
  the STE in both packages).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import bitmath as jbit
from repro.kernels import fa2 as jfa2
from repro.kernels import fa2_bwd as jfa2_bwd
from repro.kernels import hfa as jhfa
from repro.kernels import ops as jops
from repro_torch.kernels import bitmath as tbit
from repro_torch.kernels import fa2 as tfa2
from repro_torch.kernels import fa2_bwd as tfa2_bwd
from repro_torch.kernels import hfa as thfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (bh, lq, lkv, d, block_q, block_kv): a subset of tests/test_kernels.py's
# SHAPES - square, suffix queries (q_offset > 0), a 32-wide head.
SHAPES = [
    (1, 128, 128, 64, 128, 128),
    (2, 128, 256, 64, 128, 128),
    (3, 128, 384, 32, 128, 128),
]
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def _inputs(shape, dtype, seed=0):
    bh, lq, lkv, d = shape[:4]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((bh, lq, d), (bh, lkv, d), (bh, lkv, d))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fa2_forward_and_lse_match_pallas(shape, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype)
    bq, bk = shape[4:]
    jo, jlse = jfa2.fa2_pallas(jq, jk, jv, causal=causal, block_q=bq,
                               block_kv=bk, return_lse=True)
    to, tlse = tfa2.fa2_forward(tq, tk, tv, causal=causal, block_q=bq,
                                block_kv=bk, return_lse=True)
    assert to.dtype == torch.float32 and tlse.shape == shape[:2]
    np.testing.assert_allclose(_np(to), _np(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(tlse), _np(jlse), atol=2e-5, rtol=0)
    # ... and the port's own oracle, exact attention in f32.
    np.testing.assert_allclose(_np(to), _np(tref.ref_fa2(tq, tk, tv,
                                                         causal=causal)),
                               atol=2e-5, rtol=0)


def test_fa2_forward_masks_padding_and_dead_rows():
    """kv_len masks padded keys; a query row that sees no key (q_offset
    pushes it before key 0) gets O = 0 and LSE = NEG_INF, as in the
    reference's kernel."""
    (jq, jk, jv), (tq, tk, tv) = _inputs((2, 128, 128, 64), "f32", seed=3)
    kw = dict(causal=True, kv_len=100, q_offset=-5)
    jo, jlse = jfa2.fa2_pallas(jq, jk, jv, return_lse=True, **kw)
    to, tlse = tfa2.fa2_forward(tq, tk, tv, return_lse=True, **kw)
    np.testing.assert_allclose(_np(to), _np(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(tlse), _np(jlse), atol=2e-5, rtol=0)
    assert np.all(_np(to)[:, :5] == 0) and np.all(_np(tlse)[:, :5] == -1e30)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_fa2_backward_matches_pallas(shape, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype, seed=1)
    bq, bk = shape[4:]
    do = np.random.default_rng(2).standard_normal(
        (shape[0], shape[1], shape[3])).astype(np.float32)
    jo, jlse = jfa2.fa2_pallas(jq, jk, jv, causal=causal, block_q=bq,
                               block_kv=bk, return_lse=True)
    want = jfa2_bwd.fa2_backward(jq, jk, jv, jo, jnp.asarray(do), jlse,
                                 causal=causal, block_q=bq, block_kv=bk)
    got = tfa2_bwd.fa2_backward(tq, tk, tv, torch.tensor(_np(jo)),
                                torch.from_numpy(do),
                                torch.tensor(_np(jlse)), causal=causal,
                                block_q=bq, block_kv=bk)
    rtol = 2.0 ** -7 if dtype == "bf16" else 0.0
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype, name
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_hfa_forward_matches_pallas(shape, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, "bf16", seed=4)
    bq, bk = shape[4:]
    jo = jhfa.hfa_pallas(jq, jk, jv, causal=causal, block_q=bq, block_kv=bk)
    to = thfa.hfa_forward(tq, tk, tv, causal=causal, block_q=bq, block_kv=bk)
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl", ["fa2_pallas", "hfa_pallas", "fa2", "exact"])
def test_multihead_attention_forward_and_grads_match_reference(impl):
    """GQA 8 query heads over 2 KV heads, length 100: both packages pad
    to 128 and mask the padding; autograd vs jax.grad of the sum of
    out * w (a fixed random cotangent)."""
    rng = np.random.default_rng(5)
    b, s, h, hkv, d = 1, 100, 8, 2, 32
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def jloss(q, k, v):
        out = jops.multihead_attention(q, k, v, impl=impl, causal=True)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, arrs))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in arrs)
    tout = tops.multihead_attention(tq, tk, tv, impl=impl, causal=True)
    torch.sum(tout * torch.from_numpy(w)).backward()
    out_tol = 1e-5 if impl == "hfa_pallas" else 1e-4
    np.testing.assert_allclose(_np(tout), _np(jout), atol=out_tol, rtol=0)
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(_np(t.grad), _np(j), atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("fn", ["quant_rail", "exp2_hfa_rail",
                                "recip_logdiv"])
def test_rail_ste_gradients_match_reference(fn):
    """Forward stays the hardware value, bit for bit; the gradient is the
    smooth surrogate's, ties at the clamp bounds included (the row max
    of attention sits at s - m = 0, where jnp.clip splits it in half)."""
    if fn == "quant_rail":
        x = np.concatenate([np.linspace(-20.0, 3.0, 2001),
                            [-15.0, 0.0, -0.0]]).astype(np.float32)
    elif fn == "exp2_hfa_rail":
        x = np.arange(-2770, 1, 7).astype(np.float32)
    else:
        x = np.geomspace(1.0, 4096.0, 2001).astype(np.float32)
    jf, tf = getattr(jbit, fn), getattr(tbit, fn)
    jy, jvjp = jax.vjp(jf, jnp.asarray(x))
    ct = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    (jg,) = jvjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tf(tx)
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(_np(ty).view(np.uint32),
                                  _np(tf(torch.from_numpy(x))).view(np.uint32))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=0)
    np.testing.assert_allclose(_np(tx.grad), _np(jg), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["hfa", "hfa_datapath"])
def test_unported_impls_raise(impl):
    """The per-element impls were refused as not ported until the port
    took them in: now they run (bf16 out, as in the reference), and only
    a name outside IMPLS raises."""
    q = torch.zeros(1, 4, 2, 64)
    out = tops.multihead_attention(q, q, q, impl=impl)
    assert out.shape == q.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown attention impl"):
        tops.multihead_attention(q, q, q, impl=impl + "_x")
