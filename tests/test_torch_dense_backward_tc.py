"""The tensor-core FA-2 backward's numerics, modelled on the CPU.

The kernels of ``csrc/dense_attention_bwd_tc.cu`` run only on the card
(``tests/test_torch_gpu.py`` holds them against their plain version
there).  Here :func:`tc_backward_model` models what they compute: bf16
q, k, v and dO; S and dP as exact bf16 products summed in f32; p =
exp(s·scale - LSE) in f32; dS = p·(dP - δ) from the f32 p; P and dS
rounded to bf16 before their products; f32 sums; bf16 outputs.  It is
held

(a) within 2^-7 of each tensor's max of the reference's Pallas backward
    (``repro.kernels.fa2_bwd.fa2_backward``, interpret mode) on the
    shapes and masks of ``tests/test_torch_dense_attention.py``, both fed
    the reference's own forward (O, LSE), the same bound the card check
    holds the kernels to;
(b) before the output rounding, within 2^-8 of each tensor's max of the
    f32 plain version at BH 2, L 1024, d 128, causal: what single-bf16 P
    and dS cost, below the bf16 rounding of the outputs themselves.

(c) ``ops.multihead_attention(impl="fa2_pallas")`` on bf16 inputs hands
    the backward a bf16 cotangent that holds exactly the values the f32
    one held, so the gradients on the CPU are bit for bit those of an f32
    cotangent, and within 2^-7 of each tensor's max of the reference's
    ``jax.grad`` (the reference forms δ from its bf16 O, the port from
    its f32 O).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import fa2 as jfa2
from repro.kernels import fa2_bwd as jfa2_bwd
from repro.kernels import ops as jops
from repro_torch.kernels import fa2 as tfa2
from repro_torch.kernels import fa2_bwd as tfa2_bwd
from repro_torch.kernels import ops as tops

REL_BWD = 2.0 ** -7


def tc_backward_model(q, k, v, do, lse, delta, *, causal, scale=None,
                      kv_len=None, q_offset=None):
    """(dq, dk, dv) in f32 as the tensor-core kernels form them, before
    the bf16 rounding of the outputs."""
    scale, kv_len, q_offset = tfa2._defaults(q, k, scale, kv_len, q_offset)
    qf, kf, vf, dof = (t.to(torch.bfloat16).to(torch.float32)
                       for t in (q, k, v, do))
    s = torch.einsum("bqd,bkd->bqk", qf, kf)
    q_ids = q_offset + torch.arange(q.shape[1])[:, None]
    kv_ids = torch.arange(k.shape[1])[None, :]
    mask = kv_ids < kv_len
    if causal:
        mask = mask & (kv_ids <= q_ids)
    p = torch.where(mask, torch.exp(s * scale - lse[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - delta[..., None])
    pb, dsb = (t.to(torch.bfloat16).to(torch.float32) for t in (p, ds))
    dq = torch.einsum("bqk,bkd->bqd", dsb, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", dsb, qf) * scale
    dv = torch.einsum("bqk,bqd->bkd", pb, dof)
    return dq, dk, dv


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_inputs(shape, seed):
    bh, lq, lkv, d = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((bh, lq, d), (bh, lkv, d), (bh, lkv, d), (bh, lq, d))]
    # Round once through torch so both packages see the same bf16 values.
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]


# (bh, lq, lkv, d, masks): tests/test_torch_dense_attention.py's square
# and suffix-query shapes (q_offset = Lkv - Lq > 0), its padding and
# dead-row masks (kv_len 100, q_offset -5), and the d 128 head.
CASES = {"square": (1, 128, 128, 64, {}),
         "suffix": (2, 128, 256, 64, {}),
         "padded": (2, 128, 128, 64, dict(kv_len=100, q_offset=-5)),
         "d128": (1, 128, 256, 128, dict(kv_len=200))}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_tc_model_matches_pallas_backward(case, causal):
    *shape, masks = CASES[case]
    tq, tk, tv, tdo = _bf16_inputs(shape, seed=11)
    jq, jk, jv, jdo = (jnp.asarray(_np(t), jnp.bfloat16)
                       for t in (tq, tk, tv, tdo))
    jo, jlse = jfa2.fa2_pallas(jq, jk, jv, causal=causal, return_lse=True,
                               **masks)
    want = jfa2_bwd.fa2_backward(jq, jk, jv, jo, jdo, jlse, causal=causal,
                                 **masks)
    o, lse = torch.tensor(_np(jo)), torch.tensor(_np(jlse))
    delta = torch.sum(tdo.float() * o, dim=-1)
    got = tc_backward_model(tq, tk, tv, tdo, lse, delta, causal=causal,
                            **masks)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert w.dtype == jnp.bfloat16, name
        g = _np(g.to(torch.bfloat16))
        w = _np(w)
        bound = REL_BWD * np.abs(w).max()
        assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(),
                                              bound)


def test_tc_model_error_before_rounding_within_2_pow_minus_8():
    tq, tk, tv, tdo = _bf16_inputs((2, 1024, 1024, 128), seed=12)
    o, lse = tfa2.fa2_forward_plain(tq, tk, tv, causal=True)
    delta = torch.sum(tdo.float() * o, dim=-1)
    plain = tfa2_bwd.fa2_backward_plain(tq, tk, tv, tdo, lse, delta,
                                        causal=True)
    model = tc_backward_model(tq, tk, tv, tdo, lse, delta, causal=True)
    for name, m, w in zip(("dq", "dk", "dv"), model, plain):
        err = (m - w).abs().max().item()
        top = w.abs().max().item()
        assert 0 < err <= 2.0 ** -8 * top, (name, err / top)
        # The bf16 outputs stay within the card check's bound.
        out = m.to(torch.bfloat16).float()
        assert (out - w).abs().max().item() <= REL_BWD * top, name


def test_multihead_attention_bf16_cotangent_is_exact(monkeypatch):
    rng = np.random.default_rng(13)
    b, s, h, hkv, d = 1, 100, 8, 2, 64
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    seen = []
    plain = tfa2_bwd.fa2_backward

    def spy(q, k, v, o, do, lse, **kw):
        seen.append(do)
        return plain(q, k, v, o, do, lse, **kw)

    def torch_grads(widen):
        def backward(q, k, v, o, do, lse, **kw):
            return spy(q, k, v, o, do.float() if widen else do, lse, **kw)
        monkeypatch.setattr(tfa2_bwd, "fa2_backward", backward)
        x = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
             for a in arrs]
        out = tops.multihead_attention(*x, impl="fa2_pallas", causal=True)
        torch.sum(out * torch.from_numpy(w)).backward()
        return out, [t.grad for t in x]

    out, grads = torch_grads(widen=False)
    do = seen[-1]
    assert do.dtype == torch.bfloat16 and do.shape == (b * h, 128, d)
    rows = do.view(b, h, 128, d)
    assert torch.equal(rows[:, :, :s].transpose(1, 2),
                       torch.from_numpy(w).to(torch.bfloat16))
    assert torch.all(rows[:, :, s:] == 0)
    # The same gradients as with the f32 cotangent, bit for bit.
    _, f32_grads = torch_grads(widen=True)
    assert seen[-1].dtype == torch.float32
    for g, f in zip(grads, f32_grads):
        assert g.dtype == torch.bfloat16 and torch.equal(g, f)

    def jloss(q, k, v):
        o = jops.multihead_attention(q, k, v, impl="fa2_pallas", causal=True)
        return jnp.sum(o * w), o

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs))
    assert jout.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jout), atol=2.0 ** -7, rtol=0)
    for name, t, j in zip("qkv", grads, jgrads):
        j = _np(j)
        bound = REL_BWD * np.abs(j).max()
        assert np.abs(_np(t) - j).max() <= bound, f"d{name}"
