"""Kernel checks that need the card (marker ``gpu``; they skip without
one).  Run them on the machine with the card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each paged kernel, on both rails, and each dense kernel (FA-2 forward,
dq, dk/dv, H-FA forward) at small shapes against its plain version on
the same CUDA tensors (tolerances as in chip_smoke.py), and the rail
device functions of both sources bit for bit against the plain torch
rail.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bitmath, cuda_lib
from repro_torch.kernels import decode as decode_k
from repro_torch.kernels import fa2 as tfa2
from repro_torch.kernels import fa2_bwd as tfa2_bwd
from repro_torch.kernels import hfa as thfa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import paged_prefill as pp
from repro_torch.kernels import paged_verify as pv

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("source", ["paged", "dense"])
def test_rail_device_functions_bit_exact(cuda, source):
    x = torch.linspace(-20.0, 5.0, 100_003, device=cuda)
    rail, pexp, recip = cuda_lib.rail_eval(x, source)
    want = bitmath.quant_rail(x)
    assert torch.equal(rail.view(torch.int32), want.view(torch.int32))
    assert torch.equal(pexp.view(torch.int32),
                       bitmath.exp2_hfa_rail(want).view(torch.int32))
    pos = x > 0
    assert torch.equal(recip[pos].view(torch.int32),
                       bitmath.recip_logdiv(x[pos]).view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["decode", "prefill", "verify"])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_kernel_matches_plain(cuda, kind, d, dtype, use_hfa):
    rng = np.random.default_rng(d)
    g, hkv, page, j, b = 2, 2, 16, 6, 3
    num_pages = b * j + 2
    gen = torch.Generator(device=cuda).manual_seed(d)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    kp, vp = rnd(num_pages, page, hkv, d), rnd(num_pages, page, hkv, d)
    pt = torch.tensor(rng.permutation(num_pages)[:b * j].reshape(b, j),
                      dtype=torch.int32, device=cuda)

    def i32(a):
        return torch.tensor(a, dtype=torch.int32, device=cuda)

    if kind == "decode":
        args = (rnd(b, hkv, g, d), kp, vp, pt, i32([37, 0, 96]))
        fn, plain, live = pd.paged_decode_partial, \
            pd.paged_decode_partial_plain, [[1], [0], [1]]
    elif kind == "prefill":
        args = (rnd(b, hkv, g, 7, d), kp, vp, pt, i32([0, 20, 40]),
                i32([7, 23, 47]))
        fn, plain = pp.paged_prefill_partial, pp.paged_prefill_partial_plain
        live = [[1] * 7, [1] * 3 + [0] * 4, [1] * 7]
    else:
        args = (rnd(b, hkv, g, 5, d), kp, vp, pt, i32([30, 0, 90]),
                i32([5, 0, 2]))
        fn, plain = pv.paged_verify_partial, pv.paged_verify_partial_plain
        live = [[1] * 5, [0] * 5, [1, 1, 0, 0, 0]]
    before = {m: m.launches for m in (pd, pp, pv)}
    ko, km, kl = fn(*args, use_hfa=use_hfa)
    po, pm, pl_ = plain(*args, use_hfa=use_hfa)
    torch.cuda.synchronize()
    mod = {"decode": pd, "prefill": pp, "verify": pv}[kind]
    assert mod.launches == before[mod] + 1
    if kind == "decode":
        ko, po = ko[:, :, :, None], po[:, :, :, None]
        km, pm, kl, pl_ = (x[..., None] for x in (km, pm, kl, pl_))
    mask = torch.tensor(live, dtype=torch.bool, device=cuda)[:, None, None]
    mask = mask.expand(km.shape)
    assert torch.allclose(km[mask], pm[mask], atol=1e-3, rtol=0)
    kout = decode_k.finalize_decode(ko, kl, use_hfa=use_hfa)[mask]
    pout = decode_k.finalize_decode(po, pl_, use_hfa=use_hfa)[mask]
    tol = 1e-2 if use_hfa else 1e-3
    assert (kout - pout).abs().max().item() <= tol
    # Dead rows: the neutral triplet.
    dead = ~torch.tensor(live, dtype=torch.bool, device=cuda).any(-1)
    if dead.any():
        assert torch.all(kl[dead] == 0) and torch.all(ko[dead] == 0)


def _dense_inputs(cuda, dtype, d, bh=3, lq=200, lkv=320, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=cuda).to(dtype)
            for n in (lq, lkv, lkv)]


# kv_len < Lkv masks padding; q_offset 100 makes the queries a suffix.
DENSE_MASKS = dict(kv_len=300, q_offset=100)
DENSE_FWD_ATOL = 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rail", ["fa2", "hfa"])
def test_dense_forward_matches_plain(cuda, rail, causal, d, dtype):
    q, k, v = _dense_inputs(cuda, dtype, d)
    mod = tfa2 if rail == "fa2" else thfa
    before = mod.launches
    if rail == "fa2":
        ko, klse = tfa2.fa2_forward(q, k, v, causal=causal, return_lse=True,
                                    **DENSE_MASKS)
        po, plse = tfa2.fa2_forward_plain(q, k, v, causal=causal,
                                          **DENSE_MASKS)
    else:
        ko = thfa.hfa_forward(q, k, v, causal=causal, **DENSE_MASKS)
        po = thfa.hfa_forward_plain(q, k, v, causal=causal, **DENSE_MASKS)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    assert torch.isfinite(ko).all()
    # Same tiles and the same f32 score on both sides: summation order
    # only.  One rail step moves a key's weight by 0.54%, far above this.
    assert (ko - po).abs().max().item() <= DENSE_FWD_ATOL
    if rail == "fa2":
        assert (klse - plse).abs().max().item() <= DENSE_FWD_ATOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_dense_backward_matches_plain(cuda, causal, d, dtype):
    q, k, v = _dense_inputs(cuda, dtype, d, seed=1)
    o, lse = tfa2.fa2_forward_plain(q, k, v, causal=causal, **DENSE_MASKS)
    do = torch.randn(o.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(2), device=cuda)
    before = (tfa2_bwd.launches_dq, tfa2_bwd.launches_dkv)
    got = tfa2_bwd.fa2_backward(q, k, v, o, do, lse, causal=causal,
                                **DENSE_MASKS)
    delta = torch.sum(do * o, dim=-1)
    want = tfa2_bwd.fa2_backward_plain(q, k, v, do, lse, delta,
                                       causal=causal, **DENSE_MASKS)
    torch.cuda.synchronize()
    assert (tfa2_bwd.launches_dq, tfa2_bwd.launches_dkv) == (
        before[0] + 1, before[1] + 1)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype
        err = (g.float() - w).abs().max().item()
        # f32: summation order only; bf16: one rounding of the output.
        bound = 1e-4 * max(1.0, w.abs().max().item()) if dtype == \
            torch.float32 else 2.0 ** -7 * w.abs().max().item()
        assert err <= bound, (err, bound)


@pytest.mark.parametrize("impl", ["fa2_pallas", "hfa_pallas"])
def test_multihead_attention_grads_card_vs_cpu(cuda, impl):
    """Through the autograd Function: kernels on the card against the
    plain versions on the CPU, GQA 8:2 and a padded length (100).  hfa:
    a score whose f32 dot product rounds to the other bf16 neighbour on
    the card moves a rail step, and the STE gradient splits a row-max
    tie differently - held to 5e-2 of each tensor's scale, as
    chip_smoke.py holds the reduced model's gradients."""
    gen = torch.Generator().manual_seed(3)
    arrs = [torch.randn(s, generator=gen) for s in
            ((2, 100, 8, 64), (2, 100, 2, 64), (2, 100, 2, 64))]
    w = torch.randn((2, 100, 8, 64), generator=gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        x = [a.to(dev).detach().requires_grad_() for a in arrs]
        out = ops.multihead_attention(*x, impl=impl, causal=True)
        torch.sum(out * w.to(dev)).backward()
        outs[dev] = [out.detach().cpu()] + [t.grad.cpu() for t in x]
    tol = 5e-2 if impl == "hfa_pallas" else 1e-4
    for a, b in zip(outs["cuda"], outs["cpu"]):
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= tol * scale
