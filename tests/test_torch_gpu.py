"""Kernel checks that need the card (marker ``gpu``; they skip without
one).  Run them on the machine with the card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each paged kernel, on both rails, at small shapes against its plain
version on the same CUDA tensors (tolerances as in chip_smoke.py), and
the rail device functions bit for bit against the plain torch rail.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bitmath, cuda_lib
from repro_torch.kernels import decode as decode_k
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import paged_prefill as pp
from repro_torch.kernels import paged_verify as pv

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_rail_device_functions_bit_exact(cuda):
    x = torch.linspace(-20.0, 5.0, 100_003, device=cuda)
    rail, pexp, recip = cuda_lib.rail_eval(x)
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
