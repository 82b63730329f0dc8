"""Kernel checks that need the card (marker ``gpu``; they skip without
one).  Run them on the machine with the card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each paged kernel, on both rails and on each route (decode and verify:
the v2 kernel and the CUDA-core one; prefill: the tensor cores for bf16
at d 64 / 128 and the CUDA cores), at d 32, 64, 96 and 128, and each
dense kernel (FA-2 forward,
dq, dk/dv, H-FA forward - on f32 inputs the CUDA-core forward, on bf16
the tensor-core one; the backward on the CUDA cores for an f32
cotangent, on the tensor cores for bf16 inputs and cotangent - the dense
decode on both rails, the per-element LNS datapath) at small shapes
against its plain version on the same
CUDA tensors (tolerances as in chip_smoke.py), and the rail and LNS
device functions of every source (the tensor-core forward's integer
form too) bit for bit against the plain torch versions.  The dense
kernels run at d 32 and 96 too (the tensor-core ones on inputs
zero-padded to 64 and 128).  The v2 decode and verify unsplit are
bit-equal to the CUDA-core decode and verify on both rails (verify in one
block of its G K rows and in one block a query head), and split within
1e-5 of it, the merge counters back at zero after each split launch; a
verify of more than 16 rows goes to the CUDA cores; the dense decode
(strided ring, split on the FA-2 rail) is held to its plain version, its
split to its unsplit walk and its model, and on a dyadic grid the H-FA
rail to the plain 128-key walk, and it refuses a misaligned ring; the
tensor-core prefill on a dyadic grid is within 1e-5 of the CUDA-core one
on the H-FA rail; the launch counters count by route; every entry
refuses a head dim outside (32, 64, 96, 128).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitmath, cuda_lib
from repro_torch.kernels import decode as decode_k
from repro_torch.kernels import fa2 as tfa2
from repro_torch.kernels import fa2_bwd as tfa2_bwd
from repro_torch.kernels import hfa as thfa
from repro_torch.kernels import hfa_datapath as dp_k
from repro_torch.kernels import ops
from repro_torch.kernels import page_codec
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import paged_prefill as pp
from repro_torch.kernels import paged_verify as pv
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("source", ["paged", "dense", "dense_tc", "decode"])
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


def _paged_counts():
    return {k: dict(v) for k, v in cuda_lib.paged_launches.items()}


def _paged_pools(cuda, dtype, d, b=3, j=6, hkv=2, page=16, seed=None,
                 dyadic=False):
    """Shuffled bf16 / f32 pools and page table on the card."""
    seed = d if seed is None else seed
    rng = np.random.default_rng(seed)
    num_pages = b * j + 2
    gen = torch.Generator(device=cuda).manual_seed(seed)
    shape = (num_pages, page, hkv, d)
    kp = (thfa.dyadic_bf16(shape, gen, cuda, bound=0.5) if dyadic else
          torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    vp = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    pt = torch.tensor(rng.permutation(num_pages)[:b * j].reshape(b, j),
                      dtype=torch.int32, device=cuda)
    return kp, vp, pt, gen


def _i32(cuda, a):
    return torch.tensor(a, dtype=torch.int32, device=cuda)


def _prefill_simt(q, kp, vp, pt, start, kv_lens, use_hfa=False):
    """The paged prefill on the CUDA-core kernel, for the checks (the
    wrapper's rule picks the tensor cores for bf16 at d 64 / 128)."""
    return cuda_lib.launch_paged(
        "paged_prefill_fwd", q, kp, vp, pt, start, kv_lens,
        scale=q.shape[-1] ** -0.5, use_hfa=use_hfa)


def _decode_split(q, kp, vp, pt, kv_lens, splits, use_hfa=False):
    """The v2 paged decode with its walk split into ``splits`` runs (1:
    unsplit), for the checks."""
    return cuda_lib.launch_paged_decode(
        q, kp, vp, pt, kv_lens, scale=q.shape[-1] ** -0.5, use_hfa=use_hfa,
        splits=splits)


@pytest.mark.parametrize("route", ["default", "simt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("kind", ["decode", "prefill", "verify"])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_kernel_matches_plain(cuda, kind, d, dtype, use_hfa, route):
    """Each paged kernel against its plain version: route "default" is
    the wrapper's own (decode and verify: v2; prefill: the tensor cores
    for bf16 at d 64 / 128, else the CUDA cores), "simt" the CUDA-core
    kernel."""
    g, hkv, b = 2, 2, 3
    kp, vp, pt, gen = _paged_pools(cuda, dtype, d, b=b, hkv=hkv)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    i32 = lambda a: _i32(cuda, a)  # noqa: E731
    if kind == "decode":
        args = (rnd(b, hkv, g, d), kp, vp, pt, i32([37, 0, 96]))
        fn = pd.paged_decode_partial if route == "default" else \
            pd.paged_decode_partial_simt
        plain, live = pd.paged_decode_partial_plain, [[1], [0], [1]]
        key = ("decode", "v2" if route == "default" else "simt")
    elif kind == "prefill":
        args = (rnd(b, hkv, g, 7, d), kp, vp, pt, i32([0, 20, 40]),
                i32([7, 23, 47]))
        rule = cuda_lib.paged_prefill_route(args[0], kp, pt)
        fn = pp.paged_prefill_partial if route == "default" else \
            _prefill_simt
        plain = pp.paged_prefill_partial_plain
        live = [[1] * 7, [1] * 3 + [0] * 4, [1] * 7]
        key = ("prefill", rule if route == "default" else "simt")
        assert rule == ("tc" if dtype == torch.bfloat16 and d in (64, 128)
                        else "simt")
    else:
        args = (rnd(b, hkv, g, 5, d), kp, vp, pt, i32([30, 0, 90]),
                i32([5, 0, 2]))
        fn = pv.paged_verify_partial if route == "default" else \
            pv.paged_verify_partial_simt
        plain = pv.paged_verify_partial_plain
        live = [[1] * 5, [0] * 5, [1, 1, 0, 0, 0]]
        key = ("verify", "v2" if route == "default" else "simt")
    before, mods = _paged_counts(), {m: m.launches for m in (pd, pp, pv)}
    ko, km, kl = fn(*args, use_hfa=use_hfa)
    po, pm, pl_ = plain(*args, use_hfa=use_hfa)
    torch.cuda.synchronize()
    before[key[0]][key[1]] += 1
    assert _paged_counts() == before
    # The wrappers count their own launches; the checks' forced routes not.
    counted = {"decode": pd, "prefill": pp, "verify": pv}[kind]
    if route == "simt":
        counted = None
    assert {m: m.launches for m in mods} == {
        m: c + (m is counted) for m, c in mods.items()}
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


def _decode_case(cuda, dtype, d, g=2, seed=None):
    """Decode inputs at a walk long enough to split: B 4 (a free slot,
    a slot shorter than one 64-key step), Hkv 2, J 12 pages of 16."""
    kp, vp, pt, gen = _paged_pools(cuda, dtype, d, b=4, j=12, seed=seed)
    q = torch.randn((4, 2, g, d), generator=gen, device=cuda).to(dtype)
    return q, kp, vp, pt, _i32(cuda, [150, 0, 192, 9])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_decode_v2_unsplit_bit_equal_to_simt(cuda, use_hfa, g, d, dtype):
    """The v2 decode keeps the CUDA-core kernel's arithmetic order, so
    its unsplit walk gives the same triplet bit for bit, both rails."""
    args = _decode_case(cuda, dtype, d, g)
    got = _decode_split(*args, 1, use_hfa=use_hfa)
    want = pd.paged_decode_partial_simt(*args, use_hfa=use_hfa)
    torch.cuda.synchronize()
    for name, a, w in zip(("o", "m", "l"), got, want):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32)), name


@pytest.mark.parametrize("splits", [2, 3, 5, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_decode_v2_split_matches_unsplit(cuda, d, dtype, splits):
    """FA-2 rail: the page walk split into runs and merged by Eq. 16 in
    the kernel - within 1e-5 of the unsplit walk after finalize, m
    exact (the same scores), no NaN where a run holds no key (16 splits
    of a walk of at most 12 tiles), and the counters left at zero for
    the next launch (a second launch agrees bit for bit)."""
    args = _decode_case(cuda, dtype, d, seed=d + splits)
    o1, m1, l1 = _decode_split(*args, 1)
    o2, m2, l2 = _decode_split(*args, splits)
    o3, m3, l3 = _decode_split(*args, splits)
    torch.cuda.synchronize()
    assert torch.isfinite(o2).all() and torch.isfinite(l2).all()
    assert torch.equal(m1, m2)
    assert (decode_k.finalize_decode(o2, l2) -
            decode_k.finalize_decode(o1, l1)).abs().max().item() <= 1e-5
    assert torch.equal(o2, o3) and torch.equal(l2, l3)
    assert all(int(c.count_nonzero()) == 0
               for c in cuda_lib._counters.values())
    assert torch.all(l2[1] == 0) and torch.all(o2[1] == 0) \
        and torch.all(m2[1] == -1e30)
    want = ref.paged_decode_split_model(*args, splits=splits)
    assert (decode_k.finalize_decode(o2, l2) - decode_k.finalize_decode(
        want[0], want[2])).abs().max().item() <= 1e-5


def _verify_case(cuda, dtype, d, g=2, seed=None):
    """Verify inputs at a walk long enough to split: B 4 (a free slot, a
    slot shorter than one 64-key step, ragged chunks), Hkv 2, K 5, J 12
    pages of 16."""
    kp, vp, pt, gen = _paged_pools(cuda, dtype, d, b=4, j=12, seed=seed)
    q = torch.randn((4, 2, g, 5, d), generator=gen, device=cuda).to(dtype)
    return (q, kp, vp, pt, _i32(cuda, [150, 0, 185, 4]),
            _i32(cuda, [5, 0, 3, 5]))


def _verify_v2(q, kp, vp, pt, seq_lens, chunk_lens, splits, row_blocks,
               use_hfa=False):
    return cuda_lib.launch_paged_verify(
        q, kp, vp, pt, seq_lens, chunk_lens, scale=q.shape[-1] ** -0.5,
        use_hfa=use_hfa, splits=splits, row_blocks=row_blocks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_verify_v2_unsplit_bit_equal_to_simt(cuda, use_hfa, g, d, dtype):
    """The v2 verify keeps the CUDA-core kernel's arithmetic order and a
    causal limit per row, so its unsplit walk gives the same triplet bit
    for bit on both rails - with all G K rows (5, 10, 15) in one block
    and with one block a query head (the H-FA rail's grid)."""
    args = _verify_case(cuda, dtype, d, g)
    want = pv.paged_verify_partial_simt(*args, use_hfa=use_hfa)
    for row_blocks in (1, g):
        got = _verify_v2(*args, 1, row_blocks, use_hfa=use_hfa)
        torch.cuda.synchronize()
        for name, a, w in zip(("o", "m", "l"), got, want):
            assert torch.equal(a.view(torch.int32), w.view(torch.int32)), \
                (name, row_blocks)


@pytest.mark.parametrize("splits", [2, 3, 5, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_verify_v2_split_matches_unsplit(cuda, d, dtype, splits):
    """FA-2 rail: the verify walk split into runs and merged by Eq. 16 in
    the kernel - within 1e-5 of the unsplit walk after finalize, m exact,
    no NaN where a run holds no key, the counters left at zero (a second
    launch agrees bit for bit), the free slot the neutral triplet, and
    within 1e-5 of its plain model (kernels/ref.py)."""
    args = _verify_case(cuda, dtype, d, seed=d + splits)
    o1, m1, l1 = _verify_v2(*args, 1, 1)
    o2, m2, l2 = _verify_v2(*args, splits, 1)
    o3, m3, l3 = _verify_v2(*args, splits, 1)
    torch.cuda.synchronize()
    assert torch.isfinite(o2).all() and torch.isfinite(l2).all()
    assert torch.equal(m1, m2)
    assert (decode_k.finalize_decode(o2, l2) -
            decode_k.finalize_decode(o1, l1)).abs().max().item() <= 1e-5
    assert torch.equal(o2, o3) and torch.equal(l2, l3)
    assert all(int(c.count_nonzero()) == 0
               for c in cuda_lib._counters.values())
    assert torch.all(l2[1] == 0) and torch.all(o2[1] == 0) \
        and torch.all(m2[1] == -1e30)
    want = ref.paged_verify_split_model(*args, splits=splits)
    live = (torch.arange(5, device=cuda)[None] < args[5][:, None])
    mask = live[:, None, None].expand(m2.shape)
    assert (decode_k.finalize_decode(o2, l2)[mask] - decode_k.finalize_decode(
        want[0], want[2])[mask]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_verify_over_16_rows_goes_to_the_cuda_cores(cuda, use_hfa):
    """G K = 20 rows: the route rule sends the verify to paged_verify_fwd,
    counted as "simt", within the tolerances of its plain version."""
    args = _verify_case(cuda, torch.bfloat16, 128, g=4)
    assert cuda_lib.paged_verify_route(4, 5, 16, use_hfa) == "simt"
    before = _paged_counts()["verify"]
    ko, km, kl = pv.paged_verify_partial(*args, use_hfa=use_hfa)
    po, pm, pl_ = pv.paged_verify_partial_plain(*args, use_hfa=use_hfa)
    torch.cuda.synchronize()
    assert _paged_counts()["verify"] == {"v2": before["v2"],
                                         "simt": before["simt"] + 1}
    live = (torch.arange(5, device=cuda)[None] < args[5][:, None])
    mask = live[:, None, None].expand(km.shape)
    assert (km - pm)[mask].abs().max().item() <= 1e-3
    err = (decode_k.finalize_decode(ko, kl, use_hfa=use_hfa) -
           decode_k.finalize_decode(po, pl_, use_hfa=use_hfa))[mask]
    assert err.abs().max().item() <= (1e-2 if use_hfa else 1e-3)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_prefill_tc_dyadic_matches_simt(cuda, use_hfa, d, g):
    """The tensor-core prefill on a dyadic grid within +-0.5 - every
    score and every page's sum of p exact in any order, and on the H-FA
    rail every p exact in bf16 - within 1e-5 of the CUDA-core kernel
    after finalize, m exact, over a 200-token chunk from 0, a ragged
    137-token chunk at start_pos 230 and a free slot, and within 1e-5 of
    its plain model (kernels/ref.py)."""
    b, hkv, ell = 3, 2, 200
    kp, vp, pt, gen = _paged_pools(cuda, torch.bfloat16, d, b=b, j=30,
                                   hkv=hkv, dyadic=True, seed=g)
    q = thfa.dyadic_bf16((b, hkv, g, ell, d), gen, cuda, bound=0.5)
    start, chunk = _i32(cuda, [0, 230, 0]), _i32(cuda, [200, 137, 0])
    args = (q, kp, vp, pt, start, start + chunk)
    before = _paged_counts()
    tc = pp.paged_prefill_partial(*args, use_hfa=use_hfa)
    simt = _prefill_simt(*args, use_hfa=use_hfa)
    model = ref.paged_prefill_tc_model(*args, use_hfa=use_hfa)
    torch.cuda.synchronize()
    after = _paged_counts()["prefill"]
    assert after == {"tc": before["prefill"]["tc"] + 1,
                     "simt": before["prefill"]["simt"] + 1}
    live = (torch.arange(ell, device=cuda)[None] < chunk[:, None])
    mask = live[:, None, None].expand(tc[1].shape)
    outs = [decode_k.finalize_decode(o, l, use_hfa=use_hfa)[mask]
            for o, _, l in (tc, simt, model)]
    assert torch.isfinite(outs[0]).all()
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-5
    assert (outs[0] - outs[2]).abs().max().item() <= 1e-5
    assert torch.equal(tc[1][mask], simt[1][mask])
    assert torch.all(tc[2][2] == 0) and torch.all(tc[0][2] == 0) \
        and torch.all(tc[1][2] == -1e30)


@pytest.mark.parametrize("page", [3, 4, 32, 128, 256])
@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
def test_hfa_paged_rescales_once_a_page(cuda, kind, page):
    """On the H-FA rail at a page size other than 16 every paged call goes
    to the CUDA-core body (counted as "simt"), which rescales once a page
    as the reference does: on a dyadic grid within +-0.5 (every score and
    every page's sum of p exact) within 1e-5 of the per-page model
    (kernels/ref.py) after finalize, m bit for bit, bf16 pools at d 128
    (pages 32, 128 and 256: the page kernel, which stages a page 64 keys
    at a time and keeps its scores in shared memory)."""
    b, hkv, g, d = 3, 2, 2, 128
    kp, vp, pt, gen = _paged_pools(cuda, torch.bfloat16, d, b=b,
                                   j=-(-160 // page), hkv=hkv, page=page,
                                   dyadic=True, seed=page)
    i32 = lambda a: _i32(cuda, a)  # noqa: E731
    if kind == "decode":
        q = thfa.dyadic_bf16((b, hkv, g, d), gen, cuda, bound=0.5)
        args = (q, kp, vp, pt, i32([150, 0, 37]))
        want = ref.paged_decode_split_model(*args, splits=1, use_hfa=True)
        live = torch.tensor([True, False, True], device=cuda)[:, None, None]
    elif kind == "verify":
        q = thfa.dyadic_bf16((b, hkv, g, 5, d), gen, cuda, bound=0.5)
        args = (q, kp, vp, pt, i32([140, 0, 60]), i32([5, 0, 3]))
        want = ref.paged_verify_split_model(*args, splits=1, use_hfa=True)
        live = (torch.arange(5, device=cuda)[None] <
                args[5][:, None])[:, None, None]
    else:
        q = thfa.dyadic_bf16((b, hkv, g, 40, d), gen, cuda, bound=0.5)
        start, chunk = i32([0, 0, 101]), i32([40, 0, 17])
        args = (q, kp, vp, pt, start, start + chunk)
        want = ref.paged_prefill_model(*args, use_hfa=True)
        live = (torch.arange(40, device=cuda)[None] <
                chunk[:, None])[:, None, None]
    before = _paged_counts()
    got = {"decode": pd.paged_decode_partial, "verify":
           pv.paged_verify_partial, "prefill": pp.paged_prefill_partial}[
        kind](*args, use_hfa=True)
    torch.cuda.synchronize()
    before[kind]["simt"] += 1
    assert _paged_counts() == before
    mask = live.expand(got[1].shape)
    out = decode_k.finalize_decode(got[0], got[2], use_hfa=True)[mask]
    assert torch.isfinite(out).all()
    assert (out - decode_k.finalize_decode(want[0], want[2], use_hfa=True)[
        mask]).abs().max().item() <= 1e-5
    assert torch.equal(got[1][mask], want[1][mask])
    dead = ~live.reshape(b, -1).any(-1)
    assert torch.all(got[2][dead] == 0) and torch.all(got[0][dead] == 0)


def test_hfa_paged_page_above_64_is_refused(cuda):
    """Pages above 64 run on the H-FA rail up to the shared-memory
    ceiling (cuda_lib.HFA_MAX_PAGE); a page above it is refused before
    any launch."""
    page = 2 * cuda_lib.HFA_MAX_PAGE
    kp, vp, pt, gen = _paged_pools(cuda, torch.bfloat16, 64, page=page,
                                   b=3, j=1)
    q = torch.randn((3, 2, 2, 64), generator=gen, device=cuda).to(
        torch.bfloat16)
    before = _paged_counts()
    with pytest.raises(ValueError, match="rescales once a page"):
        pd.paged_decode_partial(q, kp, vp, pt, _i32(cuda, [5, 0, 9]),
                                use_hfa=True)
    assert _paged_counts() == before
    kp, vp, pt, gen = _paged_pools(cuda, torch.bfloat16, 64, b=3, j=1,
                                   page=cuda_lib.HFA_MAX_PAGE)
    o, m, l = pd.paged_decode_partial(q, kp, vp, pt,
                                      _i32(cuda, [2000, 0, 9]), use_hfa=True)
    torch.cuda.synchronize()
    before["decode"]["simt"] += 1
    assert _paged_counts() == before and torch.isfinite(o).all()


def test_paged_entries_refuse_other_head_dims(cuda):
    """Every paged entry, and the dense and decode kernels, refuse a
    head dim outside (32, 64, 96, 128) with a clear message and launch
    nothing."""
    before = _paged_counts()
    for d in (16, 48, 160):
        kp, vp, pt, gen = _paged_pools(cuda, torch.bfloat16, d)
        q4 = torch.randn((3, 2, 2, d), generator=gen, device=cuda).to(
            torch.bfloat16)
        q5 = q4[:, :, :, None].contiguous()
        lens = _i32(cuda, [5, 0, 9])
        calls = (lambda: pd.paged_decode_partial(q4, kp, vp, pt, lens),
                 lambda: pd.paged_decode_partial_simt(q4, kp, vp, pt, lens),
                 lambda: pp.paged_prefill_partial(q5, kp, vp, pt, lens, lens),
                 lambda: _prefill_simt(q5, kp, vp, pt, lens, lens),
                 lambda: pv.paged_verify_partial(q5, kp, vp, pt, lens, lens),
                 lambda: tfa2.fa2_forward(*[q4[:, 0]] * 3),
                 lambda: thfa.hfa_forward(*[q4[:, 0].float()] * 3),
                 lambda: decode_k.decode_partial(q4, q4, q4),
                 lambda: dp_k.hfa_datapath(*[q4[:, 0]] * 3))
        for call in calls:
            with pytest.raises(ValueError, match="head dim"):
                call()
    assert _paged_counts() == before


def _dense_inputs(cuda, dtype, d, bh=3, lq=200, lkv=320, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=cuda).to(dtype)
            for n in (lq, lkv, lkv)]


# kv_len < Lkv masks padding; q_offset 100 makes the queries a suffix.
DENSE_MASKS = dict(kv_len=300, q_offset=100)
DENSE_FWD_ATOL = 1e-5
# (bh, lq, lkv, masks) of the forward cases: the masks above; the
# dense-serve prefill geometry (Lq = Lkv = 512); dead rows (q_offset -5
# puts rows 0..4 before key 0, kv_len 100 masks the rest of the keys).
FWD_GEOMETRY = {"masks": (3, 200, 320, DENSE_MASKS),
                "prefill": (2, 512, 512, {}),
                "dead": (2, 128, 128, dict(kv_len=100, q_offset=-5))}


@pytest.mark.parametrize("geometry", list(FWD_GEOMETRY))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rail", ["fa2", "hfa"])
def test_dense_forward_matches_plain(cuda, rail, causal, d, dtype, geometry):
    """f32 inputs (the CUDA-core kernel) and fa2 on bf16 inputs (the
    tensor-core kernel): O and LSE within 1e-5 of the plain version -
    the same f32 scores summed in another order, and on the tensor cores
    P V on p split into bf16 hi + lo.  hfa on bf16 inputs: a score near
    a bf16 tie can round to the other neighbour under another summation
    order, which moves that key's weight by a rail step (0.54%), so the
    kernel is held (2) on a dyadic grid, where no summation order can
    move a score, and (3) on random inputs through the scores-out
    variant: its scores within one bf16 ulp of the plain f32 scores, O
    within 1e-5 of the plain walk fed those scores.  (A sum l of p near a
    LogDiv rounding boundary can also land on the other side under
    another order; on the dyadic grid at bound 0.5 every tile's sum is
    exact.)"""
    bh, lq, lkv, masks = FWD_GEOMETRY[geometry]
    q, k, v = _dense_inputs(cuda, dtype, d, bh=bh, lq=lq, lkv=lkv)
    mod = tfa2 if rail == "fa2" else thfa
    before = mod.launches
    variants = dict(cuda_lib.dense_fwd_launches)
    kw = dict(causal=causal, **masks)
    if rail == "fa2":
        ko, klse = tfa2.fa2_forward(q, k, v, return_lse=True, **kw)
        po, plse = tfa2.fa2_forward_plain(q, k, v, **kw)
    elif dtype == torch.float32:
        ko = thfa.hfa_forward(q, k, v, **kw)
        po = thfa.hfa_forward_plain(q, k, v, **kw)
    else:
        gen = torch.Generator(device=cuda).manual_seed(d)
        qa = thfa.dyadic_bf16(q.shape, gen, cuda, bound=0.5)
        ka = thfa.dyadic_bf16(k.shape, gen, cuda, bound=0.5)
        ko = thfa.hfa_forward(qa, ka, v, **kw)
        po = thfa.hfa_forward_plain(qa, ka, v, **kw)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    kernel = "tc" if dtype == torch.bfloat16 else "simt"
    assert cuda_lib.dense_fwd_launches[kernel] == variants[kernel] + 1
    assert torch.isfinite(ko).all()
    # Same tiles, and scores that are the same products: summation order
    # only.  One rail step moves a key's weight by 0.54%, far above this.
    assert (ko - po).abs().max().item() <= DENSE_FWD_ATOL
    if rail == "fa2":
        assert (klse - plse).abs().max().item() <= DENSE_FWD_ATOL
    if rail == "hfa" and dtype == torch.bfloat16:
        so, s = thfa.hfa_forward_scores(q, k, v, **kw)
        ho = thfa.hfa_forward(q, k, v, **kw)
        walk = thfa.hfa_forward_plain_from_scores(s, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(so, ho)
        assert (ho - walk).abs().max().item() <= DENSE_FWD_ATOL
        n_vis, _, n_beyond, _, _ = thfa.score_errors(q, k, s, **kw)
        assert n_vis > 0 and n_beyond == 0
    if geometry == "dead" and causal:
        assert torch.all(ko[:, :5] == 0)
        if rail == "fa2":
            assert torch.all(klse[:, :5] == -1e30)


def test_dense_forward_tc_refuses_what_it_cannot_take(cuda):
    """bf16 inputs go to the tensor-core kernel and nowhere else: what it
    cannot take raises, with no launch on either kernel."""
    before = dict(cuda_lib.dense_fwd_launches)
    q, k, v = _dense_inputs(cuda, torch.bfloat16, 64, bh=1, lq=128,
                            lkv=128)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    odd = flat[1:].view(q.shape)                       # 2-byte aligned
    odd.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa2.fa2_forward(odd, k, v, causal=True)
    d48 = [t[..., :48].contiguous() for t in (q, k, v)]
    with pytest.raises(ValueError, match="head dim"):
        thfa.hfa_forward(*d48, causal=True)
    with pytest.raises(ValueError, match="bf16 CUDA"):
        thfa.hfa_forward_scores(*(t.float() for t in (q, k, v)))
    assert cuda_lib.dense_fwd_launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
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


@pytest.mark.parametrize("geometry", list(FWD_GEOMETRY))
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_dense_forward_f32_hfa_matches_plain_on_exact_sums(cuda, causal, d,
                                                          geometry):
    """The CUDA-core H-FA forward (f32 inputs) on a dyadic grid within
    +-0.5, where every score and every tile's sum of p is exact in any
    order: O within 1e-5 of the plain version, as check (2) holds the
    tensor-core kernel.  The running sum l is rounded twice, as the plain
    version rounds it; contracted to one FMA, a last-bit difference in l
    can cross a LogDiv rounding boundary and move a row by a rail step
    (0.54%)."""
    bh, lq, lkv, masks = FWD_GEOMETRY[geometry]
    gen = torch.Generator(device=cuda).manual_seed(d)
    qa = thfa.dyadic_bf16((bh, lq, d), gen, cuda, bound=0.5).float()
    ka = thfa.dyadic_bf16((bh, lkv, d), gen, cuda, bound=0.5).float()
    v = torch.randn((bh, lkv, d), generator=gen, device=cuda)
    before = dict(cuda_lib.dense_fwd_launches)
    ko = thfa.hfa_forward(qa, ka, v, causal=causal, **masks)
    po = thfa.hfa_forward_plain(qa, ka, v, causal=causal, **masks)
    torch.cuda.synchronize()
    assert cuda_lib.dense_fwd_launches == dict(before,
                                               simt=before["simt"] + 1)
    assert torch.isfinite(ko).all()
    assert (ko - po).abs().max().item() <= DENSE_FWD_ATOL


# (bh, lq, lkv, masks) of the tensor-core backward cases: whole 128-row
# blocks; ragged (L not a multiple of 64 or 128, kv_len < Lkv, q_offset
# > 0); dead rows (q_offset -5, LSE = NEG_INF); lengths below one block.
BWD_TC_GEOMETRY = {"square": (2, 256, 256, {}),
                   "ragged": (3, 200, 320, DENSE_MASKS),
                   "dead": (2, 128, 128, dict(kv_len=100, q_offset=-5)),
                   "short": (2, 100, 100, {})}


def _bwd_counts():
    return dict(cuda_lib.dense_dq_launches), dict(cuda_lib.dense_dkv_launches)


@pytest.mark.parametrize("geometry", list(BWD_TC_GEOMETRY))
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_dense_backward_tc_matches_plain(cuda, causal, d, geometry):
    """bf16 inputs and a bf16 cotangent: the tensor-core dq and dk/dv,
    each within 2^-7 of its tensor's max of the plain version (P and dS
    enter their products as bf16, the outputs are bf16), one launch each
    on the tensor-core route and none on the CUDA-core one."""
    bh, lq, lkv, masks = BWD_TC_GEOMETRY[geometry]
    q, k, v = _dense_inputs(cuda, torch.bfloat16, d, bh=bh, lq=lq, lkv=lkv,
                            seed=1)
    o, lse = tfa2.fa2_forward_plain(q, k, v, causal=causal, **masks)
    do = torch.randn(o.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(2), device=cuda).to(torch.bfloat16)
    dq0, dkv0 = _bwd_counts()
    got = tfa2_bwd.fa2_backward(q, k, v, o, do, lse, causal=causal, **masks)
    delta = torch.sum(do.float() * o, dim=-1)
    want = tfa2_bwd.fa2_backward_plain(q, k, v, do, lse, delta,
                                       causal=causal, **masks)
    torch.cuda.synchronize()
    assert _bwd_counts() == (dict(dq0, tc=dq0["tc"] + 1),
                             dict(dkv0, tc=dkv0["tc"] + 1))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        assert torch.isfinite(g.float()).all(), name
        err = (g.float() - w).abs().max().item()
        bound = 2.0 ** -7 * w.abs().max().item()
        assert err <= bound, (name, err, bound)
    if geometry == "dead" and causal:
        assert torch.all(got[0][:, :5] == 0)


def test_dense_backward_tc_refuses_what_it_cannot_take(cuda):
    """The tensor-core backward raises a ValueError before any launch on
    what it cannot take - unaligned tensors, a head dim other than 64 or
    128, an f32 cotangent at its own entry - and fa2_backward does not
    fall back to the CUDA cores when it raises."""
    q, k, v = _dense_inputs(cuda, torch.bfloat16, 64, bh=1, lq=128,
                            lkv=128)
    o, lse = tfa2.fa2_forward_plain(q, k, v, causal=True)
    do = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    delta = torch.sum(do.float() * o, dim=-1)
    kw = dict(causal=True, scale=64 ** -0.5, kv_len=128, q_offset=0)

    def unaligned(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        out = flat[1:].view(x.shape)
        out.copy_(x)
        return out

    before = _bwd_counts(), tfa2_bwd.launches_dq, tfa2_bwd.launches_dkv
    d32 = [t[..., :32].contiguous() for t in (q, k, v, do)]
    for launch in (cuda_lib.launch_dense_dq_tc, cuda_lib.launch_dense_dkv_tc):
        with pytest.raises(ValueError, match="16-byte aligned"):
            launch(unaligned(q), k, v, do, lse, delta, **kw)
        with pytest.raises(ValueError, match="16-byte aligned"):
            launch(q, k, v, do, unaligned(lse), delta, **kw)
        with pytest.raises(ValueError, match="head dim"):
            launch(*d32, lse, delta, **kw)
        with pytest.raises(ValueError, match="do must be"):
            launch(q, k, v, do.float(), lse, delta, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa2_bwd.fa2_backward(q, k, unaligned(v), o, do, lse, causal=True)
    assert (_bwd_counts(), tfa2_bwd.launches_dq,
            tfa2_bwd.launches_dkv) == before


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


# ------------------------------------------------ dense decode, datapath
def _ring(cuda, dtype, d, b=3, s_len=300, hkv=2, g=2, seed=4):
    """q (B, Hkv, G, d) and a ring (B, S, Hkv, d) seen as (B, Hkv, S, d),
    as ``ops.decode_attention`` hands them to the kernel."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)
    ring_k, ring_v = rnd(b, s_len, hkv, d), rnd(b, s_len, hkv, d)
    return rnd(b, hkv, g, d), ring_k.transpose(1, 2), ring_v.transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("kv_len", [0, 1, 77, 130, 300])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_dense_decode_matches_plain(cuda, use_hfa, kv_len, d, dtype):
    """The kernel reads the ring in place (strided, S = 300 not a tile
    multiple; split on the FA-2 rail as the wrapper's rule splits it)
    against the plain version.  fa2: summation order only - the
    finalized output within 2e-5, o~ and l within 2e-5 of their scale
    (l sums up to ~50 here, where 2e-5 absolute is a few f32 ulps of a
    sum taken in another order), m within 2e-6.  hfa: the plain
    version's cuBLAS dot products round differently, and a score that
    lands on the other side of a rail step moves that key's p by 0.54%,
    so the finalized output is held to 1e-2 and m to 2e-6."""
    q, k, v = _ring(cuda, dtype, d)
    before = decode_k.launches
    ko, km, kl = decode_k.decode_partial(q, k, v, kv_len=kv_len,
                                         use_hfa=use_hfa)
    po, pm, pl_ = decode_k.decode_partial_plain(q, k, v, kv_len=kv_len,
                                                use_hfa=use_hfa)
    torch.cuda.synchronize()
    assert decode_k.launches == before + 1
    assert (km - pm).abs().max().item() <= 2e-6
    kout = decode_k.finalize_decode(ko, kl, use_hfa=use_hfa)
    pout = decode_k.finalize_decode(po, pl_, use_hfa=use_hfa)
    assert (kout - pout).abs().max().item() <= (1e-2 if use_hfa else 2e-5)
    if not use_hfa:
        for got, want in ((ko, po), (kl, pl_)):
            scale = max(1.0, want.abs().max().item())
            assert (got - want).abs().max().item() <= 2e-5 * scale
    if kv_len == 0:
        assert torch.all(kl == 0) and torch.all(ko == 0)


@pytest.mark.parametrize("splits", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_dense_decode_split_matches_unsplit(cuda, d, dtype, splits):
    """FA-2 rail: the dense walk (kv_len 290: three 128-key tiles) split
    into runs merged by Eq. 16 in the kernel - within 1e-5 of one walk
    after finalize, m exact, no NaN where a run holds no tile (8 runs),
    the counters left at zero, and within 1e-5 of its plain model."""
    q, k, v = _ring(cuda, dtype, d, seed=d + splits)

    def run(n):
        return cuda_lib.launch_dense_decode(q, k, v, scale=d ** -0.5,
                                            kv_len=290, use_hfa=False,
                                            splits=n)
    (o1, m1, l1), (o2, m2, l2), (o3, _, l3) = run(1), run(splits), run(splits)
    torch.cuda.synchronize()
    assert torch.isfinite(o2).all() and torch.equal(m1, m2)
    assert (decode_k.finalize_decode(o2, l2) -
            decode_k.finalize_decode(o1, l1)).abs().max().item() <= 1e-5
    assert torch.equal(o2, o3) and torch.equal(l2, l3)
    assert all(int(c.count_nonzero()) == 0
               for c in cuda_lib._counters.values())
    want = ref.dense_decode_split_model(q, k, v, kv_len=290, splits=splits)
    assert (decode_k.finalize_decode(o2, l2) - decode_k.finalize_decode(
        want[0], want[2])).abs().max().item() <= 1e-5


@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_dense_decode_hfa_dyadic_matches_plain(cuda, d):
    """H-FA rail, q and the K ring on a dyadic grid (every score and
    every tile's sum of p exact in any order): the kernel's unsplit walk
    within 1e-5 of the plain 128-key walk after finalize, m equal."""
    q, k, v = _ring(cuda, torch.bfloat16, d, seed=d)
    gen = torch.Generator(device=cuda).manual_seed(d)
    qa = thfa.dyadic_bf16(q.shape, gen, cuda, bound=0.5)
    ka = thfa.dyadic_bf16(k.transpose(1, 2).shape, gen, cuda,
                          bound=0.5).transpose(1, 2)
    got, want = (f(qa, ka, v, kv_len=290, use_hfa=True) for f in (
        decode_k.decode_partial, decode_k.decode_partial_plain))
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert (decode_k.finalize_decode(got[0], got[2], use_hfa=True) -
            decode_k.finalize_decode(want[0], want[2], use_hfa=True)
            ).abs().max().item() <= 1e-5


def test_dense_decode_refuses_a_misaligned_ring(cuda):
    """cp.async copies 16-byte chunks: a ring whose base (8 bytes in) or
    head stride (132 bytes) is not 16-byte aligned is refused before any
    launch, never read another way."""
    q = torch.zeros((3, 2, 2, 64), dtype=torch.bfloat16, device=cuda)
    before = decode_k.launches
    for width, lo in ((72, 4), (66, 0)):
        ring = torch.zeros((3, 300, 2, width), dtype=torch.bfloat16,
                           device=cuda)
        kv = ring[..., lo:lo + 64].transpose(1, 2)
        with pytest.raises(ValueError, match="16-byte aligned"):
            decode_k.decode_partial(q, kv, kv)
    assert decode_k.launches == before


def test_decode_attention_on_the_ring(cuda):
    """ops.decode_attention on the card equals the same call on the CPU
    (bf16 ring, both rails, the kernel against its plain version)."""
    q, k, v = _ring(cuda, torch.bfloat16, 128, seed=5)
    qd = q.reshape(3, 1, 4, 128)
    kr, vr = k.transpose(1, 2), v.transpose(1, 2)
    for impl, tol in (("fa2", 1e-2), ("hfa_pallas", 2e-2)):
        got = ops.decode_attention(qd, kr, vr, impl=impl, kv_len=200)
        want = ops.decode_attention(qd.cpu(), kr.cpu(), vr.cpu(), impl=impl,
                                    kv_len=200)
        # bf16 outputs: one bf16 rounding apart at most (~2^-8 relative).
        assert (got.cpu().float() - want.float()).abs().max().item() <= tol


def _dyadic(cuda, shape, seed):
    """bf16 values on a coarse dyadic grid (multiples of 1/4 in [-2, 2]):
    every f32 dot product over d <= 128 of them is exact in any order."""
    return thfa.dyadic_bf16(shape, torch.Generator(device=cuda)
                            .manual_seed(seed), cuda)


@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("shape", [(3, 40, 40), (2, 24, 70)],
                         ids=["square", "suffix"])
@pytest.mark.parametrize("causal", [False, True])
def test_hfa_datapath_bit_exact_on_exact_scores(cuda, causal, shape, d):
    """Case (a): on a dyadic grid the scores cannot depend on the
    summation order, so every output bit must equal the plain version
    (the core.hfa emulation) on the same CUDA tensors."""
    bh, lq, lkv = shape
    q = _dyadic(cuda, (bh, lq, d), 6)
    k = _dyadic(cuda, (bh, lkv, d), 7)
    v = torch.randn((bh, lkv, d), generator=torch.Generator(device=cuda)
                    .manual_seed(8), device=cuda).to(torch.bfloat16)
    before = dp_k.launches
    got = dp_k.hfa_datapath(q, k, v, causal=causal)
    want = dp_k.hfa_datapath_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert dp_k.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("causal", [False, True])
def test_hfa_datapath_random_rows_with_equal_scores_agree(cuda, causal):
    """Case (b): on random normal inputs every row is bit-equal to the
    plain walk fed the kernel's own scores (``hfa_datapath_scores``), and
    so every row whose bf16 scores the kernel and the plain f32 einsum
    form alike is bit-equal to the plain version."""
    q, k, v = _dense_inputs(cuda, torch.bfloat16, 128, bh=4, lq=48, lkv=96,
                            seed=9)
    got = dp_k.hfa_datapath(q, k, v, causal=causal)
    want = dp_k.hfa_datapath_plain(q, k, v, causal=causal)
    s_kernel = dp_k.hfa_datapath_scores(q, k, causal=causal)
    given = dp_k.hfa_datapath_from_scores(s_kernel, v, causal=causal)
    assert torch.equal(got.view(torch.int16), given.view(torch.int16))
    s_plain = (torch.einsum("bqd,bkd->bqk", q.float(), k.float())
               * 128 ** -0.5).to(torch.bfloat16)
    vis = torch.ones_like(s_plain, dtype=torch.bool)
    if causal:
        vis = torch.ones(48, 96, dtype=torch.bool, device=cuda).tril(48)
    agree = ((s_kernel == s_plain) | ~vis).all(-1)            # (BH, Lq)
    same = (got.view(torch.int16) == want.view(torch.int16)).all(-1)
    assert torch.all(same[agree])
    assert agree.float().mean().item() > 0.5


@pytest.mark.parametrize("kv_len", [None, 61])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_hfa_datapath_bit_exact_given_its_scores(cuda, causal, d, dtype,
                                                 kv_len):
    """Every row of the kernel, bit for bit, against the plain walk fed
    the scores the kernel forms (the same code, ``hfa_datapath_scores``),
    on random normal inputs: 70 rows (four row tiles and a part one)
    over 90 keys, so that causal rows stop inside tiles of 32 keys."""
    q, k, v = _dense_inputs(cuda, dtype, d, bh=3, lq=70, lkv=90,
                            seed=d + (kv_len or 0))
    before = dp_k.launches
    got = dp_k.hfa_datapath(q, k, v, causal=causal, kv_len=kv_len)
    s = dp_k.hfa_datapath_scores(q, k, causal=causal, kv_len=kv_len)
    want = dp_k.hfa_datapath_from_scores(s, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert dp_k.launches == before + 1
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.isfinite(got.float()).all()


def test_lns_device_functions_bit_exact(cuda):
    """lns_add, quant_scorediff, blinn_log2 and lns_to_bf16 as compiled
    into the datapath source against the plain torch LNS functions:
    every bf16 bit pattern, every rail value, signed pairs on a grid."""
    from repro_torch.core import lns
    raw = torch.arange(-32768, 32768, dtype=torch.float32, device=cuda)
    grid = torch.cat([torch.arange(-700., 700., 3., device=cuda),
                      torch.tensor([-32768., -32767., 32767., 0.],
                                   device=cuda)])
    ra, rb = (t.reshape(-1) for t in torch.meshgrid(grid, grid,
                                                    indexing="ij"))
    n = ra.numel()
    gen = torch.Generator(device=cuda).manual_seed(10)
    sa, sb = (torch.randint(0, 2, (n,), generator=gen, device=cuda,
                            dtype=torch.int32) for _ in range(2))
    x = torch.linspace(-20.0, 1.0, n, device=cuda)
    bits = torch.arange(n, device=cuda, dtype=torch.int32) & 0xFFFF
    sc, rc, quant, bsign, braw, packed, corr = cuda_lib.lns_eval(
        sa, ra, sb, rb, x, bits)
    # The correction table against exp2_neg over every d in [0, 65535].
    assert n >= 1 << 16
    assert torch.equal(corr, lns.exp2_neg(bits.float()))
    want_s, want_r = lns.lns_add(sa, ra, sb, rb)
    assert torch.equal(sc, want_s) and torch.equal(rc, want_r)
    assert torch.equal(quant, lns.quant_scorediff(x))
    pat = (torch.where(bits >= 0x8000, bits - 0x10000, bits)
           .to(torch.int16).view(torch.bfloat16))
    ws, wr = lns.blinn_log2(pat)
    assert torch.equal(bsign, ws) and torch.equal(braw, wr)
    assert torch.equal(packed.view(torch.int16),
                       lns.lns_to_bf16(sa, ra).view(torch.int16))
    # Every rail value through lns_to_bf16, both signs.
    for s in (0, 1):
        sg = torch.full_like(raw, s, dtype=torch.int32)
        got = cuda_lib.lns_eval(sg, raw, sg, raw, raw, sg)[5]
        assert torch.equal(got.view(torch.int16),
                           lns.lns_to_bf16(sg, raw).view(torch.int16))


# ------------------------------------------------------------ page codecs
def _encoded(codec, kp, vp):
    """(k data, v data, k scales, v scales) of f32/bf16 pools under a
    page codec, encoded on the card."""
    c = page_codec.get_codec(codec)
    kd, ks = c.encode(kp)
    vd, vs = c.encode(vp)
    return kd, vd, ks, vs


@pytest.mark.parametrize("route", ["default", "simt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("kind", ["decode", "prefill", "verify"])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
@pytest.mark.parametrize("codec", ["int8", "log16"])
def test_codec_kernel_matches_plain(cuda, codec, kind, d, dtype, use_hfa,
                                    route):
    """Each paged kernel on int8 and log16 pools against its plain version
    with the codec's decode (tolerances as test_kernel_matches_plain),
    counted on its route: decode and verify on v2, prefill on the tensor
    cores for a log16 pool's bf16 view at bf16 and d 64 / 128 and on the
    CUDA cores for int8 (and f32 q, d 32 / 96)."""
    g, hkv, b = 2, 2, 3
    kp, vp, pt, gen = _paged_pools(cuda, torch.float32, d, b=b, hkv=hkv,
                                   seed=d + 7)
    kd, vd, ks, vs = _encoded(codec, kp.to(dtype), vp.to(dtype))
    c = page_codec.get_codec(codec)
    q = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                   device=cuda).to(dtype)
    i32 = lambda a: _i32(cuda, a)  # noqa: E731
    if kind == "decode":
        args = (q(b, hkv, g, d), kd, vd, pt, i32([37, 0, 96]))
        fn = pd.paged_decode_partial if route == "default" else \
            pd.paged_decode_partial_simt
        plain, live = pd.paged_decode_partial_plain, [[1], [0], [1]]
        key = ("decode", "v2" if route == "default" else "simt")
    elif kind == "prefill":
        args = (q(b, hkv, g, 7, d), kd, vd, pt, i32([0, 20, 40]),
                i32([7, 23, 47]))
        view = pd.kernel_pools(c, kd, vd, ks, vs)[0]
        rule = cuda_lib.paged_prefill_route(args[0], view, pt)
        assert rule == ("tc" if codec == "log16" and dtype == torch.bfloat16
                        and d in (64, 128) else "simt")
        fn = pp.paged_prefill_partial
        plain = pp.paged_prefill_partial_plain
        live = [[1] * 7, [1] * 3 + [0] * 4, [1] * 7]
        key = ("prefill", rule if route == "default" else "simt")
    else:
        args = (q(b, hkv, g, 5, d), kd, vd, pt, i32([30, 0, 90]),
                i32([5, 0, 2]))
        fn = pv.paged_verify_partial if route == "default" else \
            pv.paged_verify_partial_simt
        plain = pv.paged_verify_partial_plain
        live = [[1] * 5, [0] * 5, [1, 1, 0, 0, 0]]
        key = ("verify", "v2" if route == "default" else "simt")
    kw = dict(codec=c, k_scales=ks, v_scales=vs)
    before = _paged_counts()
    if kind == "prefill" and route == "simt":
        kpool, vpool, kss, vss = pd.kernel_pools(c, kd, vd, ks, vs)
        got = cuda_lib.launch_paged(
            "paged_prefill_fwd", args[0], kpool, vpool, pt, *args[4:],
            scale=d ** -0.5, use_hfa=use_hfa, k_scales=kss, v_scales=vss)
    else:
        got = fn(*args, use_hfa=use_hfa, **kw)
    want = plain(*args, use_hfa=use_hfa, **kw)
    torch.cuda.synchronize()
    before[key[0]][key[1]] += 1
    assert _paged_counts() == before
    ko, km, kl = got
    po, pm, pl_ = want
    if kind == "decode":
        ko, po = ko[:, :, :, None], po[:, :, :, None]
        km, pm, kl, pl_ = (x[..., None] for x in (km, pm, kl, pl_))
    mask = torch.tensor(live, dtype=torch.bool, device=cuda)[:, None, None]
    mask = mask.expand(km.shape)
    assert torch.allclose(km[mask], pm[mask], atol=1e-3, rtol=0)
    kout = decode_k.finalize_decode(ko, kl, use_hfa=use_hfa)[mask]
    pout = decode_k.finalize_decode(po, pl_, use_hfa=use_hfa)[mask]
    assert (kout - pout).abs().max().item() <= (1e-2 if use_hfa else 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("kind", ["decode", "verify"])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_int8_v2_unsplit_bit_equal_to_simt(cuda, use_hfa, kind, d, dtype):
    """The int8 tile decode in the v2 ring (a key chunk times its row's
    scale, a V pair times its row's scale) is the CUDA-core body's
    decode, so unsplit the two give the same triplet bit for bit - in
    one block of the G K rows and one block a query head for verify."""
    case = _decode_case if kind == "decode" else _verify_case
    q, kp, vp, pt, *lens = case(cuda, dtype, d, seed=d + 3)
    kd, vd, ks, vs = _encoded("int8", kp, vp)
    kw = dict(scale=d ** -0.5, use_hfa=use_hfa, k_scales=ks, v_scales=vs)
    if kind == "decode":
        want = pd.paged_decode_partial_simt(q, kd, vd, pt, *lens,
                                            codec="int8", k_scales=ks,
                                            v_scales=vs, use_hfa=use_hfa)
        gots = [cuda_lib.launch_paged_decode(q, kd, vd, pt, *lens,
                                             splits=1, **kw)]
    else:
        want = pv.paged_verify_partial_simt(q, kd, vd, pt, *lens,
                                            codec="int8", k_scales=ks,
                                            v_scales=vs, use_hfa=use_hfa)
        gots = [cuda_lib.launch_paged_verify(q, kd, vd, pt, *lens, splits=1,
                                             row_blocks=rb, **kw)
                for rb in (1, q.shape[2])]
    torch.cuda.synchronize()
    for got in gots:
        for name, a, w in zip(("o", "m", "l"), got, want):
            assert torch.equal(a.view(torch.int32), w.view(torch.int32)), name


@pytest.mark.parametrize("codec", ["int8", "log16"])
def test_codec_encode_on_the_card_equals_the_cpu(cuda, codec):
    """encode on the card gives the CPU's data and scales bit for bit
    (bf16 and f32 inputs, an all-zero row, bf16 subnormals)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 16, 2, 64), generator=gen)
    x[1, 2] = 0.0
    x[2, 3, 0, :8] = 1e-39
    c = page_codec.get_codec(codec)
    for dt in (torch.float32, torch.bfloat16):
        cd, cs = c.encode(x.to(dt))
        gd, gs = c.encode(x.to(dt).to(cuda))
        assert torch.equal(gd.cpu(), cd)
        if cs is not None:
            assert torch.equal(gs.cpu().view(torch.int32),
                               cs.view(torch.int32))
