"""The H-FA paged rail rescales once a page, at every page size.

On the H-FA rail the output depends on where the online rescales fall,
and the reference's paged kernels (``paged_decode_partial_pallas``,
``paged_verify_partial_pallas``, ``paged_prefill_partial_pallas``)
rescale once a page.  At a page size other than 16 the port sends the
H-FA rail's decode, verify and prefill to the CUDA-core body of
``csrc/paged_attention.cu``, which rescales page by page too; it runs only
on the card, where ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold
it against the models here.  On the CPU the models (``kernels/ref.py``:
``paged_decode_split_model``, ``paged_verify_split_model``,
``paged_prefill_model``, each the walk one page at a time on the H-FA
rail) are held against the Pallas kernels in interpret mode, on numpy
inputs from a seed, at pages 1, 3, 4, 8, 32, 64, 128 and 256 (the last
two stage a page 64 keys at a time on the card):

* on ``hfa.dyadic_bf16(bound=0.5)`` q and K, where every score and every
  page's sum of p is exact, within 1e-5 after finalize with m bit for
  bit - as page 16 is held;
* on random normal inputs within a rail step (1e-2), where the two
  packages' f32 dot products may round a score across one.

Rows past a slot's chunk are not compared; the free slot's model triplet
is the neutral one.  The route rules are held as pure functions: page 16
and every FA-2 call keep their kernels, the H-FA rail at any other page
goes to the CUDA cores at every page up to the shared-memory ceiling
``cuda_lib.HFA_MAX_PAGE`` (2048), and a page above it on the H-FA rail is
refused - by the routes, and by the engine when it is built on the card.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import decode as jdec
from repro.kernels import paged_decode as jpd
from repro.kernels import paged_prefill as jpp
from repro.kernels import paged_verify as jpv
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import decode as tdec
from repro_torch.kernels import hfa as thfa
from repro_torch.kernels import ref
from repro_torch.serving.engine import check_page_size
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, HKV, G, K, CHUNK, KEYS = 3, 2, 2, 5, 12, 72
PAGES = [1, 3, 4, 8, 32, 64, 128, 256]
# A head dim for each page, so that every d meets more than one page.
HEAD_DIM = {1: 32, 3: 64, 4: 96, 8: 128, 32: 64, 64: 128, 128: 32, 256: 64}


def _values(shape, seed, dyadic):
    if dyadic:
        gen = torch.Generator().manual_seed(seed)
        return thfa.dyadic_bf16(shape, gen, bound=0.5).float().numpy()
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _keys(page):
    """Keys of the longest walk: 72, or past two pages above 64."""
    return KEYS if page <= 64 else 2 * page + 40


def _case(kind, page, dyadic, seed):
    """Finalized outputs and m of the model and of the Pallas kernel on
    the live rows, and the free slot's model triplet."""
    d = HEAD_DIM[page]
    keys = _keys(page)
    pages_each = -(-keys // page)
    num_pages = B * pages_each + 2
    pool = (num_pages, page, HKV, d)
    kp = _values(pool, seed + 1, dyadic)
    vp = _values(pool, seed + 2, False)
    pt = np.random.default_rng(seed).permutation(num_pages)[
        :B * pages_each].reshape(B, pages_each).astype(np.int32)
    if kind == "decode":
        q = _values((B, HKV, G, d), seed, dyadic)
        kvl = np.array([keys - 2, 0, 13], np.int32)          # a free slot
        args = (q, kp, vp, pt, kvl)
        po, pm, pl_ = jpd.paged_decode_partial_pallas(
            *map(jnp.asarray, args), use_hfa=True, interpret=True)
        to, tm, tl = ref.paged_decode_split_model(
            *map(torch.from_numpy, args), splits=1, use_hfa=True)
        live = np.broadcast_to((kvl > 0)[:, None, None], (B, HKV, G))
    elif kind == "verify":
        q = _values((B, HKV, G, K, d), seed, dyadic)
        sl = np.array([keys - K - 3, 0, 20], np.int32)
        cl = np.array([K, 0, 2], np.int32)                   # ragged, free
        args = (q, kp, vp, pt, sl, cl)
        po, pm, pl_ = jpv.paged_verify_partial_pallas(
            *map(jnp.asarray, args), use_hfa=True, interpret=True)
        to, tm, tl = ref.paged_verify_split_model(
            *map(torch.from_numpy, args), splits=1, use_hfa=True)
        live = np.broadcast_to((np.arange(K)[None] < cl[:, None])[
            :, None, None], (B, HKV, G, K))
    else:
        q = _values((B, HKV, G, CHUNK, d), seed, dyadic)
        start = np.array([keys - CHUNK - 1, 0, 21], np.int32)
        chunk = np.array([CHUNK, 0, 5], np.int32)            # ragged, free
        args = (q, kp, vp, pt, start, start + chunk)
        po, pm, pl_ = jpp.paged_prefill_partial_pallas(
            *map(jnp.asarray, args), use_hfa=True, interpret=True)
        to, tm, tl = ref.paged_prefill_model(*map(torch.from_numpy, args),
                                             use_hfa=True)
        live = np.broadcast_to((np.arange(CHUNK)[None] < chunk[:, None])[
            :, None, None], (B, HKV, G, CHUNK))
    want = np.asarray(jdec.finalize_decode(po, pl_, use_hfa=True))
    got = tdec.finalize_decode(to, tl, use_hfa=True).numpy()
    assert np.all(np.isfinite(got))
    return (got[live], want[live], tm.numpy()[live], np.asarray(pm)[live],
            (to[1], tm[1], tl[1]))


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
def test_hfa_model_matches_reference_on_the_dyadic_grid(kind, page):
    got, want, tm, pm, (o, m, l) = _case(kind, page, True, seed=page)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm, pm)
    assert torch.all(o == 0) and torch.all(m == ref.NEG_INF) \
        and torch.all(l == 0)


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
def test_hfa_model_random_within_a_rail_step(kind, page):
    got, want, _, _, _ = _case(kind, page, False, seed=10 + page)
    rows = np.abs(got - want).max(axis=-1)
    print(f"hfa {kind} model at page {page} vs reference, random inputs: "
          f"{np.mean(rows > 0):.2%} of {rows.size} live rows differ at all, "
          f"max |diff| {rows.max():.3g}")
    assert rows.max() <= 1e-2


def test_rescale_step():
    for page in (1, 3, 4, 16, 32, 64, 128, 256):
        assert ref.paged_rescale_step(page, True) == page
        assert ref.paged_rescale_step(page, False) == 16


def test_routes_keep_page_16_and_the_fa2_rail():
    for use_hfa in (False, True):
        assert cuda_lib.paged_decode_route(16, use_hfa) == "v2"
        assert cuda_lib.paged_verify_route(2, 5, 16, use_hfa) == "v2"
        assert cuda_lib.paged_verify_route(4, 5, 16, use_hfa) == "simt"
    for page in (1, 3, 4, 8, 32, 64, 128):
        assert cuda_lib.paged_decode_route(page, False) == "v2"
        assert cuda_lib.paged_verify_route(2, 5, page, False) == "v2"


@pytest.mark.parametrize("page", [1, 3, 4, 8, 15, 17, 32, 64, 65, 128, 256,
                                  1024, 2048])
def test_hfa_routes_take_the_cuda_cores_at_another_page(page):
    assert cuda_lib.paged_decode_route(page, True) == "simt"
    assert cuda_lib.paged_verify_route(2, 5, page, True) == "simt"
    assert cuda_lib.paged_verify_route(4, 5, page, True) == "simt"
    q = torch.zeros((1, 1, 2, 4, 128), dtype=torch.bfloat16)
    kp = torch.zeros((2, page, 1, 128), dtype=torch.bfloat16)
    pt = torch.zeros((1, 4), dtype=torch.int32)
    assert cuda_lib.paged_prefill_route(q, kp, pt, use_hfa=True) == "simt"


@pytest.mark.parametrize("page", [2049, 4096])
def test_hfa_page_above_64_is_refused(page):
    """Refused above the shared-memory ceiling (``HFA_MAX_PAGE``, 2048),
    which keeps every page up to 1024 on the card."""
    assert cuda_lib.HFA_MAX_PAGE >= 1024 and page > cuda_lib.HFA_MAX_PAGE
    q = torch.zeros((1, 1, 2, 4, 128), dtype=torch.bfloat16)
    kp = torch.zeros((2, page, 1, 128), dtype=torch.bfloat16)
    pt = torch.zeros((1, 4), dtype=torch.int32)
    for call in (lambda: cuda_lib.paged_decode_route(page, True),
                 lambda: cuda_lib.paged_verify_route(2, 5, page, True),
                 lambda: cuda_lib.paged_prefill_route(q, kp, pt,
                                                      use_hfa=True)):
        with pytest.raises(ValueError, match="rescales once a page"):
            call()
    # The FA-2 rail takes every page size.
    assert cuda_lib.paged_decode_route(page, False) == "v2"
    assert cuda_lib.paged_prefill_route(q, kp, pt) == "simt"


@pytest.mark.parametrize("impl", ["hfa", "hfa_pallas", "hfa_datapath"])
def test_engine_refuses_an_hfa_page_above_64_on_the_card(impl):
    """Only above the shared-memory ceiling: pages 128 to 2048 are
    served."""
    cuda = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="rescales once a page"):
        check_page_size(4096, impl, cuda)
    for page in (64, 128, 256, 1024, 2048):
        check_page_size(page, impl, cuda)
    check_page_size(4096, impl, torch.device("cpu"))   # the plain path
    check_page_size(4096, "fa2", cuda)                  # the FA-2 rail
    with pytest.raises(ValueError, match="page_size must be >= 1"):
        check_page_size(0, impl, torch.device("cpu"))
