"""The paged ops on encoded pools, the port against the reference: the
codec x rail x op matrix of the reference's
test_paged_codec_parity_matrix and the copy-on-write / rollback contract
of test_paged_codec_cow_fork_and_rollback (tests/test_kernels.py).

The same numpy pools are encoded by each package's codec (bit-equal:
tests/test_torch_page_codec.py) and read through each package's
``ops.paged_{decode,verify,prefill}_attention`` - the port's plain
versions on the CPU, which decode the gathered pages with
``codec.decode`` as the reference's jnp fallback does.  For each codec,
rail and op:

* the port's codec path against the raw fp pool through the port: fp
  (``codec=None``, the reference's read rule) bit for bit, int8 and log16
  within ``PAGE_CODEC_ATOL`` (the reference's bound);
* the port's codec path against the reference's jnp fallback on the same
  encoded pools: within 1e-5 on the FA-2 rail (summation order), within a
  rail step (1e-2) on the H-FA rail, where the two packages' f32 dot
  products can put a score on either side of a 1/128 step;
* against the reference's Pallas kernel in interpret mode
  (``force_pallas=True``), which decodes each tile in its loop: within
  1e-4 on fa2 and 2e-2 on hfa, the reference's own tolerances.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import page_codec as jcodec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import page_codec
from repro_torch.kernels import paged_prefill as tpp
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CODECS = ["fp", "int8", "log16"]
PAGE_CODEC_ATOL = {"fp": 0.0, "int8": 5e-2, "log16": 5e-2}
PAL_ATOL = {"fa2": 1e-4, "hfa": 2e-2}
JNP_ATOL = {"fa2": 1e-5, "hfa": 1e-2}


def _setup(seed, *, b=2, hkv=2, g=4, d=64, page=8, pages_each=3, kw=4):
    """As the reference's _verify_setup: random f32 pools, a shuffled
    page table, ragged seq_lens with room for a kw-token step."""
    rng = np.random.default_rng(seed)
    num_pages = b * pages_each + 2
    kp = np.random.default_rng(seed + 1).standard_normal(
        (num_pages, page, hkv, d)).astype(np.float32)
    vp = np.random.default_rng(seed + 2).standard_normal(
        (num_pages, page, hkv, d)).astype(np.float32)
    pt = rng.permutation(num_pages)[:b * pages_each].reshape(
        b, pages_each).astype(np.int32)
    sl = rng.integers(1, pages_each * page - kw + 1, b).astype(np.int32)
    cl = np.full((b,), kw, np.int32)
    q = np.random.default_rng(seed + 3).standard_normal(
        (b, kw, hkv * g, d)).astype(np.float32)
    return q, kp, vp, pt, sl, cl


def _encoded(name, kp, vp):
    """Each package's encoded pools and read arguments (fp reads on
    codec=None)."""
    tc, jc = page_codec.get_codec(name), jcodec.get_codec(name)
    tk, tks = tc.encode(torch.from_numpy(kp))
    tv, tvs = tc.encode(torch.from_numpy(vp))
    jk, jks = jc.encode(jnp.asarray(kp))
    jv, jvs = jc.encode(jnp.asarray(vp))
    fp = name == "fp"
    return ((tk, tv, dict(codec=None if fp else tc, k_scales=tks,
                          v_scales=tvs)),
            (jk, jv, dict(codec=None if fp else jc, k_scales=jks,
                          v_scales=jvs)))


def _calls(kind, q, pt, sl, cl):
    """(port call, reference call) of one op: each takes (k, v, kwargs)."""
    tq, jq = torch.from_numpy(q), jnp.asarray(q)
    t = [torch.from_numpy(x) for x in (pt, sl, cl)]
    j = [jnp.asarray(x) for x in (pt, sl, cl)]
    if kind == "decode":
        return (lambda k, v, e: tops.paged_decode_attention(
                    tq[:, :1], k, v, t[0], t[1] + 1, **e),
                lambda k, v, e: jops.paged_decode_attention(
                    jq[:, :1], k, v, j[0], j[1] + 1, **e))
    tf = tops.paged_verify_attention if kind == "verify" else \
        tops.paged_prefill_attention
    jf = jops.paged_verify_attention if kind == "verify" else \
        jops.paged_prefill_attention
    return (lambda k, v, e: tf(tq, k, v, *t, **e),
            lambda k, v, e: jf(jq, k, v, *j, **e))


@pytest.mark.parametrize("rail", ["fa2", "hfa"])
@pytest.mark.parametrize("name", CODECS)
def test_paged_codec_parity_matrix(name, rail):
    q, kp, vp, pt, sl, cl = _setup(400)
    (tk, tv, te), (jk, jv, je) = _encoded(name, kp, vp)
    impl = f"{rail}_pallas"
    for kind in ("decode", "verify", "prefill"):
        port, refc = _calls(kind, q, pt, sl, cl)
        raw = port(torch.from_numpy(kp), torch.from_numpy(vp),
                   dict(impl=impl)).numpy()
        got = port(tk, tv, dict(te, impl=impl)).numpy()
        if name == "fp":
            np.testing.assert_array_equal(got, raw, err_msg=kind)
        else:
            np.testing.assert_allclose(got, raw, atol=PAGE_CODEC_ATOL[name],
                                       rtol=0, err_msg=kind)
        want = np.asarray(refc(jk, jv, dict(je, impl=impl)))
        np.testing.assert_allclose(got, want, atol=JNP_ATOL[rail], rtol=0,
                                   err_msg=kind)
        pal = np.asarray(refc(jk, jv, dict(je, impl=impl,
                                           force_pallas=True)))
        np.testing.assert_allclose(got, pal, atol=PAL_ATOL[rail], rtol=0,
                                   err_msg=kind)


@pytest.mark.parametrize("rail", ["fa2", "hfa"])
@pytest.mark.parametrize("name", ["int8", "log16"])
def test_paged_codec_cow_fork_and_rollback(name, rail):
    """(1) A forked (page-aliased) table reads bit-equal to a
    materialized copy when the scale sidecars ride the same
    ``copy_pages``; (2) rows past a slot's length - the stale encodings
    and scales a speculative rollback leaves - never reach the output,
    so rollback stays a pure seq_len decrement."""
    rng = np.random.default_rng(501)
    b, hkv, h, d, page, pages_each, kw = 2, 2, 4, 64, 8, 3, 2
    num_pages = 2 * pages_each + 2
    kp = torch.from_numpy(np.random.default_rng(502).standard_normal(
        (num_pages, page, hkv, d)).astype(np.float32))
    vp = torch.from_numpy(np.random.default_rng(503).standard_normal(
        (num_pages, page, hkv, d)).astype(np.float32))
    c = page_codec.get_codec(name)
    kd, ks = c.encode(kp)
    vd, vs = c.encode(vp)
    src = torch.from_numpy(rng.permutation(pages_each).astype(np.int32))
    dst = torch.from_numpy((pages_each + rng.permutation(pages_each))
                           .astype(np.int32))
    for pool in (kd, vd) + ((ks, vs) if ks is not None else ()):
        tpp.copy_pages(pool, src, dst)
    shared = torch.stack([src, src])
    mat = torch.stack([src, dst])
    sl = torch.from_numpy(rng.integers(1, pages_each * page - kw + 1, b)
                          .astype(np.int32))
    cl = torch.full((b,), kw, dtype=torch.int32)
    q = torch.from_numpy(np.random.default_rng(504).standard_normal(
        (b, kw, h, d)).astype(np.float32))
    impl = f"{rail}_pallas"

    def reads(kdata, vdata, kscale, vscale, table):
        e = dict(impl=impl, codec=c, k_scales=kscale, v_scales=vscale)
        return (tops.paged_verify_attention(q, kdata, vdata, table, sl, cl,
                                            **e),
                tops.paged_decode_attention(q[:, :1], kdata, vdata, table,
                                            sl, **e))
    for a, w in zip(reads(kd, vd, ks, vs, shared),
                    reads(kd, vd, ks, vs, mat)):
        assert torch.equal(a, w)
    want = reads(kd, vd, ks, vs, mat)
    # Trash every row (and scale) no read may reach: positions >= sl + kw.
    keep = torch.zeros(kd.shape[:2], dtype=torch.bool)
    for i in range(b):
        for pos in range(int(sl[i]) + kw):
            keep[mat[i, pos // page], pos % page] = True
    jr = torch.Generator().manual_seed(505)
    trashed = []
    for pool in (kd, vd):
        t = torch.randint(1, 120, pool.shape, generator=jr).to(pool.dtype)
        t[keep] = pool[keep]
        trashed.append(t)
    for pool in (ks, vs):
        if pool is None:
            trashed.append(None)
            continue
        t = torch.randn(pool.shape, generator=jr)
        t[keep] = pool[keep]
        trashed.append(t)
    for a, w in zip(reads(*trashed, mat), want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_prefill_route_by_pool(use_hfa):
    """On the card a bf16 prefill takes the tensor cores over a bf16 pool -
    fp, or a log16 pool's bf16 view (``kernel_pools``, the decode) - and
    the CUDA cores over int8 pools, whose tiles they decode; an f32 q
    stays on the CUDA cores whatever the pool.  Decode and verify take v2
    for every codec at page 16."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import paged_decode as tpd
    q = torch.zeros((1, 2, 2, 8, 128), dtype=torch.bfloat16)
    pt = torch.zeros((1, 4), dtype=torch.int32)
    pool = torch.zeros((4, 16, 2, 128), dtype=torch.bfloat16)
    routes = {}
    for name in CODECS:
        c = page_codec.get_codec(name)
        data, scales = c.encode(pool)
        kp, _, ks, _ = tpd.kernel_pools(c, data, data, scales, scales)
        assert (ks is not None) == (name == "int8")
        routes[name] = cuda_lib.paged_prefill_route(q, kp, pt,
                                                    use_hfa=use_hfa)
        assert cuda_lib.paged_prefill_route(q.float(), kp, pt,
                                            use_hfa=use_hfa) == "simt"
    assert routes == {"fp": "tc", "int8": "simt", "log16": "tc"}
    assert cuda_lib.paged_decode_route(16, use_hfa) == "v2"
    assert cuda_lib.paged_verify_route(2, 5, 16, use_hfa) == "v2"
