"""Shared cases for the paged-kernel parity tests (the other
test_torch_paged_*.py files); this module holds no tests of its own.

Plain versions of the port's paged attention kernels are compared with
the reference's Pallas kernels (interpret mode, as tests/test_kernels.py
runs them) and with its jnp gather path (``ops.paged_*_partials``).
Inputs are built in numpy from a seed: shuffled page tables, ragged
lengths, a free slot, and (verify) a row with ``chunk_lens == 0``.

Tolerances follow tests/test_kernels.py.  Against the jnp path (the same
one-shot softmax): m to atol 1e-6 plus rtol 1e-6 (a few f32 ulps at
|m| ~ 3: the two packages' matmuls round differently), l to 1e-4, o~ to
1e-3.  Against the Pallas kernel on the fa2 rail the same - m is held to
a tolerance, not atol=0, because the reference's own m differs by up to
1.2e-6 between its jnp and Pallas paths (ROADMAP.md Queue 3).  On the hfa
rail the Pallas kernel rescales online, multiplying two quantized
exponentials where the one-shot plain version quantizes once, so there
the finalized outputs are held to the reference's own kernel-vs-jnp
bound, atol 2e-2 (tests/test_serving.py::test_ops_paged_jnp_matches_pallas),
and m as above.  Garbage rows (prefill ``l >= chunk_len``, verify
``i >= chunk_lens``) are never compared.
"""
import numpy as np

import jax.numpy as jnp
import torch

from repro.kernels import decode as jdec
from repro.kernels import ops as jops
from repro.kernels import paged_decode as jpd
from repro.kernels import paged_prefill as jpp
from repro.kernels import paged_verify as jpv
from repro_torch.kernels import decode as tdec
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels import paged_prefill as tpp
from repro_torch.kernels import paged_verify as tpv

PAGE = 4
PAGES_EACH = 4
B = 3
HKV = 2


def _pools(rng, d):
    num_pages = B * PAGES_EACH + 3
    kp = rng.standard_normal((num_pages, PAGE, HKV, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, PAGE, HKV, d)).astype(np.float32)
    pt = rng.permutation(num_pages)[:B * PAGES_EACH].reshape(
        B, PAGES_EACH).astype(np.int32)
    return kp, vp, pt


def case(kind, d, g, seed):
    """numpy inputs (q, kp, vp, pt, a, b) and the live-row mask (B, L)."""
    rng = np.random.default_rng(seed)
    kp, vp, pt = _pools(rng, d)
    cap = PAGES_EACH * PAGE
    if kind == "decode":
        kvl = rng.integers(1, cap + 1, B).astype(np.int32)
        kvl[1] = 0                                    # free slot
        q = rng.standard_normal((B, HKV, g, d)).astype(np.float32)
        return q, kp, vp, pt, kvl, None, (kvl > 0)[:, None]
    ell = 5 if kind == "prefill" else 4
    q = rng.standard_normal((B, HKV, g, ell, d)).astype(np.float32)
    if kind == "prefill":
        start = np.array([0, 6, 0], np.int32)
        chunk = np.array([5, 3, 0], np.int32)         # ragged, one free
        kvl = start + chunk
        live = np.arange(ell)[None] < chunk[:, None]
        return q, kp, vp, pt, start, kvl, live
    sl = np.array([9, 0, 11], np.int32)
    cl = np.array([4, 0, 2], np.int32)                # free slot, ragged
    live = np.arange(ell)[None] < cl[:, None]
    return q, kp, vp, pt, sl, cl, live


def reference(kind, q, kp, vp, pt, a, b, use_hfa, pallas):
    args = [jnp.asarray(x) for x in (q, kp, vp, pt, a)]
    if kind == "decode":
        if pallas:
            return jpd.paged_decode_partial_pallas(*args, use_hfa=use_hfa,
                                                   interpret=True)
        return jops.paged_decode_partials(
            *args, impl="hfa" if use_hfa else "fa2")
    args.append(jnp.asarray(b))
    impl = "hfa" if use_hfa else "fa2"
    if kind == "prefill":
        if pallas:
            return jpp.paged_prefill_partial_pallas(*args, use_hfa=use_hfa,
                                                    interpret=True)
        return jops.paged_prefill_partials(*args, impl=impl)
    if pallas:
        return jpv.paged_verify_partial_pallas(*args, use_hfa=use_hfa,
                                               interpret=True)
    return jops.paged_verify_partials(*args, impl=impl)


def port(kind, q, kp, vp, pt, a, b, use_hfa):
    t = [torch.from_numpy(x) for x in (q, kp, vp, pt, a)]
    if kind == "decode":
        return tpd.paged_decode_partial(*t, use_hfa=use_hfa)
    fn = tpp.paged_prefill_partial if kind == "prefill" \
        else tpv.paged_verify_partial
    return fn(*t, torch.from_numpy(b), use_hfa=use_hfa)


def rows(x, live, kind):
    """Live rows only: (rows, ...) with rows over (b, hkv, g, l)."""
    x = np.asarray(x)
    if kind == "decode":
        x = x[:, :, :, None]
    mask = np.broadcast_to(live[:, None, None, :], x.shape[:4])
    return x[mask]


def check_plain_matches_reference(kind, g, d, use_hfa):
    q, kp, vp, pt, a, b, live = case(kind, d, g, seed=10 * d + g)
    to, tm, tl = (x.numpy() for x in port(kind, q, kp, vp, pt, a, b,
                                           use_hfa))
    r = lambda x: rows(x, live, kind)  # noqa: E731
    # jnp gather path: the same one-shot math.
    jo, jm, jl = reference(kind, q, kp, vp, pt, a, b, use_hfa, False)
    np.testing.assert_allclose(r(tm), r(jm), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(r(tl), r(jl), atol=1e-4)
    np.testing.assert_allclose(r(to), r(jo), atol=1e-3)
    # Pallas kernel, interpret mode.
    po, pm, pl_ = reference(kind, q, kp, vp, pt, a, b, use_hfa, True)
    np.testing.assert_allclose(r(tm), r(pm), atol=1e-6, rtol=1e-6)
    t_out = tdec.finalize_decode(torch.from_numpy(to), torch.from_numpy(tl),
                                 use_hfa=use_hfa).numpy()
    p_out = np.asarray(jdec.finalize_decode(po, pl_, use_hfa=use_hfa))
    if use_hfa:
        np.testing.assert_allclose(r(t_out), r(p_out), atol=2e-2)
    else:
        np.testing.assert_allclose(r(tl), r(pl_), atol=1e-4)
        np.testing.assert_allclose(r(to), r(po), atol=1e-3)
        np.testing.assert_allclose(r(t_out), r(p_out), atol=1e-5)


def check_dead_rows(kind):
    """A free slot yields (0, NEG_INF, 0) - the Eq. 16 merge's neutral
    element - which finalizes to zero."""
    q, kp, vp, pt, a, b, live = case(kind, 64, 2, seed=3)
    for use_hfa in (False, True):
        o, m, ell = (x.numpy() for x in port(kind, q, kp, vp, pt, a, b,
                                             use_hfa))
        dead = 1 if kind != "prefill" else 2
        assert np.all(o[dead] == 0.0) and np.all(ell[dead] == 0.0)
        assert np.all(m[dead] == tdec.NEG_INF)
