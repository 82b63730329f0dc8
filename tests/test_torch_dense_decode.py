"""The port's dense flash-decode (kernel 4's plain version) and the
dense attention ops against the reference, on the same numpy inputs.

Tolerances:
* ``decode_partial``'s plain version against ``decode_partial_pallas``
  in interpret mode (the shapes of ``tests/test_kernels.py``'s decode
  test, plus a ``kv_len`` mask): o~ and l within 2e-5, m within 2e-6 -
  both walk the same 128-key tiles, and only the matmuls' summation
  order differs (the reference's own m gate, ``atol=0`` against its jnp
  oracle, does not hold across matmul orders: ROADMAP.md Queue 3).
* ``ref_decode_partial`` against the reference's oracle: the same.
* ``ops.decode_attention`` against the reference's with an int
  ``kv_len`` (the reference then runs its Pallas kernel for the
  ``*_pallas`` impls and one-shot jnp for ``fa2``): 2e-5 on f32 inputs.
* ``multihead_attention`` with ``hfa`` and ``hfa_datapath``: bit for
  bit (q, k on a dyadic grid, where the scores are exact in any
  summation order), GQA 4:2, causal and not.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import decode as jdec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode as tdec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(arrs, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("kv_len", [None, 100], ids=["full", "kv_len"])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
@pytest.mark.parametrize("g,s,d", [(4, 256, 64), (8, 384, 128), (2, 512, 32)])
def test_decode_partial_plain_vs_pallas(g, s, d, use_hfa, kv_len):
    j, t = _pair([_rand((3, g, d), 13), _rand((3, s, d), 14),
                  _rand((3, s, d), 15)], "bf16")
    o, m, l = jdec.decode_partial_pallas(*j, use_hfa=use_hfa, kv_len=kv_len,
                                         interpret=True)
    to, tm, tl = tdec.decode_partial(*t, use_hfa=use_hfa, kv_len=kv_len)
    _close(to, o, 2e-5)
    _close(tl, l, 2e-5)
    _close(tm, m, 2e-6)


@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_ref_decode_partial_matches_reference_oracle(use_hfa):
    j, t = _pair([_rand((2, 3, 4, 64), 16), _rand((2, 3, 256, 64), 17),
                  _rand((2, 3, 256, 64), 18)], "bf16")
    want = jref.ref_decode_partial(*j, use_hfa=use_hfa)
    got = tref.ref_decode_partial(*t, use_hfa=use_hfa)
    for a, b, tol in zip(got, want, (2e-5, 2e-6, 2e-5)):
        _close(a, b, tol)


def test_decode_partial_plain_strided_ring_and_dead_rows():
    """The ring view (B, S, Hkv, d) -> (B, Hkv, S, d), S not a tile
    multiple: the same call on a contiguous copy agrees to the matmul's
    summation order (the CPU BLAS orders a strided operand differently);
    kv_len 0 gives the neutral triplet."""
    rng = np.random.default_rng(19)
    q = torch.from_numpy(rng.standard_normal((2, 3, 2, 64)).astype(np.float32))
    ring = torch.from_numpy(rng.standard_normal((2, 200, 3, 64))
                            .astype(np.float32))
    view = ring.transpose(1, 2)
    for kv_len in (1, 150, 200):
        a = tdec.decode_partial(q, view, view, kv_len=kv_len, use_hfa=True)
        b = tdec.decode_partial(q, view.contiguous(), view.contiguous(),
                                kv_len=kv_len, use_hfa=True)
        for x, y in zip(a, b):
            assert (x - y).abs().max().item() <= 1e-5
    o, m, l = tdec.decode_partial(q, view, view, kv_len=0)
    assert torch.all(o == 0) and torch.all(l == 0)
    assert torch.all(m == tdec.NEG_INF)


@pytest.mark.parametrize("impl", ["fa2", "fa2_pallas", "hfa_pallas", "exact"])
@pytest.mark.parametrize("kv_len", [1, 77, 130])
def test_decode_attention_matches_reference(impl, kv_len):
    b, s_len, h, hkv, d = 2, 160, 4, 2, 64
    arrs = [_rand((b, 1, h, d), 20), _rand((b, s_len, hkv, d), 21),
            _rand((b, s_len, hkv, d), 22)]
    j, t = _pair(arrs, "f32")
    # The reference's _decode_impl: exact decodes on the fa2 rail.
    jimpl = "fa2" if impl == "exact" else impl
    want = jops.decode_attention(*j, impl=jimpl, kv_len=kv_len)
    got = tops.decode_attention(*t, impl=impl, kv_len=kv_len)
    assert got.shape == (b, 1, h, d) and got.dtype == torch.float32
    _close(got, want, 2e-5)


def _dyadic(shape, seed):
    return (np.random.default_rng(seed).integers(-8, 9, shape)
            .astype(np.float32) / 4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["hfa", "hfa_datapath"])
def test_multihead_attention_hfa_impls_bit_exact(impl, causal):
    """(B, L, H, d) with GQA 4:2 through both packages' ops: the
    emulation (hfa) and the datapath kernel's plain version."""
    arrs = [_dyadic((2, 20, 4, 32), 23), _dyadic((2, 20, 2, 32), 24),
            _rand((2, 20, 2, 32), 25)]
    j, t = _pair(arrs, "bf16")
    want = jops.multihead_attention(*j, impl=impl, causal=causal)
    got = tops.multihead_attention(*t, impl=impl, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 20, 4, 32)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
