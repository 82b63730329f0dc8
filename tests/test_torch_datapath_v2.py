"""The redesigned per-element LNS datapath (kernel 9), modelled on the CPU.

``hfa_datapath_fwd`` (``csrc/hfa_datapath.cu``) runs only on the card,
where ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold it bit for bit
against :func:`hfa_datapath_from_scores` fed the kernel's own scores.
Here the pieces its exactness rests on are held against the reference
(``src/repro/core/lns.py``, ``src/repro/kernels/hfa_datapath.py``):

* the Mitchell correction as a table (``core/lns.py::exp2_neg_table``,
  built from the port's plain ``exp2_neg``) equals the port's and the
  reference's ``exp2_neg`` on every d in [0, 65535];
* ``lns_add`` written with the table, as the kernel forms the
  correction, and the port's own ``lns_add`` equal the reference's on a
  dense grid and on every zero, tie and cancellation case;
* the kernel's rescale max(raw + q, LOG_ZERO) equals the reference's
  saturated add that keeps a zero zero, on every rail raw and every q a
  score difference quantizes to (exhaustive);
* the kernel's column update (``ref.datapath_update_model``: the
  rescales and lns_add with only the cases its operands reach) equals the
  reference's on a dense grid of states, Blinn logs and score
  differences, and on every zero, tie and cancellation case;
* the plain walk fed given scores (``hfa_datapath_from_scores``), given
  the reference's own scores, equals ``hfa_datapath_pallas`` in
  interpret mode bit for bit, causal and not, with a ``kv_len`` mask, at
  d 32 and 64, on random inputs from a seed.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import lns as jlns
from repro.kernels import hfa_datapath as jdp
from repro_torch.core import lns
from repro_torch.core.numerics import LOG_ZERO
from repro_torch.kernels import hfa_datapath as tdp
from repro_torch.kernels import ref

# Rail values at the edges: zero, one step above it, the least Blinn log
# of a bf16 plus the least score difference, the Blinn range, the top.
SPECIAL = np.array([-32768, -32767, -32766, -32700, -19025, -16255, -2770,
                    -129, -128, -1, 0, 1, 127, 128, 1023, 1024, 16511,
                    32640, 32766, 32767], np.float32)


def _np(x):
    return np.array(x)


_TABLE = torch.from_numpy(lns.exp2_neg_table())


def _table_lookup(d, cfg=lns.DEFAULT):
    """exp2_neg as the kernel forms it: the table at min(d, 1023) (the
    kernel computes the DEFAULT configuration only)."""
    assert cfg == lns.DEFAULT
    idx = torch.clamp(d, max=lns.EXP2_NEG_TABLE - 1).to(torch.int64)
    return _TABLE[idx].to(torch.float32)


def test_exp2_neg_table_matches_reference():
    tab = lns.exp2_neg_table()
    assert tab.dtype == np.uint8 and tab.shape == (lns.EXP2_NEG_TABLE,)
    assert tab[-1] == 0 and tab[0] == 128
    d = torch.arange(65536, dtype=torch.float32)
    got = _table_lookup(d).numpy()
    np.testing.assert_array_equal(got, lns.exp2_neg(d).numpy())
    np.testing.assert_array_equal(got, _np(jlns.exp2_neg(jnp.asarray(
        d.numpy()))))
    assert np.all(got[1024:] == 0)


def _ref_add(sa, ra, sb, rb):
    s, r = jlns.lns_add(*(jnp.asarray(x) for x in (sa, ra, sb, rb)))
    return _np(s), _np(r)


def _signs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, n).astype(np.int32),
            rng.integers(0, 2, n).astype(np.int32))


@pytest.mark.parametrize("corr", ["table", "pwl"])
def test_lns_add_with_the_table_matches_reference(corr, monkeypatch):
    if corr == "table":
        monkeypatch.setattr(lns, "exp2_neg", _table_lookup)
    # Dense grid: every pair of rails in [-1200, 1200], random signs.
    grid = np.arange(-1200, 1201, dtype=np.float32)
    ra, rb = (x.reshape(-1) for x in np.meshgrid(grid, grid, indexing="ij"))
    sa, sb = _signs(ra.size, 0)
    # Every pair of edge rails under all four sign pairs: the zero
    # operands, ties (cancellation with opposite signs), the clamps.
    ea, eb = (x.reshape(-1) for x in np.meshgrid(SPECIAL, SPECIAL,
                                                 indexing="ij"))
    for s_a, s_b in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ra = np.concatenate([ra, ea])
        rb = np.concatenate([rb, eb])
        sa = np.concatenate([sa, np.full(ea.size, s_a, np.int32)])
        sb = np.concatenate([sb, np.full(ea.size, s_b, np.int32)])
    got = lns.lns_add(*(torch.from_numpy(x) for x in (sa, ra, sb, rb)))
    want = _ref_add(sa, ra, sb, rb)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def _ref_rescale(raw, q):
    """The reference kernel's rescale of a rail value by a score
    difference (``_datapath_kernel``'s A and B)."""
    out = jlns.clamp_rail(raw + q)
    return jnp.where(raw <= LOG_ZERO, float(LOG_ZERO), out)


def test_rail_rescale_matches_reference_exhaustively():
    """Every rail raw in [-32768, 32767] against every q in [-2770, 0]
    (the range quant_scorediff gives: -15 log2(e) 128 = -2770), and -0."""
    raw = np.arange(-32768, 32768, dtype=np.float32)[:, None]
    rescale = jax.jit(_ref_rescale)
    qs = np.concatenate([[-0.0], np.arange(-2770, 1)]).astype(np.float32)
    for q0 in range(0, qs.size, 128):
        q = qs[q0:q0 + 128][None, :]
        want = _np(rescale(jnp.asarray(raw), jnp.asarray(q)))
        got = lns.rail_rescale(torch.from_numpy(raw),
                               torch.from_numpy(q)).numpy()
        np.testing.assert_array_equal(got, want)


def _bf16_blinn_raws():
    """Every Blinn raw a finite bf16 magnitude gives, and LOG_ZERO (v 0)."""
    bits = torch.arange(0, 0x7F80, dtype=torch.int32).to(torch.int16)
    _, raw = lns.blinn_log2(bits.view(torch.bfloat16))
    return np.unique(raw.numpy())


def _ref_update(s, raw, sv, rv, q_dm, q_ds):
    a = _ref_rescale(jnp.asarray(raw), jnp.asarray(q_dm))
    b = _ref_rescale(jnp.asarray(rv), jnp.asarray(q_ds))
    out = jlns.lns_add(jnp.asarray(s), a, jnp.asarray(sv), b)
    return _np(out[0]), _np(out[1])


def _check_update(s, raw, sv, rv, q_dm, q_ds):
    got = ref.datapath_update_model(*(
        torch.from_numpy(np.ascontiguousarray(x))
        for x in (s, raw, sv, rv, q_dm, q_ds)))
    want = _ref_update(s, raw, sv, rv, q_dm, q_ds)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("signs", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_kernel_update_matches_reference_on_a_grid(signs):
    """State rails every 257 and the edges, against Blinn logs every 131
    and the edges (v 0 included), at score differences 0, -1, -128 and
    -2770 each."""
    blinn = _bf16_blinn_raws()
    states = np.unique(np.concatenate([
        np.arange(-32768, 32768, 257, dtype=np.float32), SPECIAL]))
    vs = np.unique(np.concatenate([blinn[::131], blinn[:3], blinn[-3:],
                                   [LOG_ZERO, 0.0]]).astype(np.float32))
    qs = np.array([0, -1, -128, -2770], np.float32)
    raw, rv, q_dm, q_ds = (x.reshape(-1) for x in np.meshgrid(
        states, vs, qs, qs, indexing="ij"))
    n = raw.size
    s = np.full(n, signs[0], np.int32)
    sv = np.full(n, signs[1], np.int32)
    _check_update(s, raw, sv, rv, q_dm, q_ds)


def test_kernel_update_matches_reference_on_ties_and_zeros():
    """Every tie A == B (the cancellation with opposite signs), a zero
    state, a zero V and both, for every Blinn log of a bf16 magnitude."""
    blinn = _bf16_blinn_raws()
    blinn = blinn[blinn > LOG_ZERO]
    rng = np.random.default_rng(1)
    n = blinn.size
    q_ds = -rng.integers(0, 2771, n).astype(np.float32)
    q_dm = -rng.integers(0, 2771, n).astype(np.float32)
    tie = blinn + q_ds - q_dm                       # A = raw + q_dm = B
    keep = (tie >= -32767) & (tie <= 32767)
    cases = []
    for s, sv in ((0, 0), (0, 1), (1, 0), (1, 1)):
        m = int(keep.sum())
        cases.append((np.full(m, s), tie[keep], np.full(m, sv), blinn[keep],
                      q_dm[keep], q_ds[keep]))
        # A zero state against every V; every state against a zero V;
        # both zero.
        cases.append((np.full(n, s), np.full(n, LOG_ZERO, np.float32),
                      np.full(n, sv), blinn, q_dm, q_ds))
        cases.append((np.full(n, s), blinn * 2 - 1, np.full(n, sv),
                      np.full(n, LOG_ZERO, np.float32), q_dm, q_ds))
        cases.append((np.full(4, s), np.full(4, LOG_ZERO, np.float32),
                      np.full(4, sv), np.full(4, LOG_ZERO, np.float32),
                      np.array([0, -1, -2770, -0.0], np.float32),
                      np.array([0, -7, -2770, 0], np.float32)))
    for s, raw, sv, rv, dm, ds in cases:
        raw = np.clip(raw, -32768, 32767).astype(np.float32)
        _check_update(s.astype(np.int32), raw, sv.astype(np.int32),
                      rv.astype(np.float32), dm.astype(np.float32),
                      ds.astype(np.float32))


def _reference_scores(q, k, scale):
    """The bf16 scores of the reference kernel's body, slab by slab: the
    f32 dot_general times the scale, rounded to bf16."""
    f = jax.jit(lambda a, b: (jax.lax.dot_general(
        a.astype(jnp.float32), b.astype(jnp.float32),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
        * scale).astype(jnp.bfloat16).astype(jnp.float32))
    return np.stack([_np(f(q[i], k[i])) for i in range(q.shape[0])])


@pytest.mark.parametrize("kv_len", [None, 27])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_from_scores_matches_pallas_bit_for_bit(d, causal, kv_len):
    rng = np.random.default_rng(d + 2 * causal + (kv_len or 0))
    bh, lq, lkv = 3, 24, 40
    q, k, v = (jnp.asarray(rng.standard_normal(s).astype(np.float32))
               .astype(jnp.bfloat16)
               for s in ((bh, lq, d), (bh, lkv, d), (bh, lkv, d)))
    want = _np(jdp.hfa_datapath_pallas(q, k, v, causal=causal, kv_len=kv_len,
                                       interpret=True).astype(jnp.float32))
    s = torch.from_numpy(_reference_scores(q, k, d ** -0.5))
    vt = torch.from_numpy(_np(v.astype(jnp.float32))).to(torch.bfloat16)
    got = tdp.hfa_datapath_from_scores(s, vt, causal=causal, kv_len=kv_len)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().view(np.int32),
                                  want.view(np.int32))
    # Fed the plain version's own scores it is the plain version.
    qt, kt = (torch.from_numpy(_np(x.astype(jnp.float32))).to(torch.bfloat16)
              for x in (q, k))
    own = (torch.einsum("bqd,bkd->bqk", qt.float(), kt.float()) * d ** -0.5
           ).to(torch.bfloat16).float()
    assert torch.equal(
        tdp.hfa_datapath_from_scores(own, vt, causal=causal,
                                     kv_len=kv_len).view(torch.int16),
        tdp.hfa_datapath_plain(qt, kt, vt, causal=causal,
                               kv_len=kv_len).view(torch.int16))
