"""The port's H-FA rail numerics against the reference, bit for bit.

Every finite bf16 value and a dense sweep of the rail from
DIFF_CLAMP_NAT to 0 go through the reference's jnp function and the
port's torch function; the results must have identical bits.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import lns as jlns
from repro.kernels import bitmath as jbit
from repro.kernels import decode as jdec
from repro_torch.core import lns as tlns
from repro_torch.kernels import bitmath as tbit
from repro_torch.kernels import decode as tdec


def _finite_bf16_as_f32() -> np.ndarray:
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    f = bits.view(np.float32)
    return f[np.isfinite(f)]


F = _finite_bf16_as_f32()
# The rail's whole input range: clamp point to 0 in natural units, and
# every integer rail value from the clamp (-15 * log2 e * 128) to 0.
NAT_SWEEP = np.linspace(jlns.DIFF_CLAMP_NAT, 0.0, 200_001).astype(np.float32)
RAIL_SWEEP = np.arange(-2771, 1, dtype=np.float32)


def _same_bits(want, got: torch.Tensor):
    want = np.asarray(want, np.float32)
    got = got.numpy()
    assert want.shape == got.shape
    bad = want.view(np.uint32) != got.view(np.uint32)
    assert not bad.any(), (
        f"{bad.sum()} differ, e.g. want {want[bad][:4]} got {got[bad][:4]}")


def test_lut_tables_and_constants_match():
    assert tlns.PWL_SLOPES_Q15 == jlns.PWL_SLOPES_Q15
    assert tlns.PWL_INTERCEPTS_Q15 == jlns.PWL_INTERCEPTS_Q15
    assert tlns.LOG2E == jlns.LOG2E
    assert tlns.DIFF_CLAMP_NAT == jlns.DIFF_CLAMP_NAT
    assert tdec.NEG_INF == jdec.NEG_INF
    # The 16 values the CUDA kernels receive as a launch argument.
    np.testing.assert_array_equal(
        tlns.pwl_lut16(),
        np.asarray(jlns.PWL_SLOPES_Q15 + jlns.PWL_INTERCEPTS_Q15, np.float32))


@pytest.mark.parametrize("x", [F, NAT_SWEEP], ids=["bf16", "nat_sweep"])
def test_quant_rail_and_exp2_hfa_rail_bit_exact(x):
    rail = jbit.quant_rail(jnp.asarray(x))
    t_rail = tbit.quant_rail(torch.from_numpy(x))
    _same_bits(rail, t_rail)
    _same_bits(jbit.exp2_hfa_rail(rail), tbit.exp2_hfa_rail(t_rail))


def test_exp2_hfa_rail_bit_exact_on_every_rail_value():
    _same_bits(jbit.exp2_hfa_rail(jnp.asarray(RAIL_SWEEP)),
               tbit.exp2_hfa_rail(torch.from_numpy(RAIL_SWEEP)))


@pytest.mark.parametrize("name", ["log2_mitchell_f32", "exp2_int_sweep",
                                  "lut8", "pwl_exp2_frac", "exp2_neg"])
def test_bit_helpers_bit_exact(name):
    if name == "log2_mitchell_f32":
        x = F
        want = jbit.log2_mitchell_f32(jnp.asarray(x))
        got = tbit.log2_mitchell_f32(torch.from_numpy(x))
    elif name == "exp2_int_sweep":
        x = np.arange(-300, 300, dtype=np.float32)
        want = jbit.exp2_int(jnp.asarray(x))
        got = tbit.exp2_int(torch.from_numpy(x))
    elif name == "lut8":
        x = np.linspace(-2.0, 10.0, 97).astype(np.float32)
        want = jlns._lut8(jnp.asarray(x), jlns.PWL_SLOPES_Q15)
        got = tlns._lut8(torch.from_numpy(x), tlns.PWL_SLOPES_Q15)
    elif name == "pwl_exp2_frac":
        x = np.arange(0, 128, dtype=np.float32)
        want = jlns.pwl_exp2_frac(jnp.asarray(x))
        got = tlns.pwl_exp2_frac(torch.from_numpy(x))
    else:
        x = np.arange(0, 8000, dtype=np.float32)
        want = jlns.exp2_neg(jnp.asarray(x))
        got = tlns.exp2_neg(torch.from_numpy(x))
    _same_bits(want, got)


def test_recip_logdiv_bit_exact_on_positive_normals():
    """LogDiv normalizes l > 0 (l >= 1 on every live row).  Over every
    positive normal bf16 value below 2^117 the port equals the
    reference bit for bit; above that, at zero, on subnormals and on
    negative inputs the reference's XLA lowering departs from its own
    formula (ROADMAP.md Queue 3), outside anything attention feeds it."""
    x = F[(F >= 2.0 ** -126) & (F < 2.0 ** 117)]
    _same_bits(jbit.recip_logdiv(jnp.asarray(x)),
               tbit.recip_logdiv(torch.from_numpy(x)))


@pytest.mark.parametrize("use_hfa", [False, True])
def test_finalize_and_merge_match_reference(use_hfa):
    rng = np.random.default_rng(5)
    o = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    m = rng.standard_normal((3, 4, 2)).astype(np.float32)
    ell = rng.uniform(0.5, 40.0, (3, 4, 2)).astype(np.float32)
    ell[0, 1] = 0.0                       # dead rows finalize to zero
    m[0, 1] = jdec.NEG_INF
    got = tdec.finalize_decode(torch.from_numpy(o[0]),
                               torch.from_numpy(ell[0]), use_hfa=use_hfa)
    _same_bits(jdec.finalize_decode(jnp.asarray(o[0]), jnp.asarray(ell[0]),
                                    use_hfa=use_hfa), got)
    wo, wm, wl = jdec.merge_partials(jnp.asarray(o), jnp.asarray(m),
                                     jnp.asarray(ell), use_hfa=use_hfa)
    to, tm, tl = tdec.merge_partials(torch.from_numpy(o), torch.from_numpy(m),
                                     torch.from_numpy(ell), use_hfa=use_hfa)
    _same_bits(wm, tm)
    # Sums over the partial axis: f32 summation order only.
    np.testing.assert_allclose(tl.numpy(), np.asarray(wl), rtol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(wo), rtol=1e-6,
                               atol=1e-6)
