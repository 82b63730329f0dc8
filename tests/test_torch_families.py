"""The port's models of every config the reference's paged engine serves
beside qwen3-1.7b - qwen1.5-4b, minitron-8b, command-r-plus-104b,
hfa-paper-mini (also at its own head dim, d_head 96), and the MoE
granite-moe-1b-a400m and phi3.5-moe-42b-a6.6b - against the reference,
reduced (4 layers, d_model 256, f32), the same numpy tokens through both.

* ``convert.state_dict_from_reference`` covers every leaf, and the
  restacked tree has the reference's leaves.
* ``LM.init_reference(0)`` draws ``LM.init(PRNGKey(0))``: at f32 within 4
  ulps (XLA's f32 erf_inv uses its own log1p: 3 ulps, as
  test_torch_serve_cli.py holds for qwen3-1.7b, and the scale's multiply
  can round that one ulp further - seen at d_head 96's ``wo``), and at
  the full-size dtype, bf16, bit for bit - but the MoE router, f32 at
  every dtype, within the same 4 ulps.
* ``LM.apply``'s logits within 1e-4 (fa2; f32 matmul orders) or 2e-2
  (hfa_pallas: a score the two packages round to bf16 differently moves a
  rail step, as chip_smoke.py's RING_TOLS), its aux losses and
  ``LM.loss`` within 1e-5 relative (test_torch_train.py's loss
  tolerance), qwen1.5-4b with nonzero QKV biases in both packages'
  params.
* ``serve --dense`` on granite prints the reference's ``sample:`` line.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild
from repro.configs import REGISTRY as JREGISTRY
from repro.launch.serve import _paged_supported
from repro_torch.configs import REGISTRY, get_config
from repro_torch.models import convert
from repro_torch.models.model import LM
from repro_torch.serving.engine import check_parallel
from test_torch_engine_common import (family_models,  # noqa: F401
                                      one_torch_thread)
from test_torch_serve_cli import _cli_lines

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (arch, config fields replaced in both packages): the paged archs; the
# SSM mamba2-2.7b has its own file, test_torch_mamba2.py.
CASES = [(a, {}) for a in sorted(REGISTRY)
         if a != "qwen3-1.7b" and _paged_supported(REGISTRY[a])] + [
    ("hfa-paper-mini", {"d_head": 96})]
IDS = [a + ("-d96" if kw else "") for a, kw in CASES]


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def test_every_paged_arch_is_registered():
    """The port registers exactly the configs the reference's serve CLI
    sends to its paged engine, and the SSM mamba2-2.7b, each field for
    field."""
    assert set(REGISTRY) == {name for name, cfg in JREGISTRY.items()
                             if _paged_supported(cfg)} | {"mamba2-2.7b"}
    for arch in REGISTRY:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jget_config(arch)), arch


@pytest.mark.parametrize("arch,tps", [("qwen1.5-4b", (2, 4, 5)),
                                      ("hfa-paper-mini", (2, 4, 8)),
                                      ("command-r-plus-104b", (2, 4, 8))])
def test_check_parallel_takes_the_full_size_heads(arch, tps):
    """The serving mesh's head rule on the full-size configs: 20 KV heads
    over 20 query heads (qwen1.5-4b), 32 over 32 (hfa-paper-mini), 8 under
    96 (command-r-plus-104b); a tp that does not divide them is refused."""
    cfg = get_config(arch)
    for tp in tps:
        check_parallel(cfg, tp, 1, 8)
    with pytest.raises(ValueError, match="must divide n_kv_heads"):
        check_parallel(cfg, 3, 1, 8)


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_convert_covers_every_leaf(arch, kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    ref = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    sd = convert.state_dict_from_reference(ref, tcfg)
    tm = LM(tcfg, device="cpu")
    assert set(sd) == set(tm.state_dict())
    convert.load_reference_params(tm, ref)
    back = dict(_flat(convert.reference_tree_from_state_dict(
        tm.state_dict(), tcfg)))
    want = dict(_flat(ref))
    assert set(back) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(back[name], np.asarray(w, np.float32),
                                      err_msg=name)
    if tcfg.family == "moe":
        assert tm.layers[0].ffn.router.dtype == torch.float32


def _ulps(a: np.ndarray, b: np.ndarray, dtype) -> int:
    """Largest distance in units of the last place of ``dtype``."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    shift = 16 if dtype == torch.bfloat16 else 0
    return int(np.abs((ia >> shift) - (ib >> shift)).max())


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_init_reference_draws_the_reference_weights(arch, kw, pdt):
    jcfg, tcfg = _cfgs(arch, param_dtype=pdt, **kw)
    ref = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                       jbuild(jcfg).init(jax.random.PRNGKey(0)))
    want = convert.state_dict_from_reference(ref, tcfg)
    got = LM(tcfg, device="cpu").init_reference(0).state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        bound = 0 if g.dtype == torch.bfloat16 else 4
        assert _ulps(np.asarray(w), g.to(torch.float32).numpy(),
                     g.dtype) <= bound, name


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_apply_and_loss_match_reference(arch, kw):
    jm, params, tm = family_models(arch, **kw)
    cfg = tm.cfg
    if cfg.qkv_bias:
        assert float(tm.layers[0].mixer.bq.detach().abs().min()) > 0
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 24))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(toks.astype(np.int32))}
    jl, jaux = jm.apply(params, batch)
    with torch.no_grad():
        tl, taux = tm.apply(tbatch)
        tloss, tmet = tm.loss(tbatch)
    atol = 2e-2 if cfg.attn_impl.startswith("hfa") else 1e-4
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)
    assert set(taux) == set(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-5, atol=1e-7)
    if cfg.family == "moe":
        assert float(taux["load_balance"]) > 0
    jloss, jmet = jm.loss(params, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, atol=1e-7)


def test_serve_dense_granite_prints_the_reference_sample(capsys):
    """``serve --dense`` (the fixed-batch loop over a contiguous cache)
    on the reduced granite-moe-1b-a400m: the same ``sample:`` ids."""
    want, got = _cli_lines(["--arch", "granite-moe-1b-a400m", "--reduced",
                            "--batch", "2", "--steps", "4", "--dense"],
                           capsys)
    assert got == want and len(want) == 1
