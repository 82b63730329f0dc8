"""The port's Adafactor against the reference's (``optim/adafactor.py``),
on numpy inputs from a seed, each within 1e-6 of the leaf's largest
magnitude (f32 on both sides; the port sums a leaf's statistics chunk
by chunk, in another order than XLA), with the reference's state shapes.

* Two updates of a tree with stacked 1-D and 2-D layer leaves, 3-D ones
  and unstacked ones, ``groups`` 2, taken whole and in chunks of 64
  values.
* 3 training steps of the reduced command-r-plus-104b (f32, impl fa2,
  Adafactor) with ``microbatches`` 1 and 2: losses and parameters within
  1e-6; the second moments within 4e-6, since they hold squared
  gradients, which double the gradients' relative difference (the two
  packages' f32 matmul orders; 2.1e-6 seen).
* A checkpoint round trip through ``Trainer``: a run resumed from its
  step-2 checkpoint gives a fresh run's step-2 loss (1e-6) and its state
  (4e-6, as above); a save and restore of the state is exact.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild
from repro.optim import adafactor as jadafactor
from repro.optim import build_optimizer as jbuild_opt
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro.runtime.trainer import make_train_step as jmake_step
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models.model import LM
from repro_torch.optim import Adafactor, build_optimizer
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.trainer import Trainer, TrainerConfig, make_train_step
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-6
ARCH = "command-r-plus-104b"


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val, np.float32)


def _compare(got: dict, want: dict, rel=REL, what=""):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), what
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= rel, f"{what} {name}: {err:.3g} relative"


def _nested(flat: dict) -> dict:
    """Dotted reference leaf names -> the nested tree."""
    tree: dict = {}
    for name, val in flat.items():
        convert._insert(tree, name.split("."), val)
    return tree


def _state_tree(state: dict) -> dict:
    return _nested({k: {s: t.numpy() for s, t in v.items()}
                           for k, v in state["f"].items()})


# A port-keyed tree over 4 layers, period 2 (groups 2): 1-D norm scales
# and biases, 2-D and 3-D projections, an unstacked 2-D embedding and an
# unstacked 1-D scale.
SHAPES = {"embed.emb": (48, 16), "final_norm.scale": (16,),
          **{f"layers.{i}.norm1.scale": (16,) for i in range(4)},
          **{f"layers.{i}.mixer.wq": (16, 4, 8) for i in range(4)},
          **{f"layers.{i}.ffn.wg": (16, 40) for i in range(4)},
          **{f"layers.{i}.mixer.bq": (4, 8) for i in (0, 2)},
          **{f"layers.{i}.mixer.A_log": (4,) for i in (1, 3)}}


def _stacked(flat: dict) -> dict:
    out = {}
    for name, val in flat.items():
        ref, g = convert.reference_leaf(name, 2)
        out.setdefault(ref, {})[g] = val
    return _nested({
        ref: (by[None] if None in by else np.stack([by[g] for g in
                                                   sorted(by)]))
        for ref, by in out.items()})


@pytest.mark.parametrize("chunk", [None, 64])
def test_updates_of_a_stacked_tree_match_reference(chunk):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(2)]
    jsched, tsched = jwarmup_cosine(1e-2, 1, 10), warmup_cosine(1e-2, 1, 10)
    jopt = jadafactor(jsched)
    jparams = jax.tree.map(jnp.asarray, _stacked(params))
    jstate = jopt.init(jparams)
    opt = Adafactor(tsched, period=2, chunk_elems=chunk)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(tparams)
    _compare(_state_tree(state), jax.tree.map(np.asarray, jstate["f"]),
             what="init")
    for g in grads:
        jparams, jstate = jopt.update(
            jax.tree.map(jnp.asarray, _stacked(g)), jstate, jparams)
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state,
                   tparams)
    assert state["step"] == int(jstate["step"]) == 2
    _compare(_stacked({k: v.numpy() for k, v in tparams.items()}),
             jax.tree.map(np.asarray, jparams), what="params")
    _compare(_state_tree(state), jax.tree.map(np.asarray, jstate["f"]),
             what="state")
    leaves = opt.leaves(tparams)
    norm = leaves["layers.l0.norm1.scale"]
    assert norm.factored and norm.shape == (2, 16)
    assert not leaves["final_norm.scale"].factored
    assert leaves["layers.l0.mixer.wq"].factored
    assert leaves["embed.emb"].factored


@pytest.fixture(scope="module")
def ref_params():
    params = jbuild(jget_config(ARCH).reduced()).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("mb", [1, 2])
def test_three_train_steps_match_reference(ref_params, mb):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), microbatches=mb)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), microbatches=mb)
    assert tcfg.optimizer == "adafactor" and tcfg.attn_impl == "fa2"
    jm = jbuild(jcfg)
    tm = convert.load_reference_params(LM(tcfg, device="cpu"), ref_params)
    jsched, tsched = jwarmup_cosine(1e-3, 2, 10), warmup_cosine(1e-3, 2, 10)
    jopt = jbuild_opt(jcfg, jsched)
    topt = build_optimizer(tcfg, tsched)
    assert isinstance(topt, Adafactor)
    jparams = jax.tree.map(jnp.asarray, ref_params)
    jcarry = {"params": jparams, "opt_state": jopt.init(jparams)}
    jstep = jax.jit(jmake_step(jm, jopt, microbatches=mb))
    params = dict(tm.named_parameters())
    tcarry = {"params": params, "opt_state": topt.init(params)}
    tstep = make_train_step(tm, topt, microbatches=mb)
    rng = np.random.default_rng(1)
    for step in range(3):
        toks = rng.integers(1, tcfg.vocab_size, (4, 32)).astype(np.int32)
        jcarry, jmet = jstep(jcarry, {"tokens": jnp.asarray(toks)})
        tcarry, tmet = tstep(tcarry, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=REL, err_msg=f"step {step}")
    _compare(convert.reference_tree_from_state_dict(params, tcfg),
             jax.tree.map(np.asarray, jcarry["params"]), what="params")
    # The moments hold squared gradients: the gradients' relative
    # difference (f32 matmul orders, up to 1e-6 here) doubles in them.
    _compare(_state_tree(tcarry["opt_state"]),
             jax.tree.map(np.asarray, jcarry["opt_state"]["f"]),
             rel=4 * REL, what="state")


def _trainer(ckpt, steps):
    """A 3-step schedule, run to ``steps``."""
    cfg = get_config(ARCH).reduced()
    tcfg = TrainerConfig(steps=3, ckpt_every=2, ckpt_dir=str(ckpt),
                         seq_len=32, global_batch=4, warmup=1,
                         async_ckpt=False)
    tr = Trainer(LM(cfg, device="cpu"), tcfg)
    tr.tcfg.steps = steps
    return tr


def test_trainer_checkpoint_round_trip(tmp_path):
    first = _trainer(tmp_path / "a", 2).run()
    resumed = _trainer(tmp_path / "a", 3)
    res = resumed.run()
    assert any("resumed from step 2" in e for e in res["events"])
    fresh = _trainer(tmp_path / "b", 3)
    full = fresh.run()
    assert [m["step"] for m in res["metrics"]] == [2]
    np.testing.assert_allclose(res["metrics"][0]["loss"],
                               full["metrics"][2]["loss"], rtol=REL)
    np.testing.assert_allclose(first["metrics"][1]["loss"],
                               full["metrics"][1]["loss"], rtol=REL)
    # Resumed and fresh state agree to rounding (the CPU BLAS sums in
    # another order at other addresses; squared in the moments).
    carry, step = resumed.ckpt.restore_latest(resumed._init_carry())
    assert step == 3 and carry["opt_state"]["step"] == 3
    fresh_carry, _ = fresh.ckpt.restore_latest(fresh._init_carry())
    _compare(_state_tree(carry["opt_state"]),
             _state_tree(fresh_carry["opt_state"]), rel=4 * REL,
             what="resumed vs fresh")
    # A save and restore gives the state back bit for bit.
    checkpoint.save(str(tmp_path / "c"), step, carry)
    back, _ = checkpoint.restore(str(tmp_path / "c"), None,
                                 resumed._init_carry())
    assert back["opt_state"]["step"] == 3
    _compare(_state_tree(back["opt_state"]), _state_tree(carry["opt_state"]),
             rel=0.0, what="round trip")
