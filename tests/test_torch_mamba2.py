"""The port's Mamba-2 SSM family (``models/mamba2.py``, family "ssm")
against the reference, on the reduced mamba2-2.7b (4 layers, d_model
256, f32, chunk 16) with numpy inputs from a seed.

Tolerances (f32 on both sides; einsum, cumsum and matmul orders differ):
* ``causal_conv`` 1e-6 of the output's largest magnitude; ``ssd_chunked``
  and ``mamba_apply`` (chunked, and recurrent over every token) 1e-5,
  the SSM state too; the port's chunked scan equals its own token-by-
  token recurrence within 2e-4 (the reference's own identity,
  tests/test_mamba_moe.py).
* ``LM.init_reference(0)`` draws ``LM.init(PRNGKey(0))`` at the
  full-size dtype, bf16, bit for bit, A_log, D and dt_bias (f32 at any
  dtype) included.  The ``convert.py`` round trip is exact.
* ``LM.apply``'s logits within 1e-5 of their scale, ``LM.loss`` within
  1e-5 relative, every gradient leaf within 1e-4 of its scale.
* ``serve --arch mamba2-2.7b`` falls back to the dense loop with the
  reference's ``note:`` line and prints its ``sample:`` line (greedy
  prefill and decode through the cache's Mamba state).
* ``LM`` takes family "ssm" and still refuses "hybrid", "encdec" and
  "vlm" with the roadmap's pointer.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.models import mamba2 as jm2
from repro.models.model import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models import mamba2 as tm2
from repro_torch.models.model import LM
from test_torch_families import _flat
from test_torch_serve_cli import _cli_lines
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "mamba2-2.7b"


def _close(got, want, rel, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, f"{name}: {err:.3g} relative"


@pytest.fixture(scope="module")
def pair():
    """(reference model, its numpy params, port model with them)."""
    jm = jbuild(jget_config(ARCH).reduced())
    ref = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = convert.load_reference_params(
        LM(get_config(ARCH).reduced(), device="cpu"), ref)
    return jm, ref, tm


def test_causal_conv_and_ssd_chunked():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    st = rng.standard_normal((2, 3, 40)).astype(np.float32)
    for state in (None, st):
        got = tm2.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              None if state is None
                              else torch.from_numpy(state))
        want = jm2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if state is None else jnp.asarray(state))
        _close(got[0], want[0], 1e-6, "conv y")
        _close(got[1], want[1], 0.0, "conv window")
    b, s, h, p, n = 2, 32, 4, 8, 16
    u = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dA = -rng.random((b, s, h)).astype(np.float32) * 0.5
    Bm, Cm = (rng.standard_normal((b, s, h, n)).astype(np.float32)
              for _ in range(2))
    for chunk in (8, 16, 32):
        got = tm2.ssd_chunked(*(torch.from_numpy(a) for a in (u, dA, Bm, Cm)),
                              chunk)
        want = jm2.ssd_chunked(*(jnp.asarray(a) for a in (u, dA, Bm, Cm)),
                               chunk)
        _close(got[0], want[0], 1e-5, f"ssd y chunk {chunk}")
        _close(got[1], want[1], 1e-5, f"ssd state chunk {chunk}")


def test_mamba_apply_chunked_and_recurrent(pair):
    _, ref, tm = pair
    cfg = tm.cfg
    jp = jax.tree.map(jnp.asarray, ref["layers"]["l0"]["mixer"])
    jp = jax.tree.map(lambda a: a[0], jp)
    tp = tm.layers[0].mixer
    x = np.random.default_rng(1).standard_normal((2, 32, cfg.d_model)) \
        .astype(np.float32)
    got, gst = tm2.mamba_apply(tp, torch.from_numpy(x), cfg, chunk=16)
    want, wst = jm2.mamba_apply(jp, jnp.asarray(x), jget_config(ARCH)
                                .reduced(), chunk=16)
    _close(got, want, 1e-5, "chunked y")
    for key in wst:
        _close(gst[key], wst[key], 1e-5, f"chunked {key}")
    # Token by token from a zero state, both packages; and the port's
    # chunked scan against its own recurrence.
    state = tm2.mamba_init_state(cfg, 2, torch.float32, "cpu")
    jstate = jm2.mamba_init_state(jget_config(ARCH).reduced(), 2)
    ys, jys = [], []
    with torch.no_grad():
        for t in range(32):
            y, state = tm2.mamba_apply(tp, torch.from_numpy(x[:, t:t + 1]),
                                       cfg, state=state)
            jy, jstate = jm2.mamba_apply(jp, jnp.asarray(x[:, t:t + 1]),
                                         jget_config(ARCH).reduced(),
                                         state=jstate)
            ys.append(y)
            jys.append(np.asarray(jy))
    _close(torch.cat(ys, 1), np.concatenate(jys, 1), 1e-5, "recurrent y")
    for key in jstate:
        _close(state[key], jstate[key], 1e-5, f"recurrent {key}")
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(),
                               got.detach().numpy(), atol=2e-4)
    np.testing.assert_allclose(state["ssm"].numpy(),
                               gst["ssm"].detach().numpy(), atol=2e-4)


def test_init_reference_and_convert():
    """At the full-size parameter dtype, bf16."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                               param_dtype="bfloat16")
    ref = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                       jbuild(jcfg).init(jax.random.PRNGKey(0)))
    want = convert.state_dict_from_reference(ref, tcfg)
    tm = LM(tcfg, device="cpu").init_reference(0)
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        np.testing.assert_array_equal(g.to(torch.float32).numpy(), w,
                                      err_msg=name)
    assert tm.layers[0].mixer.A_log.dtype == torch.float32
    # convert: the reference's leaves in and back out, exactly (each was
    # drawn in the parameter dtype).
    loaded = convert.load_reference_params(LM(tcfg, device="cpu"), ref)
    back = dict(_flat(convert.reference_tree_from_state_dict(
        loaded.state_dict(), tcfg)))
    want_tree = dict(_flat(ref))
    assert set(back) == set(want_tree)
    for name, w in want_tree.items():
        np.testing.assert_array_equal(back[name], w, err_msg=name)


def test_apply_loss_and_gradients_match_reference(pair):
    jm, ref, tm = pair
    toks = np.random.default_rng(2).integers(1, tm.cfg.vocab_size,
                                             (2, 32)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, ref)
    jlogits, _ = jm.apply(jparams, {"tokens": jnp.asarray(toks)})
    logits, _ = tm.apply({"tokens": torch.from_numpy(toks)})
    _close(logits, jlogits, 1e-5, "logits")
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks)})
    tm.zero_grad()
    loss, _ = tm.loss({"tokens": torch.from_numpy(toks)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = dict(_flat(convert.reference_tree_from_state_dict(
        {k: p.grad for k, p in tm.named_parameters()}, tm.cfg)))
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    assert set(grads) == set(want)
    for name, w in want.items():
        _close(grads[name], w, 1e-4, name)


def test_serve_falls_back_to_the_dense_loop(capsys):
    """``serve --arch mamba2-2.7b``: the reference's note and sample lines
    (prompts of 32 tokens, two chunks of 16, then 4 greedy decode
    steps through the cache's Mamba state)."""
    flags = ["--arch", ARCH, "--reduced", "--batch", "2", "--steps", "4"]
    want, got = _cli_lines(flags, capsys, keep=("note:", "sample:"))
    assert got == want and len(want) == 2 and want[0].startswith("note:")


@pytest.mark.parametrize("family,kw", [
    ("hybrid", {"attn_every": 2, "attn_offset": 1}), ("encdec", {}),
    ("vlm", {})])
def test_lm_takes_ssm_and_refuses_the_other_families(family, kw):
    """``LM`` builds mamba2-2.7b (reduced here: 5.4 GB at full size) and
    refuses the hybrid, encoder-decoder and VLM families with the
    roadmap's pointer."""
    assert LM(get_config(ARCH).reduced(), device="cpu").layers[0].kind \
        == "mamba"
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              family=family, **kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13b"):
        LM(cfg, device="cpu")
