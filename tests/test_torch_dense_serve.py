"""The port's dense fixed-batch serving (``serve --dense``) against the
reference on the reduced qwen3-1.7b (4 layers, d_model 256, f32): the
reference's weights go through ``models/convert.py``, the prompts are
``DataPipeline``'s, and both packages run ``prefill`` then 16 greedy
``decode_step``s.

The reference is driven un-jitted with a cache whose ``pos`` is a
Python int, so its decode reaches the Pallas decode kernel (interpret
mode) for the ``*_pallas`` and ``hfa*`` impls, as the port's decode
always reaches its kernel; its jitted loop (``serve --dense`` itself)
traces ``pos`` and takes the one-shot jnp decode instead.

* Greedy streams: identical on all five impls (the H-FA ones in
  ``tests/test_torch_dense_serve_hfa.py``).
* Logits: fa2 and fa2_pallas within 1e-4 (f32, only the matmuls'
  summation order differs).  The H-FA impls within 1e-2: a score that
  the two packages' f32 matmuls round across a rail step (decode) or a
  bf16 boundary (the emulation's prefill) moves that key's weight by
  0.54%; the readings here are ~3e-3.
* fa2 also against the reference's jitted route (one-shot exact decode
  instead of 128-key tiles): 1e-4, the same streams.
* ``_serve_dense`` of both packages on the same weights and prompts
  prints the same ``sample:`` token ids.
* ``LM.init_reference`` and the two serve entry points' ``sample:``
  lines: ``tests/test_torch_serve_cli.py``.
"""
import contextlib
import dataclasses
import io
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models.model import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models.model import LM

STEPS = 16
BATCH, PROMPT, MAX_SEQ = 2, 24, 64


@pytest.fixture(scope="module")
def ref_params():
    cfg = jget_config("qwen3-1.7b").reduced()
    return jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.PRNGKey(0)))


def _pair(ref_params, impl):
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                               attn_impl=impl)
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               attn_impl=impl)
    tm = convert.load_reference_params(LM(tcfg, device="cpu"), ref_params)
    return jbuild(jcfg), tm


def _prompts(cfg):
    return DataPipeline.for_config(cfg, PROMPT, BATCH).batch(0)["tokens"]


def _run_reference(jm, params, toks, jit: bool):
    prefill = jax.jit(jm.prefill) if jit else jm.prefill
    decode = jax.jit(jm.decode_step) if jit else jm.decode_step
    cache = jm.init_cache(params, BATCH, MAX_SEQ)
    if not jit:
        cache["pos"] = 0                  # a host int: static in the scan
    logits, cache = prefill(params, cache, jnp.asarray(toks))
    out, stream = [np.asarray(logits)], []
    for _ in range(STEPS):
        if not jit:
            cache["pos"] = int(cache["pos"])
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        stream.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok)
        out.append(np.asarray(logits))
    return out, np.concatenate(stream, 1)


def _run_port(tm, toks):
    cache = tm.init_cache(BATCH, MAX_SEQ)
    logits, cache = tm.prefill(cache, torch.from_numpy(toks))
    out, stream = [logits.numpy()], []
    for _ in range(STEPS):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        stream.append(tok.numpy())
        logits, cache = tm.decode_step(cache, tok)
        out.append(logits.numpy())
    assert cache["pos"] == PROMPT + STEPS
    return out, np.concatenate(stream, 1)


TOLS = {"fa2": 1e-4, "fa2_pallas": 1e-4, "hfa_pallas": 1e-2, "hfa": 1e-2,
        "hfa_datapath": 1e-2}


def check_streams(ref_params, impl):
    """16 greedy steps of both packages on ``impl``: identical streams,
    logits within TOLS[impl] (fa2 also against the jitted reference)."""
    jm, tm = _pair(ref_params, impl)
    toks = _prompts(tm.cfg)
    jp = jax.tree.map(jnp.asarray, ref_params)
    want, jstream = _run_reference(jm, jp, toks, jit=False)
    got, tstream = _run_port(tm, toks)
    np.testing.assert_array_equal(tstream, jstream)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOLS[impl],
                                   err_msg=f"step {step}")
    if impl == "fa2":
        want, jstream = _run_reference(jm, jp, toks, jit=True)
        np.testing.assert_array_equal(tstream, jstream)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("impl", ["fa2", "fa2_pallas"])
def test_prefill_and_decode_match_reference(ref_params, impl):
    check_streams(ref_params, impl)


def test_serve_dense_prints_the_reference_sample(ref_params):
    """Both packages' ``_serve_dense`` loops, same weights and prompts
    (the reference's is jitted, fa2)."""
    jm, tm = _pair(ref_params, "fa2")
    args = SimpleNamespace(batch=BATCH, prompt_len=PROMPT, steps=8,
                           max_seq=MAX_SEQ)
    batch = DataPipeline.for_config(tm.cfg, PROMPT, BATCH).batch(0)
    lines = {}
    for name, run in (
            ("ref", lambda: jserve._serve_dense(
                jm, jax.tree.map(jnp.asarray, ref_params), jm.cfg, batch,
                args)),
            ("port", lambda: tserve._serve_dense(tm, tm.cfg, batch, args))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = run()
        lines[name] = [ln for ln in buf.getvalue().splitlines()
                       if ln.startswith("sample:")]
    assert lines["port"] == lines["ref"] and len(lines["ref"]) == 1
    assert res["finite"] and res["tokens"].shape == (BATCH, 8)


def test_serve_cli_dense_runs_on_the_cpu(capsys):
    tserve.main(["--arch", "qwen3-1.7b", "--reduced", "--dense", "--device",
                 "cpu", "--batch", "2", "--prompt-len", "8", "--steps", "3",
                 "--attn-impl", "hfa_datapath"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/token" in out and "sample:" in out


def test_dense_cache_refuses_overflow_and_late_prefill():
    cfg = get_config("qwen3-1.7b").reduced()
    tm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    cache = tm.init_cache(1, 8)
    _, cache = tm.prefill(cache, torch.ones(1, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="cache full"):
        tm.decode_step(cache, torch.ones(1, 1, dtype=torch.int64))
    with pytest.raises(ValueError, match="position 0"):
        tm.prefill(cache, torch.ones(1, 2, dtype=torch.int64))

