"""The port's LM against the reference on the reduced qwen3-1.7b (4
layers, d_model 256, f32): weights go through ``models/convert.py``, the
same numpy inputs through both packages' paged prefill (a first chunk
and a chunk resuming at ``start_pos > 0``), decode step and verify step.

fa2 rail: logits within 1e-4 (f32; the packages' matmuls round
differently).  hfa rail: greedy argmax equal and logits within 1e-3 -
the rail quantizes each exponential to 1/128 of an octave, so an f32
rounding difference that moves a score across a rail step moves one p by
0.54%; with these shapes the logits stay well inside 1e-3 (the K/V the
deeper layers write move up to ~5e-3, held to 2e-2).  The hfa rail
is compared paged against paged, never against a dense run (ROADMAP.md
Queue 3).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models.model import LM

PAGE = 4
NUM_PAGES = 24


@pytest.fixture(scope="module")
def ref_params():
    cfg = jget_config("qwen3-1.7b").reduced()
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _pair(ref_params, impl):
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                               attn_impl=impl)
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               attn_impl=impl)
    tm = convert.load_reference_params(LM(tcfg, device="cpu"), ref_params)
    return jbuild(jcfg), tm


def _tols(impl):
    return 1e-4 if impl == "fa2" else 1e-3


def test_convert_covers_every_parameter(ref_params):
    tcfg = get_config("qwen3-1.7b").reduced()
    sd = convert.state_dict_from_reference(ref_params, tcfg)
    assert set(sd) == set(LM(tcfg, device="cpu").state_dict())
    # Unstacked: layer i of the port is slice i of the scan stack.
    np.testing.assert_array_equal(sd["layers.2.mixer.wq"],
                                  ref_params["layers"]["l0"]["mixer"]["wq"][2])


@pytest.mark.parametrize("impl", ["fa2", "hfa"])
def test_paged_steps_match_reference(ref_params, impl):
    jm, tm = _pair(ref_params, impl)
    cfg = tm.cfg
    rng = np.random.default_rng(17)
    b = 2
    pt = rng.permutation(NUM_PAGES)[:b * 8].reshape(b, 8).astype(np.int32)
    jl = jm.init_paged_cache(NUM_PAGES, PAGE)
    tl = tm.init_paged_cache(NUM_PAGES, PAGE)
    jp = jax.tree.map(jnp.asarray, ref_params)
    tol = _tols(impl)

    def check(want, got, what):
        want, got = np.asarray(want), got.numpy()
        np.testing.assert_allclose(got, want, atol=tol, err_msg=what)
        assert np.array_equal(np.argmax(got, -1), np.argmax(want, -1)), what

    # Chunk 1 at position 0 (row 1 padded: 5 real tokens of 8), then a
    # chunk resuming at start_pos > 0.
    for start, last in (([0, 0], [7, 4]), ([8, 5], [5, 6])):
        toks = rng.integers(1, cfg.vocab_size, (b, 8)).astype(np.int32)
        start = np.asarray(start, np.int32)
        last = np.asarray(last, np.int32)
        lg_j, jl = jm.paged_prefill(jp, jl, jnp.asarray(toks),
                                    jnp.asarray(pt),
                                    last_pos=jnp.asarray(last),
                                    start_pos=jnp.asarray(start))
        lg_t, tl = tm.paged_prefill(tl, torch.from_numpy(toks),
                                    torch.from_numpy(pt),
                                    last_pos=torch.from_numpy(last),
                                    start_pos=torch.from_numpy(start))
        check(lg_j, lg_t, f"prefill at {start}")
    seq = np.array([14, 12], np.int32)
    tok = rng.integers(1, cfg.vocab_size, (b, 1)).astype(np.int32)
    lg_j, jl = jm.paged_decode_step(jp, jl, jnp.asarray(tok),
                                    jnp.asarray(pt), jnp.asarray(seq))
    lg_t, tl = tm.paged_decode_step(tl, torch.from_numpy(tok),
                                    torch.from_numpy(pt),
                                    torch.from_numpy(seq))
    check(lg_j, lg_t, "decode")
    seq = seq + 1
    toks = rng.integers(1, cfg.vocab_size, (b, 5)).astype(np.int32)
    cl = np.array([5, 3], np.int32)
    lg_j, jl = jm.paged_verify_step(jp, jl, jnp.asarray(toks),
                                    jnp.asarray(pt), jnp.asarray(seq),
                                    jnp.asarray(cl))
    lg_t, tl = tm.paged_verify_step(tl, torch.from_numpy(toks),
                                    torch.from_numpy(pt),
                                    torch.from_numpy(seq),
                                    torch.from_numpy(cl))
    # Rows past chunk_lens are garbage in both packages.
    check(np.asarray(lg_j)[0], lg_t[0], "verify row 0")
    check(np.asarray(lg_j)[1, :3], lg_t[1, :3], "verify row 1")
    # The pools the steps wrote agree too: layer 0's K/V bit for bit up
    # to matmul rounding; deeper layers carry the attention differences
    # of the layers below (a rail-step flip on hfa moves them ~5e-3).
    for key in ("k_pages", "v_pages"):
        got, want = tl["l0"][key].numpy(), np.asarray(jl["l0"][key])
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 if impl == "fa2" else 2e-2)


@pytest.mark.parametrize("impl", ["fa2", "hfa"])
def test_paged_prefill_all_positions_and_whole_prompt(ref_params, impl):
    """``return_all_logits`` (the prompt-logprobs prefill) and the
    whole-prompt prefill (no start_pos) against the reference.  The
    whole-prompt prefill runs kernel 2 from position 0; the reference's
    attends over the raw chunk, which on fa2 is the same attention and on
    hfa its dense H-FA (ROADMAP.md Queue 3 C5), so on hfa it is held to
    the reference's chunked prefill from 0, the same paged walk."""
    jm, tm = _pair(ref_params, impl)
    rng = np.random.default_rng(23)
    b, ell = 2, 7
    toks = rng.integers(1, tm.cfg.vocab_size, (b, ell)).astype(np.int32)
    pt = rng.permutation(NUM_PAGES)[:b * 3].reshape(b, 3).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, ref_params)
    tol = _tols(impl)
    last = np.array([ell - 1, 4], np.int32)
    lg_j, _ = jm.paged_prefill(jp, jm.init_paged_cache(NUM_PAGES, PAGE),
                               jnp.asarray(toks), jnp.asarray(pt),
                               last_pos=jnp.asarray(last),
                               start_pos=jnp.zeros((b,), jnp.int32),
                               return_all_logits=True)
    lg_t, _ = tm.paged_prefill(tm.init_paged_cache(NUM_PAGES, PAGE),
                               torch.from_numpy(toks), torch.from_numpy(pt),
                               last_pos=torch.from_numpy(last),
                               start_pos=torch.zeros((b,), dtype=torch.int32),
                               return_all_logits=True)
    assert lg_t.shape == (b, ell, tm.cfg.padded_vocab)
    # Row 1 is a 5-token chunk: its padded positions are garbage.
    np.testing.assert_allclose(lg_t[0].numpy(), np.asarray(lg_j)[0],
                               atol=tol)
    np.testing.assert_allclose(lg_t[1, :5].numpy(), np.asarray(lg_j)[1, :5],
                               atol=tol)
    tl = tm.init_paged_cache(NUM_PAGES, PAGE)
    whole, tl = tm.paged_prefill(tl, torch.from_numpy(toks),
                                 torch.from_numpy(pt))
    if impl == "fa2":
        jl = jm.init_paged_cache(NUM_PAGES, PAGE)
        want, jl = jm.paged_prefill(jp, jl, jnp.asarray(toks),
                                    jnp.asarray(pt))
        for key in ("k_pages", "v_pages"):
            np.testing.assert_allclose(tl["l0"][key].numpy(),
                                       np.asarray(jl["l0"][key]), atol=1e-4)
    else:
        want = lg_j
    # Causal: row 1's first 5 positions are those of its 5-token chunk.
    np.testing.assert_allclose(whole[0].numpy(), np.asarray(want)[0],
                               atol=tol)
    np.testing.assert_allclose(whole[1, :5].numpy(),
                               np.asarray(want)[1, :5], atol=tol)
    assert whole.shape == (b, ell, tm.cfg.padded_vocab)
