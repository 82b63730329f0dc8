"""Shared workload for the engine parity tests (test_torch_engine_fa2.py,
test_torch_engine_hfa.py, test_torch_engine_sampling.py,
test_torch_engine_groups.py and test_torch_engine_codecs_*.py) and the
serving stack's (test_torch_frontend.py, test_torch_http.py,
test_torch_router.py, test_torch_disagg.py: :func:`stack`); this module
holds no tests of its own.

The reference's ``ServingEngine`` and the port's serve the same greedy
shared-prefix workload on the reduced qwen3-1.7b (weights converted with
``models/convert.py``): a 12-token system prompt (three 4-token pages)
with unique tails, staggered arrivals, a prefill budget of 6 tokens so
prompts stream in as chunks resuming at ``start_pos > 0``, and enough
requests that later ones claim the cached prefix pages; with spec_k 4
drafts are both accepted and rolled back.  The port's
``PagedKVCache.check_invariants()`` runs after every step.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models.model import LM
from repro_torch.serving import Request, SamplingParams, ServingEngine

ENGINE_KW = dict(max_batch=3, page_size=4, max_seq=48, prefill_budget=6)
# Long enough that greedy streams start repeating, so prompt-lookup
# drafts get accepted as well as rejected (rolled back).
NEW_TOKENS = 12


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch thread for a module of many small CPU ops: several test
    processes share the machine, and their thread pools contending cost
    far more than the threads save here.  The previous count comes back
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def models(impl):
    """(reference model, its params, port model) on one rail, built once
    a process (the reference model keeps its compiled steps, which every
    engine over it shares; neither model is changed by serving)."""
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                               attn_impl=impl)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               attn_impl=impl)
    tm = convert.load_reference_params(
        LM(tcfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def family_models(arch, impl=None, **cfg_kw):
    """(reference model, its params, port model) for ``arch`` reduced (the
    config's own rail unless ``impl``; ``cfg_kw`` replaces config fields
    in both packages), built once a process.  A config with QKV biases
    gets nonzero ones (N(0, 0.1^2) from a seed), written into the
    reference's params before they are carried across: ``init`` leaves
    them 0, and a zero bias hides a wrong one."""
    kw = dict(cfg_kw, **({"attn_impl": impl} if impl else {}))
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **kw)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        params = with_qkv_bias(params)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    tm = convert.load_reference_params(
        LM(tcfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def with_qkv_bias(params, seed=11):
    """The reference's params with every ``bq``/``bk``/``bv`` leaf drawn
    N(0, 0.1^2) from ``seed`` (numpy)."""
    rng = np.random.default_rng(seed)
    mixer = dict(params["layers"]["l0"]["mixer"])
    for name in ("bq", "bk", "bv"):
        mixer[name] = jax.numpy.asarray(
            0.1 * rng.standard_normal(mixer[name].shape), mixer[name].dtype)
    layers = dict(params["layers"], l0=dict(params["layers"]["l0"],
                                            mixer=mixer))
    return dict(params, layers=layers)


def workload(vocab, n=6, seed=53):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, vocab, 12).tolist()
    return [(i, sysp + rng.integers(1, vocab, int(rng.integers(2, 7)))
             .tolist(), NEW_TOKENS) for i in range(n)]


def run_reference(jm, params, spec_k, work, **kw):
    eng = JEngine(jm, params, spec_k=spec_k, **ENGINE_KW, **kw)
    done = eng.run([(2 * i, JRequest(rid=i, prompt=p, max_new_tokens=t))
                    for i, p, t in work])
    return {f.rid: f.tokens for f in done}


def run_port(tm, spec_k, work, **kw):
    """Step loop of ``ServingEngine.run`` with the cache invariants
    checked after every step; returns (streams, stats)."""
    eng = ServingEngine(tm, spec_k=spec_k, device="cpu", **ENGINE_KW, **kw)
    arrivals = [(2 * i, Request(rid=i, prompt=p, max_new_tokens=t))
                for i, p, t in work]
    done, step = [], 0
    while arrivals or eng.sched.has_work:
        while arrivals and arrivals[0][0] <= step:
            eng.submit(arrivals.pop(0)[1])
        done.extend(eng.step())
        eng.cache.check_invariants()
        step += 1
    return {f.rid: f.tokens for f in done}, eng.stats


def check_engine_parity(models_, spec_k, **kw):
    """The greedy streams of both engines built with ``kw`` (e.g.
    ``kv_codec``) on the workload; returns the port's stats."""
    jm, params, tm = models_
    work = workload(tm.cfg.vocab_size)
    want = run_reference(jm, params, spec_k, work, **kw)
    got, stats = run_port(tm, spec_k, work, **kw)
    assert sorted(got) == list(range(len(work)))
    for rid, toks in want.items():
        assert got[rid] == toks, (spec_k, rid)
        assert len(toks) == NEW_TOKENS
    # The workload exercised what it is meant to.
    assert stats["cached_prefill_tokens"] > 0
    assert stats["prefill_chunks"] > len(work)
    if spec_k:
        assert stats["draft_accepted"] > 0 and stats["rollbacks"] > 0
    return stats


def request_pair(rid, prompt, max_new_tokens, sampling=None, **kw):
    """The same request for the reference engine and the port's:
    ``sampling`` is a dict of SamplingParams fields (None = greedy)."""
    jsp = None if sampling is None else JSamplingParams(**sampling)
    tsp = None if sampling is None else SamplingParams(**sampling)
    return (JRequest(rid=rid, prompt=list(prompt),
                     max_new_tokens=max_new_tokens, sampling=jsp, **kw),
            Request(rid=rid, prompt=list(prompt),
                    max_new_tokens=max_new_tokens, sampling=tsp, **kw))


def drive(eng, arrivals, between=None):
    """``ServingEngine.run``'s loop with the cache invariants checked after
    every step; ``between(step, eng)`` runs before each step.  Returns
    the finished requests by rid."""
    arrivals = sorted(arrivals, key=lambda a: a[0])
    done, step = [], 0
    while arrivals or eng.sched.has_work:
        while arrivals and arrivals[0][0] <= step:
            eng.submit(arrivals.pop(0)[1])
        if between is not None:
            between(step, eng)
        done.extend(eng.step())
        eng.cache.check_invariants()
        step += 1
    return {f.rid: f for f in done}


def run_pair(models_, timed, between=None, setup=None, **engine_kw):
    """Serve ``timed`` - [(arrival step, (reference request, port
    request))] - on both engines built with ``engine_kw``; returns
    (reference finished by rid, port finished by rid, reference engine,
    port engine).  ``setup(eng)`` runs on each engine once it is built,
    ``between(step, eng)`` before each step of both."""
    jm, params, tm = models_
    jeng = JEngine(jm, params, **engine_kw)
    teng = ServingEngine(tm, device="cpu", **engine_kw)
    for eng in (jeng, teng):
        if setup is not None:
            setup(eng)
    want = drive(jeng, [(t, rq[0]) for t, rq in timed], between)
    got = drive(teng, [(t, rq[1]) for t, rq in timed], between)
    return want, got, jeng, teng


# Logprobs and scores, port against reference.  fa2: the two summation
# orders of f32 attention and softmax, within 1e-5.  hfa: quant_rail
# rounds each score to a 1/128 step of the rail, so a score the two
# einsum orders put an ulp apart across a step moves that key's weight
# by a rail step (0.54%); with many scores a token some key does, and
# the logprobs differ by up to 4.0e-4 on the CPU (the streams stay
# equal).
LP_TOL = {"fa2": 1e-5, "hfa": 1e-3}


def assert_same_finished(want, got, lp_tol=1e-5):
    """Tokens, reasons and completions equal; scores and logprobs within
    ``lp_tol`` (None where the reference has None)."""
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        assert (g.tokens, g.reason) == (w.tokens, w.reason), rid
        assert g.accept_rate == w.accept_rate, rid
        _close_lps(g.token_logprobs, w.token_logprobs, lp_tol)
        _close_lps(g.prompt_logprobs, w.prompt_logprobs, lp_tol)
        assert (g.completions is None) == (w.completions is None), rid
        for gc, wc in zip(g.completions or [], w.completions or []):
            assert (gc.tokens, gc.branch, gc.reason) == \
                (wc.tokens, wc.branch, wc.reason), rid
            assert abs(gc.score - wc.score) <= lp_tol, rid
            _close_lps(gc.token_logprobs, wc.token_logprobs, lp_tol)
        assert len(g.completions or []) == len(w.completions or [])


def _close_lps(got, want, tol):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert abs(a - b) <= tol, (a, b)


# The serving stack over the engine (test_torch_frontend.py,
# test_torch_http.py, test_torch_router.py, test_torch_disagg.py): each
# package's names, and an engine builder over the shared models, so one
# scenario function drives either package.
STACK_KW = dict(max_batch=4, page_size=4, max_seq=64)


def stack(pkg, impl="fa2"):
    """The serving names of package ``pkg`` ("ref" or "port") and
    ``engine(**kw)``, an engine over :func:`models`' model of ``impl``
    with :data:`STACK_KW` as defaults (the port's on the CPU)."""
    import types
    if pkg == "ref":
        import repro.serving as mod
        from repro.serving import disagg, frontend, http, router
    else:
        import repro_torch.serving as mod
        from repro_torch.serving import disagg, frontend, http, router
    jm, params, tm = models(impl)

    def engine(**kw):
        kw = {**STACK_KW, **kw}
        if pkg == "ref":
            return mod.ServingEngine(jm, params, **kw)
        return mod.ServingEngine(tm, device="cpu", **kw)

    return types.SimpleNamespace(
        pkg=pkg, mod=mod, frontend=frontend, http=http, router=router,
        disagg=disagg, engine=engine, vocab=tm.cfg.vocab_size,
        **{name: getattr(mod, name) for name in mod.__all__})


def prompt(vocab, seed, n):
    return np.random.default_rng(seed).integers(1, vocab, n).tolist()


def pool_clean(engine):
    """Every page back in the allocator, bookkeeping consistent, no work
    left."""
    engine.cache.check_invariants()
    assert engine.cache.available_page_count == engine.cache.num_pages
    assert not engine.sched.has_work


def finished_key(fr):
    """What a client observes of a FinishedRequest, timing aside."""
    comps = None if fr.completions is None else \
        [(c.tokens, c.branch, c.reason) for c in fr.completions]
    return (fr.rid, fr.tokens, fr.reason, comps)
