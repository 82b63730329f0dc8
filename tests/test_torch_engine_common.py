"""Shared workload for the engine parity tests (test_torch_engine_fa2.py
and test_torch_engine_hfa.py); this module holds no tests of its own.

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

import numpy as np

import jax

from repro.configs import get_config as jget_config
from repro.models.model import build_model as jbuild
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models.model import LM
from repro_torch.serving import Request, ServingEngine

ENGINE_KW = dict(max_batch=3, page_size=4, max_seq=48, prefill_budget=6)
# Long enough that greedy streams start repeating, so prompt-lookup
# drafts get accepted as well as rejected (rolled back).
NEW_TOKENS = 12


def models(impl):
    """(reference model, its params, port model) on one rail."""
    jcfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                               attn_impl=impl)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                               attn_impl=impl)
    tm = convert.load_reference_params(
        LM(tcfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def workload(vocab, n=6, seed=53):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, vocab, 12).tolist()
    return [(i, sysp + rng.integers(1, vocab, int(rng.integers(2, 7)))
             .tolist(), NEW_TOKENS) for i in range(n)]


def run_reference(jm, params, spec_k, work):
    eng = JEngine(jm, params, spec_k=spec_k, **ENGINE_KW)
    done = eng.run([(2 * i, JRequest(rid=i, prompt=p, max_new_tokens=t))
                    for i, p, t in work])
    return {f.rid: f.tokens for f in done}


def run_port(tm, spec_k, work):
    """Step loop of ``ServingEngine.run`` with the cache invariants
    checked after every step; returns (streams, stats)."""
    eng = ServingEngine(tm, spec_k=spec_k, device="cpu", **ENGINE_KW)
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


def check_engine_parity(models_, spec_k):
    jm, params, tm = models_
    work = workload(tm.cfg.vocab_size)
    want = run_reference(jm, params, spec_k, work)
    got, stats = run_port(tm, spec_k, work)
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
