"""Seeded sampling in the port's ServingEngine against the reference
engine, on the CPU, on both rails (workload and models in
tests/test_torch_engine_common.py; the cache invariants are checked
after every step).

* Sampled streams (temperature 0.8, top-k 50, top-p 0.95, repetition
  penalty 1.1, seed = rid; every other request at temperature 0.1,
  top-k 4, whose drafts get accepted) equal the reference's token for
  token at spec_k 0, 4 and "auto", with equal ``stats`` dicts; two
  requests' prompt and token logprobs agree within 1e-5 on fa2 (within
  ``LP_TOL`` on hfa, whose rail quantizes each score), with None where
  a prefix was cached.
* A request samples the same stream solo, beside 7 neighbours and under
  speculation, and that stream is the port's sequential dense-loop
  oracle's (mirrors tests/test_sampling_spec.py (b), (d)).
* The adaptive prefill budget, under one injected clock for both
  engines, gives equal streams and equal per-step budgets.
* ``cancel`` mid-prefill, mid-decode and mid-group leaves the cache
  clean, as in the reference.
"""
import types

import numpy as np
import pytest
import torch

from repro.serving import engine as jengine_mod
from repro_torch.serving import Request, SamplingParams, ServingEngine
from repro_torch.serving import engine as tengine_mod
from repro_torch.serving import sampler as S
from test_torch_engine_common import (ENGINE_KW, LP_TOL, NEW_TOKENS,
                                      assert_same_finished, drive, models,
                                      request_pair, run_pair, workload)
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95,
               repetition_penalty=1.1)
# Cool enough that prompt-lookup drafts also get accepted on both rails.
COOL = dict(temperature=0.1, top_k=4)


@pytest.fixture(scope="module", params=["fa2", "hfa"])
def rail_models(request):
    return models(request.param)


def _sampled_work(vocab):
    """The greedy parity workload, sampled: even rids at SAMPLED, odd
    ones at COOL, seed = rid; rids 0 and 3 (whose prompt's first pages
    come from the prefix cache) ask for logprobs."""
    return [(2 * i, request_pair(i, p, t, dict(COOL if i % 2 else SAMPLED,
                                               seed=i),
                                 logprobs=i in (0, 3)))
            for i, p, t in workload(vocab)]


@pytest.mark.parametrize("spec_k", [0, 4, "auto"])
def test_sampled_streams_match_reference(rail_models, spec_k):
    tm = rail_models[2]
    want, got, jeng, teng = run_pair(
        rail_models, _sampled_work(tm.cfg.vocab_size), spec_k=spec_k,
        **ENGINE_KW)
    assert_same_finished(want, got, LP_TOL[tm.cfg.attn_impl])
    assert teng.stats == jeng.stats
    assert all(len(f.tokens) == NEW_TOKENS for f in got.values())
    assert teng.stats["cached_prefill_tokens"] > 0
    if spec_k:
        assert teng.stats["draft_accepted"] > 0
        assert teng.stats["rollbacks"] > 0
    if spec_k == "auto":
        assert 1 <= teng.stats["spec_k_last"] <= teng.AUTO_SPEC_KMAX
    # Logprobs: every position scored for rid 0; None where rid 3's
    # prompt came from the prefix cache.
    first, cached = got[0].prompt_logprobs, got[3].prompt_logprobs
    assert first[0] is None and None not in first[1:]
    assert cached[1] is None and cached[-1] is not None
    for f in (got[0], got[3]):
        lps = [x for x in f.prompt_logprobs + f.token_logprobs
               if x is not None]
        assert len(f.token_logprobs) == NEW_TOKENS
        assert all(np.isfinite(x) and x <= 0.0 for x in lps)


def _dense_loop(tm, req, max_seq):
    """The sequential oracle: the dense fixed-cache loop, one token at a
    time, sampling each from the last logits at its stream position."""
    sp = req.sampling
    presence = torch.zeros((1, tm.cfg.padded_vocab), dtype=torch.bool)
    presence[0, req.prompt] = True

    def pick(logits, pos):
        return int(S.sample_tokens(
            logits[None].float(), presence,
            torch.tensor([sp.seed], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32),
            torch.tensor([sp.temperature]), torch.tensor([sp.top_k],
                                                         dtype=torch.int32),
            torch.tensor([sp.top_p]),
            torch.tensor([sp.repetition_penalty]))[0])

    cache = tm.init_cache(1, max_seq)
    lg, cache = tm.prefill(cache, torch.tensor([req.prompt]))
    toks = [pick(lg[0, -1], len(req.prompt))]
    presence[0, toks[-1]] = True
    for i in range(req.max_new_tokens - 1):
        lg, cache = tm.decode_step(cache, torch.tensor([[toks[-1]]]))
        toks.append(pick(lg[0, -1], len(req.prompt) + i + 1))
        presence[0, toks[-1]] = True
    return toks


def test_sampled_stream_is_batch_composition_invariant(rail_models):
    """A probe samples the same stream solo, beside 7 sampled neighbours,
    and under speculation; on fa2 that stream is the dense loop's."""
    tm = rail_models[2]
    vocab = tm.cfg.vocab_size
    rng = np.random.default_rng(107)
    probe = Request(rid=0, prompt=rng.integers(1, vocab, 5).tolist(),
                    max_new_tokens=10,
                    sampling=SamplingParams(temperature=0.9, top_k=16,
                                            top_p=0.9, seed=1234))
    neighbours = [Request(rid=j + 1,
                          prompt=rng.integers(1, vocab, 4 + j % 3).tolist(),
                          max_new_tokens=8 + j % 4,
                          sampling=SamplingParams(temperature=0.7,
                                                  repetition_penalty=1.2,
                                                  seed=77 + j))
                  for j in range(7)]

    def run(n, spec_k):
        eng = ServingEngine(tm, max_batch=8, page_size=4, max_seq=48,
                            spec_k=spec_k, device="cpu")
        done = drive(eng, [(0, probe)] + [(0, r) for r in neighbours[:n]])
        return done[0].tokens

    solo = run(0, 0)
    assert run(7, 0) == solo, "neighbours perturbed a seeded stream"
    assert run(7, 4) == solo, "speculation perturbed a seeded stream"
    if tm.cfg.attn_impl == "fa2":
        assert solo == _dense_loop(tm, probe, 48)


def test_sampled_engine_matches_dense_loop():
    """Penalty and both filters on: the engine's streams equal the
    sequential dense-loop oracle's (fa2; mirrors
    test_sampled_engine_matches_reference_loop)."""
    tm = models("fa2")[2]
    rng = np.random.default_rng(109)
    reqs = [Request(rid=i, prompt=rng.integers(1, 512, 6).tolist(),
                    max_new_tokens=8,
                    sampling=SamplingParams(temperature=0.8, top_k=32,
                                            top_p=0.95,
                                            repetition_penalty=1.3,
                                            seed=i * 11 + 3))
            for i in range(3)]
    eng = ServingEngine(tm, max_batch=2, page_size=4, max_seq=48,
                        device="cpu")
    done = drive(eng, [(i, r) for i, r in enumerate(reqs)])
    for r in reqs:
        assert done[r.rid].tokens == _dense_loop(tm, r, 48), r.rid


def test_spec_auto_depth_tracks_accept_rate():
    """k = clamp(round(ema * (kmax + 1)), 1, kmax), pinned by priming
    the EMA before one decode step."""
    tm = models("fa2")[2]
    prompt = np.random.default_rng(127).integers(1, 512, 6).tolist()
    for ema, want in ((0.0, 1), (0.6, 3), (1.0, 4)):
        eng = ServingEngine(tm, max_batch=2, page_size=4, max_seq=48,
                            spec_k="auto", device="cpu")
        assert eng.auto_spec and eng.spec_k == eng.AUTO_SPEC_KMAX
        eng.stats["accept_rate_ema"] = ema
        eng.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=4))
        eng.step()                   # prefill
        eng.step()                   # the first auto-depth decode step
        assert eng.stats["spec_k_last"] == want, ema
    eng = ServingEngine(tm, max_batch=2, page_size=4, max_seq=48,
                        device="cpu")
    [f] = eng.run([(0, Request(rid=0, prompt=list(prompt),
                               max_new_tokens=5))])
    assert f.accept_rate is None
    assert eng.stats["accept_rate_ema"] == 0.0
    assert eng.stats["spec_k_last"] == 0
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(tm, max_batch=2, page_size=4, max_seq=48,
                      spec_k="fast", device="cpu")
    with pytest.raises(ValueError, match="prefill_budget"):
        ServingEngine(tm, max_batch=2, page_size=4, max_seq=48,
                      prefill_budget="fast", device="cpu")


class _Clock:
    """A clock that advances 40 ms at every read."""
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.04
        return self.t


def test_adaptive_prefill_budget_matches_reference(rail_models,
                                                   monkeypatch):
    """Each engine's scheduler and prefill timer read one injected clock:
    the same per-step budgets, streams and stats."""
    clocks = {jengine_mod: _Clock(), tengine_mod: _Clock()}
    for mod, clock in clocks.items():
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(perf_counter=clock))
    budgets = {}

    def setup(eng):
        mod = tengine_mod if isinstance(eng, ServingEngine) else jengine_mod
        eng.sched.clock = clocks[mod]

    def between(step, eng):
        if step:
            budgets.setdefault(type(eng).__module__, []).append(
                eng.stats["adaptive_budget_last"])

    tm = rail_models[2]
    want, got, jeng, teng = run_pair(
        rail_models, _sampled_work(tm.cfg.vocab_size), between, setup,
        **dict(ENGINE_KW, prefill_budget="adaptive", adaptive_floor=4,
               adaptive_ceiling=16))
    assert_same_finished(want, got, LP_TOL[tm.cfg.attn_impl])
    assert teng.stats == jeng.stats
    j, t = budgets.values()
    assert t == j and len(set(t)) > 1, (t, j)


def test_cancel_matches_reference_and_leaves_cache_clean(rail_models):
    """Cancel one request mid-prefill, one mid-decode and one n=3 group
    after its fan-out; the others finish as in the reference, with the
    cache invariants checked after every step."""
    tm = rail_models[2]
    rng = np.random.default_rng(67)
    prompts = [rng.integers(1, tm.cfg.vocab_size, n).tolist()
               for n in (14, 5, 6, 7)]
    timed = [(0, request_pair(0, prompts[0], 8, dict(SAMPLED, seed=1))),
             (0, request_pair(1, prompts[1], 10, dict(SAMPLED, seed=2))),
             (1, request_pair(2, prompts[2], 10, dict(SAMPLED, seed=4),
                              n=3)),
             (2, request_pair(3, prompts[3], 8, None))]
    plan = {1: 0, 3: 1, 4: 2}       # step -> rid cancelled before it
    states = {}

    def between(step, eng):
        rid = plan.get(step)
        if rid is None:
            return
        st = [s for s in eng.sched.running.values() if s.req.rid == rid]
        states.setdefault(rid, set()).add(
            "group" if st and st[0].group is not None and len(st) > 1
            else "decode" if st and st[0].decoding else "prefill")
        assert eng.cancel(rid)
        eng.cache.check_invariants()

    want, got, jeng, teng = run_pair(rail_models, timed, between,
                                     max_batch=5, page_size=4, max_seq=48,
                                     prefill_budget=6)
    assert states == {0: {"prefill"}, 1: {"decode"}, 2: {"group"}}
    assert sorted(got) == [3]
    assert_same_finished(want, got, LP_TOL[tm.cfg.attn_impl])
    assert teng.stats == jeng.stats and teng.stats["cancelled"] == 3
    assert teng.cache.available_page_count == teng.cache.num_pages
