"""Sequence groups in the port's ServingEngine: parallel sampling
(``n``, ``best_of``) and beam search over copy-on-write forks, on the
CPU, against the reference engine and against the port itself (mirrors
tests/test_parallel_sampling.py (a)-(c); its 2-way tensor-parallel case
is test_torch_tp_engine.py's n=3 group at tp 2).

* n=3 branches equal the reference's group and three single requests
  seeded by ``branch_seed``, on both rails; speculation leaves them
  unchanged; a group evicted under pool pressure re-derives the same
  completions.
* best_of=4, n=2 equals the reference (tokens exact, scores within
  1e-5 on fa2, ``LP_TOL`` on hfa) and is the top 2 of the full group.
* Beam width 1 equals greedy on both rails; beam 3 equals the reference
  (tokens exact, scores as above), does not depend on the slots its
  branches land on, and its scores are ranked and negative.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.serving import (InvalidRequestError, Request,
                                 SamplingParams, ServingEngine, branch_seed)
from test_torch_engine_common import (LP_TOL, assert_same_finished, drive,
                                      models, request_pair, run_pair)
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(max_batch=6, page_size=4, max_seq=64)


@pytest.fixture(scope="module", params=["fa2", "hfa"])
def rail_models(request):
    return models(request.param)


@pytest.fixture(scope="module")
def fa2_port():
    return models("fa2")[2]


def _one(tm, req, **kw):
    eng = ServingEngine(tm, device="cpu", **dict(KW, **kw))
    done = drive(eng, [(0, req)])
    return done[req.rid], eng


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, 512, n).tolist()


def test_parallel_sampling_matches_reference_and_single_requests(
        rail_models):
    """n=3 of one group == the reference's group == 3 independent requests
    with the derived branch seeds, branch for branch."""
    tm = rail_models[2]
    prompt = _prompt(11, 6)
    sp = dict(temperature=0.8, top_k=8, seed=314)
    want, got, jeng, teng = run_pair(
        rail_models, [(0, request_pair(0, prompt, 6, sp, n=3))], **KW)
    assert_same_finished(want, got, LP_TOL[tm.cfg.attn_impl])
    assert teng.stats == jeng.stats
    fin = got[0]
    assert [c.branch for c in fin.completions] == [0, 1, 2]
    assert teng.stats["groups"] == 1 and teng.stats["forks"] == 2
    assert fin.tokens == fin.completions[0].tokens
    for c in fin.completions:
        solo, _ = _one(tm, Request(rid=1, prompt=prompt, max_new_tokens=6,
                                   sampling=SamplingParams(**dict(
                                       sp, seed=branch_seed(314,
                                                            c.branch)))))
        assert c.tokens == solo.tokens, c.branch


def test_parallel_sampling_composes_with_speculation(fa2_port):
    prompt = _prompt(13, 5)
    sp = SamplingParams(temperature=0.7, top_k=4, seed=99)
    req = lambda: Request(rid=0, prompt=prompt, max_new_tokens=12,  # noqa
                          sampling=sp, n=3)
    plain, _ = _one(fa2_port, req())
    spec, eng = _one(fa2_port, req(), spec_k=3)
    assert [c.tokens for c in spec.completions] == \
        [c.tokens for c in plain.completions]
    assert eng.stats["draft_tokens"] > 0


def test_best_of_matches_reference_and_ranks(rail_models):
    """best_of=4, n=2: the reference's two completions, and the best two
    of the full n=4 group by score."""
    tm = rail_models[2]
    prompt = _prompt(17, 6)
    sp = dict(temperature=0.9, top_k=8, seed=7)
    want, got, jeng, teng = run_pair(
        rail_models, [(0, request_pair(0, prompt, 5, sp, n=2, best_of=4))],
        **KW)
    assert_same_finished(want, got, LP_TOL[tm.cfg.attn_impl])
    assert teng.stats == jeng.stats
    full, _ = _one(tm, Request(rid=0, prompt=prompt, max_new_tokens=5,
                               sampling=SamplingParams(**sp), n=4,
                               best_of=4))
    top2 = got[0].completions
    best = sorted(full.completions, key=lambda c: (-c.score, c.branch))[:2]
    assert [(c.branch, c.tokens) for c in top2] == \
        [(c.branch, c.tokens) for c in best]
    assert top2[0].score >= top2[1].score


def test_parallel_sampling_group_preemption_is_lossless(fa2_port):
    prompt = _prompt(19, 6)
    sp = SamplingParams(temperature=0.8, top_k=4, seed=5)
    mk = lambda rid: Request(rid=rid, prompt=prompt, max_new_tokens=8,  # noqa
                             sampling=sp, n=2)
    calm, _ = _one(fa2_port, mk(0))
    eng = ServingEngine(fa2_port, max_batch=4, page_size=4, num_pages=8,
                        max_seq=40, device="cpu")
    done = drive(eng, [(0, mk(0)), (0, Request(rid=1,
                                               prompt=_prompt(20, 4),
                                               max_new_tokens=8))])
    assert eng.stats["preemptions"] >= 1, "pool never pressured"
    assert [c.tokens for c in done[0].completions] == \
        [c.tokens for c in calm.completions]


def test_group_width_over_max_batch_rejected(fa2_port):
    prompt = _prompt(23, 4)
    eng = ServingEngine(fa2_port, device="cpu", **dict(KW, max_batch=3))
    with pytest.raises(ValueError, match="group width"):
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=4, n=4))
    fins = eng.run([(0, Request(rid=0, prompt=prompt, max_new_tokens=4,
                                n=4))])
    assert fins[0].reason == "rejected"
    for bad in (Request(rid=1, prompt=prompt, max_new_tokens=4,
                        beam_width=2, best_of=3),
                Request(rid=2, prompt=prompt, max_new_tokens=4, n=3,
                        best_of=2),
                Request(rid=3, prompt=prompt, max_new_tokens=4,
                        beam_width=2,
                        sampling=SamplingParams(temperature=0.5))):
        with pytest.raises(InvalidRequestError):
            eng.run([(0, bad)])


def test_beam_width_one_equals_greedy(rail_models):
    tm = rail_models[2]
    for trial in range(2):
        prompt = _prompt(29 + trial, 5 + trial)
        greedy, _ = _one(tm, Request(rid=0, prompt=prompt,
                                     max_new_tokens=6))
        beam, _ = _one(tm, Request(rid=0, prompt=prompt, max_new_tokens=6,
                                   beam_width=1))
        assert beam.completions[0].tokens == greedy.tokens
        assert beam.tokens == greedy.tokens


def test_beam_matches_reference(rail_models):
    """beam 3, n=3 beside a sampled neighbour (which speculates while the
    beam rides along on one column): tokens exact, scores and logprobs
    within LP_TOL, equal stats."""
    tm = rail_models[2]
    prompt = _prompt(37, 6)
    timed = [(0, request_pair(0, prompt, 5, None, beam_width=3, n=3,
                              logprobs=True)),
             (1, request_pair(1, _prompt(38, 7), 8,
                              dict(temperature=0.7, top_k=8, seed=3)))]
    want, got, jeng, teng = run_pair(rail_models, timed, spec_k=2, **KW)
    assert_same_finished(want, got, LP_TOL[tm.cfg.attn_impl])
    assert teng.stats == jeng.stats
    assert teng.stats["beam_steps"] > 0 and len(got[0].completions) == 3


def test_beam_results_invariant_to_slot_permutation(fa2_port):
    """The same beam request alone (slots 0..2) and after two neighbours
    (permuted slots): identical completions and scores."""
    prompt = _prompt(31, 6)
    mk = lambda: Request(rid=9, prompt=prompt, max_new_tokens=5,  # noqa
                         beam_width=3, n=3)
    alone, _ = _one(fa2_port, mk())
    eng = ServingEngine(fa2_port, device="cpu", **KW)
    done = drive(eng, [(0, Request(rid=i, prompt=_prompt(32 + i, 4 + i),
                                   max_new_tokens=10)) for i in range(2)]
                 + [(1, mk())])
    assert [(c.tokens, round(c.score, 5)) for c in done[9].completions] \
        == [(c.tokens, round(c.score, 5)) for c in alone.completions]


def test_beam_scores_are_ranked_and_normalized(fa2_port):
    fin, eng = _one(fa2_port, Request(rid=0, prompt=_prompt(37, 6),
                                      max_new_tokens=5, beam_width=4, n=4))
    scores = [c.score for c in fin.completions]
    assert len(scores) == 4 and scores == sorted(scores, reverse=True)
    assert all(s < 0 for s in scores)
    assert eng.stats["beam_steps"] > 0
    # Length penalty 0 scores the raw sum: still ranked.
    fin0, _ = _one(fa2_port, dataclasses.replace(
        Request(rid=0, prompt=_prompt(37, 6), max_new_tokens=5,
                beam_width=4, n=4), length_penalty=0.0))
    s0 = [c.score for c in fin0.completions]
    assert s0 == sorted(s0, reverse=True)
