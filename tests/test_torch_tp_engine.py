"""Tensor- and data-parallel serving of the port's ``ServingEngine`` on
gloo ranks on the CPU (mirrors tests/test_tp_serving.py's engine tests
and tests/test_parallel_sampling.py's tp 2 case).

One set of two ranks (this process rank 0, one spawned) serves every
tp 2 job in turn, and one set of four every tp 2 x dp 2 job
(``launch/mesh.py``'s ``run_ranks``; the other ranks run
``launch/ranks.py``'s ``follow_jobs``).  Rank 0 drives each engine as
``ServingEngine.run`` does, the cache invariants checked after every
step, and ends it with ``close()``.

(c) The reduced qwen3-1.7b at tp 2 on both rails, spec_k 0 and 4, fp and
    int8 pools, and the reduced granite-moe-1b-a400m (MoE: every rank
    runs the whole FFN) at tp 2 on fa2, spec_k 0 and 4: every rank's
    greedy streams equal the reference's single-shard engine's;
    ``triplet_bytes`` equals the reference's formula summed over the
    model calls the run made (qwen3-1.7b);
    ``pool_bytes_per_shard`` is half of tp 1's.  tp 2 x dp 2 equals the
    reference and tp 2 alone on both rails at spec_k 0 and 4, its pool a
    shard that of tp 2.  dp 2 with ``max_batch=3`` and a tp that does not
    divide the heads are refused; three requests on a dp-only mesh of 2
    (``max_batch=2``) finish.
(d) An n=3 group at tp 2 equals the single-shard group, and each branch
    equals a solo request under tp 2 seeded ``branch_seed(seed, b)``.
(e) Lockstep: rank 0 submits between steps and cancels one request
    mid-stream under a fake clock (40 ms a read) with
    ``prefill_budget="adaptive"``; both ranks hold equal finished
    requests (timings included) and equal stats, and the budgets moved.
(f) ``make_tp_dp_mesh``: the shapes and indices of the ranks' meshes, and
    its refusals (degrees below 1, too few cards for NCCL, a mesh with no
    ranks behind it).
Idle: an ``AsyncFrontend`` over a tp 2 engine whose collectives wait 4 s
    idles 10 s before its requests; its keepalives hold rank 1 in
    lockstep, a rejected request counts on both ranks, and the served
    stream equals the single-shard engine's.
"""
import asyncio
import functools
import itertools
import types

import numpy as np
import pytest
import torch

from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import ranks
from repro_torch.serving import (Request, SamplingParams, ServingEngine,
                                 branch_seed)
from repro_torch.serving import engine as tengine_mod
from test_torch_engine_common import (NEW_TOKENS, family_models, models,
                                      workload)
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EKW = dict(max_batch=4, page_size=4, max_seq=48, prefill_budget=6)
RAILS = ("fa2", "hfa")
TP_RUNS = list(itertools.product(RAILS, ("fp", "int8"), (0, 4)))
MOE = "granite"             # the reduced granite-moe-1b-a400m on fa2
MOE_RUNS = (0, 4)
TPDP_RUNS = list(itertools.product(RAILS, (0, 4)))
GROUP_KW = dict(max_batch=6, page_size=4, max_seq=48)


def _triple(name):
    """(reference model, its params, port model) of a job's model name: a
    rail of the reduced qwen3-1.7b, or :data:`MOE`."""
    if name == MOE:
        return family_models("granite-moe-1b-a400m", "fa2")
    return models(name)


def _arrivals(vocab):
    return [(2 * i, Request(rid=i, prompt=p, max_new_tokens=t))
            for i, p, t in workload(vocab)]


def _group_prompt(vocab):
    return np.random.default_rng(41).integers(1, vocab, 6).tolist()


def _group_arrivals(vocab, n, seed=77):
    sp = SamplingParams(temperature=0.8, top_k=8, seed=seed)
    return [(0, Request(rid=0, prompt=_group_prompt(vocab), max_new_tokens=5,
                        sampling=sp, n=n))]


def _jobs(vocab):
    """The two-rank set's jobs, in order; "drive" names how rank 0
    drives each engine."""
    jobs = []
    for rail, codec, spec_k in TP_RUNS:
        jobs.append(dict(mesh=(2, 1), model=rail,
                         engine=dict(EKW, spec_k=spec_k, kv_codec=codec),
                         drive="workload"))
    for spec_k in MOE_RUNS:
        jobs.append(dict(mesh=(2, 1), model=MOE,
                         engine=dict(EKW, spec_k=spec_k), drive="workload"))
    jobs.append(dict(mesh=(2, 1), model="fa2",
                     engine=GROUP_KW, drive="group"))
    for b in range(3):
        jobs.append(dict(mesh=(2, 1), model="fa2",
                         engine=GROUP_KW, drive=f"solo{b}"))
    jobs.append(dict(mesh=(2, 1), model="fa2",
                     engine=dict(EKW, prefill_budget="adaptive"),
                     drive="lockstep"))
    jobs.append(dict(mesh=(1, 2), model="fa2",
                     engine=dict(max_batch=2, page_size=8, max_seq=32),
                     drive="dp_odd"))
    return jobs


def _tpdp_jobs():
    return [dict(mesh=(2, 2), model=rail,
                 engine=dict(EKW, spec_k=spec_k), drive="workload")
            for rail, spec_k in TPDP_RUNS]


class _Clock:
    """A clock that advances 40 ms at every read."""
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.04
        return self.t


def _drive(eng, arrivals, between=None):
    """``run``'s loop with the invariants checked after every step,
    ``between(step, eng)`` before each step; ends with ``close()``."""
    arrivals = sorted(arrivals, key=lambda a: a[0])
    done, step = [], 0
    try:
        while arrivals or eng.sched.has_work:
            while arrivals and arrivals[0][0] <= step:
                eng.submit(arrivals.pop(0)[1])
            if between is not None:
                between(step, eng)
            done.extend(eng.step())
            eng.cache.check_invariants()
            step += 1
    finally:
        eng.close()
    return done


def _lead_engine(mesh, job, vocab):
    """Rank 0's side of an engine job: drive it, report it, plus the
    (batch, rows) of every paged model call and the lockstep budgets."""
    model = _triple(job["model"])[2]
    calls, extra = [], {}
    for meth in ("paged_prefill", "paged_decode_step", "paged_verify_step"):
        def record(layers, tokens, *a, _orig=getattr(model, meth), **k):
            calls.append(tuple(tokens.shape))
            return _orig(layers, tokens, *a, **k)
        setattr(model, meth, record)
    ranks.reset_launches()
    try:
        eng = ServingEngine(model, mesh=mesh, device="cpu", **job["engine"])
        drive = job["drive"]
        if drive == "workload":
            done = _drive(eng, _arrivals(vocab))
        elif drive == "group":
            done = _drive(eng, _group_arrivals(vocab, 3))
        elif drive.startswith("solo"):
            done = _drive(eng, _group_arrivals(
                vocab, 1, seed=branch_seed(77, int(drive[4:]))))
        elif drive == "dp_odd":
            rng = np.random.default_rng(5)
            done = _drive(eng, [(i, Request(
                rid=i, prompt=rng.integers(1, vocab, 9).tolist(),
                max_new_tokens=5)) for i in range(3)])
        else:
            done, extra = _lead_lockstep(eng, vocab)
    finally:
        for meth in ("paged_prefill", "paged_decode_step",
                     "paged_verify_step"):
            model.__dict__.pop(meth, None)
    out = ranks.engine_report(eng, done)
    out.update(calls=calls, shape=dict(mesh.shape), index=(
        mesh.data_index, mesh.model_index), **extra)
    return out


def _lead_lockstep(eng, vocab):
    """Submits between steps, a cancel mid-stream, a fake clock on this
    rank's scheduler and prefill timer; returns (finished, {"budgets"})."""
    clock = _Clock()
    eng.sched.clock = clock
    timer = tengine_mod.time
    tengine_mod.time = types.SimpleNamespace(perf_counter=clock)
    budgets = []

    def between(step, eng):
        if step == 5:
            assert eng.cancel(2)
        if step:
            budgets.append(eng.stats["adaptive_budget_last"])

    try:
        arrivals = _arrivals(vocab)
        arrivals[3] = (1, arrivals[3][1])          # two in one interval
        done = _drive(eng, arrivals, between)
    finally:
        tengine_mod.time = timer
    return done, {"budgets": budgets}


@pytest.fixture(scope="module")
def vocab():
    return models("fa2")[2].cfg.vocab_size


@pytest.fixture(scope="module")
def specs():
    return {name: {"cfg": _triple(name)[2].cfg,
                   "state": {k: v.numpy() for k, v in
                             _triple(name)[2].state_dict().items()}}
            for name in RAILS + (MOE,)}


def _run_set(world, jobs, vocab, specs):
    def lead():
        meshes, out = {}, []
        for job in jobs:
            if job["mesh"] not in meshes:
                meshes[job["mesh"]] = mesh_lib.make_tp_dp_mesh(
                    *job["mesh"], device="cpu")
            out.append(_lead_engine(meshes[job["mesh"]], job, vocab))
        return out

    mine, theirs = mesh_lib.run_ranks(
        lead, ranks.follow_jobs, world,
        args=({"device": "cpu"}, specs, jobs), device="cpu", timeout=300)
    # Per job: [rank 0's report, rank 1's, ...].
    return [[m] + [t[i] for t in theirs] for i, m in enumerate(mine)]


@pytest.fixture(scope="module")
def two_ranks(vocab, specs):
    jobs = _jobs(vocab)
    return {(job["drive"], job["model"], job["engine"].get("kv_codec", "fp"),
             job["engine"].get("spec_k", 0)): res
            for job, res in zip(jobs, _run_set(2, jobs, vocab, specs))}


@pytest.fixture(scope="module")
def four_ranks(vocab, specs):
    jobs = _tpdp_jobs()
    return {(job["model"], job["engine"]["spec_k"]): res
            for job, res in zip(jobs, _run_set(4, jobs, vocab, specs))}


@functools.lru_cache(maxsize=None)
def _reference_streams(rail, codec, spec_k):
    """The reference's single-shard engine on the workload."""
    jm, params, _ = _triple(rail)
    eng = JEngine(jm, params, spec_k=spec_k, kv_codec=codec, **EKW)
    done = eng.run([(2 * i, JRequest(rid=i, prompt=p, max_new_tokens=t))
                    for i, p, t in workload(jm.cfg.vocab_size)])
    return {f.rid: f.tokens for f in done}


@functools.lru_cache(maxsize=None)
def _tp1_pool_bytes(rail, codec):
    eng = ServingEngine(models(rail)[2], device="cpu", kv_codec=codec,
                        **EKW)
    return eng.pool_bytes_per_shard()


def _streams(report):
    return {rid: f.tokens for rid, f in report["finished"].items()}


def _triplet_formula(cfg, tp, calls):
    """The reference's ``_count_triplets`` over the model calls a run
    made: tp shards each gather tp padded triplets, (d_head + 2) f32 a
    (slot, query row, head, layer)."""
    return sum(tp * tp * b * rows * cfg.n_heads * (cfg.d_head + 2) * 4
               * cfg.n_layers for b, rows in calls)


@pytest.mark.parametrize("rail,codec,spec_k", TP_RUNS)
def test_tp2_engine_equals_the_reference(two_ranks, rail, codec, spec_k):
    reports = two_ranks[("workload", rail, codec, spec_k)]
    want = _reference_streams(rail, codec, spec_k)
    assert len(want) == 6 and all(len(t) == NEW_TOKENS
                                  for t in want.values())
    cfg = models(rail)[2].cfg
    for rank, rep in enumerate(reports):
        assert _streams(rep) == want, rank
        st = rep["stats"]
        assert st["cached_prefill_tokens"] > 0 and st["prefill_chunks"] > 6
        if spec_k:
            assert st["draft_accepted"] > 0 and st["rollbacks"] > 0
        assert rep["pool_bytes_per_shard"] * 2 == _tp1_pool_bytes(rail, codec)
        assert rep["stats"] == reports[0]["stats"]
    calls = reports[0]["calls"]
    assert calls and st["triplet_bytes"] == _triplet_formula(cfg, 2, calls)


@pytest.mark.parametrize("spec_k", MOE_RUNS)
def test_tp2_moe_engine_equals_the_reference(two_ranks, spec_k):
    """The MoE FFN runs whole on every rank, over every row of the call
    (its capacity is the call's): each rank's streams are the reference
    single shard's."""
    reports = two_ranks[("workload", MOE, "fp", spec_k)]
    want = _reference_streams(MOE, "fp", spec_k)
    assert len(want) == 6 and all(len(t) == NEW_TOKENS
                                  for t in want.values())
    for rank, rep in enumerate(reports):
        assert _streams(rep) == want, rank
        assert rep["stats"] == reports[0]["stats"]
    assert reports[0]["pool_bytes_per_shard"] * 2 == ServingEngine(
        _triple(MOE)[2], device="cpu", **EKW).pool_bytes_per_shard()


@pytest.mark.parametrize("rail,spec_k", TPDP_RUNS)
def test_tp2_dp2_engine_equals_tp2_and_the_reference(two_ranks, four_ranks,
                                                     rail, spec_k):
    reports = four_ranks[(rail, spec_k)]
    tp2 = two_ranks[("workload", rail, "fp", spec_k)][0]
    assert len(reports) == 4
    for rank, rep in enumerate(reports):
        assert _streams(rep) == _reference_streams(rail, "fp", spec_k), rank
        assert _streams(rep) == _streams(tp2), rank
        # Sharded over "model", replicated over "data".
        assert rep["pool_bytes_per_shard"] == tp2["pool_bytes_per_shard"]
    assert reports[0]["shape"] == {"data": 2, "model": 2}


def test_dp_engine_rejects_an_indivisible_batch_and_serves_an_odd_one(
        two_ranks):
    tm = models("fa2")[2]
    with pytest.raises(ValueError, match="dp=2 must divide max_batch=3"):
        ServingEngine(tm, device="cpu", max_batch=3, page_size=8, max_seq=32,
                      mesh=types.SimpleNamespace(shape={"data": 2,
                                                        "model": 1}))
    reports = two_ranks[("dp_odd", "fa2", "fp", 0)]
    for rep in reports:
        assert sorted(rep["finished"]) == [0, 1, 2]
        assert all(len(f.tokens) == 5 for f in rep["finished"].values())
        assert rep["stats"]["triplet_bytes"] == 0          # tp 1
    assert _streams(reports[0]) == _streams(reports[1])
    assert reports[0]["shape"] == {"data": 2, "model": 1}


def test_tp_engine_rejects_a_bad_head_split():
    """tp must divide the KV heads (2 here) and the query heads: tp 3 is
    an early error from the engine and from the pools themselves."""
    tm = models("fa2")[2]
    bad = types.SimpleNamespace(shape={"data": 1, "model": 3})
    with pytest.raises(ValueError, match="divide"):
        ServingEngine(tm, device="cpu", max_batch=2, page_size=8,
                      max_seq=32, mesh=bad)
    with pytest.raises(ValueError, match="heads divisible by tp"):
        tm.init_paged_cache(8, 8, mesh=bad)


def test_parallel_sampling_group_under_tp2(two_ranks, vocab):
    """Group bookkeeping is host-side and replicated, so tp 2 leaves every
    branch stream as the single-shard group's, and each branch equals a
    solo request under tp 2 seeded branch_seed(77, b)."""
    eng = ServingEngine(models("fa2")[2], device="cpu", **GROUP_KW)
    [single] = eng.run(_group_arrivals(vocab, 3))
    for rep in two_ranks[("group", "fa2", "fp", 0)]:
        [tp] = rep["finished"].values()
        assert [c.tokens for c in tp.completions] == \
            [c.tokens for c in single.completions]
        for c in tp.completions:
            for solo in two_ranks[(f"solo{c.branch}", "fa2", "fp", 0)]:
                assert solo["finished"][0].tokens == c.tokens, c.branch


def test_lockstep_intake_and_clock_reach_every_rank(two_ranks):
    lead, follower = two_ranks[("lockstep", "fa2", "fp", 0)]
    assert lead["finished"] == follower["finished"]
    assert lead["stats"] == follower["stats"]
    assert lead["stats"]["cancelled"] == 1
    assert sorted(lead["finished"]) == [0, 1, 3, 4, 5]      # 2 cancelled
    assert all(f.ttft is not None for f in lead["finished"].values())
    assert len(set(lead["budgets"])) > 1        # the clock drove them


def test_make_tp_dp_mesh_validation(two_ranks):
    """The ranks' meshes are the reference's (dp, tp) grid; degrees below
    1, NCCL without a card each and a mesh with no ranks are refused."""
    reports = two_ranks[("workload", "fa2", "fp", 0)]
    assert [r["shape"] for r in reports[:1]] == [{"data": 1, "model": 2}]
    assert reports[0]["index"] == (0, 0)
    for mesh in (mesh_lib.make_tp_dp_mesh(1, 1, device="cpu"),
                 mesh_lib.make_tp_mesh(1, device="cpu")):
        assert mesh.shape == {"data": 1, "model": 1} and mesh.world == 1
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError, match="tp and dp must be >= 1"):
            mesh_lib.make_tp_dp_mesh(*bad, device="cpu")
    found = torch.cuda.device_count()
    with pytest.raises(RuntimeError,
                       match=f"tp=2 x dp=8 needs 16 devices, found {found}"):
        mesh_lib.make_tp_dp_mesh(2, 8, device="cuda")
    with pytest.raises(RuntimeError, match="needs its ranks"):
        mesh_lib.make_tp_dp_mesh(2, 1, device="cpu")


def test_router_and_disagg_refuse_tensor_parallel_engines():
    """Replicas behind the router and a disagg pair over engines with a
    mesh are not served yet: refused with a pointer to the roadmap."""
    from repro_torch.serving import DisaggPair, Router
    eng = types.SimpleNamespace(tp=2, dp=1, page_size=4, kv_codec="fp",
                                prefix_caching=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item "
                                                  "11c"):
        Router([types.SimpleNamespace(engine=eng)])
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item "
                                                  "11c"):
        DisaggPair(eng, eng)


IDLE_TIMEOUT = 4.0      # s the idle test's collectives wait for a rank


def test_idle_frontend_keeps_its_followers_past_the_timeout(vocab, specs):
    """A tp 2 engine behind an ``AsyncFrontend`` idles 2.5x its mesh's
    collective timeout before its first request: rank 1, waiting in
    ``follow()``, stays in lockstep through rank 0's keepalives.  Then a
    request that cannot fit is rejected on both ranks (``reject`` is
    lockstep intake) and one is served, equal to the single-shard
    engine's stream."""
    from repro_torch.serving import AsyncFrontend
    kw = dict(EKW)
    prompt, budget = workload(vocab)[0][1:]

    def reqs():
        return [Request(rid=0, prompt=prompt, max_new_tokens=100),
                Request(rid=1, prompt=prompt, max_new_tokens=budget)]

    def lead():
        mesh = mesh_lib.make_tp_dp_mesh(2, 1, device="cpu",
                                        timeout=IDLE_TIMEOUT)
        eng = ServingEngine(models("fa2")[2], mesh=mesh, device="cpu", **kw)
        assert eng.keepalive_s == IDLE_TIMEOUT / 4

        async def serve():
            fe = AsyncFrontend(eng)
            fe.start()
            await asyncio.sleep(2.5 * IDLE_TIMEOUT)
            out = [[t async for t in fe.submit(r)] for r in reqs()]
            done = [fe.result(r.rid) for r in reqs()]
            await fe.close()
            return out, done

        try:
            out, done = asyncio.run(serve())
        finally:
            eng.close()
        return out, ranks.engine_report(eng, done)

    (out, mine), [[theirs]] = mesh_lib.run_ranks(
        lead, ranks.follow_jobs, 2,
        args=({"device": "cpu", "timeout": IDLE_TIMEOUT}, specs,
              [dict(mesh=(2, 1), model="fa2", engine=kw)]),
        device="cpu", timeout=300)
    single = ServingEngine(models("fa2")[2], device="cpu", **kw).run(
        [(0, r) for r in reqs()])
    want = {f.rid: (f.tokens, f.reason) for f in single}
    for rep in (mine, theirs):
        assert {rid: (f.tokens, f.reason)
                for rid, f in rep["finished"].items()} == want
        assert rep["stats"]["rejected"] == 1
        assert rep["stats"] == mine["stats"]
    assert want[0] == ([], "rejected") and len(want[1][0]) == budget
    assert out == [[], want[1][0]]
