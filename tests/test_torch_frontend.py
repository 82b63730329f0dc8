"""The port's ``AsyncFrontend`` against the reference's, on the reduced
qwen3-1.7b (fa2, weights converted): the scenarios of
``tests/test_frontend.py``, each run on both packages (the port on the
CPU), with equal streams and FinishedRequests.

Every scenario also holds its own package to the reference test's
claims: streamed tokens equal ``ServingEngine.run``'s; a group bursts
its primary completion at retirement; a cancel at the first step,
mid-prefill or mid-decode, a close without drain, a group cancel and a
stream overflow leave the pool clean, each cancel's snapshot a prefix of
the uncancelled stream; rejection and ``InvalidRequestError``; the
bounded result LRU; a crashed drive task that fails loudly.  Where a
scenario's outcome depends on when a step lands (how far a cancelled
stream got), the two packages are compared on the uncancelled streams
and each snapshot is held to be their prefix.

``test_merge_xla_flags_preserves_existing`` has no counterpart: the port
sets no XLA flags.  Two port-only tests: every step runs on the
frontend's one executor thread, under ``torch.cuda.device`` of the
engine's card when it is on one.
"""
import asyncio
import contextlib
import threading

import pytest
import torch

from repro_torch.serving import frontend as tfrontend
from test_torch_engine_common import (finished_key, one_torch_thread,  # noqa: F401
                                      pool_clean, prompt, stack)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


async def _abandon(gen):
    """Abandon a live stream the way a disconnecting client does: the
    task awaiting the next token gets cancelled, which runs the
    generator's finally block."""
    nxt = asyncio.ensure_future(gen.__anext__())
    await asyncio.sleep(0)
    nxt.cancel()
    with contextlib.suppress(asyncio.CancelledError, StopAsyncIteration):
        await nxt
    await gen.aclose()


def _full(ns, req, **engine_kw):
    """The uncancelled run of ``req`` on a fresh engine."""
    [fr] = ns.engine(**engine_kw).run([(0, req)])
    return fr


def _is_prefix(snapshot, full):
    assert snapshot == full[:len(snapshot)], (snapshot, full)


# ------------------------------------------------------------ scenarios
async def stream_parity(ns):
    reqs = [ns.Request(rid=i, prompt=prompt(ns.vocab, 20 + i, 3 + i),
                       max_new_tokens=6 + i) for i in range(3)]
    gold = {f.rid: f.tokens for f in ns.engine().run([(0, r) for r in reqs])}
    fe = ns.AsyncFrontend(ns.engine())
    streams = {r.rid: fe.submit(r) for r in reqs}

    async def consume(rid, gen):
        return rid, [tok async for tok in gen]

    got = dict(await asyncio.gather(*(consume(rid, g)
                                      for rid, g in streams.items())))
    await fe.close()
    assert got == gold
    out = {}
    for r in reqs:
        fr = fe.result(r.rid)
        assert fr.tokens == gold[r.rid] and fr.reason in ("stop", "length")
        assert fr.ttft is not None and fr.ttft >= 0.0
        out[r.rid] = finished_key(fr)
    pool_clean(fe.engine)
    return got, out


async def group_burst(ns):
    req = ns.Request(rid=0, prompt=prompt(ns.vocab, 31, 5), max_new_tokens=5,
                     sampling=ns.SamplingParams(temperature=0.8, top_k=8,
                                                seed=7), n=3)
    fe = ns.AsyncFrontend(ns.engine(max_batch=6))
    toks = [tok async for tok in fe.submit(req)]
    await fe.close()
    fr = fe.result(0)
    assert toks == fr.tokens == fr.completions[0].tokens
    assert len(fr.completions) == 3
    pool_clean(fe.engine)
    return toks, finished_key(fr)


async def cancel_first_step(ns):
    req = ns.Request(rid=0, prompt=prompt(ns.vocab, 40, 6), max_new_tokens=40)
    full = _full(ns, req).tokens
    fe = ns.AsyncFrontend(ns.engine())
    await _abandon(fe.submit(req))
    await fe.close()
    fr = fe.result(0)
    assert fr.reason == "cancelled" and len(fr.tokens) < 40
    _is_prefix(fr.tokens, full)
    pool_clean(fe.engine)
    return full, fr.reason


async def cancel_mid_prefill(ns):
    # 24-token prompt at budget 4: 6 prefill steps before any token.
    req = ns.Request(rid=0, prompt=prompt(ns.vocab, 41, 24), max_new_tokens=8)
    full = _full(ns, req, prefill_budget=4).tokens
    eng = ns.engine(prefill_budget=4)
    fe = ns.AsyncFrontend(eng)
    gen = fe.submit(req)
    nxt = asyncio.ensure_future(gen.__anext__())
    while eng.stats["prefill_chunks"] == 0:
        await asyncio.sleep(0.001)
    nxt.cancel()
    with contextlib.suppress(asyncio.CancelledError, StopAsyncIteration):
        await nxt
    await gen.aclose()
    await fe.close()
    fr = fe.result(0)
    assert fr.reason == "cancelled"
    assert eng.stats["cancelled"] == 1 and eng.stats["prefill_chunks"] >= 1
    _is_prefix(fr.tokens, full)
    pool_clean(eng)
    return full, fr.reason, eng.stats["cancelled"]


async def cancel_mid_decode(ns):
    req = ns.Request(rid=0, prompt=prompt(ns.vocab, 42, 6), max_new_tokens=48)
    full = _full(ns, req).tokens
    fe = ns.AsyncFrontend(ns.engine())
    gen = fe.submit(req)
    got = []
    async for tok in gen:
        got.append(tok)
        if len(got) == 3:
            break
    await gen.aclose()
    await fe.close()
    fr = fe.result(0)
    assert fr.reason == "cancelled" and fr.tokens[:3] == got
    _is_prefix(fr.tokens, full)
    assert fe.engine.stats["cancelled"] == 1
    pool_clean(fe.engine)
    return got, full, fr.reason


async def close_without_drain(ns):
    reqs = [ns.Request(rid=i, prompt=prompt(ns.vocab, 50 + i, 4),
                       max_new_tokens=40) for i in range(3)]
    fe = ns.AsyncFrontend(ns.engine())
    gens = [fe.submit(r) for r in reqs]
    first = [await g.__anext__() for g in gens]     # all three decoding
    await fe.close(drain=False)
    for g in gens:
        await g.aclose()
    assert sorted(fe.results) == [0, 1, 2]
    assert all(fr.reason == "cancelled" for fr in fe.results.values())
    for fr, f in zip(sorted(fe.results.values(), key=lambda f: f.rid), first):
        assert fr.tokens[:1] == [f]
    pool_clean(fe.engine)
    return first, sorted(fe.results)


async def rejection_and_invalid(ns):
    fe = ns.AsyncFrontend(ns.engine())
    # prompt + budget over the per-sequence ceiling: rejected, not raised
    toks = [t async for t in fe.submit(ns.Request(
        rid=0, prompt=prompt(ns.vocab, 60, 8), max_new_tokens=4096))]
    assert toks == []
    # contradictory knobs: raised out of the client's generator
    with pytest.raises(ns.InvalidRequestError) as ei:
        async for _ in fe.submit(ns.Request(
                rid=1, prompt=prompt(ns.vocab, 61, 4), max_new_tokens=4,
                n=4, best_of=2)):
            pass
    # the frontend survives both and still serves
    good = [t async for t in fe.submit(ns.Request(
        rid=2, prompt=prompt(ns.vocab, 62, 4), max_new_tokens=3))]
    await fe.close()
    assert fe.result(0).reason == "rejected"
    assert fe.engine.stats["rejected"] == 1
    pool_clean(fe.engine)
    return toks, str(ei.value), good, finished_key(fe.result(2))


async def results_lru(ns):
    fe = ns.AsyncFrontend(ns.engine(), max_results=2)
    for i in range(3):
        async for _ in fe.submit(ns.Request(
                rid=i, prompt=prompt(ns.vocab, 70 + i, 4), max_new_tokens=3)):
            pass
    await fe.close()
    assert fe.engine.stats["results_evicted"] == 1
    assert fe.result(0) is None              # oldest entry aged out
    fr1 = fe.result(1)
    assert fr1 is not None and fe.result(1) is None     # claimed once
    fr2 = fe.result(2)
    assert fr2 is not None
    pool_clean(fe.engine)
    return finished_key(fr1), finished_key(fr2)


async def drive_crash(ns):
    eng = ns.engine()
    fe = ns.AsyncFrontend(eng)

    def bad_step():
        raise RuntimeError("device fell over")

    eng.step = bad_step
    gen = fe.submit(ns.Request(rid=0, prompt=prompt(ns.vocab, 80, 4),
                               max_new_tokens=8))
    with pytest.raises(RuntimeError, match="device fell over"):
        async for _ in gen:
            pass
    assert fe.failed
    with pytest.raises(RuntimeError, match="frontend failed") as ei:
        fe.submit(ns.Request(rid=1, prompt=prompt(ns.vocab, 81, 4),
                             max_new_tokens=4))
    assert str(ei.value.__cause__) == "device fell over"
    await fe.close()                          # still clean to close
    return fe.failed, str(ei.value)


async def group_cancel(ns):
    req = ns.Request(
        rid=0, prompt=prompt(ns.vocab, 90, 5), max_new_tokens=40,
        sampling=ns.SamplingParams(temperature=0.8, top_k=8, seed=3), n=3)
    full = _full(ns, req, max_batch=6)
    branch0 = next(c.tokens for c in full.completions if c.branch == 0)
    eng = ns.engine(max_batch=6)
    fe = ns.AsyncFrontend(eng)
    gen = fe.submit(req)
    nxt = asyncio.ensure_future(gen.__anext__())
    while not any(r.generated for r in list(eng.sched.running.values())):
        await asyncio.sleep(0.001)
    nxt.cancel()
    with contextlib.suppress(asyncio.CancelledError, StopAsyncIteration):
        await nxt
    await gen.aclose()
    await fe.close()
    fr = fe.result(0)
    assert fr.reason == "cancelled" and len(fr.tokens) > 0
    # the primary live branch (branch 0) stands in for the group
    _is_prefix(fr.tokens, branch0)
    pool_clean(eng)
    return finished_key(full), fr.reason


async def stream_overflow(ns):
    fe = ns.AsyncFrontend(ns.engine(), stream_buffer=2)
    fe.submit(ns.Request(rid=0, prompt=prompt(ns.vocab, 95, 4),
                         max_new_tokens=40))       # generator never read
    await fe.drain()
    await fe.close()
    fr = fe.result(0)
    assert fr.reason == "cancelled"
    assert fe.engine.stats["stream_overflows"] >= 1
    assert 2 <= len(fr.tokens) < 40
    pool_clean(fe.engine)
    return finished_key(fr), fe.engine.stats["stream_overflows"]


SCENARIOS = {f.__name__: f for f in (
    stream_parity, group_burst, cancel_first_step, cancel_mid_prefill,
    cancel_mid_decode, close_without_drain, rejection_and_invalid,
    results_lru, drive_crash, group_cancel, stream_overflow)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_frontend_scenario_matches_the_reference(name):
    """The scenario on the reference's frontend and on the port's: the
    same streams, FinishedRequests and counters."""
    want = asyncio.run(SCENARIOS[name](stack("ref")))
    got = asyncio.run(SCENARIOS[name](stack("port")))
    assert got == want


# ---------------------------------------------------------- port only
def test_steps_run_on_one_executor_thread():
    """Every engine step of a frontend runs on the frontend's own single
    executor thread - never the event loop's, never two threads."""
    ns = stack("port")
    eng = ns.engine()
    threads = []
    step = eng.step

    def recording_step():
        threads.append(threading.current_thread())
        return step()

    eng.step = recording_step

    async def main():
        fe = ns.AsyncFrontend(eng)
        gens = [fe.submit(ns.Request(rid=i, prompt=prompt(ns.vocab, i, 4),
                                     max_new_tokens=4)) for i in range(3)]
        for g in gens:
            async for _ in g:
                pass
        await fe.close()
        return fe

    fe = asyncio.run(main())
    assert len(threads) == eng.stats["steps"] > 1
    assert len(set(threads)) == 1
    assert threads[0] is not threading.main_thread()
    assert threads[0].name.startswith("engine-step")
    assert fe._executor is None              # shut down with the drive task
    pool_clean(eng)


def test_step_runs_under_the_engines_card(monkeypatch):
    """An engine on a card steps under ``torch.cuda.device`` of that card
    (a new thread starts on card 0, and the kernels launch on the current
    device); an engine on the CPU enters no CUDA context."""
    seen = []

    @contextlib.contextmanager
    def device(dev):
        seen.append(("enter", dev))
        yield
        seen.append(("exit", dev))

    monkeypatch.setattr(tfrontend.torch.cuda, "device", device)

    class CardEngine:
        device = torch.device("cuda", 1)

        def step(self):
            seen.append("step")
            return []

    assert tfrontend.AsyncFrontend(CardEngine())._step() == []
    dev = torch.device("cuda", 1)
    assert seen == [("enter", dev), "step", ("exit", dev)]
    seen.clear()
    CardEngine.device = torch.device("cpu")
    tfrontend.AsyncFrontend(CardEngine())._step()
    assert seen == ["step"]
