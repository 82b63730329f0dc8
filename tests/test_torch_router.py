"""The port's router against the reference's.

``RouterCore`` is host bookkeeping, so it is held bit-exact: random
traces of place / finish / down / up / publish / evict events (through
hypothesis when installed, through numpy traces always) drive the
reference's core and the port's over the same chain-hash tables, and
every return value (placements, the ``down`` lists, raised errors) and
every state after an event (placement map, load counts, live set) must
be equal.  The reference's directed cases run on both cores.

``Router`` over two frontends of each package (reduced qwen3-1.7b, the
port on the CPU): a stream held open spreads the next request to the
other replica, a repeat of the first prompt is prefix-routed to the
replica holding it and streams the same tokens, and a replica that goes
down hands its in-flight rids back and its traffic re-routes; the same
placements, statistics and streams on both packages, every pool clean.
"""
import asyncio

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # manual traces only
    HAVE_HYPOTHESIS = False

from repro.serving.router import RouterCore as JRouterCore
from repro_torch.serving.router import RouterCore
from test_torch_engine_common import (one_torch_thread,  # noqa: F401
                                      pool_clean, stack)

N_REPLICAS = 4
N_CHAINS = 6
MAX_DEPTH = 5
N_OPS = 6


def _chain(base, depth):
    return [(base, i) for i in range(depth)]


def _outcome(fn, *args):
    """fn's return value, or the type of what it raised."""
    try:
        return ("ok", fn(*args))
    except (ValueError, RuntimeError, KeyError) as e:
        return ("raised", type(e).__name__)


def _state(core):
    return (dict(core.placement), list(core.load), set(core.live), core.n)


def _run_trace(ops):
    """Both cores over the same tables and events, compared after each."""
    tables = [set() for _ in range(N_REPLICAS)]
    cores = (JRouterCore(tables), RouterCore(tables))
    rid = 0
    for code, seed in ops:
        rng = np.random.default_rng(seed)
        if code in (0, 1):                         # place
            hashes = _chain(int(rng.integers(0, N_CHAINS)),
                            int(rng.integers(0, MAX_DEPTH + 1)))
            hits = [[c.prefix_hits(i, hashes) for i in range(N_REPLICAS)]
                    for c in cores]
            assert hits[0] == hits[1]
            out = [_outcome(c.place, rid, hashes) for c in cores]
            assert out[0] == out[1]
            if out[0][0] == "ok":                  # double placement
                assert [_outcome(c.place, rid, hashes) for c in cores] == \
                    [("raised", "ValueError")] * 2
            rid += 1
        elif code == 2:                            # finish
            placed = sorted(cores[0].placement)
            if placed:
                r = placed[int(rng.integers(len(placed)))]
                out = [c.finish(r) for c in cores]
                assert out[0] == out[1]
        elif code == 3:                            # down (twice: idempotent)
            replica = int(rng.integers(0, N_REPLICAS))
            for _ in range(2):
                out = [c.down(replica) for c in cores]
                assert out[0] == out[1]
        elif code == 4:                            # up (twice)
            replica = int(rng.integers(0, N_REPLICAS))
            for _ in range(2):
                for c in cores:
                    c.up(replica)
        else:                                      # publish a prefix
            tables[int(rng.integers(0, N_REPLICAS))].update(
                _chain(int(rng.integers(0, N_CHAINS)),
                       int(rng.integers(1, MAX_DEPTH + 1))))
        if rng.random() < 0.2:                     # LRU aging on a replica
            t = tables[int(rng.integers(0, N_REPLICAS))]
            drop = sorted(t)
            for h in drop[:int(rng.integers(0, len(drop) + 1))]:
                t.discard(h)
        assert _state(cores[0]) == _state(cores[1])
    for r in sorted(cores[0].placement):
        assert cores[0].finish(r) == cores[1].finish(r)
    assert _state(cores[0]) == _state(cores[1])


if HAVE_HYPOTHESIS:
    @settings(max_examples=80, deadline=None)
    @given(ops=st.lists(st.tuples(st.integers(0, N_OPS - 1),
                                  st.integers(0, 10 ** 6)),
                        min_size=1, max_size=120))
    def test_router_core_random_trace_matches_the_reference(ops):
        _run_trace(ops)


def test_router_core_manual_traces_match_the_reference():
    """No-hypothesis traces through the same comparison."""
    rng = np.random.default_rng(300)
    for _ in range(300):
        _run_trace([(int(rng.integers(0, N_OPS)), int(rng.integers(0, 10 ** 6)))
                    for _ in range(int(rng.integers(1, 121)))])


def _directed(core_cls):
    out = []
    tables = [set(_chain(0, 1)), set(_chain(0, 3)), set()]
    core = core_cls(tables)
    out += [core.place(0, _chain(0, 4)), core.place(1, _chain(5, 2)),
            core.down(1), core.place(2, _chain(0, 4))]
    core = core_cls([set(), set(), set()])
    out += [core.place(i, []) for i in range(3)]
    core.finish(1)
    out += [core.place(3, []), core.place(4, [])]
    for tables in ([], None):
        try:
            core = core_cls(tables if tables is not None else [set()])
            if tables is None:
                core.down(0)
                core.place(0, [])
        except (ValueError, RuntimeError) as e:
            out.append(type(e).__name__)
    return out


def test_router_core_directed_cases_match_the_reference():
    """Longest prefix first, then least loaded, then lowest index; a
    downed replica's rids come back; no replica raises."""
    want = _directed(JRouterCore)
    assert _directed(RouterCore) == want
    assert want == [1, 0, [0], 0, 0, 1, 2, 1, 0, "ValueError",
                    "RuntimeError"]


# ------------------------------------------------------- Router, live
async def _router_scenario(ns):
    engines = [ns.engine(max_seq=64), ns.engine(max_seq=64)]
    frontends = [ns.AsyncFrontend(e) for e in engines]
    router = ns.Router(frontends)
    placed = {}

    def submit(rid, prompt, n):
        gen = router.submit(ns.Request(rid=rid, prompt=list(prompt),
                                       max_new_tokens=n))
        placed[rid] = router.core.placement[rid]
        return gen

    async def collect(gen):
        return [tok async for tok in gen]

    pa, pb = list(range(1, 33)), list(range(40, 56))
    # Hold A open past its first token, so B sees replica 0 loaded.
    gen_a = submit(0, pa, 12)
    toks_a = [await gen_a.__anext__()]
    toks_b = await collect(submit(1, pb, 8))
    toks_a += await collect(gen_a)
    # A repeat of A prefix-routes to A's replica, token for token.
    toks_a2 = await collect(submit(2, pa, 12))
    assert toks_a2 == toks_a and placed == {0: 0, 1: 1, 2: 0}
    assert router.stats["prefix_routed"] >= 1
    assert not router.core.placement and not any(router.core.load)
    # Replica 0 is marked down with a request in flight: the core hands
    # its rid back, the caller re-places it, and it lands on replica 1.
    gen_c = submit(3, pa, 24)
    await gen_c.__anext__()
    lost = router.core.down(0)
    await gen_c.aclose()
    await frontends[0].close()
    assert not router.failed and router.core.live == {1}
    replaced = {rid: await collect(submit(rid, pa, 24)) for rid in lost}
    assert placed[3] == 1 and replaced[3][:12] == toks_a
    await router.drain()
    await router.close()
    for e in engines:
        pool_clean(e)
    return (toks_a, toks_b, placed, lost, replaced, dict(router.stats),
            [e.stats["steps"] > 0 for e in engines])


@pytest.mark.usefixtures("one_torch_thread")
def test_router_over_two_frontends_matches_the_reference():
    want = asyncio.run(_router_scenario(stack("ref")))
    got = asyncio.run(_router_scenario(stack("port")))
    assert got == want
    assert want[3] == [3]
