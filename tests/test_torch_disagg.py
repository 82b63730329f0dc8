"""The port's ``DisaggPair`` against the reference's, on the reduced
qwen3-1.7b (weights converted, the port on the CPU): the matrix of
``tests/test_disagg.py`` run on both packages.

* Token parity: the port's pair streams what the reference's pair
  streams (tokens, reasons, completions; beam scores within LP_TOL), on
  fa2 and hfa x greedy / seeded sampled / speculative / beam, and on the
  int8 and log16 page codecs; and, as in the reference, each pair equals
  a single engine of its own package token for token.
* The copy: every page the decode worker imports equals the exporter's
  page bit for bit, in every layer and every leaf - the data pools and
  int8's scale sidecars.
* Dedup of a shared system prompt, a mid-handoff abort, the stage
  fallback and the validation, with the same stats on both packages and
  both pools clean.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_engine_common import (LP_TOL, finished_key,  # noqa: F401
                                      one_torch_thread, stack)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _requests(ns, mode, n=3, seed=211):
    """The reference test's arrival trace for ``mode``; prompts long
    enough that at least one full page (page_size 4) is handed off."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(1, ns.vocab, int(rng.integers(6, 14))).tolist()
        mnt = int(rng.integers(4, 8))
        if mode == "sampled":
            reqs.append(ns.Request(rid=i, prompt=prompt, max_new_tokens=mnt,
                                   sampling=ns.SamplingParams(
                                       temperature=0.8, top_k=16,
                                       seed=500 + i)))
        elif mode == "beam":
            reqs.append(ns.Request(rid=i, prompt=prompt, max_new_tokens=mnt,
                                   beam_width=2, n=2))
        else:                              # greedy / spec share requests
            reqs.append(ns.Request(rid=i, prompt=prompt, max_new_tokens=mnt))
    return reqs


def _clone(reqs):
    return [dataclasses.replace(r, prompt=list(r.prompt)) for r in reqs]


def _scores(fin):
    return {f.rid: [c.score for c in f.completions or []] for f in fin}


def _bits(t):
    """The tensor's bit patterns (float pools viewed as integers)."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.float16: torch.int16}.get(t.dtype, t.dtype))


def _assert_imports_bit_equal(pair, h):
    """Every leaf of every layer: the staged pages hold the exporter's
    pages bit for bit.  Returns the number of leaves compared."""
    src = torch.tensor(h.src_pages, dtype=torch.int64)
    dst = torch.tensor(h.dst_pages, dtype=torch.int64)
    leaves = 0
    for name, pools in pair.prefill.layers.items():
        for key, pool in pools.items():
            got = pair.decode.layers[name][key].index_select(1, dst)
            assert torch.equal(_bits(got), _bits(pool.index_select(1, src))), \
                (name, key)
            leaves += 1
    return leaves


def _run_matrix(ns, reqs, *, codec="fp", spec_k=0):
    """Single-engine run vs DisaggPair run on cloned requests, the
    port's imports checked bit-equal to its exports on every handoff;
    returns (the pair's results, its stats, beam scores)."""
    kw = dict(max_batch=3, page_size=4, max_seq=64, spec_k=spec_k,
              kv_codec=codec)
    arrivals = lambda rs: [(i, r) for i, r in enumerate(rs)]  # noqa: E731
    single = {f.rid: finished_key(f) for f in
              ns.engine(**kw).run(arrivals(_clone(reqs)))}
    pair = ns.DisaggPair(ns.engine(**kw), ns.engine(**kw))
    if ns.pkg == "port":
        start, checked = pair.start_handoff, []

        def checking_start(req):
            h = start(req)
            if h is not None and h.src_pages:
                checked.append(_assert_imports_bit_equal(pair, h))
            return h

        pair.start_handoff = checking_start
    fin = pair.run(arrivals(_clone(reqs)))
    got = {f.rid: finished_key(f) for f in fin}
    assert got == single
    assert pair.stats["handoffs"] == len(reqs)
    assert pair.stats["handoff_pages"] > 0
    if ns.pkg == "port":
        n_leaves = 4 if codec == "int8" else 2
        assert checked and all(c == n_leaves * len(pair.prefill.layers)
                               for c in checked)
    pair.check_invariants()
    for cache in (pair.prefill.cache, pair.decode.cache):
        assert cache.available_page_count == cache.num_pages
    return got, dict(pair.stats), _scores(fin)


def _compare(want, got):
    (w, wstats, wscores), (g, gstats, gscores) = want, got
    assert g == w and gstats == wstats
    for rid, ws in wscores.items():
        assert len(gscores[rid]) == len(ws)
        assert all(abs(a - b) <= LP_TOL["hfa"] for a, b in
                   zip(gscores[rid], ws))


@pytest.mark.parametrize("rail", ["fa2", "hfa"])
@pytest.mark.parametrize("mode", ["greedy", "sampled", "spec", "beam"])
def test_disagg_pair_matches_the_reference(rail, mode):
    """Prefill on A, decode on B: the port's streams equal the
    reference pair's (and each its single engine's), on both rails and
    every decode mode; every import bit-equal to its export."""
    out = {}
    for pkg in ("ref", "port"):
        ns = stack(pkg, rail)
        out[pkg] = _run_matrix(ns, _requests(ns, mode),
                               spec_k=2 if mode == "spec" else 0)
    _compare(out["ref"], out["port"])


@pytest.mark.parametrize("codec", ["int8", "log16"])
def test_disagg_quantized_pages_match_the_reference(codec):
    """Coded pages hand off raw, the int8 scale sidecars with them: the
    same streams as the reference pair's and the single engine's."""
    out = {}
    for pkg in ("ref", "port"):
        ns = stack(pkg)
        out[pkg] = _run_matrix(ns, _requests(ns, "greedy", seed=223),
                               codec=codec)
    _compare(out["ref"], out["port"])


def _dedup(ns):
    rng = np.random.default_rng(227)
    sysp = rng.integers(1, ns.vocab, 12).tolist()         # 3 full pages
    reqs = [ns.Request(rid=i, prompt=sysp + rng.integers(1, ns.vocab, 3)
                       .tolist(), max_new_tokens=4) for i in range(2)]
    got, stats, _ = _run_matrix(ns, reqs)
    assert stats["handoff_dupes"] >= 3
    return got, stats


def _mid_handoff_cancel(ns):
    mk = lambda: ns.engine(max_batch=2, page_size=4, max_seq=48)  # noqa: E731
    pair = ns.DisaggPair(mk(), mk())
    req = ns.Request(rid=0, prompt=list(range(1, 14)), max_new_tokens=4)
    h = pair.start_handoff(req)
    assert h is not None and len(h.src_pages) == 3
    pair.check_invariants()
    assert pair.decode.cache.available_page_count == \
        pair.decode.cache.num_pages - len(h.dst_pages)
    pair.abort(h)
    assert h.state == "aborted"
    pair.check_invariants()
    assert pair.decode.cache.available_page_count == \
        pair.decode.cache.num_pages
    assert not np.any(pair.prefill.cache._export_pins)
    # The parked prefix is claimable again: a retried handoff succeeds.
    h2 = pair.start_handoff(req)
    assert h2 is not None and h2.hashes == h.hashes
    pair.commit(h2)
    [fin] = pair.decode.run([(0, req)])
    pair.check_invariants()
    return (h.src_pages, h.dst_pages, h2.dst_pages, finished_key(fin),
            dict(pair.stats))


def _stage_fallback(ns):
    req = ns.Request(rid=0, prompt=list(range(1, 14)), max_new_tokens=4)
    [gold] = ns.engine(max_batch=2, page_size=4, max_seq=32).run(
        [(0, _clone([req])[0])])
    pair = ns.DisaggPair(
        ns.engine(max_batch=2, page_size=4, max_seq=32),
        ns.engine(max_batch=2, page_size=4, num_pages=8, max_seq=32))
    # A live sequence holds 6 of the decode worker's 8 pages: staging the
    # 3-page transfer must fail over, not evict live KV.
    busy = pair.decode.cache.alloc_slot(21)
    assert pair.start_handoff(_clone([req])[0]) is None
    assert pair.stats["handoff_fallbacks"] == 1
    assert not np.any(pair.prefill.cache._export_pins)
    pair.check_invariants()
    pair.decode.cache.free_slot(busy)
    [fin] = pair.decode.run([(0, _clone([req])[0])])
    assert fin.tokens == gold.tokens
    pair.check_invariants()
    return finished_key(fin), dict(pair.stats)


@pytest.mark.parametrize("case", [_dedup, _mid_handoff_cancel,
                                  _stage_fallback],
                         ids=["dedup", "mid_handoff_cancel", "stage_fallback"])
def test_disagg_lifecycle_matches_the_reference(case):
    """Shared-prefix dedup, an abort between stage and commit, and the
    stage fallback: the same pages, stats and streams as the
    reference's, both pools clean."""
    assert case(stack("port")) == case(stack("ref"))


def test_disagg_validation_matches_the_reference():
    """Mismatched page size, codec or prefix caching is refused up front,
    with the reference's messages."""
    from repro.serving.disagg import DisaggPair as JPair
    from repro_torch.serving.disagg import DisaggPair

    class _Stub:
        def __init__(self, page_size=4, kv_codec="fp", prefix_caching=True):
            self.page_size = page_size
            self.kv_codec = kv_codec
            self.prefix_caching = prefix_caching

    for a, b, match in ((_Stub(page_size=4), _Stub(page_size=8), "page_size"),
                        (_Stub(), _Stub(kv_codec="int8"), "kv_codec"),
                        (_Stub(), _Stub(prefix_caching=False),
                         "prefix_caching")):
        msgs = []
        for cls in (JPair, DisaggPair):
            with pytest.raises(ValueError, match=match) as ei:
                cls(a, b)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_disagg_copy_lands_pending_cow_copies_first():
    """A copy-on-write copy the exporter queued into a page that is about
    to be exported lands before the pages are read: the import holds the
    copied bytes, not the stale ones."""
    ns = stack("port")
    pair = ns.DisaggPair(ns.engine(kv_codec="int8"),
                         ns.engine(kv_codec="int8"))
    pre = pair.prefill
    src, dst = 1, 2
    for pools in pre.layers.values():
        for pool in pools.values():
            pool[:, src].fill_(3)
            pool[:, dst].fill_(0)
    pre.cache._pending_copies.append((src, dst))
    staged = pair.decode.cache.stage_pages(1)
    pair._copy_pages([dst], staged)
    assert pre.cache.take_pending_copies() == []
    for name, pools in pre.layers.items():
        for key, pool in pools.items():
            assert (pair.decode.layers[name][key][:, staged[0]] == 3).all()
    pair.decode.cache.abort_staged(staged)
