"""Prefill/decode disaggregated serving: two engines, one request.

A :class:`DisaggPair` runs a request's *prompt* through one engine (the
prefill worker) and its *generation* through another (the decode
worker), shipping the prompt's KV pages between the two pools instead
of recomputing them.  The page table is the transfer manifest:

  1. the prefill worker runs the prompt with a 1-token budget; prefix
     caching publishes every full prompt page into its chain-hash
     table;
  2. :meth:`PagedKVCache.export_prefix` walks those chain hashes,
     returning the page ids + hashes and *export-pinning* each page
     (no eviction, no in-place COW while the copy is in flight);
  3. the decode worker *stages* that many pages out of its own pool
     (:meth:`PagedKVCache.stage_pages` - neither free nor owned until
     the handoff resolves) and an index copy on the device moves exactly
     the listed pages across pools, leaf by leaf of every layer: the
     data pools and the int8 codec's scale sidecars;
  4. :meth:`commit` publishes the staged pages into the decode worker's
     chain-hash table (parked in the cached LRU, exactly like a
     locally-retired prefix) and releases the exporter's pins; the
     original request then submits to the decode worker, whose
     *ordinary admission path* claims the imported prefix - only the
     partial tail page is ever prefilled twice.

Token parity (the conformance claim in tests/test_torch_disagg.py):
sampling is seeded per request and keyed by stream position, kernels are
deterministic, and the imported pages are bit-identical to what the
decode worker would have computed - so the disaggregated stream equals
the single-engine stream token for token, on both the fp and hfa rails
and under every page codec.  On the card a kernel's rounding depends on
the batch it runs in (the FA-2 decode's split rule counts the (slot, KV
head) pairs), so there the single engine to compare with is one that
first ran each prompt alone, as the prefill worker does.

Mid-handoff cancellation: :meth:`abort` returns the staged pages to
the free list (their contents are garbage) and unpins the exporter's -
both pools satisfy ``check_invariants`` before and after, which the
conformance suite asserts.

Both engines stay fully functional serving engines - disaggregation is
a protocol between pools, not a third engine class.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import FinishedRequest, Request


@dataclasses.dataclass
class Handoff:
    """One in-flight prefill->decode transfer.  ``src_pages`` are
    export-pinned on the prefill worker, ``dst_pages`` staged on the
    decode worker, until :meth:`DisaggPair.commit` or
    :meth:`DisaggPair.abort` resolves it."""
    req: Request
    src_pages: list[int]
    hashes: list[int]
    dst_pages: list[int]
    state: str = "staged"          # staged -> committed | aborted


class DisaggPair:
    """One prefill worker + one decode worker over separate engines.

    Both engines must agree on page size and codec (the page bytes are
    copied raw) and have prefix caching on (the chain-hash table is the
    manifest on both sides)."""

    def __init__(self, prefill_engine: ServingEngine,
                 decode_engine: ServingEngine):
        for name, a, b in (
                ("page_size", prefill_engine.page_size,
                 decode_engine.page_size),
                ("kv_codec", prefill_engine.kv_codec,
                 decode_engine.kv_codec)):
            if a != b:
                raise ValueError(
                    f"disagg workers must agree on {name}: {a!r} != {b!r}")
        if not (prefill_engine.prefix_caching
                and decode_engine.prefix_caching):
            raise ValueError(
                "disagg needs prefix_caching=True on both workers "
                "(the chain-hash table is the transfer manifest)")
        if any(e.tp * e.dp > 1 for e in (prefill_engine, decode_engine)):
            raise NotImplementedError(
                "disaggregation between tensor- or data-parallel engines "
                "is not served yet (ROADMAP.md Queue 1 item 11c)")
        self.prefill = prefill_engine
        self.decode = decode_engine
        self.stats = {"handoffs": 0, "handoff_pages": 0,
                      "handoff_dupes": 0, "handoff_aborts": 0,
                      "handoff_fallbacks": 0}

    # ---------------------------------------------------------- handoff
    def start_handoff(self, req: Request) -> Handoff | None:
        """Prefill ``req``'s prompt on the prefill worker and stage the
        page transfer onto the decode worker.  Returns None when the
        decode pool cannot stage the pages (caller submits plainly -
        the decode worker recomputes the prompt; correct, just slower).
        """
        pre = Request(rid=req.rid, prompt=list(req.prompt),
                      max_new_tokens=1)
        self.prefill.run([(0, pre)])
        pages, hashes = self.prefill.cache.export_prefix(list(req.prompt))
        if not pages:
            return Handoff(req=req, src_pages=[], hashes=[], dst_pages=[])
        try:
            staged = self.decode.cache.stage_pages(len(pages))
        except RuntimeError:
            self.prefill.cache.release_export(pages)
            self.stats["handoff_fallbacks"] += 1
            return None
        self._copy_pages(pages, staged)
        return Handoff(req=req, src_pages=pages, hashes=hashes,
                       dst_pages=staged)

    def _copy_pages(self, src: list[int], dst: list[int]) -> None:
        """Device-copy the contents of pages ``src`` of the prefill pool
        into pages ``dst`` of the decode pool, exactly the listed pages,
        for every leaf of every layer (stacked (groups, P, page, Hkv, d):
        page axis 1), the codec's scale sidecars included."""
        # The exporter's COW queue may still hold copies targeting the
        # exact source pages; land them before reading.
        self.prefill._apply_pending_copies()
        s = torch.tensor(src, dtype=torch.int64, device=self.prefill.device)
        d = torch.tensor(dst, dtype=torch.int64, device=self.decode.device)
        for name, pools in self.prefill.layers.items():
            for key, pool in pools.items():
                self.decode.layers[name][key].index_copy_(
                    1, d, pool.index_select(1, s).to(self.decode.device))

    def commit(self, h: Handoff) -> None:
        """Publish the staged pages on the decode worker and release
        the exporter's pins - the imported prefix is now claimable by
        the very next admission."""
        assert h.state == "staged", h.state
        published = self.decode.cache.publish_staged(h.dst_pages, h.hashes)
        if h.src_pages:
            self.prefill.cache.release_export(h.src_pages)
        h.state = "committed"
        self.stats["handoffs"] += 1
        self.stats["handoff_pages"] += len(published)
        self.stats["handoff_dupes"] += len(h.dst_pages) - len(published)

    def abort(self, h: Handoff) -> None:
        """Mid-handoff cancellation: staged pages return to the decode
        worker's free list, export pins release - both pools
        refcount-clean."""
        assert h.state == "staged", h.state
        self.decode.cache.abort_staged(h.dst_pages)
        if h.src_pages:
            self.prefill.cache.release_export(h.src_pages)
        h.state = "aborted"
        self.stats["handoff_aborts"] += 1

    # ----------------------------------------------------------- serving
    def submit(self, req: Request) -> None:
        """Full disaggregated intake: hand the prompt KV off, then
        submit the original request to the decode worker (admission
        claims the imported prefix)."""
        h = self.start_handoff(req)
        if h is not None:
            self.commit(h)
        self.decode.submit(req)

    def run(self, arrivals: list[tuple[int, Request]],
            max_steps: int | None = None) -> list[FinishedRequest]:
        """Drive a batch to completion: every request's prompt goes
        through the prefill worker first (in arrival order), generation
        runs on the decode worker.  Mirrors
        :meth:`ServingEngine.run`'s signature for the benchmark."""
        for _, req in sorted(arrivals, key=lambda a: a[0]):
            h = self.start_handoff(req)
            if h is not None:
                self.commit(h)
        return self.decode.run(arrivals, max_steps=max_steps)

    def check_invariants(self) -> None:
        self.prefill.cache.check_invariants()
        self.decode.cache.check_invariants()
