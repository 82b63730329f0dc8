"""Prefix-aware multi-replica router over N serving replicas.

Two layers, split so the placement policy is testable without an event
loop:

  * :class:`RouterCore` - pure bookkeeping.  Each replica is
    represented by its chain-hash table (anything supporting ``in``;
    the live system passes the replica cache's ``_hash_page`` dict, the
    property suite passes plain sets).  Placement routes a request to
    the live replica holding the *longest* chain-hash prefix of its
    prompt; with no prefix hit anywhere it falls back to the
    least-loaded live replica (ties to the lowest index).  Events:
    ``place`` / ``finish`` / ``down`` / ``up``; ``down`` returns the
    in-flight rids that must be re-placed.  Invariants (no request
    lost or double-placed, prefix-hit placement whenever a matching
    replica is live, least-loaded fallback) are pinned by
    tests/test_torch_router.py, decision for decision against the
    reference's core.

  * :class:`Router` - the asyncio front door: wraps N
    :class:`AsyncFrontend` replicas and duck-types the slice of the
    frontend surface the HTTP transport consumes (``engine``,
    ``failed``/``closed``, ``submit``/``result``/``queue_depth``/
    ``drain``/``close``), so ``serve_http --replicas N`` plugs it into
    the unmodified :class:`repro_torch.serving.http.HttpServer`.  A replica
    whose frontend fails is marked down and its future traffic
    re-routes; submission races a failure by retrying on the next live
    replica.

Prefix hits compose with disaggregated serving (:mod:`.disagg`): a
handoff publishes the prompt's pages into the decode worker's
chain-hash table, which is exactly the table the router consults - so
follow-up requests with the same system prompt land on the replica
that already holds its KV.
"""
from __future__ import annotations

from repro_torch.serving.frontend import AsyncFrontend
from repro_torch.serving.scheduler import Request


class RouterCore:
    """Pure placement logic over per-replica chain-hash tables."""

    def __init__(self, tables):
        self.tables = list(tables)
        self.n = len(self.tables)
        if self.n < 1:
            raise ValueError("router needs at least one replica")
        self.live: set[int] = set(range(self.n))
        self.load = [0] * self.n              # in-flight per replica
        self.placement: dict[int, int] = {}   # rid -> replica

    def prefix_hits(self, replica: int, hashes: list[int]) -> int:
        """Leading chain hashes of ``hashes`` present in the replica's
        table - the pages its admission path would claim."""
        k = 0
        for h in hashes:
            if h not in self.tables[replica]:
                break
            k += 1
        return k

    def place(self, rid: int, hashes: list[int]) -> int:
        """Choose a live replica for ``rid``: longest prefix hit first,
        then least loaded, then lowest index."""
        if rid in self.placement:
            raise ValueError(f"rid {rid} already placed")
        if not self.live:
            raise RuntimeError("router: no live replica")
        best, best_key = None, None
        for i in sorted(self.live):
            key = (-self.prefix_hits(i, hashes), self.load[i], i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        self.placement[rid] = best
        self.load[best] += 1
        return best

    def finish(self, rid: int) -> int:
        """A placed request finished (or was cancelled): drop it."""
        replica = self.placement.pop(rid)
        if replica in self.live:
            self.load[replica] -= 1
        return replica

    def down(self, replica: int) -> list[int]:
        """Replica died: remove it from rotation and return the rids
        that were placed on it (the caller re-places or fails them).
        Idempotent."""
        self.live.discard(replica)
        lost = sorted(rid for rid, r in self.placement.items()
                      if r == replica)
        for rid in lost:
            del self.placement[rid]
        self.load[replica] = 0
        return lost

    def up(self, replica: int) -> None:
        """(Re)join a replica with a fresh load count."""
        if replica not in self.live:
            self.live.add(replica)
            self.load[replica] = sum(
                1 for r in self.placement.values() if r == replica)


class Router:
    """Asyncio front door over N :class:`AsyncFrontend` replicas,
    duck-typing the frontend surface :class:`~repro_torch.serving.http.
    HttpServer` consumes.  Replicas must be homogeneous (same model /
    page size / ceilings): ``engine`` exposes replica 0's for the
    transport's admission-ceiling checks."""

    def __init__(self, frontends: list[AsyncFrontend]):
        if not frontends:
            raise ValueError("router needs at least one frontend")
        if any(fe.engine.tp * fe.engine.dp > 1 for fe in frontends):
            raise NotImplementedError(
                "a router over tensor- or data-parallel replicas is not "
                "served yet (ROADMAP.md Queue 1 item 11c)")
        self.frontends = list(frontends)
        self.core = RouterCore(
            [fe.engine.cache._hash_page for fe in self.frontends])
        self.stats = {"routed": 0, "prefix_routed": 0,
                      "replicas_down": 0}

    # ------------------------------------------------- frontend surface
    @property
    def engine(self):
        return self.frontends[0].engine

    @property
    def failed(self) -> bool:
        self._refresh_live()
        return not self.core.live and any(
            fe.failed for fe in self.frontends)

    @property
    def closed(self) -> bool:
        return all(fe.closed for fe in self.frontends)

    def _refresh_live(self) -> None:
        for i, fe in enumerate(self.frontends):
            if (fe.failed or fe.closed) and i in self.core.live:
                self.core.down(i)
                self.stats["replicas_down"] += 1

    def _prompt_hashes(self, prompt: list[int]) -> list[int]:
        """Chain hashes of the prompt's *claimable* full pages - the
        same cap admission's ``lookup_prefix`` applies (at least one
        token is always left to compute)."""
        cache = self.engine.cache
        return cache._chain_hashes(list(prompt[:len(prompt) - 1]))

    def submit(self, req: Request):
        """Place ``req`` on a replica and return its token stream.  A
        replica that fails at submission is marked down and the next
        live one tried; RuntimeError when none is left (the transport
        maps it to 503)."""
        self._refresh_live()
        hashes = self._prompt_hashes(req.prompt)
        while True:
            if not self.core.live:
                raise RuntimeError("router: no live replica")
            replica = self.core.place(req.rid, hashes)
            fe = self.frontends[replica]
            try:
                gen = fe.submit(req)
            except RuntimeError:
                self.core.finish(req.rid)
                self.core.down(replica)
                self.stats["replicas_down"] += 1
                continue
            self.stats["routed"] += 1
            if self.core.prefix_hits(replica, hashes):
                self.stats["prefix_routed"] += 1
            return self._wrap(gen, req.rid)

    async def _wrap(self, gen, rid: int):
        try:
            async for tok in gen:
                yield tok
        finally:
            if rid in self.core.placement:
                self.core.finish(rid)

    def result(self, rid: int):
        for fe in self.frontends:
            fr = fe.result(rid)
            if fr is not None:
                return fr
        return None

    def queue_depth(self, cls_name: str) -> int:
        """Admission gating depth: the *least* backlog among live
        replicas (that is where the next request of the class lands
        absent a prefix hit)."""
        self._refresh_live()
        depths = [self.frontends[i].queue_depth(cls_name)
                  for i in sorted(self.core.live)]
        return min(depths) if depths else 0

    async def drain(self) -> None:
        for fe in self.frontends:
            if not (fe.failed or fe.closed):
                await fe.drain()

    async def close(self, drain: bool = True) -> None:
        for fe in self.frontends:
            if not (fe.failed or fe.closed):
                await fe.close(drain)
