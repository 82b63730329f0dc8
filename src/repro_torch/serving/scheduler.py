"""Continuous-batching request scheduler over a PagedKVCache.

Lifecycle: submit -> (waiting) -> admit -> chunked prefill (one bounded
token-budget chunk per engine step, Sarathi-style, so a long prompt
never stalls running decodes) -> (decoding) -> one token per engine
step -> retire on EOS / length budget.

Under page-pool pressure:

  * a mid-prefill sequence *pauses in place* - it keeps its slot and
    pages and simply schedules no chunk until pages free up, then
    resumes prefill at pos > 0 (no recompute);
  * a decoding sequence that cannot append forces a preemption: the
    victim is the running sequence with the *least accumulated work*
    (fewest KV tokens materialized - cheapest replay), its pages are
    freed (published prefix pages stay claimable in the cache's LRU,
    so the replay usually resumes from the last full prompt page) and
    it re-queues at the front, vLLM recompute-style.

Sequence groups (parallel sampling / beam search): a request with
``n > 1`` (or ``best_of``, or ``beam_width > 0``) is admitted as ONE
prefill and fanned out into ``width`` branch slots over
``PagedKVCache.fork`` - a fork costs one page-table row plus refcount
bumps, never a KV copy, so n-best serving scales with *distinct*
tokens, not with n.  Parallel-sampling branches then decode like
independent requests (per-branch seeds); beam branches are reordered
every step (top-2k expansion, fork the parents that keep multiple
children, free the childless ones).  Preemption is group-aware: the
whole group is evicted and the request re-queued - regeneration is
deterministic (seeded keys / beam scores are pure functions of the
request), so the group re-derives the same completions from whatever
shared prefix pages survive in the cache LRU.

Latency classes (SLA-aware scheduling): every request carries a
:class:`LatencyClass` - a TTFT target (admission to first token), a
TPOT target (gap between subsequent tokens) and a priority rank.
Admission is priority-ordered across classes (FCFS within a class, and
the best-ranked waiting request head-blocks the queue so a big
interactive prompt is never starved by a stream of batch arrivals),
preemption evicts the least-urgent class first, and
:meth:`Scheduler.adaptive_prefill_budget` derives the per-step chunked
prefill budget from the decode batch's TPOT headroom instead of a
fixed ``--prefill-budget``: the tighter the most-urgent decoding slot's
next-token deadline, the fewer prompt tokens ride along in its step.

Cancellation (:meth:`Scheduler.cancel`): an abandoned stream is removed
wherever it is - waiting, mid-prefill, mid-decode, or a fanned-out
sequence group - and every slot/page reference it held is released
refcount-clean (published prefix pages park in the cache LRU as on any
retirement).

Pure host logic - fully testable without a device.  Wall-clock is injected
(``clock``) so SLA behavior is deterministic under test.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

from repro_torch.serving import spec
from repro_torch.serving.paged_cache import PagedKVCache
from repro_torch.serving.sampler import SamplingParams


@dataclasses.dataclass(frozen=True)
class LatencyClass:
    """One SLA tier: targets in seconds, lower ``priority`` = more
    urgent.  The targets are *scheduling inputs* (headroom / ordering),
    not hard guarantees - the open-loop benchmark reports the achieved
    p50/p99 TTFT and TPOT per class against them."""
    name: str
    ttft_target: float      # admission -> first token, seconds
    tpot_target: float      # per-token gap while decoding, seconds
    priority: int           # admission / eviction rank (0 = most urgent)


INTERACTIVE = LatencyClass("interactive", ttft_target=0.5,
                           tpot_target=0.05, priority=0)
STANDARD = LatencyClass("standard", ttft_target=2.0,
                        tpot_target=0.2, priority=1)
BATCH = LatencyClass("batch", ttft_target=30.0,
                     tpot_target=2.0, priority=2)
LATENCY_CLASSES = {c.name: c for c in (INTERACTIVE, STANDARD, BATCH)}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    sampling: SamplingParams | None = None     # None = greedy
    latency_class: LatencyClass = STANDARD     # SLA tier (see above)
    # -- sequence-group knobs (parallel sampling / beam search) -----------
    n: int = 1                    # completions returned
    best_of: int | None = None    # branches sampled (>= n); None = n
    beam_width: int = 0           # > 0: length-normalized beam search
    length_penalty: float = 1.0   # score = cum_logprob / len**length_penalty
    # Return per-token logprobs: generated-token logprobs on every
    # completion, prompt-token logprobs on the FinishedRequest (None at
    # position 0 and at positions restored from the prefix cache, whose
    # logits were never computed).
    logprobs: bool = False
    # Beam search only: stop expanding once ``n`` hypotheses are
    # finished and no live branch's score upper bound can beat the
    # n-th best finished score (results provably unchanged; saves the
    # tail decode steps).  Off = run until ``beam_width`` hypotheses
    # finish or every branch exhausts its budget.
    beam_early_stop: bool = True
    # Multi-tenant fairness: waiting requests of the same latency class
    # are round-robined across tenants (see Scheduler._waiting_key);
    # the default "" (everything one tenant) degrades to plain FCFS
    # within the class.  The HTTP transport fills this from the
    # ``x-tenant`` request header.
    tenant: str = ""


@dataclasses.dataclass
class Completion:
    """One finished branch of a sequence group."""
    tokens: list[int]          # generated tokens (includes eos if hit)
    branch: int                # branch id (seed fold for parallel sampling)
    reason: str                # "eos" | "length"
    score: float = 0.0         # length-normalized cumulative logprob
    # Per generated token log p(token | prefix); only when the request
    # set ``logprobs`` (None otherwise - never an empty list).
    token_logprobs: list[float] | None = None


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    prompt: list[int]
    tokens: list[int]          # generated tokens (includes eos if hit)
    reason: str                # "eos" | "length" | "rejected" | "cancelled"
    preemptions: int = 0
    # Scheduler-side time to first token (seconds, submit -> first
    # recorded token); None for rejected/cancelled-before-first-token
    # and for sequence groups (the async frontend measures groups and
    # client-visible latency itself).
    ttft: float | None = None
    # Sequence groups only: the n returned completions (tokens/reason
    # above mirror completions[0]).  Ordered by branch id for plain
    # n-parallel sampling, by score (desc) when ranking applies
    # (best_of > n, or beam search).
    completions: list[Completion] | None = None
    # ``Request.logprobs`` only (None otherwise): per-token logprobs.
    # prompt_logprobs[i] = log p(prompt[i] | prompt[:i]); None at i = 0
    # and at positions whose KV came from the prefix cache (their
    # logits were never computed).  token_logprobs mirrors
    # completions[0] for groups.
    prompt_logprobs: list[float | None] | None = None
    token_logprobs: list[float] | None = None
    # Speculative-decode draft quality for THIS request: accepted /
    # proposed over its lifetime (survives preemption replay).  None
    # when no draft was ever proposed for it (spec_k == 0, groups,
    # too-short streams) - never NaN.
    accept_rate: float | None = None


@dataclasses.dataclass
class SequenceGroup:
    """Host bookkeeping for one parallel-sampling / beam request.

    One prefill, ``width`` branch slots sharing every prompt page by
    refcount.  ``slots`` tracks the live branches; ``finished`` collects
    completions until the group retires (all branches done, or - for
    beam - ``width`` hypotheses finished).
    """
    req: Request
    width: int                 # branches fanned out of the shared prefill
    beam: bool
    slots: set[int] = dataclasses.field(default_factory=set)
    finished: list[Completion] = dataclasses.field(default_factory=list)
    # Parent's full prompt pages at fan-out: branches never write below
    # the prompt, so these stay physically shared for the group's life
    # (the shared-prefix invariant the property suite checks).
    prefix_pages: tuple[int, ...] = ()
    fanned_out: bool = False
    preemptions: int = 0
    next_branch: int = 0
    # ``Request.logprobs``: the shared prompt's logprobs, stashed off
    # the parent branch at fan-out (branch slots never recompute them).
    prompt_lps: list[float | None] = dataclasses.field(
        default_factory=list)

    @property
    def ranked(self) -> bool:
        """Completions are ranked by score (vs returned by branch id)."""
        return self.beam or self.width > self.req.n

    def score(self, cum_logprob: float, length: int) -> float:
        return cum_logprob / (max(length, 1) ** self.req.length_penalty)


class InvalidRequestError(ValueError):
    """Contradictory request knobs (client misuse).  Deliberately NOT
    absorbed by ``ServingEngine.run``'s per-request rejection path -
    unlike a resource rejection (prompt/width over the engine's
    capacity), a self-contradictory request should fail loudly, not
    come back as ``reason="rejected"``."""


def _make_group(req: Request) -> SequenceGroup | None:
    """Validate the group knobs; None when the request is a plain
    single-stream one."""
    if req.n < 1:
        raise InvalidRequestError(
            f"request {req.rid}: n must be >= 1, got {req.n}")
    if req.beam_width > 0:
        if req.best_of is not None:
            raise InvalidRequestError(
                f"request {req.rid}: best_of is a parallel-sampling knob, "
                f"incompatible with beam_width")
        if req.n > req.beam_width:
            raise InvalidRequestError(
                f"request {req.rid}: n={req.n} exceeds beam_width="
                f"{req.beam_width}")
        if req.sampling is not None and req.sampling.temperature > 0:
            raise InvalidRequestError(
                f"request {req.rid}: beam search is deterministic - "
                f"temperature must be 0")
        return SequenceGroup(req, req.beam_width, beam=True)
    width = req.best_of if req.best_of is not None else req.n
    if width < req.n:
        raise InvalidRequestError(
            f"request {req.rid}: best_of={width} < n={req.n}")
    if width == 1:
        return None
    return SequenceGroup(req, width, beam=False)


@dataclasses.dataclass
class _Running:
    req: Request
    generated: list[int]
    seq_no: int = 0            # admission order (FCFS tie-break)
    computed: int = 0          # KV tokens materialized (incl. reused prefix)
    decoding: bool = False     # prefill complete, generating
    preemptions: int = 0
    group: SequenceGroup | None = None
    branch: int = 0            # branch id within the group
    cum_logprob: float = 0.0   # beam / best_of ranking state
    # -- SLA bookkeeping (scheduler clock) --------------------------------
    submit_time: float = 0.0          # original submission (survives
    #                                   preemption replay)
    first_token_time: float | None = None
    last_token_time: float = 0.0      # base of the next-token deadline
    queue_seq: int = 0                # waiting order within a class
    fair_round: int = 0               # tenant round-robin round (see
    #                                   Scheduler._waiting_key)
    # Speculative-draft quality (engine fills these in its accept loop):
    drafted: int = 0                  # draft tokens proposed for this slot
    accepted: int = 0                 # ... of which the sampler confirmed

    def __post_init__(self):
        # Maintained incrementally by record_token: tokens() is on the
        # per-step scheduling/registration path, and rebuilding the
        # concatenation there would cost O(len) per call.
        self._stream = list(self.req.prompt) + list(self.generated)
        # ``Request.logprobs`` bookkeeping.  token_logprobs survives
        # preemption alongside ``generated`` (the replay prefill does
        # not re-sample); prompt_lps fills in as prefill chunks compute
        # each position's logits (cache-reused positions stay None).
        self.token_logprobs: list[float] = []
        self.prompt_lps: list[float | None] = \
            [None] * len(self.req.prompt) if self.req.logprobs else []

    def tokens(self) -> list[int]:
        """Token stream whose KV backs this sequence: prompt plus any
        generated tokens carried over a preemption (replaying them
        rebuilds the KV state the evicted sequence had).  Shared
        internal list - callers must not mutate it."""
        return self._stream

    @property
    def target(self) -> int:
        return len(self.req.prompt) + len(self.generated)


@dataclasses.dataclass
class DecodeStep:
    """One slot's work item for a (possibly speculative) decode step:
    feed ``tokens`` = [carry token] + ``drafts`` at positions
    ``seq_lens[slot]..``, verify all of them in one paged-attention
    call, and keep the longest prefix the sampler confirms.  A
    non-speculative step is simply ``drafts == []``."""
    slot: int
    tokens: list[int]
    drafts: list[int]


@dataclasses.dataclass
class PrefillChunk:
    """One bounded prefill chunk: write KV for ``tokens`` at positions
    [start, start + len(tokens)) of ``slot``.  The final chunk's
    last-position logits yield the sequence's next token."""
    slot: int
    tokens: list[int]
    start: int
    is_final: bool


class Scheduler:
    """Admission / chunked prefill / preemption / retirement.

    ``clock`` is the monotonic time source for the SLA bookkeeping
    (defaults to ``time.monotonic``); tests inject a fake."""

    def __init__(self, cache: PagedKVCache, clock=time.monotonic):
        self.cache = cache
        self.clock = clock
        self.waiting: deque[_Running] = deque()
        self.running: dict[int, _Running] = {}     # slot -> state
        self._seq_no = 0
        # Waiting order: requests are admitted by (class priority,
        # queue_seq).  Fresh submissions draw increasing seqs (FCFS
        # within a class); preempted work draws decreasing ones, so it
        # resumes ahead of every later arrival of its class.
        self._queue_seq_next = 0
        self._queue_seq_front = -1
        # Per-tenant fairness within a class: start-time fair queuing
        # with unit service times.  A submission's fair_round is
        # max(the tenant's own next round, the class's virtual time =
        # the highest round already admitted), so a bursting tenant
        # runs its rounds up while a freshly-arriving tenant enters at
        # the current virtual time: admission round-robins across
        # tenants and stays FCFS within one (a single tenant's rounds
        # are monotone, so the key degrades to (priority, queue_seq)).
        self._tenant_round: dict[tuple[int, str], int] = {}
        self._class_vt: dict[int, int] = {}
        # Monotone accounting the engine reads as deltas around group
        # operations (beam reorders emit tokens and fork slots deep
        # inside the scheduler).
        self.tokens_emitted = 0
        self.forks = 0
        self.beam_early_stops = 0

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        assert len(req.prompt) >= 1, "empty prompt"
        assert req.max_new_tokens >= 1
        now = self.clock()
        st = _Running(req, [], group=_make_group(req))
        st.submit_time = st.last_token_time = now
        st.queue_seq = self._queue_seq_next
        self._queue_seq_next += 1
        ckey = req.latency_class.priority
        st.fair_round = max(self._tenant_round.get((ckey, req.tenant), 0),
                            self._class_vt.get(ckey, 0))
        self._tenant_round[(ckey, req.tenant)] = st.fair_round + 1
        self.waiting.append(st)

    @staticmethod
    def _waiting_key(st: _Running) -> tuple[int, int, int]:
        # Class priority first, then the tenant round-robin round, then
        # arrival order: within a class, tenants take turns; within a
        # tenant (and with a single tenant), FCFS by queue_seq.
        # Preempted work carries fair_round = -1 (see _requeue_front),
        # so it resumes ahead of every fresh arrival of its class.
        return (st.req.latency_class.priority, st.fair_round, st.queue_seq)

    def _advance_vt(self, st: _Running) -> None:
        """Advance the class's virtual time to an admitted request's
        round, and drop tenant entries at/below it (max(round, vt)
        makes them indistinguishable from absent - pruning keeps the
        table bounded by the number of *backlogged* tenants)."""
        ckey = st.req.latency_class.priority
        if st.fair_round > self._class_vt.get(ckey, 0):
            self._class_vt[ckey] = vt = st.fair_round
            for k in [k for k, r in self._tenant_round.items()
                      if k[0] == ckey and r <= vt]:
                del self._tenant_round[k]

    def _next_waiting(self) -> _Running | None:
        """Best waiting candidate: most urgent class first, FCFS within
        a class, preempted work ahead of fresh arrivals.  This is the
        *only* candidate admission tries - a blocked urgent request
        head-blocks the queue (no lower-class bypass) so it cannot be
        starved by a stream of small batch-class arrivals."""
        if not self.waiting:
            return None
        return min(self.waiting, key=self._waiting_key)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def decoding_slots(self) -> list[int]:
        return sorted(s for s, st in self.running.items() if st.decoding)

    def prefilling_slots(self) -> list[int]:
        return sorted(s for s, st in self.running.items() if not st.decoding)

    def group_slots(self) -> set[int]:
        """Slots currently owned by sequence-group branches."""
        return {s for s, st in self.running.items() if st.group is not None}

    def _reserved_slots(self) -> int:
        """Slots admission must keep free for live groups: the pending
        fan-out of a mid-prefill group parent (width - 1 forks land the
        step its prefill completes), and beam regrowth headroom (an
        eos-finished hypothesis frees a slot the next reorder may
        re-fill up to width)."""
        groups: dict[int, SequenceGroup] = {}
        for st in self.running.values():
            if st.group is not None:
                groups[id(st.group)] = st.group
        total = 0
        for g in groups.values():
            if not g.fanned_out:
                total += g.width - 1
            elif g.beam:
                total += g.width - len(g.slots)
        return total

    # --------------------------------------------------------- admission
    def schedule_prefill(self, budget: int | None) -> tuple[
            list[PrefillChunk], int]:
        """Plan this step's prefill work under a token ``budget``
        (None = unbounded).

        In-flight prefills continue first (oldest admission first), then
        waiting requests are admitted FCFS while budget, a slot, and
        pages for prompt + one decode append remain - each admission
        claims the longest cached prompt prefix (full pages) instead of
        recomputing it.  A sequence whose next chunk cannot get pages is
        paused in place (no chunk, keeps pages).

        Returns (chunks, prefix_tokens_reused_by_new_admissions).
        """
        chunks: list[PrefillChunk] = []
        left = budget if budget is not None else None
        reused = 0
        live = [(st.seq_no, slot) for slot, st in self.running.items()
                if not st.decoding]
        for _, slot in sorted(live):
            if left is not None and left <= 0:
                return chunks, reused
            ck = self._chunk_for(slot, left)
            if ck is not None:
                chunks.append(ck)
                if left is not None:
                    left -= len(ck.tokens)
        while self.waiting and (left is None or left > 0):
            st = self._next_waiting()
            toks = st.tokens()
            shared = self.cache.lookup_prefix(toks)
            if not self.cache.can_admit(len(toks), shared):
                break          # priority head blocks the queue (no
                #                lower-class bypass - starvation-free)
            # Group-aware slot budget: a group needs its full fan-out
            # width, and slots reserved for other live groups (pending
            # fan-outs, beam regrowth) are off-limits.
            need_slots = st.group.width if st.group is not None else 1
            if self.cache.free_slot_count - self._reserved_slots() \
                    < need_slots:
                break
            self.waiting.remove(st)
            self._advance_vt(st)
            slot = self.cache.alloc_slot(len(toks), shared, lazy=True)
            st.computed = len(shared) * self.cache.page_size
            st.decoding = False
            st.seq_no = self._seq_no
            self._seq_no += 1
            self.running[slot] = st
            reused += st.computed
            ck = self._chunk_for(slot, left)
            if ck is not None:
                chunks.append(ck)
                if left is not None:
                    left -= len(ck.tokens)
        return chunks, reused

    def _chunk_for(self, slot: int, left: int | None) -> PrefillChunk | None:
        """Next prefill chunk for ``slot`` under the remaining budget,
        shrunk to the pages actually obtainable (pause-in-place when the
        pool is dry)."""
        st = self.running[slot]
        toks = st.tokens()
        remaining = st.target - st.computed
        n = remaining if left is None else min(remaining, left)
        if n <= 0:
            return None
        if not self.cache.ensure_capacity(slot, st.computed + n):
            # Shrink to pages that are actually writable - a shared page
            # whose copy-on-write failed for lack of a free page must
            # NOT be written (a forked sibling still reads it).
            n = min(n, self.cache.writable_token_capacity(slot)
                    - st.computed)
            if n <= 0:
                return None                # paused in place, pages kept
        return PrefillChunk(
            slot=slot, tokens=toks[st.computed:st.computed + n],
            start=st.computed, is_final=(st.computed + n == st.target))

    def complete_chunk(self, chunk: PrefillChunk) -> None:
        """Record that ``chunk``'s KV is on device; the final chunk
        flips the sequence into the decode phase."""
        st = self.running[chunk.slot]
        assert st.computed == chunk.start, (st.computed, chunk.start)
        st.computed += len(chunk.tokens)
        self.cache.mark_prefilled(chunk.slot, st.computed)
        if chunk.is_final:
            assert st.computed == st.target
            st.decoding = True

    def admit(self) -> list[tuple[int, list[int]]]:
        """Legacy all-at-once admission (no chunking): admit waiting
        requests while slots + pages allow (FCFS), allocating every page
        up front.  Returns [(slot, tokens_to_prefill)].

        Kept for host-only scheduler tests; the engine admits through
        :meth:`schedule_prefill`.  Both paths share ``can_admit`` (the
        decode-page reserve) and ``alloc_slot``.
        """
        out = []
        while self.waiting:
            st = self._next_waiting()
            toks = st.tokens()
            if not self.cache.can_admit(len(toks)):
                break
            need_slots = st.group.width if st.group is not None else 1
            if self.cache.free_slot_count - self._reserved_slots() \
                    < need_slots:
                break
            self.waiting.remove(st)
            self._advance_vt(st)
            slot = self.cache.alloc_slot(len(toks))
            st.computed = st.target
            st.decoding = True
            st.seq_no = self._seq_no
            self._seq_no += 1
            self.running[slot] = st
            out.append((slot, toks))
        return out

    # ----------------------------------------------------- decode planning
    def schedule_decode(self, spec_k: int = 0) -> list[DecodeStep]:
        """Plan this step's decode work: one :class:`DecodeStep` per
        decoding slot.  With ``spec_k > 0`` the prompt-lookup proposer
        drafts up to ``spec_k`` continuation tokens from the request's
        own token history (never past the remaining generation budget -
        a token beyond it could only be discarded).  The carry token is
        the stream's last generated token, whose KV lands at
        ``seq_lens[slot]`` during the verify step.
        """
        out: list[DecodeStep] = []
        for slot in self.decoding_slots():
            st = self.running[slot]
            stream = st.tokens()
            remaining = st.req.max_new_tokens - len(st.generated)
            n_draft = min(spec_k, max(0, remaining - 1))
            if st.group is not None and st.group.beam:
                # Beam branches take their next token from the reorder
                # (top-2k expansion), not from acceptance against a
                # draft - speculation is auto-disabled inside beam
                # groups.  Parallel-sampling branches keep exact-accept
                # speculation: each branch verifies like an independent
                # seeded request.
                n_draft = 0
            drafts = spec.propose_draft(stream, n_draft) if n_draft else []
            out.append(DecodeStep(slot=slot, tokens=[stream[-1]] + drafts,
                                  drafts=drafts))
        return out

    # ------------------------------------------------------- progression
    def record_token(self, slot: int, tok: int) -> str:
        """Append a generated token; returns "running"|"eos"|"length"."""
        st = self.running[slot]
        self.tokens_emitted += 1
        now = self.clock()
        if st.first_token_time is None:
            st.first_token_time = now
        st.last_token_time = now
        st.generated.append(tok)
        st._stream.append(tok)
        if st.req.eos_id is not None and tok == st.req.eos_id:
            return "eos"
        if len(st.generated) >= st.req.max_new_tokens:
            return "length"
        return "running"

    def choose_victim(self) -> int | None:
        """Preemption victim: the least-urgent latency class first
        (evicting a batch request to keep an interactive decode alive is
        the whole point of the classes), then the sequence with the
        least accumulated work (fewest materialized KV tokens - cheapest
        to replay); newest admission loses ties (FCFS fairness)."""
        if not self.running:
            return None
        return min(self.running,
                   key=lambda s: (-self.running[s].req.latency_class
                                  .priority,
                                  int(self.cache.seq_lens[s]),
                                  -self.running[s].seq_no))

    def preempt(self, slot: int) -> None:
        """Evict a running sequence (page-pool pressure); progress is
        kept as tokens: the resumed prefill replays prompt + generated
        (minus whatever prefix pages are still cached).

        Re-queued at the *front of its class* (a decreasing queue_seq):
        oldest work resumes first, and a preempted sequence never
        starves behind new arrivals of the same class.

        A slot belonging to a sequence group evicts the *whole group*
        (branch streams diverge right after the shared prefill, so no
        single replay prefill could restore them all).
        """
        st = self.running[slot]
        if st.group is not None:
            self.preempt_group(st.group)
            return
        self.running.pop(slot)
        st.preemptions += 1
        st.computed = 0
        st.decoding = False
        self.cache.free_slot(slot)
        self._requeue_front(st)

    def _requeue_front(self, st: _Running) -> None:
        st.queue_seq = self._queue_seq_front
        self._queue_seq_front -= 1
        # Preempted work outranks every fresh arrival of its class, no
        # matter which tenant it belongs to (it already held pages).
        st.fair_round = -1
        self.waiting.append(st)

    def preempt_group(self, group: SequenceGroup) -> None:
        """Evict every live branch of ``group`` and re-queue the request
        at the front.  All branch progress is dropped: regeneration is
        deterministic (sampling keys are fold_in(seed, branch) x
        position, beam scores are pure functions of the logits), so the
        group re-derives the same completions after re-admission,
        resuming from whatever shared prefix pages survive in the
        cache's LRU."""
        submit_time = None
        for s, st in list(self.running.items()):
            if st.group is group:           # branches + mid-prefill parent
                self.running.pop(s)
                self.cache.free_slot(s)
                submit_time = st.submit_time if submit_time is None \
                    else min(submit_time, st.submit_time)
        group.slots.clear()
        group.finished.clear()
        group.fanned_out = False
        group.prefix_pages = ()
        group.prompt_lps = []
        group.next_branch = 0
        group.preemptions += 1
        nst = _Running(group.req, [], group=group)
        nst.submit_time = submit_time if submit_time is not None \
            else self.clock()
        nst.last_token_time = nst.submit_time
        self._requeue_front(nst)

    def retire(self, slot: int, reason: str) -> FinishedRequest:
        st = self.running.pop(slot)
        self.cache.free_slot(slot)
        ttft = None
        if st.first_token_time is not None:
            ttft = st.first_token_time - st.submit_time
        lp = st.req.logprobs
        rate = st.accepted / st.drafted if st.drafted else None
        return FinishedRequest(rid=st.req.rid, prompt=st.req.prompt,
                               tokens=st.generated, reason=reason,
                               preemptions=st.preemptions, ttft=ttft,
                               prompt_logprobs=st.prompt_lps if lp else None,
                               token_logprobs=list(st.token_logprobs)
                               if lp else None,
                               accept_rate=rate)

    def finish(self, slot: int, reason: str) -> FinishedRequest | None:
        """Group-aware retirement: a plain sequence retires immediately;
        a group branch records its completion, and the group's single
        FinishedRequest is emitted only when the whole group is done."""
        st = self.running[slot]
        if st.group is None:
            return self.retire(slot, reason)
        group = st.group
        self._retire_branch(slot, reason)
        return self._maybe_retire_group(group)

    # ----------------------------------------------- SLA / cancellation
    def sla_headroom(self, now: float | None = None) -> float | None:
        """Seconds until the most-urgent decoding slot blows its TPOT
        target: min over decoding slots of
        ``last_token_time + tpot_target - now``.  None when nothing is
        decoding (no deadline to protect).  Negative = already late."""
        if now is None:
            now = self.clock()
        deadlines = [st.last_token_time + st.req.latency_class.tpot_target
                     for st in self.running.values() if st.decoding]
        if not deadlines:
            return None
        return min(deadlines) - now

    def adaptive_prefill_budget(self, prefill_rate: float, floor: int,
                                ceiling: int,
                                now: float | None = None) -> int:
        """Per-step chunked-prefill token budget from the decode batch's
        SLA headroom: roughly the prompt tokens the engine can process
        (at the measured ``prefill_rate`` tokens/sec) before the tightest
        decoding slot's next-token deadline.  Clamped to
        [``floor``, ``ceiling``]: the floor keeps prefill from starving
        outright when decodes are already late, the ceiling bounds a
        step's latency when nothing is decoding (full ceiling)."""
        assert 1 <= floor <= ceiling
        headroom = self.sla_headroom(now)
        if headroom is None:
            return ceiling
        budget = int(max(0.0, headroom) * max(prefill_rate, 0.0))
        return max(floor, min(ceiling, budget))

    def cancel(self, rid: int) -> bool:
        """Remove request ``rid`` wherever it is - waiting, mid-prefill,
        mid-decode, or a fanned-out sequence group - freeing every slot
        it holds refcount-clean.  Returns True if anything was removed.

        The engine must flush pending COW copies *before* calling this
        (a queued device copy targeting a freed-and-reallocated page
        would clobber the new owner's KV)."""
        hit = False
        for st in [w for w in self.waiting if w.req.rid == rid]:
            self.waiting.remove(st)
            hit = True
        group = None
        for s, st in list(self.running.items()):
            if st.req.rid == rid:
                self.running.pop(s)
                self.cache.free_slot(s)
                group = st.group or group
                hit = True
        if group is not None:
            group.slots.clear()
            group.finished.clear()
        return hit

    # ------------------------------------------------- sequence groups
    def fan_out(self, slot: int) -> list[tuple[int, int]]:
        """Fan a freshly-prefilled parallel-sampling group parent out
        into its ``width`` branches: the parent becomes branch 0 and
        each extra branch forks the parent's slot (COW - one page-table
        row + refcount bumps, zero KV copied).  Must be called right
        after the final prefill chunk completes, *before* any first
        token is recorded: at that instant the slot's pages hold
        exactly the prompt KV, so every branch shares all of it.
        Returns [(slot, branch)] for all width branches, parent first.
        """
        st = self.running[slot]
        group = st.group
        assert group is not None and not group.beam
        assert not group.fanned_out
        assert st.decoding and st.computed == st.target, \
            "fan_out before prefill completed"
        self._record_prefix_pages(group, slot)
        st.branch = 0
        group.slots = {slot}
        out = [(slot, 0)]
        for b in range(1, group.width):
            ns = self.cache.fork(slot)
            self.forks += 1
            bst = _Running(st.req, [], seq_no=self._seq_no,
                           computed=st.computed, decoding=True,
                           group=group, branch=b)
            self._seq_no += 1
            self.running[ns] = bst
            group.slots.add(ns)
            out.append((ns, b))
        group.fanned_out = True
        group.next_branch = group.width
        return out

    def fan_out_beam(self, slot: int,
                     candidates: list[tuple[int, float]]) \
            -> FinishedRequest | None:
        """First beam expansion, from the prompt's last-position logits:
        ``candidates`` is the top-2*width (token, logprob) list, sorted
        by logprob descending.  Selects up to ``width`` continuations
        (eos candidates finish as 1-token hypotheses and take no slot);
        the best continuation keeps the parent's slot, the rest fork it.
        Returns the group's FinishedRequest if it already converged
        (e.g. beam_width 1 and the top token is eos).
        """
        st = self.running[slot]
        group = st.group
        assert group is not None and group.beam and not group.fanned_out
        assert st.decoding and st.computed == st.target
        self._record_prefix_pages(group, slot)
        group.fanned_out = True
        # Branch id 0 is reserved for the continuation that keeps the
        # parent slot (_beam_place hands it st.branch == 0); eos
        # hypotheses and forked children draw fresh ids from 1 up so
        # completions never collide on branch id.
        group.next_branch = 1
        live, fin = self._beam_select(
            group, [(lp, 0, tok, slot) for tok, lp in candidates],
            st.req.eos_id)
        for cum, _, tok, _ in fin:
            self.tokens_emitted += 1
            group.finished.append(Completion(
                [tok], group.next_branch, "eos", group.score(cum, 1),
                token_logprobs=[cum] if st.req.logprobs else None))
            group.next_branch += 1
        group.slots = {slot}
        if not live:
            self.drop_branch(slot)
        else:
            self._beam_place(group, {slot: st}, live)
        return self._maybe_retire_group(group)

    def beam_reorder(self, group: SequenceGroup,
                     per_slot: dict[int, list[tuple[int, float]]]) \
            -> FinishedRequest | None:
        """One beam step: every live branch contributes its top-2*width
        (token, logprob) candidates (scored at the branch's last
        committed position); the 2k expansion is ranked by cumulative
        logprob, eos candidates finish as hypotheses, and the top
        ``width`` continuations become the new beams - reordered over
        the slots via fork (a parent keeping several children) and
        free (a childless parent).  Candidate ordering is a pure
        function of (score, branch id, token), never of slot numbers,
        so beam results are invariant to slot permutation.
        Returns the group's FinishedRequest when it converges
        (``width`` finished hypotheses, or no live branch left).
        """
        states = {s: self.running[s] for s in group.slots}
        cands = []
        for s, st in states.items():
            for tok, lp in per_slot[s]:
                cands.append((st.cum_logprob + lp, st.branch, tok, s))
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        live, fin = self._beam_select(group, cands, group.req.eos_id)
        for cum, _, tok, s in fin:
            st = states[s]
            self.tokens_emitted += 1
            group.finished.append(Completion(
                st.generated + [tok], group.next_branch, "eos",
                group.score(cum, len(st.generated) + 1),
                token_logprobs=st.token_logprobs + [cum - st.cum_logprob]
                if st.req.logprobs else None))
            group.next_branch += 1
        if len(group.finished) >= group.width:
            live = []
        elif live and self._beam_converged(group, states, live):
            # Early stop: >= n hypotheses are in and no live branch's
            # score upper bound can displace the n-th best - the
            # remaining decode steps cannot change the returned
            # completions, so drop every live branch now.
            self.beam_early_stops += 1
            live = []
        # Reorder: drop childless parents first (frees slots), then fork
        # multi-child parents into them.
        keep = {c[3] for c in live}
        for s in sorted(group.slots - keep):
            self.drop_branch(s)
        self._beam_place(group, states, live)
        return self._maybe_retire_group(group)

    def _beam_converged(self, group, states, live) -> bool:
        """Beam early-stopping test (results provably unchanged): True
        when the group already holds >= ``n`` finished hypotheses and
        the best score any live continuation could *ever* reach is
        strictly below the n-th best finished score.

        Upper bound per live candidate: logprobs are <= 0, so a
        branch's cumulative logprob never increases with length -
        ``score(cum, L) = cum / L**length_penalty`` is therefore
        monotone in L for fixed cum, and its supremum over the
        remaining lengths is at one of the endpoints: the length after
        this token, or the full ``max_new_tokens`` budget.  Strict
        comparison keeps ties alive (a tying branch could still change
        completion ordering), so early-stopped results are identical
        to run-to-exhaustion results, which the regression test pins.
        """
        req = group.req
        if not req.beam_early_stop or len(group.finished) < req.n:
            return False
        nth_best = sorted(
            (c.score for c in group.finished), reverse=True)[req.n - 1]
        for cum, _, tok, s in live:
            length = len(states[s].generated) + 1
            bound = max(group.score(cum, length),
                        group.score(cum, req.max_new_tokens))
            if bound >= nth_best:
                return False
        return True

    def _beam_select(self, group, cands, eos_id):
        """Split ranked candidates into up-to-width continuations and
        newly finished (eos) hypotheses."""
        live, fin = [], []
        for cand in cands:
            if eos_id is not None and cand[2] == eos_id:
                if len(group.finished) + len(fin) < group.width:
                    fin.append(cand)
            elif len(live) < group.width:
                live.append(cand)
        return live, fin

    def _beam_place(self, group, states, live):
        """Materialize the selected continuations: per parent (in global
        candidate order), the first child continues in the parent's
        slot and keeps its branch id; every further child forks the
        parent *before* its token is recorded (the carry token's KV is
        already committed, the new token's is not - so the fork shares
        the full stream so far) and takes a fresh branch id."""
        by_parent: dict[int, list[tuple[float, int, int]]] = {}
        for cum, _, tok, s in live:
            bid = states[s].branch if s not in by_parent \
                else group.next_branch
            if s in by_parent:
                group.next_branch += 1
            by_parent.setdefault(s, []).append((cum, bid, tok))
        for s, children in sorted(by_parent.items()):
            st = states[s]
            base_gen = list(st.generated)
            base_lps = list(st.token_logprobs)
            want_lp = st.req.logprobs
            for cum, bid, tok in children[1:]:
                ns = self.cache.fork(s)
                self.forks += 1
                self.tokens_emitted += 1
                nst = _Running(st.req, base_gen + [tok],
                               seq_no=self._seq_no, computed=st.computed,
                               decoding=True, group=group, branch=bid,
                               cum_logprob=cum)
                if want_lp:
                    # The step's logprob is the candidate's cumulative
                    # minus the shared parent's (st.cum_logprob is
                    # still the pre-step value here).
                    nst.token_logprobs = base_lps + [cum - st.cum_logprob]
                self._seq_no += 1
                self.running[ns] = nst
                group.slots.add(ns)
                if len(nst.generated) >= st.req.max_new_tokens:
                    self._retire_branch(ns, "length")
            cum, bid, tok = children[0]
            if want_lp:
                st.token_logprobs.append(cum - st.cum_logprob)
            st.cum_logprob = cum
            status = self.record_token(s, tok)
            if status != "running":
                self._retire_branch(s, status)

    def _record_prefix_pages(self, group, slot):
        plen = len(group.req.prompt)
        group.prefix_pages = self.cache.slot_pages(slot)[
            :plen // self.cache.page_size]
        group.prompt_lps = self.running[slot].prompt_lps

    def _retire_branch(self, slot: int, reason: str) -> None:
        """Free a finished branch's slot and record its completion."""
        st = self.running.pop(slot)
        group = st.group
        group.slots.discard(slot)
        self.cache.free_slot(slot)
        group.finished.append(Completion(
            list(st.generated), st.branch, reason,
            group.score(st.cum_logprob, len(st.generated)),
            token_logprobs=list(st.token_logprobs)
            if st.req.logprobs else None))

    def drop_branch(self, slot: int) -> None:
        """Free a branch that yields no completion (beam reorder left it
        childless, or the group retired with surplus live branches)."""
        st = self.running.pop(slot)
        st.group.slots.discard(slot)
        self.cache.free_slot(slot)

    def _maybe_retire_group(self, group: SequenceGroup) \
            -> FinishedRequest | None:
        """Emit the group's FinishedRequest once it is done: every
        branch finished (parallel sampling), or - beam - ``width``
        hypotheses collected / no live branch left."""
        done = group.fanned_out and (
            not group.slots
            or (group.beam and len(group.finished) >= group.width))
        if not done:
            return None
        for s in sorted(group.slots):       # beam early stop: surplus
            self.drop_branch(s)
        comps = sorted(group.finished,
                       key=(lambda c: (-c.score, c.branch)) if group.ranked
                       else (lambda c: c.branch))
        comps = comps[:group.req.n]
        lp = group.req.logprobs
        return FinishedRequest(
            rid=group.req.rid, prompt=group.req.prompt,
            tokens=comps[0].tokens, reason=comps[0].reason,
            preemptions=group.preemptions, completions=comps,
            prompt_logprobs=group.prompt_lps if lp else None,
            token_logprobs=comps[0].token_logprobs if lp else None)
