"""ServingEngine: continuous-batching sampled and speculative decode over
paged KV.

One engine step mixes prefill chunks with one batched decode
(Sarathi-style), as in the reference engine:

  * prefill work is bounded by ``prefill_budget`` tokens per step - a
    fixed int, or ``"adaptive"``: each step's budget derived from the
    decode batch's SLA headroom and the measured prefill rate
    (``Scheduler.adaptive_prefill_budget``), clamped to
    [``adaptive_floor``, ``adaptive_ceiling``] - and handed out as chunks
    that resume at ``start_pos > 0``;
  * admission claims the longest cached prompt prefix (full pages, by
    chain hash) instead of recomputing it;
  * decode is one call over all ``max_batch`` slots: the single-token
    paged decode when a step drafts nothing, otherwise a verify over the
    carry token plus up to ``spec_k`` prompt-lookup drafts per slot
    (``spec_k="auto"``: up to ``AUTO_SPEC_KMAX``, each step's count from
    the accept-rate EMA), with paged rollback of the rejected columns;
  * sampling (temperature, top-k, top-p, repetition penalty) runs on the
    device, seeded per request and keyed by stream position
    (:mod:`repro_torch.serving.sampler`), so a draft is kept iff it
    equals the token the sampler draws at its position and speculation
    is lossless under sampling as under greedy;
  * sequence groups (``n`` / ``best_of`` / ``beam_width``): one prefill
    fans out into width branch slots over ``PagedKVCache.fork`` (prompt
    pages shared by refcount, no KV copied).  Parallel branches sample
    under ``branch_seed(seed, branch)``; beam branches take their tokens
    from the group's top-2w reorder, without speculation;
  * logprobs: a request that asks for them routes its prefill through
    the LM head at every chunk position (prompt logprobs) and gets the
    chosen token's logprob at every sampled position;
  * copy-on-write page copies queued by the cache are applied to the
    device pools before any write.

Only the sampled tokens - and, when a step needs them, the chosen
tokens' logprobs and the beam groups' top-2w - cross to the host; the
repetition-penalty presence bitmask (max_batch, padded vocab) lives on
the device and is updated by scatter.  ``kv_codec`` ("fp", "int8",
"log16") picks the page codec: K/V rows are encoded on write, the int8
scale sidecars ride every page copy, and the paged kernels decode each
tile (``kernels/page_codec.py``).  Host bookkeeping (``paged_cache``,
``scheduler``, ``spec``) is the reference's, copied.

Tensor and data parallelism (a ``mesh`` from
:func:`repro_torch.launch.mesh.make_tp_dp_mesh`, one engine a rank): the
pools hold this rank's ``Hkv / tp`` KV heads, every paged attention call
goes through :mod:`repro_torch.parallel.collectives` (the triplet
all-gather and the ACC merge; with dp > 1 each rank attends its slots'
slice), and everything else - weights, the model's other layers, the
sampler, the host bookkeeping - is replicated.  The ranks must make the
same decisions in the same step, or they call different collectives:
so rank 0 alone takes ``submit`` and ``cancel``, and each of its steps
first broadcasts the intake queued since the last step (in order, each
item with the clock reading it was taken at), its clock reading and its
prefill rate; the scheduler's clock reads that one reading all step
long.  Every other rank runs :meth:`ServingEngine.follow`, which
applies each step's inputs and steps, until rank 0's ``run`` ends or
its :meth:`ServingEngine.close` sends a stop.  Every rank then holds
the same finished requests with the same tokens.  While rank 0 has no
step to take (a frontend with no requests), it must call
:meth:`ServingEngine.keepalive` every ``keepalive_s`` seconds, so that
the followers' wait for the next step stays inside the mesh's
collective timeout; ``AsyncFrontend`` does.

The engine runs on ``cuda`` unless built with ``device="cpu"``; the
model must already live on that device.  Pools are updated in place.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_lib, page_codec
from repro_torch.kernels import paged_prefill as paged_pf_k
from repro_torch.serving import sampler
from repro_torch.serving.paged_cache import PagedKVCache
from repro_torch.serving.scheduler import (FinishedRequest,
                                           InvalidRequestError,
                                           PrefillChunk, Request, Scheduler)


def check_page_size(page_size: int, impl: str,
                    device: torch.device) -> None:
    """Refuse a page size the engine cannot serve: below 1 anywhere, and
    above ``cuda_lib.HFA_MAX_PAGE`` on the H-FA rail (an impl "hfa...")
    on the card, whose paged kernel rescales once a page and keeps a
    page's scores in shared memory, which holds them up to that page.
    The plain path on the CPU takes it."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if device.type == "cuda":
        cuda_lib.check_hfa_page(page_size, impl.startswith("hfa"))


def check_parallel(cfg, tp: int, dp: int, max_batch: int) -> None:
    """The reference's checks of a serving mesh: tp must divide the KV
    and the query heads (each rank holds whole GQA groups) and dp the
    slots (each decode and verify splits them evenly)."""
    if tp > 1 and (cfg.n_kv_heads % tp or cfg.n_heads % tp):
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads} and "
            f"n_heads={cfg.n_heads}")
    if dp > 1 and max_batch % dp:
        raise ValueError(
            f"data-parallel degree dp={dp} must divide "
            f"max_batch={max_batch}")


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k`` of the log-softmax: (logprob, token) of the k
    best per row, the lower token first on a tie (a stable sort)."""
    vals, idx = torch.sort(_log_softmax(logits), dim=-1, descending=True,
                           stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _chosen_lp(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """The log-softmax at each row's chosen token."""
    return torch.gather(_log_softmax(logits), -1,
                        toks[..., None].to(torch.int64))[..., 0]


class ServingEngine:
    # spec_k="auto" draft ceiling: bounds the per-step draft count.
    AUTO_SPEC_KMAX = 4

    def __init__(self, model, *, max_batch: int = 8, page_size: int = 16,
                 num_pages: int | None = None, max_seq: int | None = None,
                 prefill_budget: int | str | None = None,
                 prefix_caching: bool = True, spec_k: int | str = 0,
                 cached_frac: float = 0.5,
                 adaptive_floor: int | None = None,
                 adaptive_ceiling: int | None = None,
                 mesh=None, kv_codec: str = "fp", device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}: move it with .to(device)")
        check_page_size(page_size, model.cfg.attn_impl, self.device)
        # A mesh's "model" axis (tp) shards the pools by KV head, its
        # "data" axis (dp) the slots of each paged attention call.
        self.mesh = mesh
        self.tp = 1 if mesh is None else int(mesh.shape.get("model", 1))
        self.dp = 1 if mesh is None else int(mesh.shape.get("data", 1))
        check_parallel(model.cfg, self.tp, self.dp, max_batch)
        self._lockstep = self.tp * self.dp > 1
        if self._lockstep and mesh.device != self.device:
            raise ValueError(f"the mesh puts this rank on {mesh.device}, "
                             f"the engine on {self.device}")
        # Rank 0 of a mesh leads: it takes the intake and broadcasts each
        # step's inputs; the others follow().
        self._lead = not self._lockstep or mesh.rank == 0
        self._intake: list = []
        self._unstopped = True         # a stop not yet sent (rank 0)
        # Rank 0 sends an empty step this often while idle: a quarter of
        # the time a follower's collective waits for it.
        self.keepalive_s = mesh.timeout / 4 \
            if self._lockstep and self._lead else None
        self.kv_codec = page_codec.get_codec(kv_codec).name
        self.adaptive_prefill = prefill_budget == "adaptive"
        if isinstance(prefill_budget, str) and not self.adaptive_prefill:
            raise ValueError(
                f"prefill_budget must be an int, None or 'adaptive', "
                f"got {prefill_budget!r}")
        if not self.adaptive_prefill and prefill_budget is not None \
                and prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {prefill_budget}")
        # spec_k="auto" speculates up to AUTO_SPEC_KMAX drafts; the
        # accept-rate EMA picks each step's count (exact acceptance keeps
        # the stream of every fixed spec_k - only the step count moves).
        self.auto_spec = spec_k == "auto"
        if self.auto_spec:
            spec_k = self.AUTO_SPEC_KMAX
        elif isinstance(spec_k, str):
            raise ValueError(
                f"spec_k must be an int or 'auto', got {spec_k!r}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if not 0.0 <= cached_frac <= 1.0:
            raise ValueError(
                f"cached_frac must be in [0, 1], got {cached_frac}")
        self.model = model
        self.page_size = page_size
        self.max_batch = max_batch
        self.prefill_budget = prefill_budget
        self.adaptive_floor = adaptive_floor if adaptive_floor is not None \
            else page_size
        self.adaptive_ceiling = adaptive_ceiling \
            if adaptive_ceiling is not None \
            else max(8 * page_size, self.adaptive_floor)
        if not 1 <= self.adaptive_floor <= self.adaptive_ceiling:
            raise ValueError(
                f"need 1 <= adaptive_floor <= adaptive_ceiling, got "
                f"{self.adaptive_floor}..{self.adaptive_ceiling}")
        # EMA of the measured prefill rate (tokens per second of wall
        # time in _run_chunks): converts SLA headroom into a budget.
        self._prefill_rate = 0.0
        self.prefix_caching = prefix_caching
        self.spec_k = spec_k
        max_seq = max_seq if max_seq is not None else model.cfg.max_seq
        self.pages_per_seq = -(-max_seq // page_size)
        if num_pages is None:
            num_pages = max_batch * self.pages_per_seq
        max_cached = None if cached_frac >= 1.0 \
            else int(cached_frac * num_pages)
        self.cache = PagedKVCache(num_pages, page_size, max_batch,
                                  self.pages_per_seq,
                                  max_cached_pages=max_cached)
        self.sched = Scheduler(self.cache)
        self.layers = model.init_paged_cache(num_pages, page_size,
                                             codec=self.kv_codec, mesh=mesh)
        # Measured from the pools this rank holds, the largest over the
        # ranks: pools left at full width would show at full size.
        local = self._local_pool_bytes()
        self._pool_bytes_per_shard = mesh.all_reduce_max(local) \
            if self._lockstep else local
        # Per-slot sampling vectors (greedy defaults), sent to the device
        # with each sampled call; the presence bitmask (the repetition
        # penalty's context) stays on the device.
        self._temp = np.zeros((max_batch,), np.float32)
        self._top_k = np.zeros((max_batch,), np.int32)
        self._top_p = np.ones((max_batch,), np.float32)
        self._rep_pen = np.ones((max_batch,), np.float32)
        self._seed = np.zeros((max_batch,), np.int32)
        self._presence = torch.zeros((max_batch, model.cfg.padded_vocab),
                                     dtype=torch.bool, device=self.device)
        # The reference's counters, key for key ("triplet_bytes" counts
        # the tensor-parallel triplet traffic; the last two are the async
        # frontend's bookkeeping).
        self.stats = {"steps": 0, "prefills": 0, "prefill_chunks": 0,
                      "prefill_tokens": 0, "cached_prefill_tokens": 0,
                      "generated_tokens": 0, "preemptions": 0,
                      "cow_copies": 0, "rejected": 0, "decode_steps": 0,
                      "decode_slot_steps": 0, "decode_tokens": 0,
                      "draft_tokens": 0, "draft_accepted": 0,
                      "accept_rate_ema": 0.0, "spec_k_last": 0,
                      "rollbacks": 0, "triplet_bytes": 0,
                      "groups": 0, "forks": 0, "beam_steps": 0,
                      "beam_early_stops": 0,
                      "cancelled": 0, "adaptive_budget_last": 0,
                      "results_evicted": 0, "stream_overflows": 0}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def _local_pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for pools in self.layers.values() for t in pools.values())

    def pool_bytes(self) -> int:
        """Total logical KV pool bytes, over the tensor-parallel shards
        (each holds Hkv / tp heads of every page)."""
        return self._local_pool_bytes() * self.tp

    def pool_bytes_per_shard(self) -> int:
        """KV pool bytes a rank holds, measured from each rank's own pool
        tensors when the engine was built and reduced with MAX over the
        mesh - not derived from tp, so pools silently left at full width
        show at full size."""
        return self._pool_bytes_per_shard

    def _count_triplets(self, batch: int, rows: int) -> None:
        """The reference's count of one call's ACC-merge traffic: each of
        the tp shards gathers tp padded (o~, m, l) triplets, (d_head + 2)
        f32 a (slot, query row, head, layer)."""
        if self.tp <= 1:
            return
        cfg = self.model.cfg
        per_shard = self.tp * batch * rows * cfg.n_heads * \
            (cfg.d_head + 2) * 4 * cfg.n_layers
        self.stats["triplet_bytes"] += self.tp * per_shard

    def bytes_per_token(self) -> int:
        """Pool bytes per stored KV token row (all layers)."""
        return self.pool_bytes() // (self.cache.num_pages * self.page_size)

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        self._lead_only("submit")
        limit = self.pages_per_seq * self.page_size
        need = len(req.prompt) + req.max_new_tokens
        if need > limit:
            raise ValueError(
                f"request {req.rid}: prompt+budget {need} exceeds the "
                f"per-sequence ceiling {limit} (pages_per_seq * page_size)")
        width = req.beam_width if req.beam_width > 0 \
            else (req.best_of if req.best_of is not None else req.n)
        if width > self.max_batch:
            raise ValueError(
                f"request {req.rid}: group width {width} exceeds "
                f"max_batch {self.max_batch}")
        self._take("submit", req)

    def cancel(self, rid: int) -> bool:
        """Drop request ``rid`` wherever it is (waiting, mid-prefill,
        mid-decode, a fanned-out group), freeing its slots and pages
        refcount-clean.  Pending copy-on-write copies are applied first:
        a queued copy into a page freed here and reallocated next step
        would clobber the new owner's KV.  Returns True if the request
        was found.  Call it between engine steps."""
        self._lead_only("cancel")
        return self._take("cancel", rid)

    def reject(self, req: Request) -> FinishedRequest:
        """Turn ``req`` away (``submit`` raised ValueError: it can never
        fit): counted in ``stats["rejected"]`` on every rank."""
        self._lead_only("reject")
        return self._take("reject", req)

    # ------------------------------------------------------------ lockstep
    def _lead_only(self, what: str) -> None:
        if not self._lead:
            raise RuntimeError(f"{what}: rank {self.mesh.rank} follows rank "
                               f"0 (call follow()); rank 0 takes the intake")

    @contextlib.contextmanager
    def _clock_at(self, now: float):
        """The scheduler's clock reads ``now`` within the block."""
        live = self.sched.clock
        self.sched.clock = lambda: now
        try:
            yield
        finally:
            self.sched.clock = live

    def _take(self, kind: str, arg, now: float | None = None):
        """Apply one intake item: "submit" (a request), "cancel" (a rid)
        or "reject" (a request ``run`` turned away).  Under a mesh it runs
        at one clock reading: rank 0 reads the clock and queues the item
        for its next step's broadcast, the others apply it at rank 0's
        reading."""
        if not self._lockstep:
            return self._apply(kind, arg)
        lead = now is None
        if lead:
            now = self.sched.clock()
        with self._clock_at(now):
            out = self._apply(kind, arg)
        if lead:                       # taken: the others apply it too
            self._intake.append((kind, arg, now))
            self._unstopped = True
        return out

    def _apply(self, kind: str, arg):
        if kind == "submit":
            self.sched.submit(arg)
            return None
        if kind == "cancel":
            self._apply_pending_copies()
            hit = self.sched.cancel(arg)
            if hit:
                self.stats["cancelled"] += 1
            return hit
        self.stats["rejected"] += 1
        return FinishedRequest(rid=arg.rid, prompt=arg.prompt, tokens=[],
                               reason="rejected")

    def _fingerprint(self) -> tuple:
        """What every rank's host state must agree on before a step."""
        return (self.stats["steps"], self.stats["generated_tokens"],
                tuple(int(x) for x in self.cache.seq_lens))

    def follow(self) -> list[FinishedRequest]:
        """A rank other than 0: receive each step's inputs from rank 0,
        apply them and step, until rank 0 sends a stop (the end of its
        ``run``, or :meth:`close`), applying the intake of rank 0's
        keepalives without a step.  Returns the requests finished (and
        rejected) meanwhile, as rank 0's ``run`` does."""
        if not self._lockstep or self._lead:
            raise RuntimeError("follow() runs on the ranks other than 0 of "
                               "a serving mesh")
        finished: list[FinishedRequest] = []
        while True:
            msg = self.mesh.broadcast_object()
            for kind, arg, now in msg["intake"]:
                out = self._take(kind, arg, now)
                if kind == "reject":
                    finished.append(out)
            if msg["do"] == "stop":
                return finished
            if msg["do"] == "idle":
                continue
            if msg["check"] != self._fingerprint():
                raise RuntimeError(
                    f"rank {self.mesh.rank} left lockstep with rank 0: "
                    f"{self._fingerprint()} != {msg['check']}")
            self._prefill_rate = msg["rate"]
            with self._clock_at(msg["now"]):
                finished.extend(self._step())

    def close(self) -> None:
        """Rank 0 of a mesh: send the intake still queued and a stop, so
        each other rank's :meth:`follow` returns (``run`` does this at its
        end).  Nothing to do without a mesh, or when no step or intake
        came since the last stop."""
        if self._lockstep and self._lead and self._unstopped:
            self.mesh.broadcast_object({"do": "stop",
                                        "intake": self._intake})
            self._intake = []
            self._unstopped = False

    def keepalive(self) -> None:
        """Rank 0 of a mesh with no step to take: send the intake queued
        so far and no step, so that the other ranks, waiting in
        :meth:`follow` for the next step, are not left past the mesh's
        collective timeout (call it every ``keepalive_s`` seconds while
        idle).  Nothing to do without a mesh, or after a stop."""
        if self._lockstep and self._lead and self._unstopped:
            self.mesh.broadcast_object({"do": "idle",
                                        "intake": self._intake})
            self._intake = []

    # -------------------------------------------------------------- step
    def _step_budget(self) -> int | None:
        """This step's prefill token budget (None = unbounded)."""
        if not self.adaptive_prefill:
            return self.prefill_budget
        budget = self.sched.adaptive_prefill_budget(
            self._prefill_rate, self.adaptive_floor, self.adaptive_ceiling)
        self.stats["adaptive_budget_last"] = budget
        return budget

    def step(self) -> list[FinishedRequest]:
        """One token-budget step: continue/admit prefill chunks, run one
        batched (speculative) decode over every decoding slot; returns
        the requests that finished during this step.  Under a mesh, rank
        0's step first sends the step's inputs to the other ranks."""
        if not self._lockstep:
            return self._step()
        self._lead_only("step")
        msg = {"do": "step", "intake": self._intake,
               "now": self.sched.clock(), "rate": self._prefill_rate,
               "check": self._fingerprint()}
        self._intake = []
        self._unstopped = True
        self.mesh.broadcast_object(msg)
        with self._clock_at(msg["now"]):
            return self._step()

    def _step(self) -> list[FinishedRequest]:
        finished: list[FinishedRequest] = []
        # Decoding slots claim their next page before prefill work is
        # scheduled, so a prompt chunk cannot evict an in-flight decode.
        self._capacity_pass()
        budget = self._step_budget()
        chunks, reused = self.sched.schedule_prefill(budget)
        if not chunks and not self.sched.decoding_slots() \
                and self.sched.running:
            # Gridlock: every running slot is a paused prefill and the
            # pool is dry - free the least-advanced one and re-plan.
            victim = self.sched.choose_victim()
            if victim is not None:
                self.sched.preempt(victim)
                self.stats["preemptions"] += 1
                chunks, r2 = self.sched.schedule_prefill(budget)
                reused += r2
        self.stats["cached_prefill_tokens"] += reused
        self._apply_pending_copies()
        t0 = time.perf_counter()
        self._run_chunks(chunks, finished)
        if chunks:
            dt = time.perf_counter() - t0
            n_tok = sum(len(ck.tokens) for ck in chunks)
            if dt > 0.0 and n_tok:
                rate = n_tok / dt
                self._prefill_rate = rate if self._prefill_rate == 0.0 \
                    else 0.8 * self._prefill_rate + 0.2 * rate
        # Slots that finished their prefill append below; a prompt ending
        # on a page boundary needs its next page first.
        self._capacity_pass()
        self._run_decode(finished)
        self.stats["steps"] += 1
        return finished

    def _capacity_pass(self) -> None:
        """Guarantee every decoding slot can append one token, preempting
        the least-advanced running sequence under pool pressure (a group
        victim evicts every branch of its group)."""
        for slot in self.sched.decoding_slots():
            if slot not in self.sched.running:
                continue                    # already evicted as a victim
            while slot in self.sched.running and \
                    not self.cache.ensure_append_capacity(slot):
                at_ceiling = self.cache.pages_for(
                    int(self.cache.seq_lens[slot]) + 1) \
                    > self.cache.pages_per_seq
                victim = slot if at_ceiling else self.sched.choose_victim()
                self.sched.preempt(victim)
                self.stats["preemptions"] += 1

    def _apply_pending_copies(self) -> None:
        """Apply queued copy-on-write page copies to every layer pool
        (stacked (groups, P, page, Hkv, d): page axis 1)."""
        copies = self.cache.take_pending_copies()
        if not copies:
            return
        self.stats["cow_copies"] += len(copies)
        src = self._dev(np.array([s for s, _ in copies], np.int64))
        dst = self._dev(np.array([d for _, d in copies], np.int64))
        for pools in self.layers.values():
            for pool in pools.values():
                paged_pf_k.copy_pages(pool, src, dst, axis=1)

    # ----------------------------------------------------------- sampling
    def _all_greedy(self, slots) -> bool:
        """True when every listed slot is pure argmax (temperature 0, no
        repetition penalty): the call then skips the sampling pipeline."""
        idx = np.asarray(list(slots), np.int64)
        return bool(np.all(self._temp[idx] == 0.0)
                    and np.all(self._rep_pen[idx] == 1.0))

    def _set_sampling(self, slot: int) -> None:
        """Mirror a slot's request sampling params into the per-slot
        vectors."""
        sp = self.sched.running[slot].req.sampling or sampler.GREEDY
        self._set_branch_sampling(slot, sp, 0)

    def _set_branch_sampling(self, slot: int, sp, branch: int) -> None:
        """Branch ``branch`` samples under ``branch_seed(seed, branch)``
        - otherwise the request's own sampling params."""
        self._temp[slot] = sp.temperature
        self._top_k[slot] = sp.top_k
        self._top_p[slot] = sp.top_p
        self._rep_pen[slot] = sp.repetition_penalty
        self._seed[slot] = sampler.branch_seed(sp.seed, branch)

    def _reset_beam_slots(self, group) -> None:
        """Pin every live beam slot's sampling vectors to greedy: a
        reorder forks branches into slots whose vectors may still hold a
        previous occupant's sampled params."""
        for slot in group.slots:
            self._set_branch_sampling(slot, sampler.GREEDY, 0)

    def _rebuild_presence(self, slot: int) -> None:
        """Recompute a slot's repetition-penalty context from its full
        token stream (admission, or replay after preemption)."""
        toks = self._dev(np.asarray(self.sched.running[slot].tokens(),
                                    np.int64))
        self._presence[slot] = False
        self._presence[slot, toks] = True

    def _mark_presence(self, marks: list[tuple[int, int]]) -> None:
        """Add each recorded (slot, token) to the presence bitmask, in one
        scatter."""
        if marks:
            idx = self._dev(np.asarray(marks, np.int64))
            self._presence[idx[:, 0], idx[:, 1]] = True

    def _vectors(self, slots: np.ndarray | None = None) -> tuple:
        """The per-slot sampling vectors (of ``slots``, or all) on the
        device: seeds, temperature, top-k, top-p, penalty."""
        pick = (lambda a: a) if slots is None else (lambda a: a[slots])
        return tuple(self._dev(pick(a)) for a in (
            self._seed, self._temp, self._top_k, self._top_p,
            self._rep_pen))

    def _want_logprobs(self) -> bool:
        """True when a parallel-sampling group is live (branches score
        their completions, and best_of > n ranks on it) or a live
        request asked for logprobs."""
        return any((st.group is not None and not st.group.beam)
                   or st.req.logprobs
                   for st in self.sched.running.values())

    # ----------------------------------------------------------- prefill
    def _run_chunks(self, chunks: list[PrefillChunk], finished: list):
        """Run this step's prefill chunks, batched by page-padded length.
        Final chunks yield the sequence's first token(s): a group fans
        out its branches over ``fork``, and every first token - one per
        plain request, one per branch - is drawn in one sampling call."""
        for ck in chunks:
            self._set_sampling(ck.slot)
        groups: dict[int, list[PrefillChunk]] = {}
        for ck in chunks:
            lpad = -(-len(ck.tokens) // self.page_size) * self.page_size
            groups.setdefault(lpad, []).append(ck)
        for lpad, grp in sorted(groups.items()):
            bsz = len(grp)
            width = max(self.cache.pages_for(ck.start + len(ck.tokens))
                        for ck in grp)
            toks = np.zeros((bsz, lpad), np.int32)
            rows = np.zeros((bsz, width), np.int32)
            start = np.zeros((bsz,), np.int32)
            last = np.zeros((bsz,), np.int32)
            for i, ck in enumerate(grp):
                toks[i, :len(ck.tokens)] = ck.tokens
                rows[i] = self.cache.page_table[ck.slot, :width]
                start[i] = ck.start
                last[i] = len(ck.tokens) - 1
            # A logprobs request routes its whole group through the LM
            # head at every chunk position; other groups take the head
            # at the last position only.
            want_plp = any(self.sched.running[ck.slot].req.logprobs
                           for ck in grp)
            last_t = self._dev(last)
            logits, self.layers = self.model.paged_prefill(
                self.layers, self._dev(toks), self._dev(rows),
                last_pos=last_t, start_pos=self._dev(start),
                codec=self.kv_codec, return_all_logits=want_plp,
                mesh=self.mesh)
            if want_plp:
                lsm = _log_softmax(logits)
                targets = self._dev(self._prompt_targets(grp, lpad))
                plp = torch.gather(lsm, -1,
                                   targets[..., None].to(torch.int64))
                self._record_prompt_lps(grp, plp[..., 0].cpu().numpy())
                rows_i = torch.arange(bsz, device=self.device)
                logits = logits[rows_i, last_t.to(torch.int64)]
            else:
                logits = logits[:, 0]
            self.stats["prefills"] += 1
            self._count_triplets(bsz, lpad)
            finals = []
            for i, ck in enumerate(grp):
                self.stats["prefill_chunks"] += 1
                self.stats["prefill_tokens"] += len(ck.tokens)
                self.sched.complete_chunk(ck)
                if self.prefix_caching:
                    self.cache.register_pages(
                        ck.slot, self.sched.running[ck.slot].tokens())
                if ck.is_final:
                    finals.append((i, ck.slot))
            if finals:
                self._finish_prefills(logits, finals, finished)

    def _prompt_targets(self, grp, lpad: int) -> np.ndarray:
        """Next-token target per chunk position: ``targets[i, j]`` is
        chunk i's stream token at absolute position start + j + 1 (what
        the logit at position j predicts), 0 where out of range."""
        targets = np.zeros((len(grp), lpad), np.int32)
        for i, ck in enumerate(grp):
            stream = self.sched.running[ck.slot].tokens()
            hi = min(len(ck.tokens), len(stream) - ck.start - 1)
            if hi > 0:
                targets[i, :hi] = stream[ck.start + 1:ck.start + 1 + hi]
        return targets

    def _record_prompt_lps(self, grp, plp: np.ndarray) -> None:
        """Fill each logprobs request's prompt_lps: position j of a chunk
        scores the prompt token at stream index start + j + 1.  Indices
        past the prompt (replayed generated tokens) and the final chunk's
        last position (it predicts the first generated token, which the
        sampler's logprob covers) are skipped."""
        for i, ck in enumerate(grp):
            st = self.sched.running[ck.slot]
            if not st.req.logprobs:
                continue
            plen = len(st.req.prompt)
            n = len(ck.tokens)
            valid = n - 1 if ck.is_final else n
            for j in range(valid):
                t = ck.start + j + 1
                if 1 <= t < plen:
                    st.prompt_lps[t] = float(plp[i, j])

    def _finish_prefills(self, logits, finals: list, finished: list):
        """First tokens for every sequence whose prefill just completed:
        fan sequence groups out into their branches, draw one token per
        plain request or parallel branch in one sampling call over
        replicated logits rows, and hand beam roots their top-2w."""
        rows: list[tuple[int, int]] = []     # (logits row, slot)
        beams: list[tuple[int, int]] = []
        for i, slot in finals:
            st = self.sched.running[slot]
            if st.group is None:
                self._rebuild_presence(slot)
                rows.append((i, slot))
            elif st.group.beam:
                self.stats["groups"] += 1
                beams.append((i, slot))
            else:
                self.stats["groups"] += 1
                base = st.req.sampling or sampler.GREEDY
                branches = self.sched.fan_out(slot)
                self.stats["forks"] += len(branches) - 1
                for bslot, b in branches:
                    self._set_branch_sampling(bslot, base, b)
                    self._rebuild_presence(bslot)
                    rows.append((i, bslot))
        if rows:
            self._sample_first_tokens(logits, rows, finished)
        for i, slot in beams:
            self._expand_beam_root(logits, i, slot, finished)

    def _sample_first_tokens(self, logits, rows, finished):
        """One sampling call covering every first token: row j draws for
        ``rows[j] = (logits row, slot)`` at the slot's stream position
        (the stream's length: the prompt plus any generated tokens
        replayed after a preemption) under the slot's (branch) seed."""
        src = self._dev(np.asarray([i for i, _ in rows], np.int64))
        slots = np.asarray([s for _, s in rows], np.int64)
        lrows = logits[src]
        if self._all_greedy(slots):
            toks = sampler.greedy_tokens(lrows)
        else:
            pos = np.asarray([self.sched.running[s].target for s in slots],
                             np.int32)
            seeds, temp, top_k, top_p, pen = self._vectors(slots)
            toks = sampler.sample_tokens(
                lrows, self._presence[self._dev(slots)], seeds,
                self._dev(pos), temp, top_k, top_p, pen)
        lps = _chosen_lp(lrows, toks).cpu().numpy() \
            if self._want_logprobs() else np.zeros(len(rows), np.float32)
        toks = toks.cpu().numpy()
        marks = []
        for j, (_, slot) in enumerate(rows):
            tok = int(toks[j])
            self.stats["generated_tokens"] += 1
            st = self.sched.running[slot]
            status = self.sched.record_token(slot, tok)
            st.cum_logprob += float(lps[j])
            if st.req.logprobs:
                st.token_logprobs.append(float(lps[j]))
            marks.append((slot, tok))
            if status != "running":
                fr = self.sched.finish(slot, status)
                if fr is not None:
                    finished.append(fr)
        self._mark_presence(marks)

    def _expand_beam_root(self, logits, i, slot, finished):
        """First beam expansion: the top-2w (logprob, token) candidates of
        the prompt's last-position logits seed the beam."""
        group = self.sched.running[slot].group
        vals, idx = _top_k(logits[i:i + 1], 2 * group.width)
        cands = list(zip(idx[0].tolist(), vals[0].tolist()))
        before_tok = self.sched.tokens_emitted
        before_forks = self.sched.forks
        fr = self.sched.fan_out_beam(slot, cands)
        self.stats["generated_tokens"] += \
            self.sched.tokens_emitted - before_tok
        self.stats["forks"] += self.sched.forks - before_forks
        if fr is not None:
            finished.append(fr)
        else:
            self._reset_beam_slots(group)

    # ------------------------------------------------------------ decode
    def _sample_step(self, logits, toks_t, seq_lens_t, kw: int):
        """Tokens (B, kw) for a decode (kw 1) or verify step's logits
        (B, kw, V): position i of slot b samples at stream index
        seq_lens[b] + 1 + i, its context the slot's presence plus the
        step's drafts 1..i."""
        b, _, v = logits.shape
        seeds, temp, top_k, top_p, pen = self._vectors()
        pres = self._presence if kw == 1 else \
            sampler.step_presence(self._presence, toks_t).reshape(b * kw, v)
        pos = seq_lens_t.to(torch.int32)[:, None] + 1 + torch.arange(
            kw, dtype=torch.int32, device=self.device)[None]
        rep = lambda x: torch.repeat_interleave(x, kw, dim=0)  # noqa: E731
        return sampler.sample_tokens(
            logits.reshape(b * kw, v), pres, rep(seeds), pos.reshape(-1),
            rep(temp), rep(top_k), rep(top_p), rep(pen)).reshape(b, kw)

    def _run_decode(self, finished: list) -> None:
        """One batched decode/verify step: feed each decoding slot its
        carry token plus up to ``spec_k`` drafts, sample the target token
        at every position on the device, keep the longest prefix whose
        drafts the sampler confirms, and roll the paged KV back past it.
        Beam branches ride along with a single carry column: their next
        tokens come from the group's top-2w reorder after the call."""
        k = self.spec_k
        if self.auto_spec:
            # Draft count from the accept-rate EMA (floor 1 keeps
            # measuring after a cold start or a workload shift).
            ema = self.stats["accept_rate_ema"]
            k = max(1, min(self.spec_k, round(ema * (self.spec_k + 1))))
        self.stats["spec_k_last"] = k
        steps = self.sched.schedule_decode(k)
        if not steps:
            return
        kw = k + 1
        toks = np.zeros((self.max_batch, kw), np.int32)
        dl = np.zeros((self.max_batch,), np.int32)
        cl = np.zeros((self.max_batch,), np.int32)
        beam_groups: dict[int, object] = {}
        for step in steps:
            slot = step.slot
            st = self.sched.running[slot]
            if st.group is not None and st.group.beam:
                beam_groups.setdefault(id(st.group), st.group)
            sl = int(self.cache.seq_lens[slot])
            c = len(step.tokens)
            if c > 1 and not self.cache.ensure_capacity(slot, sl + c):
                # Pool pressure / per-seq ceiling: shrink the step to the
                # writable pages (the capacity pass guaranteed one token).
                c = max(1, min(
                    c, self.cache.writable_token_capacity(slot) - sl))
                del step.tokens[c:]
                del step.drafts[max(0, c - 1):]
            dl[slot] = sl
            cl[slot] = c
            toks[slot, :c] = step.tokens
        width = max(self.cache.pages_for(int(dl[s.slot] + cl[s.slot]))
                    for s in steps)
        self._apply_pending_copies()
        pt = self._dev(self.cache.page_table[:, :width])
        toks_t, dl_t = self._dev(toks), self._dev(dl)
        if kw == 1:
            logits, self.layers = self.model.paged_decode_step(
                self.layers, toks_t, pt, dl_t, codec=self.kv_codec,
                mesh=self.mesh)
        else:
            logits, self.layers = self.model.paged_verify_step(
                self.layers, toks_t, pt, dl_t, self._dev(cl),
                codec=self.kv_codec, mesh=self.mesh)
        if self._all_greedy(s.slot for s in steps):
            sampled_t = sampler.greedy_tokens(logits)
        else:
            sampled_t = self._sample_step(logits, toks_t, dl_t, kw)
        if self._want_logprobs():
            lps = _chosen_lp(logits, sampled_t).cpu().numpy()
        else:
            lps = np.zeros((self.max_batch, kw), np.float32)
        if beam_groups:
            # Beam slots feed one column: the top-2w of column 0.
            beam_k = 2 * max(g.width for g in beam_groups.values())
            tkv, tki = (t.cpu().numpy()
                        for t in _top_k(logits[:, 0], beam_k))
        sampled = sampled_t.cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["decode_slot_steps"] += len(steps)
        self._count_triplets(self.max_batch, kw)
        step_drafted = step_accepted = 0
        marks = []
        for step in steps:
            slot = step.slot
            st = self.sched.running[slot]
            c = len(step.tokens)
            t = sampled[slot]
            sl = int(self.cache.seq_lens[slot])
            # KV for all c inputs is on device: commit it, then roll back
            # past the accepted prefix (see the rollback x refcount
            # contract in paged_cache).
            self.cache.mark_prefilled(slot, sl + c)
            if st.group is not None and st.group.beam:
                # Carry KV committed (c == 1, no speculation); the
                # group's reorder below picks the next tokens.
                if self.prefix_caching:
                    self.cache.register_pages(slot, st.tokens())
                continue
            # A draft is kept while it equals the token sampled at its
            # position (t[j-1] is what the no-spec loop would emit where
            # the step fed draft step.tokens[j]).
            a = 1
            while a < c and int(t[a - 1]) == step.tokens[a]:
                a += 1
            self.stats["draft_tokens"] += c - 1
            self.stats["draft_accepted"] += a - 1
            st.drafted += c - 1
            st.accepted += a - 1
            step_drafted += c - 1
            step_accepted += a - 1
            status, used = "running", 0
            for j in range(a):
                tok = int(t[j])
                used += 1
                self.stats["generated_tokens"] += 1
                self.stats["decode_tokens"] += 1
                status = self.sched.record_token(slot, tok)
                st.cum_logprob += float(lps[slot, j])
                if st.req.logprobs:
                    st.token_logprobs.append(float(lps[slot, j]))
                marks.append((slot, tok))
                if status != "running":
                    break
            if status != "running":
                fr = self.sched.finish(slot, status)
                if fr is not None:
                    finished.append(fr)
                continue
            if used < c:
                self.cache.rollback(slot, sl + used)
                self.stats["rollbacks"] += 1
            if self.prefix_caching:
                self.cache.register_pages(slot, st.tokens())
        self._mark_presence(marks)
        if step_drafted:
            rate = step_accepted / step_drafted
            ema = self.stats["accept_rate_ema"]
            self.stats["accept_rate_ema"] = rate if ema == 0.0 \
                else 0.8 * ema + 0.2 * rate
        for group in beam_groups.values():
            if not group.slots:
                continue
            # Each group sees exactly its own top-2w slice, so its
            # expansion does not depend on the other live beam groups.
            k2 = 2 * group.width
            per_slot = {s: list(zip(tki[s, :k2].tolist(),
                                    tkv[s, :k2].tolist()))
                        for s in group.slots}
            before_tok = self.sched.tokens_emitted
            before_forks = self.sched.forks
            before_stops = self.sched.beam_early_stops
            fr = self.sched.beam_reorder(group, per_slot)
            self.stats["generated_tokens"] += \
                self.sched.tokens_emitted - before_tok
            self.stats["forks"] += self.sched.forks - before_forks
            self.stats["beam_early_stops"] += \
                self.sched.beam_early_stops - before_stops
            self.stats["beam_steps"] += 1
            if fr is not None:
                finished.append(fr)
            else:
                self._reset_beam_slots(group)

    # --------------------------------------------------------------- run
    def run(self, arrivals: list[tuple[int, Request]],
            max_steps: int | None = None) -> list[FinishedRequest]:
        """Drive to completion. arrivals: [(arrival_step, request)].

        A request whose prompt + budget cannot ever fit a sequence's page
        allowance, or whose group is wider than ``max_batch``, is
        rejected (``reason="rejected"``); contradictory knobs raise
        ``InvalidRequestError``.  Under a mesh this is rank 0's side:
        it ends with :meth:`close`, which ends the others' ``follow``.
        """
        pending = sorted(arrivals, key=lambda a: a[0])
        finished: list[FinishedRequest] = []
        step = 0
        while pending or self.sched.has_work:
            while pending and pending[0][0] <= step:
                _, req = pending.pop(0)
                try:
                    self.submit(req)
                except InvalidRequestError:
                    raise        # contradictory knobs: client misuse
                except ValueError:
                    finished.append(self.reject(req))
            before = self.stats["generated_tokens"]
            finished.extend(self.step())
            step += 1
            if max_steps is not None and step >= max_steps:
                break
            if (self.stats["generated_tokens"] == before
                    and not self.sched.running and not pending
                    and self.sched.waiting):
                self.close()
                raise RuntimeError(
                    "serving stalled: page pool too small for the "
                    "smallest waiting request")
        self.close()
        return finished
