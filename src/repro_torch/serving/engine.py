"""ServingEngine: continuous-batching greedy decode over paged KV.

One engine step mixes prefill chunks with one batched decode
(Sarathi-style), as in the reference engine:

  * prefill work is bounded by ``prefill_budget`` tokens per step and
    handed out as chunks that resume at ``start_pos > 0``;
  * admission claims the longest cached prompt prefix (full pages, by
    chain hash) instead of recomputing it;
  * decode is one call over all ``max_batch`` slots: the single-token
    paged decode when ``spec_k == 0``, otherwise a verify over the
    carry token plus up to ``spec_k`` prompt-lookup drafts per slot,
    with exact acceptance (a draft is kept iff it equals the argmax at
    its position) and paged rollback of the rejected columns;
  * copy-on-write page copies queued by the cache are applied to the
    device pools before any write.

The next token is the argmax of the logits: this slice serves greedy
requests only.  The engine rejects at construction or submission what
it does not port yet - sampling, sequence groups (``n``, ``best_of``,
``beam_width``), logprobs, a tensor-parallel ``mesh``, the int8/log16
codecs, ``spec_k="auto"`` and the adaptive prefill budget (ROADMAP.md
Queue 1).  Host bookkeeping (``paged_cache``, ``scheduler``, ``spec``)
is the reference's, copied.

The engine runs on ``cuda`` unless built with ``device="cpu"``; the
model must already live on that device.  Pools are updated in place.
"""
from __future__ import annotations

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


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1 item {item})")


def check_page_size(page_size: int, impl: str,
                    device: torch.device) -> None:
    """Refuse a page size the engine cannot serve: below 1 anywhere, and
    above ``cuda_lib.HFA_MAX_PAGE`` on the H-FA rail (an impl "hfa...")
    on the card, whose paged kernels rescale once a page and stage at
    most that many keys of one.  The plain path on the CPU takes it."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if device.type == "cuda":
        cuda_lib.check_hfa_page(page_size, impl.startswith("hfa"))


class ServingEngine:
    def __init__(self, model, *, max_batch: int = 8, page_size: int = 16,
                 num_pages: int | None = None, max_seq: int | None = None,
                 prefill_budget: int | None = None,
                 prefix_caching: bool = True, spec_k: int = 0,
                 cached_frac: float = 0.5, mesh=None, kv_codec: str = "fp",
                 device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}: move it with .to(device)")
        check_page_size(page_size, model.cfg.attn_impl, self.device)
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh)", 11)
        self.kv_codec = page_codec.get_codec(kv_codec).name
        if isinstance(prefill_budget, str):
            if prefill_budget == "adaptive":
                raise _not_ported("the adaptive prefill budget", 8)
            raise ValueError(f"prefill_budget must be an int or None, got "
                             f"{prefill_budget!r}")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {prefill_budget}")
        if spec_k == "auto":
            raise _not_ported('spec_k="auto"', 8)
        if isinstance(spec_k, str) or spec_k < 0:
            raise ValueError(f"spec_k must be an int >= 0, got {spec_k!r}")
        if not 0.0 <= cached_frac <= 1.0:
            raise ValueError(
                f"cached_frac must be in [0, 1], got {cached_frac}")
        self.model = model
        self.page_size = page_size
        self.max_batch = max_batch
        self.prefill_budget = prefill_budget
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
                                             codec=self.kv_codec)
        self.stats = {"steps": 0, "prefills": 0, "prefill_chunks": 0,
                      "prefill_tokens": 0, "cached_prefill_tokens": 0,
                      "generated_tokens": 0, "preemptions": 0,
                      "cow_copies": 0, "rejected": 0, "decode_steps": 0,
                      "decode_slot_steps": 0, "decode_tokens": 0,
                      "draft_tokens": 0, "draft_accepted": 0,
                      "rollbacks": 0}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def pool_bytes(self) -> int:
        """Total KV pool bytes."""
        return sum(t.numel() * t.element_size()
                   for pools in self.layers.values() for t in pools.values())

    def bytes_per_token(self) -> int:
        """Pool bytes per stored KV token row (all layers)."""
        return self.pool_bytes() // (self.cache.num_pages * self.page_size)

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        sp = req.sampling or sampler.GREEDY
        if not sp.greedy:
            raise _not_ported("sampling (temperature > 0 or a repetition "
                              "penalty)", 7)
        if req.n != 1 or req.best_of is not None or req.beam_width > 0:
            raise _not_ported("sequence groups (n, best_of, beam_width)", 8)
        if req.logprobs:
            raise _not_ported("logprobs", 8)
        limit = self.pages_per_seq * self.page_size
        need = len(req.prompt) + req.max_new_tokens
        if need > limit:
            raise ValueError(
                f"request {req.rid}: prompt+budget {need} exceeds the "
                f"per-sequence ceiling {limit} (pages_per_seq * page_size)")
        self.sched.submit(req)

    # -------------------------------------------------------------- step
    def step(self) -> list[FinishedRequest]:
        """One token-budget step: continue/admit prefill chunks, run one
        batched (speculative) decode over every decoding slot; returns
        the requests that finished during this step."""
        finished: list[FinishedRequest] = []
        # Decoding slots claim their next page before prefill work is
        # scheduled, so a prompt chunk cannot evict an in-flight decode.
        self._capacity_pass()
        chunks, reused = self.sched.schedule_prefill(self.prefill_budget)
        if not chunks and not self.sched.decoding_slots() \
                and self.sched.running:
            # Gridlock: every running slot is a paused prefill and the
            # pool is dry - free the least-advanced one and re-plan.
            victim = self.sched.choose_victim()
            if victim is not None:
                self.sched.preempt(victim)
                self.stats["preemptions"] += 1
                chunks, r2 = self.sched.schedule_prefill(self.prefill_budget)
                reused += r2
        self.stats["cached_prefill_tokens"] += reused
        self._apply_pending_copies()
        self._run_chunks(chunks, finished)
        # Slots that finished their prefill append below; a prompt ending
        # on a page boundary needs its next page first.
        self._capacity_pass()
        self._run_decode(finished)
        self.stats["steps"] += 1
        return finished

    def _capacity_pass(self) -> None:
        """Guarantee every decoding slot can append one token, preempting
        the least-advanced running sequence under pool pressure."""
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

    def _record(self, slot: int, tok: int, finished: list) -> str:
        """Record one generated token; retire the slot if it finished."""
        self.stats["generated_tokens"] += 1
        status = self.sched.record_token(slot, tok)
        if status != "running":
            fr = self.sched.finish(slot, status)
            if fr is not None:
                finished.append(fr)
        return status

    # ----------------------------------------------------------- prefill
    def _run_chunks(self, chunks: list[PrefillChunk], finished: list):
        """Run this step's prefill chunks, batched by page-padded length.
        Final chunks yield the sequence's first token (argmax of the
        last-position logits)."""
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
            logits, self.layers = self.model.paged_prefill(
                self.layers, self._dev(toks), self._dev(rows),
                last_pos=self._dev(last), start_pos=self._dev(start),
                codec=self.kv_codec)
            self.stats["prefills"] += 1
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
                first = sampler.greedy_tokens(logits[:, 0]).cpu().numpy()
                for i, slot in finals:
                    self._record(slot, int(first[i]), finished)

    # ------------------------------------------------------------ decode
    def _run_decode(self, finished: list) -> None:
        """One batched decode/verify step: feed each decoding slot its
        carry token plus up to ``spec_k`` drafts, take the argmax at
        every position, keep the longest prefix whose drafts it
        confirms, and roll the paged KV back past it."""
        steps = self.sched.schedule_decode(self.spec_k)
        if not steps:
            return
        kw = self.spec_k + 1
        toks = np.zeros((self.max_batch, kw), np.int32)
        dl = np.zeros((self.max_batch,), np.int32)
        cl = np.zeros((self.max_batch,), np.int32)
        for step in steps:
            slot = step.slot
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
        if kw == 1:
            logits, self.layers = self.model.paged_decode_step(
                self.layers, self._dev(toks), pt, self._dev(dl),
                codec=self.kv_codec)
        else:
            logits, self.layers = self.model.paged_verify_step(
                self.layers, self._dev(toks), pt, self._dev(dl),
                self._dev(cl), codec=self.kv_codec)
        sampled = sampler.greedy_tokens(logits).cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["decode_slot_steps"] += len(steps)
        for step in steps:
            slot = step.slot
            c = len(step.tokens)
            t = sampled[slot]
            sl = int(self.cache.seq_lens[slot])
            # KV for all c inputs is on device: commit it, then roll back
            # past the accepted prefix (see the rollback x refcount
            # contract in paged_cache).
            self.cache.mark_prefilled(slot, sl + c)
            a = 1
            while a < c and int(t[a - 1]) == step.tokens[a]:
                a += 1
            self.stats["draft_tokens"] += c - 1
            self.stats["draft_accepted"] += a - 1
            st = self.sched.running[slot]
            st.drafted += c - 1
            st.accepted += a - 1
            status, used = "running", 0
            for j in range(a):
                used += 1
                self.stats["decode_tokens"] += 1
                status = self._record(slot, int(t[j]), finished)
                if status != "running":
                    break
            if status != "running":
                continue
            if used < c:
                self.cache.rollback(slot, sl + used)
                self.stats["rollbacks"] += 1
            if self.prefix_caching:
                self.cache.register_pages(slot, st.tokens())

    # --------------------------------------------------------------- run
    def run(self, arrivals: list[tuple[int, Request]],
            max_steps: int | None = None) -> list[FinishedRequest]:
        """Drive to completion. arrivals: [(arrival_step, request)].

        A request whose prompt + budget cannot ever fit a sequence's page
        allowance is rejected (``reason="rejected"``); a request asking
        for what this engine does not port raises.
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
                    self.stats["rejected"] += 1
                    finished.append(FinishedRequest(
                        rid=req.rid, prompt=req.prompt, tokens=[],
                        reason="rejected"))
            before = self.stats["generated_tokens"]
            finished.extend(self.step())
            step += 1
            if max_steps is not None and step >= max_steps:
                break
            if (self.stats["generated_tokens"] == before
                    and not self.sched.running and not pending
                    and self.sched.waiting):
                raise RuntimeError(
                    "serving stalled: page pool too small for the "
                    "smallest waiting request")
        return finished
