"""Asyncio streaming front-end over :meth:`ServingEngine.step`.

:class:`AsyncFrontend` turns the engine's synchronous step loop into a
per-request token stream: ``submit(request)`` returns an async generator
that yields generated token ids as the engine produces them.  One
background *drive task* owns the engine; each iteration

  1. applies cancellations (abandoned generators), then
  2. feeds queued submissions to the engine, then
  3. runs exactly one ``engine.step()`` on the frontend's own executor
     thread (the event loop stays responsive during the device work),
     with the engine's card made current there, then
  4. publishes each running request's newly generated tokens to its
     stream.

Everything that mutates engine state happens inside the drive task,
*between* steps - client coroutines only enqueue intents (submit /
cancel) and read from per-stream queues, so the scheduler and paged
cache never see concurrent mutation and cancellation is always applied
at a step boundary (``engine.cancel`` flushes pending COW copies before
freeing slots, see :mod:`repro_torch.serving.engine`).

The executor has one thread, so one engine is never stepped by two
threads at once.  The port's kernels launch through ctypes on the
calling thread's current device and stream
(:mod:`repro_torch.kernels.cuda_lib`), and a new thread starts on card 0:
each step runs under ``torch.cuda.device(engine.device)`` so an engine
on any card launches there.

An engine on a serving mesh (rank 0 of tensor- or data-parallel ranks)
has its other ranks waiting in a collective for each step: while idle,
the drive task sends them ``engine.keepalive()`` on the executor every
``engine.keepalive_s`` seconds, well inside the mesh's collective
timeout.  ``start()`` starts the drive task before the first request,
so that a server that waits long for one keeps its ranks too.

Cancellation: abandoning the generator (``break`` / ``aclose()`` / GC)
triggers its ``finally`` block, which files a cancel intent; the next
drive iteration frees the request's slot and pages refcount-clean -
mid-prefill, mid-decode, or fanned-out group alike.  ``drain()`` waits
for every in-flight stream to finish; ``close()`` drains (optionally)
and stops the drive task.

Token publishing is diff-based: a plain request streams each token the
step it is recorded (``_Running.generated`` grows monotonically between
preemption replays, which replay *into the KV*, not into ``generated``);
a sequence group (n > 1 / best_of / beam) bursts its primary
completion's tokens at retirement - branch streams diverge, so there is
no single incremental stream to publish.  The full
:class:`FinishedRequest` (completions, scores, scheduler TTFT) is
available via :meth:`AsyncFrontend.result` once the stream ends.

Long-running-server hygiene (each bound below has a regression test in
``tests/test_torch_frontend.py``):

  * per-stream queues are bounded (``stream_buffer`` items).  A reader
    that stalls for that many tokens is treated as disconnected - the
    request is cancelled (slot/pages freed refcount-clean) rather than
    buffering without limit; ``engine.stats["stream_overflows"]``
    counts it.  The terminal ``_End`` always gets through (oldest
    buffered tokens are dropped to make room - the full token list
    rides the FinishedRequest payload anyway);
  * ``results`` is a bounded LRU: :meth:`result` *claims* (removes) an
    entry, and unclaimed entries beyond ``max_results`` age out
    oldest-first (``engine.stats["results_evicted"]``);
  * a crashed drive task fails the frontend loudly instead of being
    silently restarted: the exception is pushed into every live
    stream's queue (streams raise ``BaseException`` items) and every
    later ``submit`` raises with the original failure chained.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextlib
import dataclasses

import torch

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import (FinishedRequest, InvalidRequestError,
                                     Request)


@dataclasses.dataclass
class _End:
    """Stream terminator carrying the request's FinishedRequest."""
    fr: FinishedRequest


@dataclasses.dataclass
class _Stream:
    req: Request
    queue: asyncio.Queue
    sent: int = 0              # generated tokens published so far
    done: bool = False


class AsyncFrontend:
    """Async streaming facade over one :class:`ServingEngine`.

    Single-event-loop, single-drive-task; not thread-safe.  Typical use::

        fe = AsyncFrontend(engine)
        async for tok in fe.submit(req):
            ...
        fr = fe.result(req.rid)          # claims (removes) the result
        await fe.close()

    ``stream_buffer`` bounds each stream's token queue (0 = unbounded;
    a full queue cancels the request - the reader is presumed gone).
    ``max_results`` bounds the unclaimed-results LRU.
    """

    def __init__(self, engine: ServingEngine, *,
                 stream_buffer: int = 1024, max_results: int = 1024):
        self.engine = engine
        self.stream_buffer = stream_buffer
        self.max_results = max_results
        self._streams: dict[int, _Stream] = {}
        self._pending: list[Request] = []
        self._cancels: list[int] = []
        # rid -> FinishedRequest, insertion-ordered for LRU eviction.
        self.results: collections.OrderedDict[int, FinishedRequest] = \
            collections.OrderedDict()
        self._wake = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        self._task: asyncio.Task | None = None
        self._closed = False
        self._failed: BaseException | None = None
        # Created on the first step, shut down when the drive task ends.
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None

    # ------------------------------------------------------------- client
    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def failed(self) -> bool:
        """True once the drive task crashed; the frontend no longer
        accepts submissions (the engine's state is suspect)."""
        return self._failed is not None

    def start(self) -> None:
        """Start the drive task now rather than at the first ``submit``
        (call it inside the running event loop)."""
        self._ensure_task()

    def submit(self, req: Request):
        """Enqueue ``req`` and return an async generator of its token
        ids.  The request enters the engine on the next drive iteration;
        abandoning the generator cancels the request and frees its
        slot/pages refcount-clean."""
        if self._failed is not None:
            raise RuntimeError(
                "frontend failed (drive task crashed)") from self._failed
        if self._closed:
            raise RuntimeError("frontend is closed")
        if req.rid in self._streams:
            raise ValueError(f"rid {req.rid} already in flight")
        maxsize = self.stream_buffer if self.stream_buffer > 0 else 0
        st = _Stream(req=req, queue=asyncio.Queue(maxsize=maxsize))
        self._streams[req.rid] = st
        self._pending.append(req)
        self._idle.clear()
        self._wake.set()
        self._ensure_task()
        return self._stream(st)

    async def _stream(self, st: _Stream):
        try:
            while True:
                item = await st.queue.get()
                if isinstance(item, _End):
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # Runs on normal exhaustion AND on abandonment (break /
            # aclose / GC closing the generator mid-iteration).
            if not st.done:
                self._request_cancel(st.req.rid)

    def result(self, rid: int) -> FinishedRequest | None:
        """Claim the FinishedRequest of a completed stream: returns it
        and removes it from the unclaimed-results LRU (None while the
        stream is live or after the entry was claimed/evicted)."""
        return self.results.pop(rid, None)

    def queue_depth(self, cls_name: str) -> int:
        """Requests of latency class ``cls_name`` accepted but not yet
        running: frontend submissions awaiting the drive loop plus the
        scheduler's waiting queue.  The HTTP transport's per-class
        admission cap gates on this."""
        n = sum(1 for r in self._pending
                if r.latency_class.name == cls_name)
        # A snapshot: the step may mutate the queue on the executor
        # thread while the transport reads it here.
        n += sum(1 for w in tuple(self.engine.sched.waiting)
                 if w.req.latency_class.name == cls_name)
        return n

    def _request_cancel(self, rid: int) -> None:
        if rid in self._streams and not self._streams[rid].done:
            self._cancels.append(rid)
            self._wake.set()

    async def drain(self) -> None:
        """Wait until every submitted stream has finished (or been
        cancelled) and the engine is idle."""
        self._ensure_task()
        await self._idle.wait()

    async def close(self, drain: bool = True) -> None:
        """Stop the drive task; ``drain=True`` finishes in-flight work
        first, ``drain=False`` cancels every live stream."""
        if drain:
            await self.drain()
        else:
            for rid, st in self._streams.items():
                if not st.done:
                    self._cancels.append(rid)
            self._wake.set()
            await self.drain()
        self._closed = True
        if self._task is not None:
            self._wake.set()        # unblock the wait, task sees _closed
            await self._task
            self._task = None

    # -------------------------------------------------------- drive task
    def _ensure_task(self) -> None:
        if self._task is not None and self._task.done():
            # A done drive task either saw _closed (clean return) or
            # crashed.  _drive routes its own exceptions through
            # _fail(), but keep the belt-and-braces check here: a
            # crash must fail the frontend, never be silently
            # restarted with the exception discarded.
            exc = None if self._task.cancelled() else self._task.exception()
            if exc is not None:
                self._fail(exc)
            self._task = None
        if self._task is None and self._failed is None:
            self._task = asyncio.get_running_loop().create_task(
                self._drive())

    async def _drive(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                self._apply_cancels()
                self._apply_submissions()
                if not self.engine.sched.has_work:
                    self._idle.set()
                    if self._closed:
                        return
                    self._wake.clear()
                    # Intents filed between the clear and this wait were
                    # filed with _wake.set() afterwards, so no lost
                    # wakeup.
                    while not (self._pending or self._cancels):
                        try:
                            await asyncio.wait_for(self._wake.wait(),
                                                   self.engine.keepalive_s)
                            break
                        except asyncio.TimeoutError:
                            await loop.run_in_executor(
                                self._pool(), self.engine.keepalive)
                    continue
                finished = await loop.run_in_executor(self._pool(),
                                                      self._step)
                self._publish(finished)
        except asyncio.CancelledError:
            self._fail(RuntimeError("drive task cancelled"))
            raise
        except BaseException as e:   # noqa: BLE001 - delivered to clients
            # Engine/step failure: every live stream raises it, later
            # submits reject.  Swallowed here so close() can await the
            # task without re-raising what clients already saw.
            self._fail(e)
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=False)
                self._executor = None

    def _pool(self) -> concurrent.futures.ThreadPoolExecutor:
        """The executor thread, made at first use."""
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="engine-step")
        return self._executor

    def _step(self) -> list[FinishedRequest]:
        """One engine step, on the executor thread, with the engine's card
        current there (the kernels launch on the current device)."""
        dev = self.engine.device
        with torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext():
            return self.engine.step()

    def _fail(self, exc: BaseException) -> None:
        """Mark the frontend failed and propagate ``exc`` into every
        live stream (their queues raise BaseException items)."""
        if self._failed is not None:
            return
        self._failed = exc
        for st in list(self._streams.values()):
            if not st.done:
                st.done = True
                self._force_put(st, exc)
        self._streams.clear()
        self._pending.clear()
        self._cancels.clear()
        self._idle.set()

    def _apply_cancels(self) -> None:
        while self._cancels:
            rid = self._cancels.pop()
            st = self._streams.get(rid)
            if st is None or st.done:
                continue
            # Snapshot generated-so-far before the scheduler forgets it.
            # For a fanned-out group there is no single stream; the
            # primary live branch (lowest branch id - completions[0]'s
            # lineage) stands in, mirroring what the client would have
            # been streamed at retirement.
            plain = primary = None
            for run in self.engine.sched.running.values():
                if run.req.rid != rid:
                    continue
                if run.group is None:
                    plain = run
                    break
                if primary is None or run.branch < primary.branch:
                    primary = run
            src = plain if plain is not None else primary
            toks = list(src.generated) if src is not None else []
            self._pending = [r for r in self._pending if r.rid != rid]
            self.engine.cancel(rid)
            self._finish(st, FinishedRequest(
                rid=rid, prompt=st.req.prompt, tokens=toks,
                reason="cancelled"))

    def _apply_submissions(self) -> None:
        while self._pending:
            req = self._pending.pop(0)
            st = self._streams[req.rid]
            try:
                self.engine.submit(req)
            except InvalidRequestError as e:
                # Client misuse: raise it out of the client's generator.
                st.done = True
                del self._streams[req.rid]
                self._force_put(st, e)
            except ValueError:
                # Resource rejection (prompt/width over capacity) -
                # mirrors ServingEngine.run's per-request rejection.
                self._finish(st, self.engine.reject(req))

    def _publish(self, finished: list[FinishedRequest]) -> None:
        for fr in finished:
            st = self._streams.get(fr.rid)
            if st is None or st.done:
                continue
            for tok in fr.tokens[st.sent:]:
                if not self._offer(st, tok):
                    # Finished burst into a stalled reader: drop the
                    # remainder - the full token list rides the _End
                    # payload; the engine holds nothing for this
                    # request anymore.
                    self.engine.stats["stream_overflows"] += 1
                    break
            st.sent = len(fr.tokens)
            self._finish(st, fr)
        # Incremental: publish each live plain request's new tokens.
        for run in self.engine.sched.running.values():
            st = self._streams.get(run.req.rid)
            if st is None or st.done or run.group is not None:
                continue
            for tok in run.generated[st.sent:]:
                if not self._offer(st, tok):
                    # The reader stalled for a full stream_buffer of
                    # tokens while the request still holds slot+pages:
                    # presume it disconnected and cancel (the cancel
                    # snapshot keeps everything generated so far).
                    self.engine.stats["stream_overflows"] += 1
                    self._request_cancel(run.req.rid)
                    break
                st.sent += 1

    def _offer(self, st: _Stream, item) -> bool:
        """put_nowait that reports overflow instead of raising."""
        try:
            st.queue.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    @staticmethod
    def _force_put(st: _Stream, item) -> None:
        """Deliver a terminal item (an _End or an exception) even to a
        full queue by dropping the oldest buffered tokens."""
        while True:
            try:
                st.queue.put_nowait(item)
                return
            except asyncio.QueueFull:
                try:
                    st.queue.get_nowait()
                except asyncio.QueueEmpty:
                    pass

    def _finish(self, st: _Stream, fr: FinishedRequest) -> None:
        st.done = True
        self.results[fr.rid] = fr
        while len(self.results) > self.max_results > 0:
            self.results.popitem(last=False)
            self.engine.stats["results_evicted"] += 1
        del self._streams[fr.rid]
        self._force_put(st, _End(fr))
