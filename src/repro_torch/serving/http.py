"""Dependency-free HTTP/1.1 + SSE transport over :class:`AsyncFrontend`.

The wire layer of the serving stack: a raw-``asyncio`` server (no
aiohttp/fastapi - the container is stdlib-only) that turns the
in-process token streams of :mod:`repro_torch.serving.frontend` into
Server-Sent Events over a real socket.

Endpoints (one request per connection; every response carries
``connection: close``):

  * ``POST /v1/generate`` - JSON body mapped to a
    :class:`repro_torch.serving.scheduler.Request` (prompt, budget, sampling,
    n/best_of/beam, logprobs, latency_class; see
    :func:`request_from_json`).  Response is an SSE stream: one
    ``data: {"index": i, "token": t}`` event per generated token and a
    terminal ``event: done`` whose data is the full FinishedRequest
    payload (tokens, reason, ttft, completions, logprobs).  With
    ``"stream": false`` the terminal payload comes back as one JSON
    response instead.
  * ``GET /healthz`` - 200 while serving, 503 once the frontend failed
    or closed.
  * ``GET /stats`` - engine counters, pool occupancy, per-class queue
    depths and caps, HTTP counters.

Flow control and failure mapping:

  * bounded admission: per-latency-class queue-depth caps; a class at
    its cap answers 429 (with ``retry-after``) without touching
    in-flight streams.  Engine down (frontend failed/closed) answers
    503.
  * multi-tenant fairness: the ``x-tenant`` request header lands in
    ``Request.tenant``; the scheduler round-robins waiting requests of
    the same latency class across tenants (see
    ``Scheduler._waiting_key``).
  * disconnect-driven cancellation: a watcher task reads the socket for
    EOF; a client that goes away mid-stream cancels the request through
    the generator's existing cancel-intent path, so slot and pages come
    back refcount-clean.  A reader that stalls (TCP backpressure) first
    hits the frontend's bounded per-stream queue (cancel-on-overflow),
    then the connection's ``drain_timeout``.
  * client misuse maps to 400 (malformed JSON, unknown fields, bad
    types, contradictory knobs, prompt/width over the engine's
    ceilings); an unroutable path to 404.

The module also ships the matching stdlib client
(:func:`stream_generate`, :func:`http_json`) used by the ``serve_http
--smoke`` gate, the ``serving_stack`` phase of ``chip_smoke.py`` and the
socket tests.  Every payload is plain Python ints, floats and strings,
so ``json.dumps`` takes it.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import socket

from repro_torch.serving.frontend import AsyncFrontend
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import (LATENCY_CLASSES, FinishedRequest,
                                     InvalidRequestError, Request)

TENANT_HEADER = "x-tenant"

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}

_SAMPLING_FIELDS = ("temperature", "top_k", "top_p",
                    "repetition_penalty", "seed")
_REQUEST_FIELDS = frozenset({
    "prompt", "max_new_tokens", "eos_id", "latency_class", "n",
    "best_of", "beam_width", "length_penalty", "beam_early_stop",
    "logprobs", "stream", "id", *_SAMPLING_FIELDS})


class HttpError(Exception):
    """A client-visible HTTP failure (status + JSON error message)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def request_from_json(spec: dict, *, rid: int, tenant: str = "",
                      engine=None) -> Request:
    """Validate a ``POST /v1/generate`` JSON body into a
    :class:`Request`; raises :class:`HttpError` (400) on misuse.  With
    ``engine``, the engine's resource ceilings (per-sequence token
    allowance, group width vs max_batch, vocab range) are checked at
    the door too - submitting past them would only stream back
    ``reason="rejected"``."""
    if not isinstance(spec, dict):
        raise HttpError(400, "body must be a JSON object")
    unknown = sorted(set(spec) - _REQUEST_FIELDS)
    if unknown:
        raise HttpError(400, f"unknown fields: {unknown}")

    def _int(name, default, lo=None):
        v = spec.get(name, default)
        if isinstance(v, bool) or not isinstance(v, int) or \
                (lo is not None and v < lo):
            bound = f" >= {lo}" if lo is not None else ""
            raise HttpError(400, f"{name} must be an int{bound}")
        return v

    def _num(name, default):
        v = spec.get(name, default)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise HttpError(400, f"{name} must be a number")
        return float(v)

    def _bool(name, default):
        v = spec.get(name, default)
        if not isinstance(v, bool):
            raise HttpError(400, f"{name} must be a boolean")
        return v

    prompt = spec.get("prompt")
    if not isinstance(prompt, list) or not prompt or not all(
            isinstance(t, int) and not isinstance(t, bool) and t >= 0
            for t in prompt):
        raise HttpError(400, "prompt must be a non-empty list of "
                             "non-negative token ids")
    cls_name = spec.get("latency_class", "standard")
    if cls_name not in LATENCY_CLASSES:
        raise HttpError(400, f"unknown latency_class {cls_name!r} "
                             f"(have {sorted(LATENCY_CLASSES)})")
    eos = spec.get("eos_id")
    if eos is not None and (isinstance(eos, bool)
                            or not isinstance(eos, int)):
        raise HttpError(400, "eos_id must be an int or null")
    sampling = None
    if any(f in spec for f in _SAMPLING_FIELDS):
        try:
            sampling = SamplingParams(
                temperature=_num("temperature", 0.0),
                top_k=_int("top_k", 0, lo=0),
                top_p=_num("top_p", 1.0),
                repetition_penalty=_num("repetition_penalty", 1.0),
                seed=_int("seed", 0))
        except AssertionError as e:
            raise HttpError(400, f"bad sampling params: {e}") from e
    best_of = None
    if spec.get("best_of") is not None:
        best_of = _int("best_of", 1, lo=1)
    req = Request(
        rid=rid, prompt=list(prompt),
        max_new_tokens=_int("max_new_tokens", 16, lo=1),
        eos_id=eos, sampling=sampling,
        latency_class=LATENCY_CLASSES[cls_name],
        n=_int("n", 1, lo=1), best_of=best_of,
        beam_width=_int("beam_width", 0, lo=0),
        length_penalty=_num("length_penalty", 1.0),
        logprobs=_bool("logprobs", False),
        beam_early_stop=_bool("beam_early_stop", True),
        tenant=tenant)
    if engine is not None:
        limit = engine.pages_per_seq * engine.page_size
        need = len(req.prompt) + req.max_new_tokens
        if need > limit:
            raise HttpError(400, f"prompt+budget {need} exceeds the "
                                 f"per-sequence ceiling {limit}")
        width = req.beam_width if req.beam_width > 0 else \
            (req.best_of if req.best_of is not None else req.n)
        if width > engine.max_batch:
            raise HttpError(400, f"group width {width} exceeds "
                                 f"max_batch {engine.max_batch}")
        vocab = engine.model.cfg.vocab_size
        if any(t >= vocab for t in req.prompt):
            raise HttpError(400, f"prompt token id out of range "
                                 f"(vocab_size {vocab})")
    return req


def _ints(xs) -> list[int]:
    return [int(x) for x in xs]


def _floats(xs):
    """Plain floats (None kept), or None: numpy and torch scalars are
    not JSON."""
    return None if xs is None else \
        [None if x is None else float(x) for x in xs]


def finished_payload(fr: FinishedRequest, tag=None) -> dict:
    """The ``event: done`` data: a JSON-safe FinishedRequest (plain
    Python ints and floats).  ``tag`` echoes the request's client-chosen
    ``id`` field."""
    d = {"rid": int(fr.rid), "tokens": _ints(fr.tokens),
         "reason": fr.reason, "preemptions": int(fr.preemptions),
         "ttft": None if fr.ttft is None else float(fr.ttft)}
    if tag is not None:
        d["id"] = tag
    if fr.completions is not None:
        d["completions"] = [
            {"tokens": _ints(c.tokens), "branch": int(c.branch),
             "reason": c.reason, "score": float(c.score),
             "token_logprobs": _floats(c.token_logprobs)}
            for c in fr.completions]
    if fr.prompt_logprobs is not None:
        d["prompt_logprobs"] = _floats(fr.prompt_logprobs)
    if fr.token_logprobs is not None:
        d["token_logprobs"] = _floats(fr.token_logprobs)
    return d


class HttpServer:
    """The asyncio HTTP/1.1 + SSE server over one AsyncFrontend.

    ``queue_caps``: per-class admission bound on not-yet-running
    requests - an int applies to every class, a {class: cap} dict
    overrides per class, None defaults to ``4 * engine.max_batch``.
    Depth at/over the cap answers 429 (cap 0 = admit nothing).

    ``drain_timeout``: per-write bound on how long a client may stall
    the socket before the connection is treated as dead.  ``sndbuf``
    (socket send-buffer bytes) and ``event_pad`` (an SSE comment of
    that many bytes after each event - the classic anti-buffering
    padding for proxies) are serving knobs the slow-reader tests also
    lean on to exercise TCP backpressure at test scale.

    The server does not own the frontend: ``stop()`` closes the
    listener and aborts live connections, the caller closes the
    frontend."""

    def __init__(self, frontend: AsyncFrontend, *,
                 host: str = "127.0.0.1", port: int = 0,
                 queue_caps: int | dict | None = None,
                 tenant_header: str = TENANT_HEADER,
                 drain_timeout: float = 30.0,
                 max_body: int = 1 << 20,
                 event_pad: int = 0, sndbuf: int | None = None):
        self.frontend = frontend
        self.host = host
        self.port = port
        self.tenant_header = tenant_header.lower()
        self.drain_timeout = drain_timeout
        self.max_body = max_body
        self.event_pad = event_pad
        self.sndbuf = sndbuf
        self.queue_caps = self._resolve_caps(queue_caps)
        self.http_stats = {"requests": 0, "streams": 0,
                           "rejected_429": 0, "unavailable_503": 0,
                           "bad_request_400": 0, "disconnects": 0,
                           "open_connections": 0}
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.Task] = set()
        self._next_rid = 0

    def _resolve_caps(self, caps) -> dict[str, int]:
        default = 4 * self.frontend.engine.max_batch
        if caps is None:
            caps = default
        if isinstance(caps, int):
            return {name: caps for name in LATENCY_CLASSES}
        out = {name: default for name in LATENCY_CLASSES}
        for name, v in caps.items():
            if name not in LATENCY_CLASSES:
                raise ValueError(f"unknown latency class {name!r} "
                                 f"(have {sorted(LATENCY_CLASSES)})")
            out[name] = int(v)
        return out

    # ---------------------------------------------------------- lifecycle
    async def start(self) -> "HttpServer":
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        # Learn the kernel-assigned port when started with port 0.
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        """Close the listener and abort live connections (aborted
        streams cancel their requests through the generator cleanup)."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for task in list(self._conns):
            task.cancel()
        for task in list(self._conns):
            with contextlib.suppress(BaseException):
                await task
        self._conns.clear()

    # --------------------------------------------------------- connection
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        self.http_stats["open_connections"] += 1
        if self.sndbuf:
            sock = writer.get_extra_info("socket")
            if sock is not None:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self.sndbuf)
            # Keep asyncio's own write buffer out of the picture so
            # drain() reflects what the kernel (and the client) accept.
            writer.transport.set_write_buffer_limits(high=0)
        try:
            parsed = await self._read_request(reader)
            if parsed is None:
                return
            method, path, headers, body = parsed
            self.http_stats["requests"] += 1
            if method == "GET" and path == "/healthz":
                status, payload = self._healthz()
                await self._respond_json(writer, status, payload)
            elif method == "GET" and path == "/stats":
                await self._respond_json(writer, 200,
                                         self._stats_payload())
            elif method == "POST" and path == "/v1/generate":
                await self._generate(reader, writer, headers, body)
            else:
                await self._respond_json(
                    writer, 404, {"error": f"no route {method} {path}"})
        except asyncio.CancelledError:
            raise
        except HttpError as e:
            self.http_stats["bad_request_400"] += 1
            with contextlib.suppress(Exception):
                await self._respond_json(writer, e.status,
                                         {"error": e.message})
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            self.http_stats["disconnects"] += 1
        except Exception as e:   # noqa: BLE001 - keep the server alive
            with contextlib.suppress(Exception):
                await self._respond_json(writer, 500, {"error": repr(e)})
        finally:
            self.http_stats["open_connections"] -= 1
            self._conns.discard(task)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _read_request(self, reader):
        """(method, path, headers, body) | None on immediate EOF."""
        try:
            line = await reader.readline()
        except (ConnectionResetError, ValueError):
            return None
        if not line.strip():
            return None
        parts = line.decode("latin-1").split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise HttpError(400, "malformed request line")
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or 0)
        if length > self.max_body:
            raise HttpError(413, f"body over {self.max_body} bytes")
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    # ------------------------------------------------------------- routes
    def _healthz(self) -> tuple[int, dict]:
        fe = self.frontend
        if fe.failed:
            return 503, {"status": "failed"}
        if fe.closed:
            return 503, {"status": "closed"}
        return 200, {"status": "ok", "steps": fe.engine.stats["steps"]}

    def _stats_payload(self) -> dict:
        fe = self.frontend
        eng = fe.engine
        return {"engine": dict(eng.stats),
                "pool": {"num_pages": eng.cache.num_pages,
                         "free_pages": eng.cache.available_page_count,
                         "free_slots": eng.cache.free_slot_count},
                "queues": {name: fe.queue_depth(name)
                           for name in LATENCY_CLASSES},
                "caps": dict(self.queue_caps),
                "http": dict(self.http_stats)}

    async def _generate(self, reader, writer, headers, body) -> None:
        fe = self.frontend
        if fe.failed or fe.closed:
            self.http_stats["unavailable_503"] += 1
            await self._respond_json(writer, 503,
                                     {"error": "engine unavailable"})
            return
        try:
            spec = json.loads(body.decode("utf-8")) if body else None
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise HttpError(400, f"bad JSON body: {e}") from e
        tenant = headers.get(self.tenant_header, "")
        rid = self._next_rid
        self._next_rid += 1
        req = request_from_json(spec, rid=rid, tenant=tenant,
                                engine=fe.engine)
        cls = req.latency_class.name
        cap = self.queue_caps.get(cls)
        if cap is not None and fe.queue_depth(cls) >= cap:
            self.http_stats["rejected_429"] += 1
            await self._respond_json(
                writer, 429,
                {"error": f"queue full for class {cls!r}",
                 "class": cls, "cap": cap},
                extra=("retry-after: 1",))
            return
        try:
            gen = fe.submit(req)
        except RuntimeError as e:       # failed/closed raced the check
            self.http_stats["unavailable_503"] += 1
            await self._respond_json(writer, 503, {"error": str(e)})
            return
        self.http_stats["streams"] += 1
        eof = asyncio.ensure_future(self._watch_eof(reader))
        pump = asyncio.ensure_future(self._pump(
            gen, writer, rid, spec.get("id"), spec.get("stream", True)))
        try:
            await asyncio.wait({eof, pump},
                               return_when=asyncio.FIRST_COMPLETED)
            if not pump.done():
                # Socket EOF/reset while the stream is live: the
                # cleanup below closes the generator, whose finally
                # files the cancel intent - slot and pages come back
                # refcount-clean on the next drive iteration.
                self.http_stats["disconnects"] += 1
            else:
                pump.result()        # re-raise HttpError / reset
        finally:
            for t in (pump, eof):
                if not t.done():
                    t.cancel()
            with contextlib.suppress(BaseException):
                await pump
            with contextlib.suppress(BaseException):
                await eof
            with contextlib.suppress(BaseException):
                await gen.aclose()

    @staticmethod
    async def _watch_eof(reader) -> None:
        """Resolve when the client half-closes or resets: the client
        sends nothing after the request body, so any read completing
        means the connection is gone."""
        with contextlib.suppress(Exception):
            while await reader.read(4096):
                pass

    async def _pump(self, gen, writer, rid: int, tag, stream: bool):
        """Consume the token generator into SSE frames (or one JSON
        response for ``stream=false``)."""
        toks = []
        started = False
        try:
            async for tok in gen:
                if stream:
                    if not started:
                        self._write_head(writer, 200,
                                         "text/event-stream")
                        started = True
                    self._write_event(writer, None,
                                      {"index": len(toks),
                                       "token": int(tok)})
                    await self._drain(writer)
                toks.append(tok)
        except InvalidRequestError as e:
            if started:
                raise            # headers already sent; drop the stream
            raise HttpError(400, str(e)) from e
        fr = self.frontend.result(rid)
        payload = finished_payload(fr, tag) if fr is not None else \
            {"rid": rid, "tokens": toks, "reason": "unknown"}
        if not stream:
            await self._respond_json(writer, 200, payload)
            return
        if not started:
            self._write_head(writer, 200, "text/event-stream")
        self._write_event(writer, "done", payload)
        await self._drain(writer)

    # -------------------------------------------------------- wire format
    def _write_head(self, writer, status: int, ctype: str, *,
                    length: int | None = None, extra=()) -> None:
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
                 f"content-type: {ctype}", "cache-control: no-store",
                 "connection: close"]
        if length is not None:
            lines.append(f"content-length: {length}")
        lines.extend(extra)
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

    def _write_event(self, writer, event: str | None, data: dict) -> None:
        buf = []
        if event:
            buf.append(f"event: {event}\n")
        buf.append(f"data: {json.dumps(data)}\n")
        if self.event_pad:
            buf.append(":" + " " * self.event_pad + "\n")
        buf.append("\n")
        writer.write("".join(buf).encode("utf-8"))

    async def _respond_json(self, writer, status: int, payload: dict,
                            extra=()) -> None:
        body = (json.dumps(payload, sort_keys=True) + "\n").encode()
        self._write_head(writer, status, "application/json",
                         length=len(body), extra=extra)
        writer.write(body)
        await self._drain(writer)

    async def _drain(self, writer) -> None:
        try:
            await asyncio.wait_for(writer.drain(), self.drain_timeout)
        except asyncio.TimeoutError:
            raise ConnectionResetError(
                f"client stalled past drain_timeout "
                f"({self.drain_timeout}s)") from None


# ------------------------------------------------------------ client side
async def http_json(host: str, port: int, method: str, path: str,
                    payload: dict | None = None,
                    headers=()) -> tuple[int, dict]:
    """One-shot JSON request; returns (status, decoded body)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = b"" if payload is None else json.dumps(payload).encode()
        lines = [f"{method} {path} HTTP/1.1", f"host: {host}",
                 "connection: close", f"content-length: {len(body)}"]
        if body:
            lines.append("content-type: application/json")
        lines.extend(headers)
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
        await writer.drain()
        status, hdrs = await _read_head(reader)
        raw = await _read_plain_body(reader, hdrs)
        return status, (json.loads(raw) if raw else {})
    finally:
        writer.close()
        with contextlib.suppress(Exception):
            await writer.wait_closed()


async def stream_generate(host: str, port: int, payload: dict, *,
                          tenant: str | None = None):
    """POST /v1/generate and decode the response into an async stream
    of ``("token", {...})`` events followed by one ``("done", {...})``
    - or a single ``("error", {"status": ..., "body": ...})`` for a
    non-2xx answer.  Closing the generator mid-stream closes the
    socket, which the server treats as a client disconnect (the
    request is cancelled, freeing its slot/pages)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps(payload).encode()
        lines = ["POST /v1/generate HTTP/1.1", f"host: {host}",
                 "connection: close", "content-type: application/json",
                 f"content-length: {len(body)}"]
        if tenant:
            lines.append(f"{TENANT_HEADER}: {tenant}")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
        await writer.drain()
        status, hdrs = await _read_head(reader)
        if status != 200 or "text/event-stream" not in \
                hdrs.get("content-type", ""):
            raw = await _read_plain_body(reader, hdrs)
            data = json.loads(raw) if raw else {}
            if status == 200:
                yield "done", data       # "stream": false JSON answer
            else:
                yield "error", {"status": status, "body": data}
            return
        async for event, data in _read_sse(reader):
            if event == "done":
                yield "done", data
                return
            yield "token", data
    finally:
        writer.close()
        with contextlib.suppress(Exception):
            await writer.wait_closed()


async def _read_head(reader) -> tuple[int, dict]:
    line = await reader.readline()
    parts = line.decode("latin-1").split(None, 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/"):
        raise ConnectionError(f"malformed status line: {line!r}")
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    return int(parts[1]), headers


async def _read_plain_body(reader, headers) -> bytes:
    n = headers.get("content-length")
    if n is not None:
        return await reader.readexactly(int(n))
    return await reader.read()           # connection: close delimits


async def _read_sse(reader):
    """Decode SSE frames into (event_name, json_data) pairs; comment
    (padding) lines are skipped per the spec."""
    event, data = None, []
    while True:
        line = await reader.readline()
        if not line:
            return                       # connection closed
        text = line.rstrip(b"\r\n").decode("utf-8")
        if not text:
            if data:
                yield (event or "message"), json.loads("\n".join(data))
            event, data = None, []
            continue
        if text.startswith(":"):
            continue
        name, _, value = text.partition(":")
        if value.startswith(" "):
            value = value[1:]
        if name == "event":
            event = value
        elif name == "data":
            data.append(value)
