"""The port's HTTP/SSE transport against the reference's, over loopback
sockets: the scenarios of ``tests/test_http.py``, each run on the
reference's ``HttpServer`` over its engine and on the port's over the
port's (reduced qwen3-1.7b, converted weights, the port on the CPU),
with each package's own stdlib client.  Token ids are equal, logprobs
within ``LP_TOL``, statuses and payload keys the same.

Every scenario also holds its own package to the reference test's
claims: SSE streams equal ``ServingEngine.run`` (greedy and seeded
sampled), ``"stream": false`` answers one JSON payload, a group's done
payload carries every completion, ``/healthz`` / ``/stats`` / 404, a
class at its cap answers 429 without touching in-flight streams, a
closed frontend 503, misuse 400 at the door or from the engine, tenants
round-robin within a class, a disconnect cancels the request, a stalled
reader trips the bounded stream queue; the pools come back clean.
"""
import asyncio
import contextlib
import json
import socket

import pytest

from test_torch_engine_common import (LP_TOL, one_torch_thread,  # noqa: F401
                                      pool_clean, prompt, stack)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _keys(d):
    """The nested key structure of a JSON payload (values dropped)."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list) and d and isinstance(d[0], dict):
        return [_keys(d[0])]
    return None


async def _collect(ns, server, payload, tenant=None):
    toks, done, errors = [], None, []
    async for kind, data in ns.http.stream_generate(
            server.host, server.port, payload, tenant=tenant):
        if kind == "token":
            assert data["index"] == len(toks)
            toks.append(data["token"])
        elif kind == "done":
            done = data
        else:
            errors.append(data)
    return toks, done, errors


# ------------------------------------------------------------ scenarios
def request_validation(ns):
    """``request_from_json``: the same requests and the same 400s."""
    rfj, HttpError = ns.http.request_from_json, ns.HttpError
    ok = rfj({"prompt": [1, 2], "max_new_tokens": 4}, rid=7, tenant="alice")
    assert ok.rid == 7 and ok.tenant == "alice" and ok.sampling is None
    sp = rfj({"prompt": [1], "temperature": 0.5, "seed": 3}, rid=0)
    assert sp.sampling is not None and sp.sampling.seed == 3
    out = [(ok.prompt, ok.max_new_tokens, ok.latency_class.name),
           (sp.sampling.temperature, sp.sampling.seed)]
    eng = ns.engine()
    for bad, engine in (([1, 2], None), ({"prompt": []}, None),
                        ({"prompt": "hi"}, None), ({"prompt": [1, -2]}, None),
                        ({"prompt": [1, True]}, None),
                        ({"prompt": [1], "latency_class": "warp"}, None),
                        ({"prompt": [1], "max_new_tokens": 0}, None),
                        ({"prompt": [1], "frobnicate": 1}, None),
                        ({"prompt": [1], "temperature": "hot"}, None),
                        ({"prompt": [1], "top_k": -1}, None),
                        ({"prompt": [1], "logprobs": 1}, None),
                        ({"prompt": [1], "max_new_tokens": 4096}, eng),
                        ({"prompt": [1], "n": 5}, eng),
                        ({"prompt": [ns.vocab]}, eng)):
        with pytest.raises(HttpError) as ei:
            rfj(bad, rid=0, engine=engine)
        assert ei.value.status == 400
        out.append(ei.value.message)
    return out


async def sse_parity(ns):
    reqs = [ns.Request(rid=i, prompt=prompt(ns.vocab, 20 + i, 3 + i),
                       max_new_tokens=6 + i) for i in range(3)]
    gold = {f.rid: f.tokens for f in ns.engine().run([(0, r) for r in reqs])}
    fe = ns.AsyncFrontend(ns.engine())
    server = await ns.HttpServer(fe).start()
    out = await asyncio.gather(*(_collect(
        ns, server, {"prompt": r.prompt, "max_new_tokens": r.max_new_tokens,
                     "id": r.rid}) for r in reqs))
    await server.stop()
    await fe.close()
    res = {}
    for r, (toks, done, errors) in zip(reqs, out):
        assert not errors and toks == gold[r.rid] == done["tokens"]
        assert done["id"] == r.rid and done["reason"] in ("stop", "length")
        assert done["ttft"] is not None
        res[r.rid] = (toks, done["reason"], _keys(done))
    pool_clean(fe.engine)
    return res


async def sse_sampled_logprobs(ns):
    """A seeded sampled stream with logprobs over the wire: the engine's
    tokens; its logprobs are compared across packages by the caller."""
    req = ns.Request(rid=0, prompt=prompt(ns.vocab, 33, 5), max_new_tokens=6,
                     sampling=ns.SamplingParams(temperature=0.8, top_k=8,
                                                seed=11), logprobs=True)
    gold = ns.engine().run([(0, req)])[0]
    fe = ns.AsyncFrontend(ns.engine())
    server = await ns.HttpServer(fe).start()
    toks, done, errors = await _collect(
        ns, server, {"prompt": req.prompt, "max_new_tokens": 6,
                     "temperature": 0.8, "top_k": 8, "seed": 11,
                     "logprobs": True}, tenant="alice")
    await server.stop()
    await fe.close()
    assert not errors and toks == gold.tokens == done["tokens"]
    pool_clean(fe.engine)
    return {"tokens": toks, "keys": _keys(done),
            "lps": (done["token_logprobs"], done["prompt_logprobs"])}


async def stream_false(ns):
    req = ns.Request(rid=0, prompt=prompt(ns.vocab, 25, 4), max_new_tokens=5)
    gold = ns.engine().run([(0, req)])[0].tokens
    fe = ns.AsyncFrontend(ns.engine())
    server = await ns.HttpServer(fe).start()
    events = [ev async for ev in ns.http.stream_generate(
        server.host, server.port,
        {"prompt": req.prompt, "max_new_tokens": 5, "stream": False})]
    await server.stop()
    await fe.close()
    (kind, data), = events
    assert kind == "done" and data["tokens"] == gold
    pool_clean(fe.engine)
    return data["tokens"], data["reason"], _keys(data)


async def group_completions(ns):
    fe = ns.AsyncFrontend(ns.engine(max_batch=6))
    server = await ns.HttpServer(fe).start()
    toks, done, errors = await _collect(
        ns, server, {"prompt": prompt(ns.vocab, 31, 5), "max_new_tokens": 5,
                     "temperature": 0.8, "top_k": 8, "seed": 7, "n": 3})
    await server.stop()
    await fe.close()
    assert not errors and len(done["completions"]) == 3
    assert toks == done["tokens"] == done["completions"][0]["tokens"]
    pool_clean(fe.engine)
    comps = [(c["tokens"], c["branch"], c["reason"])
             for c in done["completions"]]
    return comps, [c["score"] for c in done["completions"]], _keys(done)


async def healthz_stats_404(ns):
    fe = ns.AsyncFrontend(ns.engine())
    server = await ns.HttpServer(fe).start()
    host, port = server.host, server.port
    status, health = await ns.http.http_json(host, port, "GET", "/healthz")
    assert status == 200 and health["status"] == "ok"
    status404, _ = await ns.http.http_json(host, port, "GET", "/nope")
    await _collect(ns, server, {"prompt": prompt(ns.vocab, 26, 3),
                                "max_new_tokens": 2})
    status, st = await ns.http.http_json(host, port, "GET", "/stats")
    assert status == 200 and st["engine"]["steps"] > 0
    assert st["http"]["streams"] == 1 and set(st["queues"]) == set(st["caps"])
    assert st["pool"]["free_pages"] == st["pool"]["num_pages"]
    await server.stop()
    await fe.close()
    pool_clean(fe.engine)
    return (status404, sorted(health), _keys(st),
            {k: st[k] for k in ("pool", "queues", "caps", "http")})


async def queue_cap_429(ns):
    fe = ns.AsyncFrontend(ns.engine(max_batch=1))
    server = await ns.HttpServer(fe, queue_caps={"standard": 1}).start()

    def client(tag, ntok):
        return asyncio.ensure_future(_collect(
            ns, server, {"prompt": prompt(ns.vocab, 100 + tag, 4),
                         "max_new_tokens": ntok, "id": tag}))

    a = client(0, 24)
    while not fe.engine.sched.running:          # A holds the one slot
        await asyncio.sleep(0.005)
    b = client(1, 4)
    while fe.queue_depth("standard") < 1:       # B parked in waiting
        await asyncio.sleep(0.005)
    events = [ev async for ev in ns.http.stream_generate(
        server.host, server.port,
        {"prompt": prompt(ns.vocab, 102, 4), "max_new_tokens": 4})]
    (kind, data), = events
    assert kind == "error" and data["status"] == 429
    assert data["body"]["class"] == "standard"
    toks_a, done_a, _ = await a
    toks_b, done_b, _ = await b
    assert toks_a and done_a["tokens"] == toks_a
    assert toks_b and done_b["tokens"] == toks_b
    assert server.http_stats["rejected_429"] == 1
    await server.stop()
    await fe.close()
    pool_clean(fe.engine)
    return data, toks_a, toks_b


async def engine_down_503(ns):
    fe = ns.AsyncFrontend(ns.engine())
    server = await ns.HttpServer(fe).start()
    await fe.close()
    status, health = await ns.http.http_json(server.host, server.port,
                                             "GET", "/healthz")
    events = [ev async for ev in ns.http.stream_generate(
        server.host, server.port, {"prompt": [1, 2], "max_new_tokens": 2})]
    await server.stop()
    assert status == 503 and health["status"] == "closed"
    (kind, data), = events
    assert kind == "error" and data["status"] == 503
    assert server.http_stats["unavailable_503"] == 1
    return status, health, data


async def bad_request_400(ns):
    fe = ns.AsyncFrontend(ns.engine())
    server = await ns.HttpServer(fe).start()
    answers = []
    for payload in ({"prompt": [1], "bogus": 1},
                    {"prompt": prompt(ns.vocab, 27, 4),
                     "max_new_tokens": 4096},
                    {"prompt": prompt(ns.vocab, 28, 4), "max_new_tokens": 4,
                     "n": 4, "best_of": 2}):
        events = [ev async for ev in ns.http.stream_generate(
            server.host, server.port, payload)]
        (kind, data), = events
        answers.append((kind, data))
    assert server.http_stats["bad_request_400"] == 3
    await server.stop()
    await fe.close()
    assert [(k, d["status"]) for k, d in answers] == [("error", 400)] * 3
    pool_clean(fe.engine)
    return answers


async def tenant_fairness(ns):
    fe = ns.AsyncFrontend(ns.engine(max_batch=1))
    server = await ns.HttpServer(fe).start()
    order = []

    async def run_client(tag, tenant, ntok):
        _, done, _ = await _collect(
            ns, server, {"prompt": prompt(ns.vocab, 120 + ntok, 4),
                         "max_new_tokens": ntok, "id": tag}, tenant=tenant)
        assert done is not None and done["id"] == tag
        order.append(tag)

    tasks = [asyncio.ensure_future(run_client("A1", "alice", 24))]
    while not fe.engine.sched.running:
        await asyncio.sleep(0.005)
    for depth, tag in enumerate(("A2", "A3"), start=1):
        tasks.append(asyncio.ensure_future(run_client(tag, "alice", 6)))
        while fe.queue_depth("standard") < depth:
            await asyncio.sleep(0.005)
    tasks.append(asyncio.ensure_future(run_client("B1", "bob", 6)))
    while fe.queue_depth("standard") < 3:
        await asyncio.sleep(0.005)
    await asyncio.gather(*tasks)
    await server.stop()
    await fe.close()
    assert order == ["A1", "B1", "A2", "A3"]
    pool_clean(fe.engine)
    return order


async def disconnect_cancels(ns):
    req = ns.Request(rid=0, prompt=prompt(ns.vocab, 130, 5), max_new_tokens=48)
    full = ns.engine().run([(0, req)])[0].tokens
    fe = ns.AsyncFrontend(ns.engine())
    server = await ns.HttpServer(fe).start()
    gen = ns.http.stream_generate(server.host, server.port,
                                  {"prompt": req.prompt, "max_new_tokens": 48})
    got = []
    async for kind, data in gen:
        if kind == "token":
            got.append(data["token"])
            if len(got) >= 2:
                break
    await gen.aclose()                      # socket closed mid-stream
    for _ in range(1000):
        if fe.engine.stats["cancelled"] >= 1:
            break
        await asyncio.sleep(0.005)
    await fe.drain()
    assert server.http_stats["disconnects"] >= 1
    await server.stop()
    await fe.close()
    fr = fe.result(0)
    assert fe.engine.stats["cancelled"] == 1 and fr.reason == "cancelled"
    assert fr.tokens == full[:len(fr.tokens)] and got == full[:2]
    pool_clean(fe.engine)
    return got, full, fr.reason


async def slow_reader(ns):
    eng = ns.engine(max_seq=128)
    fe = ns.AsyncFrontend(eng, stream_buffer=4)
    server = await ns.HttpServer(fe, event_pad=2048, sndbuf=4608,
                                 drain_timeout=1.0).start()
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    sock.setblocking(False)
    await asyncio.get_running_loop().sock_connect(sock,
                                                  (server.host, server.port))
    _, writer = await asyncio.open_connection(sock=sock)
    body = json.dumps({"prompt": prompt(ns.vocab, 140, 4),
                       "max_new_tokens": 96}).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\nhost: t\r\n"
                  f"content-length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    for _ in range(2000):                   # ... and never read a byte
        if eng.stats["stream_overflows"] >= 1:
            break
        await asyncio.sleep(0.005)
    assert eng.stats["stream_overflows"] >= 1
    writer.close()
    with contextlib.suppress(Exception):
        await writer.wait_closed()
    await fe.drain()
    await server.stop()
    await fe.close()
    fr = fe.result(0)
    assert eng.stats["cancelled"] >= 1 and fr.reason == "cancelled"
    assert len(fr.tokens) < 96
    pool_clean(eng)
    return fr.reason


SCENARIOS = {f.__name__: f for f in (
    request_validation, sse_parity, sse_sampled_logprobs, stream_false,
    group_completions, healthz_stats_404, queue_cap_429, engine_down_503,
    bad_request_400, tenant_fairness, disconnect_cancels, slow_reader)}


def _run(fn, ns):
    out = fn(ns)
    return asyncio.run(out) if asyncio.iscoroutine(out) else out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_http_scenario_matches_the_reference(name):
    """The scenario against the reference's server and against the
    port's: the same tokens, statuses, payload keys and counters;
    logprobs and beam scores within LP_TOL."""
    want = _run(SCENARIOS[name], stack("ref"))
    got = _run(SCENARIOS[name], stack("port"))
    if name == "sse_sampled_logprobs":
        for g, w in zip(got.pop("lps"), want.pop("lps")):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert (a is None) == (b is None)
                assert a is None or abs(a - b) <= LP_TOL["fa2"]
    elif name == "group_completions":
        got, gs = got[::2], got[1]
        want, ws = want[::2], want[1]
        assert all(abs(a - b) <= LP_TOL["fa2"] for a, b in zip(gs, ws))
    assert got == want


def test_payloads_are_plain_json():
    """``finished_payload`` turns numpy and torch scalars into plain ints
    and floats, so ``json.dumps`` takes it."""
    import numpy as np
    import torch
    from repro_torch.serving.http import finished_payload
    from repro_torch.serving.scheduler import Completion, FinishedRequest
    fr = FinishedRequest(
        rid=np.int64(3), prompt=[1], tokens=[np.int64(5), torch.tensor(6)],
        reason="length", preemptions=np.int32(0), ttft=np.float32(0.5),
        completions=[Completion(tokens=[np.int32(5)], branch=np.int64(0),
                                reason="length", score=np.float32(-1.5),
                                token_logprobs=[np.float32(-0.25)])],
        prompt_logprobs=[None, torch.tensor(-2.0)],
        token_logprobs=[np.float64(-0.25)])
    d = json.loads(json.dumps(finished_payload(fr, tag="x")))
    assert d == {"rid": 3, "tokens": [5, 6], "reason": "length",
                 "preemptions": 0, "ttft": 0.5, "id": "x",
                 "completions": [{"tokens": [5], "branch": 0,
                                  "reason": "length", "score": -1.5,
                                  "token_logprobs": [-0.25]}],
                 "prompt_logprobs": [None, -2.0], "token_logprobs": [-0.25]}
