"""HTTP/SSE serving entry point of the port: the network transport over
the asyncio streaming front-end.

Starts :class:`repro_torch.serving.http.HttpServer` (raw-asyncio
HTTP/1.1 + Server-Sent Events, no third-party deps) over an
:class:`AsyncFrontend` and serves until interrupted:

  python -m repro_torch.launch.serve_http --arch qwen3-1.7b --device cuda \\
      --port 8100 [--replicas 2]
  PYTHONPATH=src python -m repro_torch.launch.serve_http \\
      --arch qwen3-1.7b --reduced --device cpu --smoke

  curl -N localhost:8100/v1/generate -H 'x-tenant: alice' \\
      -d '{"prompt": [1, 2, 3], "max_new_tokens": 8}'

``--queue-cap`` bounds per-latency-class admission (429 past the cap):
a bare int applies to every class, or per-class as
``interactive=8,standard=16,batch=64``.  ``--replicas N`` serves N
engines over one shared model (each with its own pools) behind a
prefix-aware :class:`~repro_torch.serving.router.Router`.  ``--smoke``
binds an ephemeral loopback port, runs a built-in client
(healthz/stats, a greedy and a sampled+tenant SSE stream, a mid-stream
disconnect; with replicas the router's placement and prefix hit),
checks the paged pools came back clean, and exits - the CI gate.
``--tp`` / ``--dp`` serve one engine on tp x dp ranks (the pools
KV-head-sharded over "model", each paged attention call's slots split
over "data"; gloo ranks on the CPU, one NCCL rank a card on ``cuda``):
this process is rank 0 and runs the server, the other ranks follow its
engine.  Replicas behind the router over such engines are not served
yet (ROADMAP.md Queue 1 item 11c).  torch is imported only after
argument parsing.
"""
import argparse
import asyncio
import sys

from repro_torch.launch.serve import (IMPLS, _paged_supported, config,
                                     follow_parallel, paged_engine,
                                     parse_prefill_budget, run_parallel)


def parse_queue_caps(s: str):
    """"16" (every class) or "interactive=8,standard=16,batch=64"
    (per-class, unlisted classes keep the default); "none" disables
    the cap parse (server default of 4 x max_batch applies)."""
    s = s.strip()
    if not s or s.lower() == "none":
        return None
    if "=" not in s:
        try:
            return int(s)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"queue cap must be an int or name=int list: {s!r}")
    caps = {}
    for part in s.split(","):
        name, _, v = part.partition("=")
        try:
            caps[name.strip()] = int(v)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"bad per-class cap {part!r} in {s!r}")
    return caps


async def _smoke_router(server) -> list[str]:
    """--replicas N --smoke extension: spread two concurrent streams
    across replicas (least-loaded fallback), then repeat the first
    prompt and require a prefix-hit route plus token-identical output -
    the multi-replica parity + placement gate.  Every replica's pool
    must come back invariant-clean."""
    from repro_torch.serving.http import stream_generate
    fails = []
    host, port = server.host, server.port
    router = server.frontend

    async def collect(payload):
        toks, done = [], None
        async for kind, data in stream_generate(host, port, payload):
            if kind == "token":
                toks.append(data["token"])
            elif kind == "done":
                done = data
            else:
                fails.append(f"router stream error: {data}")
        return toks, done

    pa = {"prompt": list(range(1, 33)), "max_new_tokens": 12}
    pb = {"prompt": list(range(40, 56)), "max_new_tokens": 8}
    # Hold stream A open past its first token so B's placement sees a
    # loaded replica 0 and falls back to replica 1.
    gen_a = stream_generate(host, port, pa)
    toks_a = []
    async for kind, data in gen_a:
        if kind == "token":
            toks_a.append(data["token"])
            break
    _toks_b, done_b = await collect(pb)
    async for kind, data in gen_a:
        if kind == "token":
            toks_a.append(data["token"])
        elif kind == "done":
            if data["tokens"] != toks_a:
                fails.append(f"stream A tokens {toks_a} != {data['tokens']}")
    await gen_a.aclose()
    if done_b is None or done_b["reason"] not in ("eos", "length"):
        fails.append(f"stream B: done={done_b}")
    # Repeat prompt A: must prefix-route to A's replica and reproduce
    # A's token stream exactly (per-request determinism + shared KV).
    toks_a2, done_a2 = await collect(pa)
    if done_a2 is None or toks_a2 != toks_a:
        fails.append(f"repeat of A not token-identical: "
                     f"{toks_a2} != {toks_a}")
    await router.drain()
    if router.stats["prefix_routed"] < 1:
        fails.append(f"no prefix-hit route: {router.stats}")
    stepped = [fe.engine.stats["steps"] > 0 for fe in router.frontends]
    if not all(stepped):
        fails.append(f"replica(s) never stepped: {stepped}")
    if router.core.placement or any(router.core.load):
        fails.append(f"router leaked placements: {router.core.placement} "
                     f"load={router.core.load}")
    for i, fe in enumerate(router.frontends):
        fe.engine.cache.check_invariants()
        if fe.engine.cache.available_page_count != \
                fe.engine.cache.num_pages:
            fails.append(f"replica {i} leaked pages")
    return fails


async def _smoke_client(server, cfg) -> list[str]:
    """The --smoke self-test: drive the server over real sockets the
    way the conformance tests do; returns a list of failures."""
    from repro_torch.serving.http import http_json, stream_generate
    fails = []
    host, port = server.host, server.port

    status, health = await http_json(host, port, "GET", "/healthz")
    if status != 200 or health.get("status") != "ok":
        fails.append(f"healthz: {status} {health}")

    prompt = list(range(1, 9))
    toks = []
    done = None
    async for kind, data in stream_generate(
            host, port, {"prompt": prompt, "max_new_tokens": 8,
                         "latency_class": "interactive"}):
        if kind == "token":
            toks.append(data["token"])
        elif kind == "done":
            done = data
        else:
            fails.append(f"greedy stream error: {data}")
    if done is None or done["tokens"] != toks or len(toks) == 0:
        fails.append(f"greedy stream: {len(toks)} tokens, done={done}")

    done = None
    async for kind, data in stream_generate(
            host, port, {"prompt": prompt, "max_new_tokens": 6,
                         "temperature": 0.8, "top_k": 8, "seed": 7},
            tenant="smoke-tenant"):
        if kind == "done":
            done = data
    if done is None or done["reason"] not in ("eos", "length"):
        fails.append(f"sampled stream: done={done}")

    # Mid-stream disconnect: close after 2 tokens; the server must
    # cancel the request and free its slot/pages.
    gen = stream_generate(host, port,
                          {"prompt": prompt, "max_new_tokens": 64})
    got = 0
    async for kind, _data in gen:
        if kind == "token":
            got += 1
            if got >= 2:
                break
    await gen.aclose()
    engine = server.frontend.engine
    for _ in range(500):
        if engine.stats["cancelled"] >= 1:
            break
        await asyncio.sleep(0.01)
    await server.frontend.drain()
    engine.cache.check_invariants()
    if engine.stats["cancelled"] < 1:
        fails.append("disconnect did not cancel the request")
    if engine.cache.available_page_count != engine.cache.num_pages:
        fails.append("disconnect leaked pages")

    status, stats = await http_json(host, port, "GET", "/stats")
    if status != 200 or stats.get("engine", {}).get("steps", 0) <= 0:
        fails.append(f"stats: {status} {stats}")
    if stats.get("http", {}).get("disconnects", 0) < 1:
        fails.append(f"stats missed the disconnect: {stats.get('http')}")

    from repro_torch.serving.router import Router
    if isinstance(server.frontend, Router):
        fails.extend(await _smoke_router(server))
    return fails


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain versions")
    ap.add_argument("--attn-impl", choices=IMPLS, default=None,
                    help="attention impl (default: the config's)")
    ap.add_argument("--batch", type=int, default=4,
                    help="concurrent decode slots")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-budget", type=parse_prefill_budget,
                    default="adaptive",
                    help="int, 'none', or 'adaptive' (default)")
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--kv-codec", choices=("fp", "int8", "log16"),
                    default="fp", help="paged KV page codec")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shards: KV-head-shard the paged "
                         "pools over a 'model' mesh axis")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree: batch-shard every paged "
                         "attention call over a 'data' mesh axis")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve N independent engine replicas behind a "
                         "prefix-cache-aware router")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100,
                    help="listen port (0 = kernel-assigned)")
    ap.add_argument("--queue-cap", type=parse_queue_caps, default=None,
                    help="per-class admission cap before 429: an int "
                         "for every class or "
                         "interactive=8,standard=16,batch=64 "
                         "(default: 4 x --batch)")
    ap.add_argument("--stream-buffer", type=int, default=1024,
                    help="per-stream token queue bound; a reader "
                         "stalled this many tokens behind is treated "
                         "as disconnected and cancelled")
    ap.add_argument("--max-results", type=int, default=1024,
                    help="unclaimed FinishedRequest LRU bound")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="seconds a client may stall a socket write "
                         "before the connection is dropped")
    ap.add_argument("--smoke", action="store_true",
                    help="bind an ephemeral port, run the built-in "
                         "client self-test, and exit")
    args = ap.parse_args(argv)
    if isinstance(args.queue_cap, str):
        args.queue_cap = parse_queue_caps(args.queue_cap)
    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")
    return args


def follow(argv: list) -> None:
    """Rank > 0 of ``serve_http --tp / --dp``."""
    args = _args(argv)
    follow_parallel(args, args.dp)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    cfg = config(args)
    if not _paged_supported(cfg):
        raise SystemExit(f"{cfg.name} is not paged-servable; the HTTP "
                         "front-end has no dense fallback")
    try:
        if (args.tp, args.dp) != (1, 1):
            if args.replicas > 1:
                raise NotImplementedError(
                    f"--replicas {args.replicas} with --tp {args.tp} --dp "
                    f"{args.dp}: the router over tensor-parallel replicas "
                    "is not served yet (ROADMAP.md Queue 1 item 11c)")
            code = run_parallel("repro_torch.launch.serve_http", argv, args,
                                cfg, lambda mesh: _serve(args, cfg, mesh),
                                dp=args.dp)
        else:
            code = _serve(args, cfg)
    except KeyboardInterrupt:
        print("interrupted; shut down")
        return
    raise SystemExit(code)


def _serve(args, cfg, mesh=None) -> int:
    """Serve until interrupted, or the smoke's exit code (rank 0's side
    under a mesh)."""
    from repro_torch.serving import AsyncFrontend
    from repro_torch.serving.http import HttpServer
    from repro_torch.serving.router import Router

    # One model; each replica's engine holds its own pools over it.
    engines = [paged_engine(args, cfg, mesh)]
    model = engines[0].model
    engines += [paged_engine(args, cfg, model=model)
                for _ in range(args.replicas - 1)]
    engine = engines[0]

    async def run() -> int:
        frontends = [AsyncFrontend(e,
                                   stream_buffer=args.stream_buffer,
                                   max_results=args.max_results)
                     for e in engines]
        for fe in frontends:        # a mesh's ranks kept from the start
            fe.start()
        frontend = frontends[0] if args.replicas == 1 \
            else Router(frontends)
        server = HttpServer(frontend, host=args.host,
                            port=0 if args.smoke else args.port,
                            queue_caps=args.queue_cap,
                            drain_timeout=args.drain_timeout)
        await server.start()
        print(f"serving {cfg.name} ({model.device}, rail "
              f"{cfg.attn_impl}) on http://{server.host}:{server.port} "
              f"(batch {args.batch}, page {args.page_size}, codec "
              f"{engine.kv_codec}, replicas {args.replicas}, "
              f"tp {args.tp} dp {args.dp}, caps {server.queue_caps})")
        try:
            if args.smoke:
                fails = await _smoke_client(server, cfg)
                st = engine.stats
                print(f"smoke: {st['steps']} steps, "
                      f"{st['generated_tokens']} tokens, "
                      f"{st['cancelled']} cancelled, "
                      f"{server.http_stats['streams']} streams")
                for f in fails:
                    print("SMOKE FAIL:", f)
                print("smoke:", "FAIL" if fails else "OK")
                return 1 if fails else 0
            await asyncio.Event().wait()      # serve until interrupted
            return 0
        finally:
            await server.stop()
            for fe in frontends:
                if not fe.closed:
                    await fe.close()

    try:
        return asyncio.run(run())
    finally:
        engine.close()


if __name__ == "__main__":
    main()
