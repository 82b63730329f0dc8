"""Async streaming serving entry point of the port: Poisson open-loop
traffic over the :class:`repro_torch.serving.frontend.AsyncFrontend`.

Where ``repro_torch.launch.serve`` drives the engine synchronously to
completion, this entry point serves the way real traffic arrives: an
open-loop Poisson process (arrivals do not wait for completions), one
async client coroutine per request consuming its token stream, latency
classes (``interactive`` / ``standard`` / ``batch``) mixed per
``--class-mix``, and optional mid-stream abandonment (``--cancel-every``)
exercising the refcount-clean cancellation path.  Client-side TTFT
(submit -> first token out of the generator) and TPOT (mean gap between
consecutive tokens) are reported as p50/p99 per class against the
class targets.

  python -m repro_torch.launch.serve_async --arch qwen3-1.7b --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve_async \\
      --arch qwen3-1.7b --reduced --device cpu --smoke

Weights are the reference's ``LM.init(PRNGKey(0))`` drawn in torch
(``LM.init_reference``), prompts ``DataPipeline.for_config``'s, as in
``repro_torch.launch.serve``.  ``--tp N`` serves on N ranks, the pools
KV-head-sharded over them (gloo ranks on the CPU, one NCCL rank a card
on ``cuda``): this process is rank 0 and runs the open loop, the
frontend and the prints; the other ranks follow its engine.  torch is
imported only after argument parsing.
"""
import argparse
import asyncio
import sys
import time

import numpy as np

from repro_torch.launch.serve import (IMPLS, _paged_supported, config,
                                     follow_parallel, paged_engine,
                                     parse_prefill_budget, run_parallel)


def parse_class_mix(s: str) -> dict[str, float]:
    """"interactive=0.5,standard=0.3,batch=0.2" -> {name: weight}.
    Weights are normalized; unknown class names fail in main() where
    LATENCY_CLASSES is importable."""
    mix = {}
    for part in s.split(","):
        name, _, w = part.partition("=")
        mix[name.strip()] = float(w) if w else 1.0
    total = sum(mix.values())
    if total <= 0:
        raise argparse.ArgumentTypeError(f"empty class mix: {s!r}")
    return {k: v / total for k, v in mix.items()}


def poisson_gaps(rng, n: int, rate: float) -> list[float]:
    """n exponential inter-arrival gaps for a Poisson process of
    ``rate`` requests/sec (rate <= 0: all arrive at t=0)."""
    if rate <= 0:
        return [0.0] * n
    return rng.exponential(1.0 / rate, size=n).tolist()


async def open_loop(frontend, arrivals, *, cancel_every: int = 0,
                    cancel_after: int = 4) -> list[dict]:
    """Drive an open-loop workload: ``arrivals`` is [(gap_seconds,
    request)]; each request gets a client coroutine that consumes its
    stream and measures client-side latency.  Every ``cancel_every``-th
    client abandons its generator after ``cancel_after`` tokens
    (0 = never), exercising mid-prefill and mid-decode cancellation.

    Returns one record per request:
    {rid, cls, ttft, tpot, tokens, reason, fr}; ttft/tpot are None when
    no token arrived (cancelled pre-first-token / rejected); fr is the
    claimed FinishedRequest (result() removes it from the frontend's
    bounded LRU, so the record carries it for later inspection)."""
    records: list[dict] = []

    async def client(i: int, req) -> None:
        cancel_at = None
        if cancel_every > 0 and i % cancel_every == cancel_every - 1:
            cancel_at = cancel_after
        t_submit = time.perf_counter()
        t_tokens: list[float] = []
        gen = frontend.submit(req)
        try:
            async for _tok in gen:
                t_tokens.append(time.perf_counter())
                if cancel_at is not None and len(t_tokens) >= cancel_at:
                    break                      # abandon mid-stream
        finally:
            await gen.aclose()
        # aclose() files the cancel intent; the result lands once the
        # drive loop applies it.  result() claims (removes) it.
        fr = None
        while fr is None:
            fr = frontend.result(req.rid)
            if fr is None:
                await asyncio.sleep(0.001)
        ttft = t_tokens[0] - t_submit if t_tokens else None
        tpot = (t_tokens[-1] - t_tokens[0]) / (len(t_tokens) - 1) \
            if len(t_tokens) > 1 else None
        records.append({"rid": req.rid, "cls": req.latency_class.name,
                        "ttft": ttft, "tpot": tpot,
                        "tokens": len(t_tokens), "reason": fr.reason,
                        "fr": fr})

    tasks = []
    for i, (gap, req) in enumerate(arrivals):
        if gap:
            await asyncio.sleep(gap)
        tasks.append(asyncio.ensure_future(client(i, req)))
    await asyncio.gather(*tasks)
    await frontend.close()
    return sorted(records, key=lambda r: r["rid"])


def summarize(records: list[dict]) -> dict:
    """Per-class p50/p99 TTFT and TPOT (seconds) plus counts:
    {cls: {n, cancelled, ttft_p50, ttft_p99, tpot_p50, tpot_p99}}."""
    out: dict[str, dict] = {}
    for cls in sorted({r["cls"] for r in records}):
        rs = [r for r in records if r["cls"] == cls]
        ttfts = [r["ttft"] for r in rs if r["ttft"] is not None]
        tpots = [r["tpot"] for r in rs if r["tpot"] is not None]
        ent = {"n": len(rs),
               "cancelled": sum(r["reason"] == "cancelled" for r in rs)}
        for key, vals in (("ttft", ttfts), ("tpot", tpots)):
            ent[f"{key}_p50"] = float(np.percentile(vals, 50)) \
                if vals else None
            ent[f"{key}_p99"] = float(np.percentile(vals, 99)) \
                if vals else None
        out[cls] = ent
    return out


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
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32,
                    help="decode tokens per request")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=0,
                    help="total requests (default 4x batch)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-budget", type=parse_prefill_budget,
                    default="adaptive",
                    help="int, 'none', or 'adaptive' (default: derive "
                         "the chunked-prefill budget from the decode "
                         "batch's SLA headroom each step)")
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate, requests/sec "
                         "(<= 0: all requests arrive at t=0)")
    ap.add_argument("--class-mix", type=parse_class_mix,
                    default="interactive=0.25,standard=0.5,batch=0.25",
                    help="latency-class weights, e.g. "
                         "interactive=0.5,standard=0.3,batch=0.2")
    ap.add_argument("--cancel-every", type=int, default=0,
                    help="every k-th client abandons its stream after "
                         "--cancel-after tokens (0 = never)")
    ap.add_argument("--cancel-after", type=int, default=4)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shards: KV-head-shard the paged "
                         "pools over a 'model' mesh axis, one rank a "
                         "shard")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI configuration (few short requests)")
    args = ap.parse_args(argv)
    if isinstance(args.class_mix, str):
        args.class_mix = parse_class_mix(args.class_mix)
    if args.smoke:
        args.batch = min(args.batch, 4)
        args.prompt_len = min(args.prompt_len, 16)
        args.steps = min(args.steps, 8)
        args.requests = args.requests or 6
        args.rate = 50.0
    return args


def follow(argv: list) -> None:
    """Rank > 0 of ``serve_async --tp``."""
    follow_parallel(_args(argv))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)

    from repro_torch.serving import LATENCY_CLASSES

    for name in args.class_mix:
        if name not in LATENCY_CLASSES:
            raise SystemExit(f"unknown latency class {name!r} (have "
                             f"{sorted(LATENCY_CLASSES)})")
    cfg = config(args)
    if not _paged_supported(cfg):
        raise SystemExit(f"{cfg.name} is not paged-servable; the async "
                         "front-end has no dense fallback")
    if args.tp != 1:
        return run_parallel("repro_torch.launch.serve_async", argv, args,
                            cfg, lambda mesh: _serve(args, cfg, mesh))
    return _serve(args, cfg)


def _serve(args, cfg, mesh=None):
    """The open loop over the engine (rank 0's under a mesh)."""
    import torch

    from repro_torch.data import DataPipeline
    from repro_torch.serving import (LATENCY_CLASSES, AsyncFrontend, Request,
                                     SamplingParams)

    engine = paged_engine(args, cfg, mesh)
    model = engine.model

    n_req = args.requests or 4 * args.batch
    pipe = DataPipeline.for_config(cfg, args.prompt_len, args.batch)
    prompts = np.concatenate(
        [pipe.batch(s)["tokens"] for s in range((n_req + args.batch - 1)
                                                // args.batch)])[:n_req]
    rng = np.random.default_rng(args.seed)
    names = sorted(args.class_mix)
    picks = rng.choice(len(names), size=n_req,
                       p=[args.class_mix[n] for n in names])
    gaps = poisson_gaps(rng, n_req, args.rate)
    arrivals = []
    for i in range(n_req):
        sp = SamplingParams(temperature=args.temperature,
                            seed=args.seed + i)
        arrivals.append((gaps[i], Request(
            rid=i, prompt=prompts[i].tolist(),
            max_new_tokens=args.steps, sampling=sp,
            latency_class=LATENCY_CLASSES[names[int(picks[i])]])))

    frontend = AsyncFrontend(engine)
    t0 = time.perf_counter()
    try:
        records = asyncio.run(open_loop(frontend, arrivals,
                                        cancel_every=args.cancel_every,
                                        cancel_after=args.cancel_after))
    finally:
        engine.close()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    engine.cache.check_invariants()

    st = engine.stats
    print(f"device {model.device}"
          + (f" ({torch.cuda.get_device_name(model.device)})"
             if model.device.type == "cuda" else "")
          + f", {cfg.name}, rail {cfg.attn_impl}")
    print(f"open loop: {len(records)} requests in {dt:.2f} s at rate "
          f"{args.rate}/s ({st['steps']} engine steps, "
          f"{st['cancelled']} cancelled, {st['preemptions']} preemptions)")
    if engine.adaptive_prefill:
        print(f"adaptive prefill budget: last {st['adaptive_budget_last']} "
              f"tokens (floor {engine.adaptive_floor}, ceiling "
              f"{engine.adaptive_ceiling})")
    for cls, ent in summarize(records).items():
        tgt = LATENCY_CLASSES[cls]
        fmt = lambda v: "-" if v is None else f"{1e3 * v:.0f}ms"  # noqa: E731
        print(f"  {cls:<12} n={ent['n']:<3} "
              f"ttft p50/p99 {fmt(ent['ttft_p50'])}/{fmt(ent['ttft_p99'])} "
              f"(target {1e3 * tgt.ttft_target:.0f}ms)  "
              f"tpot p50/p99 {fmt(ent['tpot_p50'])}/{fmt(ent['tpot_p99'])} "
              f"(target {1e3 * tgt.tpot_target:.0f}ms)  "
              f"cancelled={ent['cancelled']}")
    done = [r for r in records if r["reason"] in ("eos", "length")]
    if done:
        print("sample:", done[0]["fr"].tokens[:12])
    return records


if __name__ == "__main__":
    main()
