"""Serving entry point of the port: continuous batching over paged KV on
the card - greedy or seeded sampling, speculation, sequence groups and
beam search, logprobs - or (``--dense``) the greedy fixed-batch loop over
a contiguous cache.

  python -m repro_torch.launch.serve --arch qwen3-1.7b --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --reduced --device cpu --batch 2 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --reduced --device cpu --spec-k 4 --temperature 0.8 --top-p 0.95 \\
      --seed 7
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --reduced --device cpu --dense
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --reduced --device cpu --tp 2
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \\
      --device cuda --spec-k 4

``--arch`` takes every config the reference's paged engine serves:
qwen3-1.7b, qwen1.5-4b, minitron-8b, command-r-plus-104b, hfa-paper-mini
(H-FA rail by default), granite-moe-1b-a400m and phi3.5-moe-42b-a6.6b
(``repro_torch.configs.REGISTRY``; the last two route each token to its
top-k experts, :mod:`repro_torch.models.moe`).  At full size
phi3.5-moe-42b-a6.6b (~84 GB in bf16) and command-r-plus-104b (~208 GB)
do not fit one 80 GB card.

Weights are random (nothing is downloaded): the reference's
``LM.init(PRNGKey(0))`` weights, drawn with JAX's generator written in
torch (``LM.init_reference``).  Prompts are the reference's too,
``DataPipeline.for_config(cfg, prompt_len, batch)``; the paged path takes
one new arrival per engine step, request i sampling under seed
``--seed + i``.  So on the CPU both packages print the same ``sample:``
token ids for the same flags.
``--attn-impl`` takes the reference's impls: on the paged path any
"hfa..." impl runs the FIX16 H-FA rail and LogDiv, anything else fa2
(exp and a float divide); the dense path prefills through
``multihead_attention`` with the impl and decodes through the dense
decode kernel on its rail.
``--tp N`` serves on N ranks, the pools KV-head-sharded over them
(``launch/mesh.py``): gloo ranks on the CPU, one NCCL rank a card on
``cuda`` (N cards, or an error).  This process is rank 0 and prints; the
other ranks are spawned (or started by torchrun) and follow it.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

# The reference's impl names (repro_torch.kernels.ops.IMPLS), spelled out
# so that --help needs no torch import.
IMPLS = ("exact", "fa2", "hfa", "fa2_pallas", "hfa_pallas", "hfa_datapath")


def parse_prefill_budget(value: str | None) -> int | str | None:
    """CLI form of the engine's ``prefill_budget``: "none"/"" -> None
    (unbounded), "adaptive" -> the per-step budget from the decode
    batch's SLA headroom, else an int token budget."""
    if value is None or value.lower() in ("", "none"):
        return None
    if value.lower() == "adaptive":
        return "adaptive"
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an int, 'none' or 'adaptive', got {value!r}")


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
                    help="total requests (default 2x batch)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-budget", type=parse_prefill_budget,
                    default=None,
                    help="prefill token budget per engine step (chunked "
                         "prefill): an int, 'none' (unbounded, the default) "
                         "or 'adaptive' (from the decode batch's SLA "
                         "headroom)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix page reuse")
    ap.add_argument("--kv-codec", choices=("fp", "int8", "log16"),
                    default="fp",
                    help="paged KV page codec: 'fp' stores raw "
                         "compute-dtype rows, 'int8' per-row absmax "
                         "quantization with an f32 scale sidecar, "
                         "'log16' 16-bit log-domain rows (the bf16 bit "
                         "pattern); the paged kernels decode each tile")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="max prompt-lookup draft tokens verified per "
                         "decode step (0 = no speculation)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus truncation (1.0 = disabled)")
    ap.add_argument("--repetition-penalty", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed (request i uses seed + i)")
    ap.add_argument("--n", type=int, default=1,
                    help="parallel samples per request (one prefill fans "
                         "n branches out over copy-on-write forks; branch "
                         "b samples under branch_seed(seed, b))")
    ap.add_argument("--best-of", type=int, default=None,
                    help="branches sampled per request (>= n); the n best "
                         "by length-normalized cumulative logprob are "
                         "returned")
    ap.add_argument("--beam-width", type=int, default=0,
                    help="> 0: length-normalized beam search with this "
                         "many beams (temperature must stay 0; returns the "
                         "n best hypotheses)")
    ap.add_argument("--length-penalty", type=float, default=1.0,
                    help="score = cum_logprob / len**length_penalty "
                         "(1.0 = mean logprob, 0 = raw sum)")
    ap.add_argument("--logprobs", action="store_true",
                    help="return per-token logprobs: prompt positions (the "
                         "LM head at every prefill position) and every "
                         "generated token")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shards: KV-head-shard the paged "
                         "pools over a 'model' mesh axis, one rank a "
                         "shard (gloo ranks on the CPU, one NCCL rank a "
                         "card on cuda)")
    ap.add_argument("--dense", action="store_true",
                    help="fixed-batch greedy loop over a contiguous cache")
    args = ap.parse_args(argv)
    if args.tp < 1:
        ap.error("--tp must be >= 1")
    if args.n < 1:
        ap.error("--n must be >= 1")
    if args.beam_width > 0 and args.temperature > 0:
        ap.error("beam search is deterministic: --temperature must be 0")
    if args.beam_width > 0 and args.best_of is not None:
        ap.error("--best-of is a parallel-sampling knob, incompatible "
                 "with --beam-width")
    width = args.beam_width or (args.best_of or args.n)
    if width > args.batch:
        ap.error(f"group width {width} exceeds --batch {args.batch}")
    return args


def config(args):
    """The model config the serving CLIs' flags name."""
    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    return cfg


def paged_engine(args, cfg, mesh=None, model=None):
    """The serving CLIs' engine over the reference's weights (or over
    ``model``, another replica's), on the mesh's device under a mesh
    (every rank builds the same one)."""
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServingEngine
    dev = args.device if mesh is None else mesh.device
    if model is None:
        model = build_model(cfg, device=dev).init_reference(0)
    return ServingEngine(model, max_batch=args.batch,
                         page_size=args.page_size, max_seq=args.max_seq,
                         prefill_budget=args.prefill_budget,
                         prefix_caching=not getattr(args, "no_prefix_cache",
                                                    False),
                         spec_k=args.spec_k,
                         kv_codec=getattr(args, "kv_codec", "fp"),
                         mesh=mesh, device=dev)


def run_parallel(module: str, argv: list, args, cfg, lead, dp: int = 1):
    """Serve on ``args.tp * dp`` ranks: the mesh checks first, then
    ``lead(mesh)`` here as rank 0 and ``module.follow(argv)`` on the
    others (:func:`repro_torch.launch.mesh.run_ranks`); returns what
    ``lead`` returns.  The mesh's collectives wait run_ranks' timeout
    for a rank; an idle server keeps its followers inside it
    (``ServingEngine.keepalive``)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import ranks
    from repro_torch.serving.engine import check_parallel
    mesh_lib.check_degrees(args.tp, dp)
    check_parallel(cfg, args.tp, dp, args.batch)
    if mesh_lib.default_backend(args.device) == "nccl":
        import torch
        mesh_lib.check_devices(args.tp, dp, torch.cuda.device_count())
    return mesh_lib.run_ranks(
        lambda: lead(mesh_lib.make_tp_dp_mesh(args.tp, dp,
                                              device=args.device)),
        ranks.cli_follower, args.tp * dp, args=(module, argv),
        device=args.device)[0]


def follow_parallel(args, dp: int = 1) -> None:
    """A serving CLI's rank > 0: the same engine on its mesh, following
    rank 0 until it stops."""
    from repro_torch.launch.mesh import make_tp_dp_mesh
    mesh = make_tp_dp_mesh(args.tp, dp, device=args.device)
    paged_engine(args, config(args), mesh).follow()


def follow(argv: list) -> None:
    """Rank > 0 of ``serve --tp``."""
    follow_parallel(_args(argv))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)

    from repro_torch.data import DataPipeline
    from repro_torch.models.model import build_model

    cfg = config(args)
    if args.dense or not _paged_supported(cfg):
        if args.tp > 1:
            raise SystemExit("--tp requires the paged serving path")
        if not args.dense:
            print(f"note: {cfg.name} (family={cfg.family}, "
                  f"pos_emb={cfg.pos_emb}) is not paged-servable yet; "
                  "falling back to the dense fixed-batch loop")
        model = build_model(cfg, device=args.device).init_reference(0)
        _serve_dense(model, cfg, DataPipeline.for_config(
            cfg, args.prompt_len, args.batch).batch(0), args)
        return
    if args.tp > 1:
        return run_parallel("repro_torch.launch.serve", argv, args, cfg,
                            lambda mesh: _serve_paged(args, cfg, mesh))
    return _serve_paged(args, cfg)


def _serve_paged(args, cfg, mesh=None):
    """The paged run (rank 0's under a mesh): prompts, the engine, its
    lines."""
    import torch

    from repro_torch.data import DataPipeline
    from repro_torch.serving import Request, SamplingParams

    pipe = DataPipeline.for_config(cfg, args.prompt_len, args.batch)
    n_req = args.requests or 2 * args.batch
    prompts = np.concatenate(
        [pipe.batch(s)["tokens"] for s in range((n_req + args.batch - 1)
                                                // args.batch)])[:n_req]
    engine = paged_engine(args, cfg, mesh)
    model = engine.model
    arrivals = [(i, Request(rid=i, prompt=prompts[i].tolist(),
                            max_new_tokens=args.steps,
                            sampling=SamplingParams(
                                temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p,
                                repetition_penalty=args.repetition_penalty,
                                seed=args.seed + i),
                            n=args.n, best_of=args.best_of,
                            beam_width=args.beam_width,
                            length_penalty=args.length_penalty,
                            logprobs=args.logprobs))
                for i in range(n_req)]
    t0 = time.perf_counter()
    try:
        finished = engine.run(arrivals)
    finally:
        engine.close()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    engine.cache.check_invariants()
    st = engine.stats
    print(f"device {model.device}"
          + (f" ({torch.cuda.get_device_name(model.device)})"
             if model.device.type == "cuda" else "")
          + f", {cfg.name}, rail {cfg.attn_impl}")
    print(f"served {len(finished)} requests in {st['steps']} steps "
          f"({st['prefill_chunks']} prefill chunks, "
          f"{st['preemptions']} preemptions, page_size={args.page_size})")
    print(f"prefill: {st['prefill_tokens']} tokens computed, "
          f"{st['cached_prefill_tokens']} reused from prefix cache")
    print(f"generated {st['generated_tokens']} tokens in {dt:.2f} s "
          f"-> {st['generated_tokens'] / dt:.1f} tok/s")
    print(f"kv codec {engine.kv_codec}: pool {engine.pool_bytes()} B, "
          f"{engine.bytes_per_token()} B/token")
    if mesh is not None:
        print(f"tensor parallel: tp {engine.tp} on {mesh.backend} ranks, "
              f"{engine.pool_bytes_per_shard()} B of pool a shard, "
              f"{st['triplet_bytes']} B of triplets gathered")
    if args.logprobs:
        fr = finished[0]
        plp = [f"{x:+.2f}" if x is not None else "None"
               for x in (fr.prompt_logprobs or [])[:6]]
        tlp = [f"{x:+.2f}" for x in (fr.token_logprobs or [])[:6]]
        print(f"logprobs rid {fr.rid}: prompt {plp} tokens {tlp}")
    if args.spec_k:
        rate = st["draft_accepted"] / max(st["draft_tokens"], 1)
        tps = st["decode_tokens"] / max(st["decode_slot_steps"], 1)
        print(f"speculation: {st['draft_accepted']}/{st['draft_tokens']} "
              f"drafts accepted ({rate:.0%}), "
              f"{tps:.2f} accepted tokens/step, "
              f"{st['rollbacks']} rollbacks")
    if st["groups"]:
        kind = f"beam-{args.beam_width}" if args.beam_width \
            else f"n={args.n}" + (f"/best-of-{args.best_of}"
                                  if args.best_of else "")
        print(f"sequence groups ({kind}): {st['groups']} groups, "
              f"{st['forks']} COW forks (zero KV copied at fork)")
        best = finished[0]
        if best.completions:
            for c in best.completions[:4]:
                print(f"  rid {best.rid} branch {c.branch} "
                      f"score {c.score:+.3f}: {c.tokens[:10]}")
    print("sample:", finished[0].tokens[:12])


def _paged_supported(cfg) -> bool:
    """Archs the paged engine can serve today: rope-positioned,
    attention-only stacks with token-only prompts (no Mamba per-slot
    state, no encoder cross caches, no patch/frame prefixes)."""
    return (cfg.pos_emb == "rope"
            and all(k == "attn" for k in cfg.layer_kinds())
            and cfg.family not in ("encdec", "vlm"))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_dense(model, cfg, batch, args) -> dict:
    """Fixed-batch greedy loop over a dense contiguous cache: prefill
    ``batch["tokens"]``, then ``args.steps`` decode steps.  Prints the
    reference's lines and returns {"tokens" (B, steps) int64, "prefill_ms",
    "decode_ms" (per token), "tok_s", "finite"}."""
    import torch
    dev = model.device
    prompts = torch.as_tensor(batch["tokens"], device=dev)
    cache = model.init_cache(args.batch, args.max_seq)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(cache, prompts)
    _sync(dev)
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    print(f"prefill: {prefill_ms:.1f} ms ({args.batch}x{args.prompt_len})")
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    toks = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        toks.append(tok)
        logits, cache = model.decode_step(cache, tok)
        finite = finite & torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    dt = (time.perf_counter() - t0) / args.steps
    print(f"decode: {dt * 1e3:.2f} ms/token; "
          f"throughput {args.batch / dt:.1f} tok/s")
    out = torch.cat(toks, dim=1).cpu().numpy()
    print("sample:", out[0][:12])
    return {"tokens": out, "prefill_ms": prefill_ms, "decode_ms": dt * 1e3,
            "tok_s": args.batch / dt, "finite": bool(finite)}


if __name__ == "__main__":
    main()
