"""Training entry point of the port: the reference's ``launch/train.py``
flags plus ``--device`` (default ``cuda``).

  python -m repro_torch.launch.train --arch qwen3-1.7b --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --device cpu --steps 4

  python -m repro_torch.launch.train --arch command-r-plus-104b \
      --device cuda --layers 2 --microbatches 1 --global-batch 2 \
      --seq 1024 --ckpt-every 0
  python -m repro_torch.launch.train --arch mamba2-2.7b --device cuda \
      --layers 4

Weights are random, drawn from the trainer's seed; data is the
synthetic Markov pipeline.  The config's ``attn_impl`` picks the
attention kernels (``fa2`` for qwen3-1.7b and command-r-plus-104b: the
FA-2 forward and backward kernels) and its ``optimizer`` the update
(Adafactor for command-r-plus-104b, AdamW otherwise).  ``--layers`` cuts
the depth at full width (command-r-plus-104b's 64 layers are ~208 GB in
bf16; at 2 layers its parameters and gradients take 37.8 GB), and
``--microbatches`` overrides the config's (its f32 gradient sums add
4 bytes a parameter: take 1 for command-r-plus-104b on one card).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.runtime.trainer import DEFAULT_CKPT_DIR


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain versions")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the stack to this many layers (full width)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="gradient accumulation steps (default: the config's)")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="steps between checkpoints; 0 saves none")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cut = {k: v for k, v in (("n_layers", args.layers),
                             ("microbatches", args.microbatches))
           if v is not None}
    cfg = dataclasses.replace(cfg, **cut)
    model = build_model(cfg, device=args.device)
    print(f"{cfg.name}: ~{cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers, attn_impl {cfg.attn_impl}, optimizer "
          f"{cfg.optimizer}, {cfg.microbatches} microbatches, device "
          f"{model.device}")
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt,
        peak_lr=args.lr,
        warmup=max(args.steps // 20, 1), seq_len=args.seq,
        global_batch=args.global_batch,
        grad_compression=args.grad_compression)
    res = Trainer(model, tcfg).run()
    losses = [m["loss"] for m in res["metrics"]]
    print(f"steps={res['final_step']} restarts={res['restarts']} "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return res


if __name__ == "__main__":
    main()
