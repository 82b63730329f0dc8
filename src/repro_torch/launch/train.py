"""Training entry point of the port: the reference's ``launch/train.py``
flags plus ``--device`` (default ``cuda``).

  python -m repro_torch.launch.train --arch qwen3-1.7b --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --device cpu --steps 4

Weights are random, drawn from the trainer's seed; data is the
synthetic Markov pipeline.  The config's ``attn_impl`` picks the
attention kernels (``fa2`` for qwen3-1.7b: the FA-2 forward and
backward kernels).
"""
from __future__ import annotations

import argparse

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
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    print(f"{cfg.name}: ~{cfg.param_count() / 1e6:.1f}M params, "
          f"attn_impl {cfg.attn_impl}, device {model.device}")
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_dir=args.ckpt, peak_lr=args.lr,
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
