"""Fault-tolerant training driver (the reference's
``src/repro/runtime/trainer.py`` in torch).

``make_train_step`` builds the step: loss -> backward -> optional int8
error-feedback gradient compression -> optimizer, with gradient
accumulation over microbatches (f32 sums, as the reference's scan).

``Trainer`` owns the loop: periodic atomic checkpoints (async),
automatic restore-and-restart after failures (including injected ones,
for tests), a step-time watchdog that logs stragglers, and
deterministic data resume (the pipeline is addressed by step, so a
restart at step N replays exactly batch N).

The carry is {"params", "opt_state"[, "grad_error"]}: ``params`` is the
model's own parameter dict (updated in place), the rest plain dicts of
tensors - the tree a checkpoint holds.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataPipeline
from repro_torch.optim import build_optimizer, compression
from repro_torch.optim.schedule import warmup_cosine

# Checkpoints stay inside the checkout unless the caller says otherwise.
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" /
                       "repro_torch" / "ckpt")
METRIC_KEYS = ("nll", "loss", "load_balance", "router_z")
NORM_CHUNK = 1 << 26             # values of a leaf squared at a time


@torch.no_grad()
def grad_norm(grads: dict) -> torch.Tensor:
    """The global f32 norm of ``grads``, at most NORM_CHUNK values of a
    leaf at a time: a whole leaf's f32 square would be a temporary of 4
    bytes a value (25 GB for command-r-plus-104b's embedding and head)."""
    total = 0
    for g in grads.values():
        flat = g.reshape(-1)
        for s0 in range(0, flat.numel(), NORM_CHUNK):
            total = total + torch.sum(flat[s0:s0 + NORM_CHUNK]
                                      .to(torch.float32) ** 2)
    return torch.sqrt(total)


def make_train_step(model, opt, *, microbatches: int = 1,
                    grad_compression: bool = False):
    """Returns step(carry, batch) -> (carry, metrics).

    ``batch`` leaves have the global batch leading; with microbatching
    they are split into ``microbatches`` equal slices and the grads
    summed in f32, then averaged.  Metrics are 0-d f32 tensors: nll,
    loss, load_balance, router_z and grad_norm.
    """

    def step(carry, batch):
        params = carry["params"]
        for p in params.values():
            p.grad = None
        if microbatches == 1:
            loss, metrics = model.loss(batch)
            loss.backward()
            grads = {k: p.grad for k, p in params.items()}
            metrics = {k: metrics[k].detach() for k in METRIC_KEYS}
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=next(iter(grads.values())).device)
                       for k in METRIC_KEYS}
            slices = {k: torch.chunk(v, microbatches)
                      for k, v in batch.items()}
            for i in range(microbatches):
                loss, m = model.loss({k: v[i] for k, v in slices.items()})
                loss.backward()
                with torch.no_grad():
                    for k, p in params.items():
                        grads[k] += p.grad.to(torch.float32)
                        p.grad = None
                    for k in METRIC_KEYS:
                        metrics[k] += m[k].detach()
            grads = {k: g / microbatches for k, g in grads.items()}
            metrics = {k: m / microbatches for k, m in metrics.items()}
        new_carry = dict(carry)
        if grad_compression:
            grads, new_carry["grad_error"] = compression.compress_gradients(
                grads, carry["grad_error"])
        gnorm = grad_norm(grads)
        new_carry["params"], new_carry["opt_state"] = opt.update(
            grads, carry["opt_state"], params)
        for p in params.values():
            p.grad = None
        metrics["grad_norm"] = gnorm
        return new_carry, metrics

    return step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20             # 0: no checkpoints
    ckpt_dir: str = DEFAULT_CKPT_DIR
    keep: int = 3
    peak_lr: float = 3e-4
    warmup: int = 10
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    straggler_threshold: float = 10.0  # x median step time -> flagged
    max_restarts: int = 3
    async_ckpt: bool = True
    grad_compression: bool = False


class Trainer:
    """Single-host driver with the multi-host control flow in place.
    ``model`` is an ``LM``; its parameters are (re)initialized from
    ``tcfg.seed`` by a ``torch.Generator`` on the model's device, and
    batches go to that device."""

    def __init__(self, model, tcfg: TrainerConfig):
        self.model = model
        self.tcfg = tcfg
        self.device = model.device
        self.pipeline = DataPipeline.for_config(
            model.cfg, tcfg.seq_len, tcfg.global_batch, tcfg.seed)
        sched = warmup_cosine(tcfg.peak_lr, tcfg.warmup, tcfg.steps)
        self.opt = build_optimizer(model.cfg, sched)
        self.step_fn = make_train_step(
            model, self.opt, microbatches=model.cfg.microbatches,
            grad_compression=tcfg.grad_compression)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep,
                                      async_save=tcfg.async_ckpt)
        self.metrics_log: list[dict] = []
        self.events: list[str] = []

    def _init_carry(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.model.init(gen)
        params = dict(self.model.named_parameters())
        carry = {"params": params, "opt_state": self.opt.init(params)}
        if self.tcfg.grad_compression:
            carry["grad_error"] = compression.init_error(params)
        return carry

    def _batch(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipeline.batch(step).items()}

    def run(self, *, fail_at: dict[int, Exception] | None = None) -> dict:
        """Train with auto-restart.  ``fail_at`` injects failures (tests)."""
        tcfg = self.tcfg
        fail_at = dict(fail_at or {})
        restarts = 0
        carry = self._init_carry()
        start = 0
        try:
            carry, start = self.ckpt.restore_latest(carry)
            self.events.append(f"resumed from step {start}")
        except FileNotFoundError:
            pass

        step = start
        times: list[float] = []
        while step < tcfg.steps:
            try:
                if step in fail_at:
                    raise fail_at.pop(step)
                batch = self._batch(step)
                t0 = time.perf_counter()
                carry, metrics = self.step_fn(carry, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                # Straggler watchdog: in multi-host this aborts the step
                # group and triggers redistribution; here it is logged.
                if times and dt > tcfg.straggler_threshold * (
                        sorted(times)[len(times) // 2]):
                    self.events.append(f"straggler at step {step}: {dt:.3f}s")
                times.append(dt)
                metrics["step"] = step
                metrics["step_time"] = dt
                self.metrics_log.append(metrics)
                step += 1
                if tcfg.ckpt_every and (step % tcfg.ckpt_every == 0
                                        or step == tcfg.steps):
                    self.ckpt.save(step, carry)
            except (FloatingPointError, RuntimeError) as e:
                restarts += 1
                self.events.append(f"failure at step {step}: {e!r}")
                if restarts > tcfg.max_restarts:
                    raise
                carry = self._init_carry()
                try:
                    carry, step = self.ckpt.restore_latest(carry)
                    self.events.append(f"restarted from step {step}")
                except FileNotFoundError:
                    step = 0
                    self.events.append("restarted from scratch")
        self.ckpt.wait()
        return {"final_step": step, "restarts": restarts,
                "metrics": self.metrics_log, "events": self.events}
