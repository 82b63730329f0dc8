"""Atomic, async checkpointing with retention, over nested dicts of
tensors (the port's state dicts) - the reference's format.

A checkpoint is a directory ``step_<N>/`` holding ``arrays.npz`` (the
leaves, keyed by their "/"-joined path) and ``manifest.json`` (step,
keys, shapes, dtypes).  Writes go to ``step_<N>.tmp`` and are
``os.replace``d into place, so a crash mid-write never corrupts the
latest checkpoint.  ``CheckpointManager`` adds async background saves
(one writer, snapshots taken to host memory before ``save`` returns), a
retention policy and latest-step discovery.  bf16 leaves are stored as
f32 (npz has no bf16; the widening is lossless) and restored in the
target's dtype, on the target's device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flatten(val, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Any) -> str:
    """Atomic checkpoint write of a nested dict of tensors / numbers.
    Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _fill(target: Any, flat: dict, prefix: str = "") -> Any:
    """``target`` with every leaf replaced by the checkpoint's value:
    tensors are copied into in place (cast to their dtype), numbers
    come back as Python numbers."""
    if isinstance(target, dict):
        return {k: _fill(v, flat, f"{prefix}{k}/") for k, v in target.items()}
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key]
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.asarray(arr)).to(target.dtype))
        return target
    return type(target)(arr)


def restore(directory: str, step: int | None, target: Any) -> tuple[Any, int]:
    """Restore into the structure (and tensors) of ``target``; returns
    (tree, step).  ``step=None`` takes the latest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    return _fill(target, flat), step


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(directory)
             if n.startswith("step_") and not n.endswith(".tmp")]
    return max(steps) if steps else None


class CheckpointManager:
    """Async saves + retention.  ``save`` returns once the tree is on the
    host; the previous pending save is awaited first (one writer)."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._worker = None
        self._error: Exception | None = None

    def _run(self, step, host_tree):
        try:
            save(self.directory, step, host_tree)
            self._gc()
        except Exception as e:  # surfaced on the next wait()
            self._error = e

    def save(self, step: int, tree: Any):
        self.wait()
        host_tree = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if not self.async_save:
            self._run(step, host_tree)
            return
        self._worker = threading.Thread(target=self._run,
                                        args=(step, host_tree), daemon=True)
        self._worker.start()

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, target):
        self.wait()
        return restore(self.directory, None, target)
