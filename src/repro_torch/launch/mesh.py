"""Serving meshes over ``torch.distributed``, and the rank launcher.

The reference lays ``dp * tp`` devices out as a ("data", "model") grid
and runs one process over all of them (``shard_map``).  The port runs
one process a shard: ranks are laid out as the reference's ``(dp, tp)``
device grid, rank = data index * tp + model index.  The "model" axis
KV-head-shards the paged pools (tensor parallelism); the "data" axis
splits the slots of every paged attention call (data parallelism).
:class:`Mesh` holds the axis sizes, this rank's place on them, one
process group per axis and one over every rank, the rank's device and
the seconds each of its collectives waits for the other ranks, and does
the three collectives the paged path needs: the triplet all-gather over
an axis, a MAX over every rank and rank 0's broadcast of each step's
inputs.

Backends: NCCL on ``cuda`` (one rank a card) and gloo on ``cpu``.  NCCL
refuses two ranks on one card, so ``backend="gloo"`` with a ``cuda``
device puts several ranks on one card; gloo then moves every tensor
through host memory (the collectives here copy to the host
explicitly), so it checks the sharded path's results and routes, not
NVLink's speed.

:func:`run_ranks` starts the ranks: this process is rank 0 and runs
``lead``, the others are spawned (the ``spawn`` start method, so
``follower`` must be a function of an importable module) and run
``follower``.  They meet through a file store under a fresh directory,
not a fixed port; the kernels are built once before the spawn.  Under
``torchrun`` (``WORLD_SIZE`` set) nothing is spawned: each process runs
the side its ``RANK`` names, in the group torchrun's environment gives.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import shutil
import tempfile
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass
class Mesh:
    """This rank's view of a ("data", "model") serving mesh."""
    shape: dict                 # {"data": dp, "model": tp}
    rank: int
    data_index: int
    model_index: int
    device: torch.device
    backend: str | None         # None: one shard, no process group
    groups: dict = dataclasses.field(default_factory=dict)   # axis -> group
    timeout: float | None = None    # s a collective waits for the others

    @property
    def world(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """Where the backend takes ``t``: gloo's copy on the host."""
        return t.cpu() if self.backend == "gloo" else t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` of every rank on this rank's ``axis`` line, stacked in
        axis order (index 0 first): (size, *t.shape) on t's device."""
        n = self.shape[axis]
        if n == 1:
            return t[None]
        src = self._host(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.groups[axis])
        return torch.stack(parts).to(t.device)

    def all_reduce_max(self, value: int) -> int:
        """The largest ``value`` over every rank."""
        if self.world == 1:
            return int(value)
        dev = "cpu" if self.backend == "gloo" else self.device
        t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.groups["world"])
        return int(t.item())

    def broadcast_object(self, obj=None):
        """Rank 0's ``obj`` on every rank (pickled)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.groups["world"])
        return box[0]


def check_degrees(tp: int, dp: int) -> None:
    if tp < 1 or dp < 1:
        raise ValueError(f"tp and dp must be >= 1, got tp={tp} dp={dp}")


def check_devices(tp: int, dp: int, found: int) -> None:
    """NCCL puts one rank on each card: ``tp * dp`` cards or an error."""
    need = tp * dp
    if found < need:
        raise RuntimeError(
            f"tp={tp} x dp={dp} needs {need} devices, found {found}; "
            f"pass backend='gloo' to put several ranks on one card")


def default_backend(device) -> str:
    """NCCL on ``cuda``, gloo on ``cpu``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


# The seconds the process group this process joined by run_ranks waits
# in a collective (None: not joined by run_ranks).
_joined_timeout: float | None = None


def default_timeout(backend: str) -> float:
    """How long a mesh's collective waits by default: what :func:`run_ranks`
    started the ranks with, else torch's default for ``backend``."""
    if _joined_timeout is not None:
        return _joined_timeout
    from torch.distributed import constants
    t = (constants.default_pg_nccl_timeout if backend == "nccl" else None) \
        or constants.default_pg_timeout
    return t.total_seconds()


def make_tp_dp_mesh(tp: int, dp: int, *, device=None, backend=None,
                    timeout: float | None = None) -> Mesh:
    """Composed serving mesh: ("data"=dp, "model"=tp) over ``dp * tp``
    ranks, this process one of them, in the default process group
    (:func:`run_ranks`'s, or torchrun's, joined here).  ``backend`` None
    picks :func:`default_backend`: NCCL is one rank a card (rank r on
    card r, or ``LOCAL_RANK``'s under torchrun); ``backend="gloo"`` on
    ``cuda`` puts every rank on ``device``.  Every collective of the mesh
    waits ``timeout`` seconds for the other ranks (None:
    :func:`default_timeout`); a serving engine's rank 0 keeps its idle
    followers inside it (``ServingEngine.keepalive``).
    Makes one group over every rank and one per line of each axis: every
    rank must call it with the same arguments, in the same order as its
    other meshes."""
    check_degrees(tp, dp)
    dev = torch.device("cuda" if device is None else device)
    need = tp * dp
    if need == 1:
        return Mesh({"data": 1, "model": 1}, 0, 0, 0, resolve_device(dev),
                    None)
    backend = backend or default_backend(dev)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL serves ranks on cuda devices; the CPU "
                             "takes gloo")
        check_devices(tp, dp, torch.cuda.device_count())
    dev = resolve_device(dev)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"a mesh of {need} ranks needs its ranks: start them with "
                f"repro_torch.launch.mesh.run_ranks or torchrun")
        dist.init_process_group(backend, init_method="env://")
    if dist.get_world_size() != need:
        raise RuntimeError(f"tp={tp} x dp={dp} needs {need} ranks, the "
                           f"process group has {dist.get_world_size()}")
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"the mesh asks for {backend}")
    rank = dist.get_rank()
    if backend == "nccl":
        dev = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
        torch.cuda.set_device(dev)
    d_idx, m_idx = divmod(rank, tp)
    timeout = default_timeout(backend) if timeout is None else float(timeout)
    groups = {}
    # Every rank makes every group, in one order (new_group is
    # collective); each keeps the line it is on.
    for axis, lines in (("world", [list(range(need))]),
                        ("model", [[d * tp + m for m in range(tp)]
                                   for d in range(dp)]),
                        ("data", [[d * tp + m for d in range(dp)]
                                  for m in range(tp)])):
        if len(lines[0]) == 1:
            continue
        for ranks in lines:
            g = dist.new_group(ranks, timeout=datetime.timedelta(
                seconds=timeout))
            if rank in ranks:
                groups[axis] = g
    return Mesh({"data": dp, "model": tp}, rank, d_idx, m_idx, dev, backend,
                groups, timeout)


def make_tp_mesh(tp: int, **kw) -> Mesh:
    """Tensor-parallel serving mesh: ("data"=1, "model"=tp)."""
    return make_tp_dp_mesh(tp, 1, **kw)


# ------------------------------------------------------------ launcher
def _join(group: tuple, rank: int) -> None:
    """Join the process group ``group`` = (backend, init method, world,
    timeout s) as ``rank``."""
    global _joined_timeout
    backend, init, world, timeout = group
    _joined_timeout = float(timeout)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))


def _follower_main(follower, args, group, rank, out):
    """Body of a spawned rank: one torch thread, the group joined,
    ``follower(*args)``, the group left in every case; the result (or
    the traceback) pickled to ``out``."""
    torch.set_num_threads(1)
    try:
        _join(group, rank)
        res = {"ok": follower(*args)}
        if dist.is_initialized():
            dist.barrier()
    except BaseException:         # noqa: BLE001 - reported to rank 0
        res = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    tmp = f"{out}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(res, f)
    os.replace(tmp, out)


def run_ranks(lead, follower, world: int, *, args: tuple = (),
              device=None, backend: str | None = None,
              timeout: float = 600.0):
    """Run ``lead()`` here as rank 0 of ``world`` ranks and
    ``follower(*args)`` on ranks 1.. in spawned processes; returns
    (lead's result, [each follower's result]).

    Every rank joins one process group (``backend``, default
    :func:`default_backend` of ``device``) before its side runs, and
    makes its mesh in it (:func:`make_tp_dp_mesh`).  Every rank runs one
    torch thread (this one's count comes back after).  On a ``cuda``
    device the kernels are built here before the spawn, so that the
    ranks load one build.  The ranks meet at a file store under a fresh
    temporary directory; ``timeout`` seconds bound the meeting, every
    collective (a mesh's too, unless it is given its own) and the wait
    for each follower once ``lead`` has returned; a follower that fails
    raises its traceback here.  Under torchrun this process
    runs its own side only and nothing is spawned."""
    if world == 1:
        return lead(), []
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["RANK"]) == 0:
            return lead(), []
        return None, [follower(*args)]
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import cuda_lib
        cuda_lib.build()
    base = Path(tempfile.mkdtemp(prefix="repro_torch_ranks."))
    group = (backend or default_backend(dev), f"file://{base / 'store'}",
             world, timeout)
    outs = [base / f"rank{r}.pkl" for r in range(world)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_follower_main, daemon=True,
                         args=(follower, args, group, r, str(outs[r])))
             for r in range(1, world)]
    for p in procs:
        p.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ok = False
    try:
        _join(group, 0)
        out = lead()
        ok = True
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.set_num_threads(threads)
        for p in procs:
            p.join(timeout if ok else 10.0)
            if p.is_alive():
                p.terminate()
                p.join(10.0)
        results = []
        for r, p in zip(range(1, world), procs):
            path = outs[r]
            res = pickle.loads(path.read_bytes()) if path.exists() else {
                "error": f"rank {r} left no result (exit code "
                         f"{p.exitcode})"}
            results.append(res)
        shutil.rmtree(base, ignore_errors=True)
    for r, res in enumerate(results, start=1):
        if "error" in res:
            raise RuntimeError(f"rank {r} of {world} failed:\n"
                               f"{res['error']}")
    return out, [res["ok"] for res in results]
