"""What the ranks other than 0 of a serving mesh run.

:func:`repro_torch.launch.mesh.run_ranks` spawns them, and the spawn
start method imports their entry function by name: these live here, in
the package.

* :func:`cli_follower` - a serving CLI's other ranks: the CLI's own
  ``follow(argv)``, which builds the same model and engine on the rank's
  mesh and follows rank 0 until it stops.
* :func:`follow_jobs` - a list of engine jobs on one set of ranks, each
  on a mesh of its own (tp, dp): each builds a ``ServingEngine`` with the
  job's keywords over one of ``models`` and follows rank 0's driving of
  it.  Rank 0 runs the same list, driving each engine itself.

Models travel as specs: {"cfg": ModelConfig, "state": {name: ndarray}}
(the exact weights) or {"cfg": ..., "seed": s} (``LM.init`` from a
generator seeded with s on the rank's device, as every rank draws the
same weights there), and "layers": n keeps the first n layers of either.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from repro_torch.launch.mesh import make_tp_dp_mesh


def cli_follower(module: str, argv: list[str]) -> None:
    """Rank > 0 of a serving CLI (``module``, e.g.
    ``repro_torch.launch.serve``) started with ``argv``."""
    importlib.import_module(module).follow(argv)


def build_lm(spec: dict, device: torch.device):
    """The model a spec names, on ``device``."""
    from repro_torch.models.model import LM
    model = LM(spec["cfg"], device=device)
    if spec.get("state") is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in spec["state"].items()})
    else:
        model.init(torch.Generator(device=device).manual_seed(spec["seed"]))
    if spec.get("layers") is not None:
        cut_depth(model, spec["layers"])
    return model


def cut_depth(model, n: int):
    """Keep the first ``n`` layers of ``model`` (embedding, final norm and
    head as they are), in place: the same weights at a cut depth."""
    model.layers = torch.nn.ModuleList(list(model.layers)[:n])
    model.cfg = dataclasses.replace(model.cfg, n_layers=n)
    return model


def engine_report(eng, finished: list) -> dict:
    """What a rank reports of an engine run: its finished requests by
    rid, the stats, the measured pool bytes a shard and the paged
    launches by route since the job began."""
    from repro_torch.kernels import cuda_lib
    eng.cache.check_invariants()
    return {"finished": {f.rid: f for f in finished},
            "stats": dict(eng.stats),
            "pool_bytes_per_shard": eng.pool_bytes_per_shard(),
            "launches": {k: dict(v)
                         for k, v in cuda_lib.paged_launches.items()}}


def reset_launches() -> None:
    from repro_torch.kernels import cuda_lib
    for routes in cuda_lib.paged_launches.values():
        for r in routes:
            routes[r] = 0


def follow_jobs(mesh_kw: dict, models: dict, jobs: list[dict]) -> list:
    """Rank > 0's side of ``jobs``: each job names its "mesh" (tp, dp),
    its "model" (a key of ``models``) and its "engine" keywords.
    ``mesh_kw`` (device, backend, timeout) goes to every
    :func:`make_tp_dp_mesh`.  Returns :func:`engine_report` a job."""
    from repro_torch.serving import ServingEngine
    meshes: dict = {}
    built: dict = {}
    out = []
    for job in jobs:
        key = tuple(job["mesh"])
        if key not in meshes:
            meshes[key] = make_tp_dp_mesh(*key, **mesh_kw)
        mesh = meshes[key]
        name = job["model"]
        if name not in built:
            built[name] = build_lm(models[name], mesh.device)
        reset_launches()
        eng = ServingEngine(built[name], mesh=mesh, device=mesh.device,
                            **job["engine"])
        out.append(engine_report(eng, eng.follow()))
    return out
