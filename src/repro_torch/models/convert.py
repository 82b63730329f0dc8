"""Parameter bridge from the reference package to the port.

The reference's parameters are a nested dict of arrays (take
``jax.tree.map(np.asarray, model.init(key))`` to get numpy leaves).  Its
layer leaves are stacked along a leading ``groups`` axis for
``lax.scan``: ``params["layers"]["l{i}"][...]`` has shape (groups, ...),
and layer ``g * period + i`` is slice ``g``.  The port keeps one module
per layer, so this unstacks them; every leaf keeps its layout (``wq``
(d_model, H, dh), ``wo`` (H, dh, d_model), ...), which is why both
packages compute the same function after conversion.

:func:`reference_tree_from_state_dict` is the reverse view: any dict
keyed by the port's parameter names (gradients, AdamW moments, master
weights) restacked into the reference's nested, scan-stacked tree, so
the two packages can be compared leaf by leaf.

This module imports neither jax nor the reference: it takes and gives
plain numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import period_pattern


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def reference_leaf(name: str, period: int) -> tuple[str, int | None]:
    """The reference leaf a port parameter name belongs to, and its slice
    of the leaf's stacked axis: "layers.{g * period + i}.rest" ->
    ("layers.l{i}.rest", g); any other name -> (name, None)."""
    if not name.startswith("layers."):
        return name, None
    _, idx, rest = name.split(".", 2)
    g, i = divmod(int(idx), period)
    return f"layers.l{i}.{rest}", g


def state_dict_from_reference(ref_params: dict, cfg) -> dict:
    """Reference params (numpy leaves) -> the port's ``state_dict``
    (numpy leaves, keys as in :class:`repro_torch.models.model.LM`)."""
    period = period_pattern(cfg)[2]
    out = {}
    for name, val in _flatten(ref_params):
        if not name.startswith("layers."):
            out[name] = np.asarray(val)
            continue
        _, li, rest = name.split(".", 2)          # "layers", "l{i}", leaf
        i = int(li[1:])
        for g in range(np.shape(val)[0]):
            out[f"layers.{g * period + i}.{rest}"] = np.asarray(val[g])
    return out


def reference_tree_from_state_dict(sd: dict, cfg) -> dict:
    """Port-keyed leaves (tensors or arrays, keys as in ``LM``'s
    ``state_dict``) -> the reference's nested tree of numpy f32 arrays,
    layer leaves stacked (groups, ...) under ``layers.l{i}``."""
    period = period_pattern(cfg)[2]
    tree: dict = {}
    stacks: dict = {}
    for name, val in sd.items():
        arr = (val.detach().to(torch.float32).cpu().numpy()
               if isinstance(val, torch.Tensor)
               else np.asarray(val, np.float32))
        ref, g = reference_leaf(name, period)
        if g is None:
            _insert(tree, name.split("."), arr)
        else:
            stacks.setdefault(ref, {})[g] = arr
    for ref, by_group in stacks.items():
        stacked = np.stack([by_group[g] for g in sorted(by_group)])
        _insert(tree, ref.split("."), stacked)
    return tree


def _insert(tree: dict, path: list[str], val) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


@torch.no_grad()
def load_reference_params(model, ref_params: dict):
    """Copy the reference's parameters into ``model`` (an ``LM``), cast
    to its parameter dtype and device.  Every parameter must be covered
    and no reference leaf left over.  Returns the model."""
    sd = state_dict_from_reference(ref_params, model.cfg)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"parameter mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, val in sd.items():
        dst = own[name]
        if tuple(dst.shape) != tuple(val.shape):
            raise ValueError(f"{name}: shape {val.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.tensor(np.asarray(val, np.float32)).to(dst.dtype))
    return model
