"""Parameter bridge from the reference package to the port.

The reference's parameters are a nested dict of arrays (take
``jax.tree.map(np.asarray, model.init(key))`` to get numpy leaves).  Its
layer leaves are stacked along a leading ``groups`` axis for
``lax.scan``: ``params["layers"]["l{i}"][...]`` has shape (groups, ...),
and layer ``g * period + i`` is slice ``g``.  The port keeps one module
per layer, so this unstacks them; every leaf keeps its layout (``wq``
(d_model, H, dh), ``wo`` (H, dh, d_model), ...), which is why both
packages compute the same function after conversion.

This module imports neither jax nor the reference: it takes plain
numpy arrays.
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
