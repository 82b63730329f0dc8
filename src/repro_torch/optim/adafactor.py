"""Adafactor (Shazeer & Stern 2018), the reference's rule
(``src/repro/optim/adafactor.py``): factored second moments, decay 0.8,
eps1 1e-30, eps2 1e-3, update clipping at RMS 1, a step scaled by the
parameter's RMS, no f32 master copy.

The reference updates its scan-stacked tree: every layer parameter is one
leaf of shape (groups, ...) under ``layers.l{i}``, holding layer ``g *
period + i`` at slice g.  The port keeps one tensor per layer, so this
optimizer groups them back by reference leaf
(:func:`repro_torch.models.convert.reference_leaf`) and computes each
leaf's statistics over the whole group:

* a leaf is factored when its *stacked* shape has two axes or more - so
  a layer's 1-D norm scale is, with ``vr`` one value a layer and ``vc``
  a mean across the layers;
* ``rms_u`` and the parameter scale are means over the whole stacked
  leaf, every layer of it.

State is ``{"f": {reference leaf name: {"vr", "vc"} or {"v"}}, "step"}``
with the reference's stacked shapes, so it restacks into the reference's
tree and survives the port's checkpoints as it is.

A stacked leaf of 1-D tensors is updated as one (1, layers, d) tensor
(a copy, whose rows go back to the layers' tensors), so every factored
leaf takes one path.

``update`` works in place, as ``AdamW.update``, in three passes over a
leaf: the moment statistics and the parameter's RMS, then the RMS of the
unclipped update, then the update.  Each pass walks the leaf in chunks of
at most ``chunk_elems`` values (whole rows of its last axis), so the f32
temporaries stay bounded however large the leaf (command-r-plus-104b's
embedding is 3.15e9 values); ``chunk_elems=None`` takes each tensor whole.
Chunking changes only the order of the sums.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.models.convert import reference_leaf


DECAY, EPS1, EPS2, CLIP_THRESHOLD = 0.8, 1e-30, 1e-3, 1.0


def _f32(x) -> float:
    return float(np.float32(x))


def _f32_copy(t: torch.Tensor) -> torch.Tensor:
    """An f32 copy to work on in place (one temporary the size of t)."""
    return t.to(torch.float32, copy=True)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One reference leaf: the port's tensors of it, in stacked order.
    ``stacked``: a layer leaf, shape (len(names), *part_shape)."""

    names: tuple[str, ...]
    part_shape: tuple[int, ...]
    stacked: bool

    @property
    def shape(self) -> tuple[int, ...]:
        lead = (len(self.names),) if self.stacked else ()
        return lead + self.part_shape

    @property
    def factored(self) -> bool:
        return len(self.shape) >= 2


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr_schedule: Callable[[int], float]
    period: int = 1                 # layer period of the reference's stack
    chunk_elems: int | None = 1 << 26

    def leaves(self, params: dict) -> dict[str, _Leaf]:
        """Reference leaf name -> the port's tensors of it."""
        groups: dict[str, dict[int | None, str]] = {}
        for name in params:
            ref, g = reference_leaf(name, self.period)
            groups.setdefault(ref, {})[g] = name
        out = {}
        for ref, by_g in groups.items():
            stacked = None not in by_g
            names = tuple(by_g[g] for g in sorted(by_g)) if stacked \
                else (by_g[None],)
            if stacked and sorted(by_g) != list(range(len(by_g))):
                raise ValueError(f"{ref}: layers {sorted(by_g)} do not "
                                 "stack")
            shape = tuple(params[names[0]].shape)
            if stacked and not shape:
                raise NotImplementedError(f"{ref}: a per-layer scalar")
            out[ref] = _Leaf(names, shape, stacked)
        return out

    @torch.no_grad()
    def init(self, params: dict) -> dict:
        dev = next(iter(params.values())).device
        f = {}
        for ref, leaf in self.leaves(params).items():
            shp = leaf.shape
            if not leaf.factored:
                f[ref] = {"v": torch.zeros(shp, dtype=torch.float32,
                                           device=dev)}
            else:
                f[ref] = {"vr": torch.zeros(shp[:-1], dtype=torch.float32,
                                            device=dev),
                          "vc": torch.zeros(shp[:-2] + shp[-1:],
                                            dtype=torch.float32, device=dev)}
        return {"f": f, "step": 0}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        step = state["step"] + 1
        lr = _f32(self.lr_schedule(step))
        beta = _f32(np.float32(1.0) - np.float32((step + 1.0) ** -DECAY))
        for ref, leaf in self.leaves(params).items():
            self._update_leaf(leaf, [grads[n] for n in leaf.names],
                              [params[n] for n in leaf.names],
                              state["f"][ref], lr, beta)
        state["step"] = step
        return params, state

    # ------------------------------------------------------------ a leaf
    def _rows(self, n_rows: int, row: int) -> int:
        if self.chunk_elems is None:
            return n_rows
        return max(1, min(n_rows, self.chunk_elems // max(row, 1)))

    def _chunks(self, t: torch.Tensor):
        """(a, r) slices of ``t`` viewed (A, R, C): whole A-slices when A
        > 1, else runs of rows."""
        a_n, r_n, c_n = t.shape
        if a_n > 1:
            k = self._rows(a_n, r_n * c_n)
            for a0 in range(0, a_n, k):
                yield slice(a0, a0 + k), slice(None)
        else:
            k = self._rows(r_n, c_n)
            for r0 in range(0, r_n, k):
                yield slice(0, 1), slice(r0, r0 + k)

    def _update_leaf(self, leaf: _Leaf, grads, params, st, lr, beta):
        one_m = _f32(np.float32(1.0) - np.float32(beta))
        n = math.prod(leaf.shape)

        def g2(g):
            return _f32_copy(g).square_().add_(EPS1)

        # Pass 1: moments and sum p^2 (the scalars stay on the device).
        dev = params[0].device
        sum_p2 = torch.zeros((), dtype=torch.float64, device=dev)
        for p in params:
            for _, pc in self._flat_slices(p):
                sum_p2 += torch.sum(_f32_copy(pc).square_(),
                                    dtype=torch.float64)
        parts = self._parts(leaf, grads, params, st)
        if not leaf.factored:
            v = st["v"].view(-1)
            for (sl, gc) in self._flat_slices(grads[0]):
                v[sl] = beta * v[sl] + one_m * g2(gc)
        for g3, _, vr3, vc3 in parts:
            col = torch.zeros(vc3.shape, dtype=torch.float32, device=dev)
            for asl, rsl in self._chunks(g3):
                x = g2(g3[asl, rsl])
                vr3[asl, rsl] = beta * vr3[asl, rsl] + one_m * \
                    torch.mean(x, dim=-1)
                col[asl] += torch.sum(x, dim=-2)
            vc3.copy_(beta * vc3 + one_m * (col / g3.shape[1]))

        # Pass 2: the RMS of the unclipped update; pass 3: the update.
        scale = torch.clamp(torch.sqrt((sum_p2 / n).to(torch.float32)),
                            min=EPS2)
        sum_u2 = torch.zeros((), dtype=torch.float64, device=dev)
        for u, _, _ in self._updates(leaf, grads, params, st, parts):
            sum_u2 += torch.sum(u.square_(), dtype=torch.float64)
        rms_u = torch.sqrt((sum_u2 / n).to(torch.float32) + EPS1)
        clip = torch.clamp(rms_u / CLIP_THRESHOLD, min=1.0)
        step = lr * scale
        for u, pv, sl in self._updates(leaf, grads, params, st, parts):
            pf = _f32_copy(pv[sl])
            pf.sub_(u.div_(clip).mul_(step))
            pv[sl] = pf.to(pv.dtype)
        if leaf.stacked and len(leaf.part_shape) == 1:
            for j, p in enumerate(params):
                p.copy_(parts[0][1][0, j])

    def _parts(self, leaf, grads, params, st):
        """A factored leaf as (grad, param, vr, vc) views: each tensor
        (A, R, C) with vr (A, R) and vc (A, C); a stacked leaf of 1-D
        tensors as one stacked copy (1, layers, d)."""
        if not leaf.factored:
            return []
        vr, vc = st["vr"], st["vc"]
        if len(leaf.part_shape) == 1:
            g, p = torch.stack(grads)[None], torch.stack(params)[None]
            return [(g, p, vr.view(1, -1), vc.view(1, -1))]
        out = []
        for j, (g, p) in enumerate(zip(grads, params)):
            *lead, r_n, c_n = g.shape
            a_n = math.prod(lead)
            vrj, vcj = (vr[j], vc[j]) if leaf.stacked else (vr, vc)
            out.append((g.reshape(a_n, r_n, c_n), p.view(a_n, r_n, c_n),
                        vrj.view(a_n, r_n), vcj.view(a_n, c_n)))
        return out

    def _flat_slices(self, t):
        flat = t.reshape(-1)
        k = self._rows(flat.numel(), 1)
        for s0 in range(0, flat.numel(), k):
            sl = slice(s0, s0 + k)
            yield sl, flat[sl]

    def _updates(self, leaf, grads, params, st, parts):
        """(f32 update chunk, the param's view, its slice) over the leaf,
        before clipping."""
        if not leaf.factored:
            v = st["v"].view(-1)
            pv = params[0].view(-1)
            for sl, gc in self._flat_slices(grads[0]):
                yield _f32_copy(gc).div_(torch.sqrt(
                    torch.clamp(v[sl], min=EPS1))), pv, sl
        for g3, p3, vr3, vc3 in parts:
            denom = torch.mean(vr3, dim=-1, keepdim=True)
            for asl, rsl in self._chunks(g3):
                r = torch.sqrt(torch.clamp(vr3[asl, rsl] / denom[asl],
                                           min=EPS1))
                c = torch.sqrt(torch.clamp(vc3[asl], min=EPS1))
                u = _f32_copy(g3[asl, rsl]).div_(r[..., None]) \
                    .div_(c[:, None, :])
                yield u, p3, (asl, rsl)
