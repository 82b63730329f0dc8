"""Mixture-of-Experts FFN: top-k router + capacity dispatch/combine.

The reference's ``models/moe.py`` (GShard/Switch generalized to top-k):
tokens are split into groups, each token is routed to its top-k experts,
each expert takes at most C = max(ceil(g/E * cf * k), k) of a group's
(token, choice) assignments in token-major order (the rest are dropped),
and the outputs are combined with the renormalized router weights.

Where the reference dispatches and combines with one-hot einsums, this
module gathers: a slot of an expert's capacity buffer holds at most one
assignment, so the dispatch einsum is a gather of that token's row (an
empty slot reads a zero row) and the combine is a gather of each kept
assignment's expert output weighted by its gate.  The assignments that
drop and the combine weights are the reference's.  Every index write
goes to a distinct slot (the dropped ones to a column that is cut off),
so no reduction depends on the order of atomics: a run on the card
repeats bit for bit.

Aux losses: Switch load balance and router z-loss, per group, averaged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _param

GROUP_SIZE = 4096  # tokens per dispatch group (GShard 'group' dimension)


class MoE(nn.Module):
    """Router (d, E), kept f32 whatever the parameter dtype, and the
    experts' SwiGLU weights ``wg``/``wu`` (E, d, ff) and ``wd`` (E, ff,
    d)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = _param((d, e), torch.float32, device)
        self.wg = _param((e, d, ff), dtype, device)
        self.wu = _param((e, d, ff), dtype, device)
        self.wd = _param((e, ff, d), dtype, device)


def groups(t: int, cfg) -> tuple[int, int, int]:
    """(group size g, groups, capacity a group) for ``t`` tokens: g is
    ``moe_group`` or min(GROUP_SIZE, 4 max(d_ff, 128)), at most t, halved
    until it divides t."""
    e, k = cfg.n_experts, cfg.moe_top_k
    auto = cfg.moe_group or min(GROUP_SIZE, 4 * max(cfg.d_ff, 128))
    g = min(auto, t)
    while t % g:
        g //= 2
    cap = max(int(math.ceil(g / e * cfg.capacity_factor * k)), k)
    return g, t // g, cap


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean one-hot of ``idx`` over ``n`` classes; unlike
    ``F.one_hot`` it reads no value back from the card to check them."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def route(p: MoE, x: torch.Tensor, cfg) -> dict:
    """The routing of x (B, S, d): f32 router ``logits`` and ``probs``
    (N, g, E), the renormalized ``gate`` (N, g, k) over the top-k experts
    ``idx`` (ties to the lower expert, as ``jax.lax.top_k``), each
    assignment's slot ``pos`` in its expert's buffer (a cumulative count
    over the group's (token, choice) order, token-major), ``keep`` = pos <
    ``cap``."""
    d = x.shape[-1]
    e, k = cfg.n_experts, cfg.moe_top_k
    g, ng, cap = groups(x.shape[0] * x.shape[1], cfg)
    xt = x.reshape(ng, g, d)
    logits = torch.einsum("ntd,de->nte", xt.to(torch.float32),
                          p.router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = vals[..., :k]
    idx = order[..., :k]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    onehot = _one_hot(idx, e).to(torch.int32).reshape(ng, g * k, e)
    pos = (torch.cumsum(onehot, dim=1) * onehot - 1).amax(dim=-1)
    pos = pos.reshape(ng, g, k)
    return {"logits": logits, "probs": probs, "gate": gate, "idx": idx,
            "pos": pos, "keep": pos < cap, "cap": cap}


def moe_apply(p: MoE, x: torch.Tensor, cfg,
              routing: dict | None = None) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (out, aux) with aux = {load_balance, router_z}.
    ``routing`` (what :func:`route` returns for x) saves recomputing it."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    r = route(p, x, cfg) if routing is None else routing
    idx, pos, keep, cap = r["idx"], r["pos"], r["keep"], r["cap"]
    ng, g = idx.shape[:2]
    dt = x.dtype
    xt = x.reshape(ng, g, d)
    slots = e * cap

    # Dispatch: the token each (expert, slot) holds, g (a zero row) where
    # none; dropped assignments write the extra column, cut off.
    flat = torch.where(keep, idx * cap + pos,
                       torch.full_like(pos, slots)).reshape(ng, g * k)
    tok = torch.arange(g, device=x.device).repeat_interleave(k)
    owner = torch.full((ng, slots + 1), g, dtype=torch.int64,
                       device=x.device)
    owner.scatter_(1, flat.to(torch.int64), tok.expand(ng, -1))
    xpad = torch.cat([xt, xt.new_zeros(ng, 1, d)], dim=1)
    expert_in = torch.gather(
        xpad, 1, owner[:, :slots, None].expand(ng, slots, d))
    ei = expert_in.reshape(ng, e, cap, d).transpose(0, 1).reshape(
        e, ng * cap, d)
    gact = torch.bmm(ei, p.wg.to(dt))
    uact = torch.bmm(ei, p.wu.to(dt))
    act = F.silu(gact.to(torch.float32)).to(dt) * uact
    eo = torch.bmm(act, p.wd.to(dt)).reshape(e, ng, cap, d).transpose(
        0, 1).reshape(ng, slots, d)

    # Combine: each kept assignment's expert output times gate * keep (in
    # x's dtype, as the reference's combine tensor), summed over the k
    # choices in f32 and rounded once.
    src = torch.where(keep, idx * cap + pos, torch.zeros_like(pos))
    got = torch.gather(eo, 1, src.reshape(ng, g * k, 1).to(
        torch.int64).expand(ng, g * k, d)).reshape(ng, g, k, d)
    w = r["gate"].to(dt) * keep.to(dt)
    out = torch.sum(w[..., None].to(torch.float32) * got.to(torch.float32),
                    dim=2).to(dt)

    # Switch load-balance loss + router z-loss (per group, averaged).
    me = torch.mean(r["probs"], dim=1)                        # (N, e)
    ce = torch.mean(_one_hot(idx[..., 0], e).to(torch.float32), dim=1)
    aux = {"load_balance": e * torch.mean(torch.sum(me * ce, dim=-1)),
           "router_z": torch.mean(
               torch.logsumexp(r["logits"], dim=-1) ** 2)}
    return out.reshape(b, s, d), aux
