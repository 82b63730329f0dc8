"""Mamba-2 (SSD, state-space duality) mixer layer - arXiv:2405.21060 -
the reference's ``src/repro/models/mamba2.py`` in torch.

The chunked SSD forward for training and prefill (an intra-chunk matmul
and an inter-chunk state recurrence in f32) and a constant-memory
single-token decode step.  Separate z / x / B / C / dt projections, as
the reference keeps them.  Mamba has no softmax, so the paper's H-FA
rail does not apply inside this mixer and it runs no attention kernel.

The reference's behaviours kept here (ROADMAP.md Queue 3 C):
* With a state given and S > 1 (a prefill into the dense cache), the
  chunked scan starts from a zero SSM state: the incoming ``ssm`` is not
  read, the incoming conv windows are.
* The chunk is ``min(cfg.m_chunk, S)`` and must divide S, so a prompt
  longer than ``m_chunk`` (128) must be a multiple of it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import lns
from repro_torch.models.layers import _head_rmsnorm, _param

DT_LIMIT = (1e-3, 1e2)


class Mamba2(nn.Module):
    """The mixer's parameters, named and laid out as the reference's
    (``wz`` (d_model, d_inner), ..., ``conv_x`` (m_conv, d_inner), ``wo``
    (d_inner, d_model)); ``A_log``, ``D`` and ``dt_bias`` are f32 at any
    parameter dtype."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, din, h, gn, cw = dims(cfg)
        for name, shape in (("wz", (d, din)), ("wx", (d, din)),
                            ("wB", (d, gn)), ("wC", (d, gn)),
                            ("wdt", (d, h)), ("conv_x", (cw, din)),
                            ("conv_B", (cw, gn)), ("conv_C", (cw, gn))):
            setattr(self, name, _param(shape, dtype, device))
        for name in ("A_log", "D", "dt_bias"):
            setattr(self, name, _param((h,), torch.float32, device))
        self.norm = _param((din,), dtype, device)
        self.wo = _param((din, d), dtype, device)


def dims(cfg) -> tuple[int, int, int, int, int]:
    """(d_model, d_inner, heads, ngroups * d_state, conv width)."""
    d = cfg.d_model
    din = cfg.m_expand * d
    return d, din, din // cfg.m_headdim, cfg.m_ngroups * cfg.m_dstate, \
        cfg.m_conv


def draw_scales(cfg) -> dict:
    """Weight name -> the scale of its normal draw, in the reference's key
    order (``mamba_init``'s split(key, 9))."""
    d, din, _, _, cw = dims(cfg)
    s_in, s_conv = 1.0 / math.sqrt(d), 1.0 / math.sqrt(cw)
    return {"wz": s_in, "wx": s_in, "wB": s_in, "wC": s_in, "wdt": s_in,
            "conv_x": s_conv, "conv_B": s_conv, "conv_C": s_conv,
            "wo": 1.0 / math.sqrt(din)}


def a_log_init(h: int) -> torch.Tensor:
    """``jnp.log(jnp.linspace(1.0, 16.0, h))`` bit for bit: XLA computes
    point i < h - 1 as fma(i, f32(16 c), 1 - i c) with c = f32(1 / (h -
    1)), then its f32 log (``lns.log_f32``)."""
    f32 = np.float32
    if h == 1:
        lin = torch.ones(1)
    else:
        c1 = f32(1.0) / f32(h - 1)
        c2 = f32(16.0) * c1
        i = torch.arange(h - 1, dtype=torch.float32)
        lin = torch.cat([lns.fma_f32(i, float(c2), 1.0 - i * float(c1)),
                         torch.tensor([16.0])])
    return lns.log_f32(lin)


@torch.no_grad()
def fill_constants_(m: Mamba2) -> None:
    """The reference's non-random initial values: A_log = log(linspace(1,
    16, h)), D = 1, dt_bias = 0, norm = 1."""
    m.A_log.copy_(a_log_init(m.A_log.shape[0]))
    m.D.fill_(1.0)
    m.dt_bias.zero_()
    m.norm.fill_(1.0)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: torch.Tensor | None = None):
    """Depthwise causal conv.  x (B, S, C), w (W, C); ``state`` the
    trailing (B, W-1, C) window of the previous call.  Returns (y, the
    new window)."""
    bw = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], bw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, S+W-1, C)
    s = x.shape[1]
    y = 0
    for i in range(bw):
        y = y + xp[:, i:i + s, :] * w[i][None, None, :]
    return y, (xp[:, -(bw - 1):, :] if bw > 1 else pad)


def ssd_chunked(u, dA, Bm, Cm, chunk: int):
    """The chunked SSD scan.  u (B, S, H, P) dt-weighted inputs, dA (B, S,
    H) log-decay increments (<= 0), Bm and Cm (B, S, H, N).  Returns y
    (B, S, H, P) and the final state (B, H, N, P), f32."""
    b, s, h, pdim = u.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    nc = s // chunk

    def ck(x):
        return x.reshape((b, nc, chunk) + tuple(x.shape[2:]))

    uc, dAc, Bc, Cc = ck(u), ck(dA), ck(Bm), ck(Cm)
    cs = torch.cumsum(dAc, dim=2)                          # (B,nc,Q,H)
    # Intra-chunk (the attention-like quadratic-in-Q term).
    att = torch.einsum("bcqhn,bcthn->bchqt", Cc, Bc)
    ldiff = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # (B,nc,Q,T,H)
    ldiff = torch.movedim(ldiff, -1, 2)                    # (B,nc,H,Q,T)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=u.device))
    # Mask BEFORE exp: above the diagonal ldiff is positive and exp would
    # overflow, poisoning the gradients through the where.
    decay = torch.exp(torch.where(causal, ldiff,
                                  torch.full_like(ldiff, -1e9)))
    y_intra = torch.einsum("bchqt,bcthp->bcqhp", att * decay, uc)
    # Each chunk's outgoing state and total decay.
    dte = torch.exp(cs[:, :, -1:, :] - cs)                 # to chunk end
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", dte, Bc, uc)
    tot = torch.exp(cs[:, :, -1, :])                       # (B,nc,H)
    # The inter-chunk recurrence, in f32.
    hstate = torch.zeros((b, h, n, pdim), dtype=torch.float32,
                         device=u.device)
    h_in = []
    for c in range(nc):
        h_in.append(hstate)
        hstate = hstate * tot[:, c].to(torch.float32)[..., None, None] \
            + states[:, c].to(torch.float32)
    h_in = torch.stack(h_in, dim=1)                        # entering chunk
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Cc,
                           h_in.to(Cc.dtype)) * torch.exp(cs)[..., None]
    return (y_intra + y_inter).reshape(b, s, h, pdim), hstate


def mamba_apply(p: Mamba2, x: torch.Tensor, cfg, *, state=None,
                chunk: int | None = None):
    """x (B, S, d_model); ``state`` None (training) or {"ssm", "conv_x",
    "conv_B", "conv_C"}.  Returns (out, new state).  With a state and S
    == 1 (decode) the recurrent step; otherwise the chunked scan."""
    b, s, _ = x.shape
    _, din, h, _, _ = dims(cfg)
    pdim, n = cfg.m_headdim, cfg.m_dstate

    def proj(w):
        return torch.einsum("bsd,de->bse", x, w.to(x.dtype))

    z, xr, Br, Cr, dt = (proj(w) for w in (p.wz, p.wx, p.wB, p.wC, p.wdt))
    cs = {} if state is None else state
    xr, cx = causal_conv(xr, p.conv_x.to(x.dtype), cs.get("conv_x"))
    Br, cB = causal_conv(Br, p.conv_B.to(x.dtype), cs.get("conv_B"))
    Cr, cC = causal_conv(Cr, p.conv_C.to(x.dtype), cs.get("conv_C"))
    xr, Br, Cr = (F.silu(t.to(torch.float32)) for t in (xr, Br, Cr))

    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)
    dt = torch.clamp(dt, DT_LIMIT[0], DT_LIMIT[1])          # (B, S, H)
    dA = dt * -torch.exp(p.A_log)                           # <= 0
    xh = xr.reshape(b, s, h, pdim)
    u = xh * dt[..., None]
    # ngroups == 1: B and C broadcast across the heads.
    Bm = torch.broadcast_to(Br.reshape(b, s, 1, n), (b, s, h, n))
    Cm = torch.broadcast_to(Cr.reshape(b, s, 1, n), (b, s, h, n))

    if state is not None and s == 1:
        decay = torch.exp(dA[:, 0])                         # (B, H)
        upd = torch.einsum("bhn,bhp->bhnp", Bm[:, 0], u[:, 0])
        hst = cs["ssm"] * decay[..., None, None] + upd
        y = torch.einsum("bhn,bhnp->bhp", Cm[:, 0], hst)[:, None]
    else:
        y, hst = ssd_chunked(u, dA, Bm, Cm, chunk or min(cfg.m_chunk, s))
    new_state = {"ssm": hst, "conv_x": cx, "conv_B": cB, "conv_C": cC}

    y = y + xh * p.D[None, None, :, None]
    y = y.reshape(b, s, din) * F.silu(z.to(torch.float32))
    y = _head_rmsnorm(p.norm, y.to(x.dtype))
    return torch.einsum("bse,ed->bsd", y, p.wo.to(x.dtype)), new_state


def mamba_init_state(cfg, batch: int, dtype, device) -> dict:
    """A zero decode state: the f32 SSM state and the conv windows in
    ``dtype``."""
    _, din, h, gn, cw = dims(cfg)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"ssm": zeros((batch, h, cfg.m_dstate, cfg.m_headdim),
                         torch.float32),
            "conv_x": zeros((batch, cw - 1, din), dtype),
            "conv_B": zeros((batch, cw - 1, gn), dtype),
            "conv_C": zeros((batch, cw - 1, gn), dtype)}
