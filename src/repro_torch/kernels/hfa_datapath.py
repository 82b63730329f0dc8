"""The per-element H-FA datapath (the paper's FAU, Fig. 3): kernel
wrapper and plain version.

``hfa_datapath`` replaces the Pallas kernel
``src/repro/kernels/hfa_datapath.py::_datapath_kernel`` (wrapper
``hfa_datapath_pallas``).  It streams keys one at a time and keeps the
fused accumulator O = [l, o] of every query row as (sign, FIX16 raw)
LNS state of width d+1: BF16 scores (f32 dot product, rounded to BF16
after the scale), Eq. (14) quantized score differences, Blinn log2 of
[1, v] (V read as BF16), Mitchell ``lns_add``, then LogDiv and
``lns_to_bf16``.  Forward only, as in the reference.

On a CUDA tensor it launches ``hfa_datapath_fwd`` of
``csrc/hfa_datapath.cu`` and counts the launch in :data:`launches`; on a
CPU tensor it runs :func:`hfa_datapath_plain`, the ``core.hfa``
emulation (``kernels/ref.py::ref_hfa_datapath``).  The gate is exact:
given the kernel's own scores (:func:`hfa_datapath_scores`, the same
score code), :func:`hfa_datapath_from_scores` gives every output bit.
What bounds the kernel on the card is its LNS updates - one per
(visible query-key pair, column), with no tensor-core form - so it runs
them on the CUDA cores: a block owns 16 query rows of one (batch, head),
streams their keys in tiles, converts each V tile to LNS once, forms the
per-(row, key) score differences once in a pass with one thread a row,
and gives each column thread four rows' independent chains; the Mitchell
correction is a table lookup (``core/lns.py::exp2_neg_table``).
"""
from __future__ import annotations

import torch

from repro_torch.core import hfa as core_hfa
from repro_torch.kernels import cuda_lib

launches = 0


def _mask(lq: int, lkv: int, causal: bool, kv_len, device):
    """(Lq, Lkv) keys visible to each row: j < kv_len and, if causal, j
    <= i + Lkv - Lq."""
    kv_ids = torch.arange(lkv, device=device)
    mask = (kv_ids < (lkv if kv_len is None else int(kv_len)))[None, :]
    if causal:
        mask = mask & core_hfa.causal_mask(lq, kv_ids, lkv)
    return mask


def hfa_datapath_plain(q, k, v, *, causal=False, scale=None, kv_len=None):
    """The ``core.hfa`` emulation over (BH, Lq, d) x (BH, Lkv, d) with the
    kernel's masks (key j visible when j < kv_len and, if causal, j <= i
    + Lkv - Lq): (BH, Lq, d) bf16."""
    mask = _mask(q.shape[-2], k.shape[-2], causal, kv_len, q.device)
    return core_hfa.logdiv(core_hfa.hfa_partial(q, k, v, scale=scale,
                                                mask=mask))


def hfa_datapath_from_scores(s, v, *, causal=False, kv_len=None):
    """:func:`hfa_datapath_plain` fed bf16 scores s (BH, Lq, Lkv) -
    already scaled and rounded, such as the ones the kernel forms - in
    place of its QK^T: the same masks, walk and LogDiv.  Fed the plain
    version's own scores it returns its output bit for bit."""
    mask = _mask(s.shape[-2], s.shape[-1], causal, kv_len, s.device)
    return core_hfa.logdiv(core_hfa.hfa_partial_scores(
        s.to(torch.float32), v, mask=mask))


def hfa_datapath(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = False, scale: float | None = None,
                 kv_len: int | None = None) -> torch.Tensor:
    """Per-element LNS H-FA over (BH, Lq, d) x (BH, Lkv, d) -> (BH, Lq, d)
    bf16; queries are the last Lq positions (causal offset Lkv - Lq) and
    ``kv_len`` (default Lkv) masks key padding."""
    if q.device.type == "cpu":
        return hfa_datapath_plain(q, k, v, causal=causal, scale=scale,
                                  kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"hfa_datapath: no kernel for {q.device}")
    global launches
    d, lq, lkv = q.shape[-1], q.shape[-2], k.shape[-2]
    out = cuda_lib.launch_hfa_datapath(
        q, k, v, causal=causal,
        scale=(1.0 / d ** 0.5) if scale is None else scale,
        kv_len=lkv if kv_len is None else int(kv_len), q_offset=lkv - lq)
    launches += 1
    return out


def hfa_datapath_scores(q: torch.Tensor, k: torch.Tensor, *,
                        causal: bool = False, scale: float | None = None,
                        kv_len: int | None = None) -> torch.Tensor:
    """The bf16 scores (BH, Lq, Lkv) the kernel forms for the same call,
    from the same code (``hfa_datapath_scores`` of the source; zero where
    it forms none, past a row tile's last visible key), for the checks:
    fed to :func:`hfa_datapath_from_scores` they give the kernel's output
    bit for bit.  Card only; not counted in :data:`launches`."""
    d, lq, lkv = q.shape[-1], q.shape[-2], k.shape[-2]
    return cuda_lib.launch_hfa_datapath_scores(
        q, k, causal=causal,
        scale=(1.0 / d ** 0.5) if scale is None else scale,
        kv_len=lkv if kv_len is None else int(kv_len), q_offset=lkv - lq)

