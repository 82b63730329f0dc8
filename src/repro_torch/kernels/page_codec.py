"""Page codecs for the paged KV block pool - the ``fp`` codec.

A codec maps compute-dtype K/V rows to what the pools store (encode on
write; the kernels decode each tile).  ``fp`` is the identity: pages
hold the compute dtype, no scale sidecar.  The quantized codecs of the
reference (``int8`` with per-row f32 scales, ``log16`` on the FIX16
rail) are not ported yet: ROADMAP.md Queue 1 item 9 brings them, with
the tile decode inside the paged kernels (Queue 2).
"""
from __future__ import annotations

import torch

CODECS = ("fp", "int8", "log16")


class FpCodec:
    """Identity codec: pages stored in the compute dtype."""

    name = "fp"

    def storage_dtype(self, ref_dtype: torch.dtype) -> torch.dtype:
        return ref_dtype

    def encode(self, x: torch.Tensor):
        return x, None

    def bytes_per_row(self, d: int, ref_dtype: torch.dtype) -> int:
        """Stored bytes for one token row of one KV head."""
        return d * ref_dtype.itemsize


_FP = FpCodec()


def get_codec(name=None) -> FpCodec:
    """Resolve a codec by name (None -> fp); a codec passes through."""
    if name is None or isinstance(name, FpCodec):
        return _FP if name is None else name
    if name == "fp":
        return _FP
    if name in CODECS:
        raise NotImplementedError(
            f"page codec {name!r} is not ported yet (ROADMAP.md Queue 1 "
            f"item 9, with its tile decode in Queue 2); use 'fp'")
    raise ValueError(f"unknown page codec {name!r}; have {list(CODECS)}")


def bytes_per_token(codec, hkv: int, d: int, ref_dtype: torch.dtype) -> int:
    """Stored KV bytes per token position per layer: K + V rows across
    all KV heads."""
    return 2 * hkv * get_codec(codec).bytes_per_row(d, ref_dtype)


def encode_write(writer, codec, pools: dict, k_new: torch.Tensor,
                 v_new: torch.Tensor, *args) -> dict:
    """Encode-on-write: run ``codec.encode`` on this step's K/V and push
    it through ``writer(kp, vp, k, v, *args)`` (one of the page scatter
    ops).  Returns the pools dict with the same keys."""
    c = get_codec(codec)
    kd, _ = c.encode(k_new)
    vd, _ = c.encode(v_new)
    kp, vp = writer(pools["k_pages"], pools["v_pages"], kd, vd, *args)
    return {"k_pages": kp, "v_pages": vp}
