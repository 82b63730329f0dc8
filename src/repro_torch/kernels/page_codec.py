"""Page codecs for the paged KV block pool.

A codec maps compute-dtype K/V rows to what the pools store (encode on
write) and back to f32 (decode).  The pools hold encoded pages in the
codec's storage dtype; codecs with scales add a per-row f32 **scale
sidecar** of the same rank with a trailing dim of 1 ("k_scale" /
"v_scale"), so the page scatter writers, copy-on-write ``copy_pages``
and ``gather_pages`` move scale rows exactly as they move data rows.
The paged kernels decode each K/V tile right after its load, with the
same arithmetic as :meth:`PageCodec.decode`, and the plain versions call
that function on the gathered pages.

Codecs (bit-exact to ``src/repro/kernels/page_codec.py``):

  fp     identity - pages in the compute dtype, no sidecar (the default).
  int8   per-row absmax int8: scale = absmax / 127 per token row per KV
         head, data = round(x / scale) (half to even) clipped to +-127;
         decode = data * scale, one f32 multiply.
  log16  FIX16 log-domain pages: ``lns.blinn_log2`` packed as
         ``sign << 15 | (rail + BF16_BIAS << FRAC_BITS)``, which is the
         bf16 bit pattern, so decode is a bitcast to bf16 and a widening
         to f32.  The reference stores it as uint16; the port stores the
         same 16 bits as int16, because torch has no index_put for uint16
         (the page scatter).  ``pages.view(torch.bfloat16)`` is the decode.
"""
from __future__ import annotations

import torch

from repro_torch.core import lns
from repro_torch.core.numerics import BF16_BIAS, FRAC_BITS, LOG_ZERO

CODECS = ("fp", "int8", "log16")

_SCALE_DTYPE = torch.float32


class PageCodec:
    """Encode-on-write / decode-in-kernel page transform.

    ``encode(x)`` maps ``(..., d)`` values to ``(data, scales)``: data in
    :meth:`storage_dtype`, scales ``(..., 1)`` f32 or None when
    :attr:`has_scales` is False.  ``decode(data, scales)`` is the f32
    inverse."""

    name: str = "?"
    has_scales: bool = False

    def storage_dtype(self, ref_dtype: torch.dtype) -> torch.dtype:
        raise NotImplementedError

    def encode(self, x: torch.Tensor):
        raise NotImplementedError

    def decode(self, data: torch.Tensor, scales: torch.Tensor | None):
        raise NotImplementedError

    def bytes_per_row(self, d: int, ref_dtype: torch.dtype) -> int:
        """Stored bytes for one token row of one KV head (d elements
        plus this codec's share of the scale sidecar)."""
        raise NotImplementedError


class FpCodec(PageCodec):
    """Identity codec: pages stored in the compute dtype."""

    name = "fp"

    def storage_dtype(self, ref_dtype):
        return ref_dtype

    def encode(self, x):
        return x, None

    def decode(self, data, scales):
        return data.to(torch.float32)

    def bytes_per_row(self, d, ref_dtype):
        return d * ref_dtype.itemsize


class Int8Codec(PageCodec):
    """Per-row absmax int8 with an f32 scale sidecar."""

    name = "int8"
    has_scales = True

    def storage_dtype(self, ref_dtype):
        return torch.int8

    def encode(self, x):
        xf = x.to(torch.float32)
        amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
        # An elementwise divide: torch on the card turns a divide by a
        # Python scalar into a multiply by its reciprocal, which rounds
        # differently from the reference's amax / 127.
        scale = amax / torch.full_like(amax, 127.0)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        data = torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)
        return data, scale.to(_SCALE_DTYPE)

    def decode(self, data, scales):
        return data.to(torch.float32) * scales.to(torch.float32)

    def bytes_per_row(self, d, ref_dtype):
        return d + _SCALE_DTYPE.itemsize


class Log16Codec(PageCodec):
    """FIX16 log-domain pages: Blinn-quantized (sign, rail) bit-packs,
    which are the bf16 bit patterns of the values."""

    name = "log16"

    def storage_dtype(self, ref_dtype):
        return torch.int16

    def encode(self, x):
        sign, raw = lns.blinn_log2(x)
        mag = torch.clamp(raw + (BF16_BIAS << FRAC_BITS), 0, 0x7FFF)
        mag = torch.where(raw <= LOG_ZERO, torch.zeros_like(mag), mag)
        bits = (sign << 15) | mag.to(torch.int32)
        # int32 patterns in [0, 65535] to the same 16 bits as int16.
        bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)
        return bits.to(torch.int16), None

    def decode(self, data, scales):
        return data.view(torch.bfloat16).to(torch.float32)

    def bytes_per_row(self, d, ref_dtype):
        return d * 2


_REGISTRY: dict[str, PageCodec] = {
    c.name: c for c in (FpCodec(), Int8Codec(), Log16Codec())}


def get_codec(name: str | PageCodec | None = None) -> PageCodec:
    """Resolve a codec by name (None -> fp); a codec passes through."""
    if name is None:
        return _REGISTRY["fp"]
    if isinstance(name, PageCodec):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown page codec {name!r}; have "
                         f"{sorted(_REGISTRY)}") from None


def bytes_per_token(codec, hkv: int, d: int, ref_dtype: torch.dtype) -> int:
    """Stored KV bytes per token position per layer: K + V rows across
    all KV heads, scale sidecar included."""
    return 2 * hkv * get_codec(codec).bytes_per_row(d, ref_dtype)


def decode_pages(codec, pages: torch.Tensor,
                 scales: torch.Tensor | None) -> torch.Tensor:
    """Decode a whole (or gathered) pool view to f32."""
    return get_codec(codec).decode(pages, scales)


def encode_write(writer, codec, pools: dict, k_new: torch.Tensor,
                 v_new: torch.Tensor, *args) -> dict:
    """Encode-on-write: run ``codec.encode`` on this step's K/V and push
    the data - and, for a codec with scales, the (B, L, Hkv, 1) scale
    rows - through the same ``writer(kp, vp, k, v, *args)`` (one of the
    page scatter ops, which take any dtype and trailing dim).  Returns
    the pools dict with the same keys."""
    c = get_codec(codec)
    kd, ks = c.encode(k_new)
    vd, vs = c.encode(v_new)
    kp, vp = writer(pools["k_pages"], pools["v_pages"], kd, vd, *args)
    out = {"k_pages": kp, "v_pages": vp}
    if c.has_scales:
        out["k_scale"], out["v_scale"] = writer(
            pools["k_scale"], pools["v_scale"], ks, vs, *args)
    return out
