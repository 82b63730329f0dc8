"""Build, load and launch the hand-written CUDA kernels.

``csrc/paged_attention.cu`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` - no
PyTorch headers, so a build takes seconds.  The build runs at first use,
writes into ``build/repro_torch/`` under the repository root, and is
keyed by a hash of the source and the flags.  Nothing here runs when the
module is imported: the package imports on machines without ``nvcc`` or
a card.

Every pointer and the stream travel as ``ctypes.c_void_p``; each entry
point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.core import lns

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# The 16 PWL LUT values, as a host array the entry points copy from.
_LUT = (ctypes.c_float * 16)(*lns.pwl_lut16().tolist())
build_log = ""    # nvcc's stderr (ptxas register / spill report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def build(force: bool = False) -> Path:
    """Compile the kernels for sm_90a; returns the library path."""
    global build_log
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libpaged_attention_{key}.so"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    build_log = proc.stderr
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use).  Raises without a
    card: these kernels have no CPU fallback."""
    global _lib
    if _lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the paged attention kernels "
                               "run only on the card")
        lib = ctypes.CDLL(str(build()))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode_fwd.argtypes = [ptr] * 8 + [i32] * 6 + [
            f32, i32, i32, ptr, ptr]
        for name in ("paged_prefill_fwd", "paged_verify_fwd"):
            getattr(lib, name).argtypes = [ptr] * 9 + [i32] * 7 + [
                f32, i32, i32, ptr, ptr]
        lib.hfa_rail_eval.argtypes = [ptr] * 4 + [i32, ptr, ptr]
        for name in ("paged_decode_fwd", "paged_prefill_fwd",
                     "paged_verify_fwd", "hfa_rail_eval"):
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def launch_paged(entry: str, q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 lens_a: torch.Tensor, lens_b: torch.Tensor | None, *,
                 scale: float, use_hfa: bool):
    """Launch one paged attention entry point on the current stream.

    q: (B, Hkv, G, L, d) in the pools' dtype; returns the f32 triplet
    o~ (B, Hkv, G, L, d), m and l (B, Hkv, G, L).
    """
    b, hkv, g, ell, d = q.shape
    tensors = [q, k_pages, v_pages, page_table, lens_a] + (
        [] if lens_b is None else [lens_b])
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             f"{entry}: every tensor must be on the same CUDA device")
    _require(q.dtype in (torch.bfloat16, torch.float32)
             and k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
             f"{entry}: q and pools must share a dtype in (bf16, f32), got "
             f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    _require(d in (64, 128), f"{entry}: head dim {d} not in (64, 128)")
    _require(k_pages.dim() == 4 and k_pages.shape == v_pages.shape
             and k_pages.shape[2] == hkv and k_pages.shape[3] == d,
             f"{entry}: pools {tuple(k_pages.shape)} do not match q "
             f"{tuple(q.shape)}")
    _require(page_table.dim() == 2 and page_table.shape[0] == b,
             f"{entry}: page_table {tuple(page_table.shape)} for batch {b}")
    _require(all(t.dtype == torch.int32 for t in tensors[3:]),
             f"{entry}: page table and lengths must be int32")
    _require(all(t.is_contiguous() for t in tensors),
             f"{entry}: every tensor must be contiguous")
    o = torch.empty((b, hkv, g, ell, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, g, ell), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hkv, g, ell), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, m, l
    lib = library()
    j, page = page_table.shape[1], k_pages.shape[1]
    ptrs = [_ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_table),
            _ptr(lens_a)] + ([] if lens_b is None else [_ptr(lens_b)]) + [
        _ptr(o), _ptr(m), _ptr(l)]
    dims = [b, hkv, g] + ([] if entry == "paged_decode_fwd" else [ell]) \
        + [d, j, page]
    err = getattr(lib, entry)(*ptrs, *dims, ctypes.c_float(scale),
                              int(use_hfa), int(q.dtype == torch.bfloat16),
                              ctypes.cast(_LUT, ctypes.c_void_p), _stream())
    check(err, entry)
    return o, m, l


def rail_eval(x: torch.Tensor):
    """The kernels' rail device functions over an f32 CUDA tensor:
    (quant_rail(x), exp2_hfa_rail(quant_rail(x)), recip_logdiv(x))."""
    _require(x.is_cuda and x.dtype == torch.float32 and x.is_contiguous(),
             "rail_eval: needs a contiguous f32 CUDA tensor")
    outs = [torch.empty_like(x) for _ in range(3)]
    err = library().hfa_rail_eval(_ptr(x), *map(_ptr, outs), x.numel(),
                                  ctypes.cast(_LUT, ctypes.c_void_p), _stream())
    check(err, "hfa_rail_eval")
    return tuple(outs)

