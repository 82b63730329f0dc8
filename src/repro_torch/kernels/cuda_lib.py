"""Build, load and launch the hand-written CUDA kernels.

Every source under ``csrc/`` (``paged_attention.cu``,
``paged_attention_tc.cu``, ``paged_decode_v2_codec.cu``,
``dense_attention.cu``, ``dense_attention_tc.cu``,
``dense_attention_bwd_tc.cu``, ``dense_decode.cu``, ``hfa_datapath.cu``,
and the headers ``hfa_rail.cuh``, ``lns_rail.cuh``, ``tc_common.cuh``,
``decode_common.cuh`` and ``paged_decode_v2.cuh`` they share) is
compiled by ``nvcc`` - one process per ``.cu`` file, all started
together - and linked into one shared library with a plain C interface,
loaded with ``ctypes``.  No PyTorch headers, so a build takes seconds.
The tensor-core sources encode their TMA tensor maps with the driver's
``cuTensorMapEncodeTiled``, which they look up at run time
(``cudaGetDriverEntryPoint``): the library links no ``-lcuda``.
The build runs at first use, writes into ``build/repro_torch/`` under
the repository root, and is keyed by a hash of every source and the
flags.  Nothing here runs when the module is imported: the package
imports on machines without ``nvcc`` or a card.

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
import threading
import time
from pathlib import Path

import torch

from repro_torch.core import lns

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Keys per tile of the dense forward kernel: the reference's block_kv,
# where the H-FA rail's row max is taken.
DENSE_KV_TILE = 128

_lib = None
_lib_lock = threading.Lock()      # one build and load for every thread
# The 16 PWL LUT values, as a host array the entry points copy from.
_LUT = (ctypes.c_float * 16)(*lns.pwl_lut16().tolist())
# exp2_neg(d) for d < 1024 (0 beyond), the datapath kernel's correction
# table, as a host array its entry points copy from.
_CORR = (ctypes.c_uint8 * lns.EXP2_NEG_TABLE)(*lns.exp2_neg_table().tolist())
build_log = ""    # nvcc's stderr (ptxas register / spill report)
build_seconds: dict = {}   # seconds each source's nvcc took, last build
# rail entry point of each source, for the bit-equality checks
RAIL_ENTRIES = {"paged": "hfa_rail_eval", "dense": "dense_rail_eval",
                "dense_tc": "dense_tc_rail_eval", "decode": "decode_rail_eval"}
# Query heads per KV head the dense decode kernel takes, and its tile
# (the reference's block_kv: the H-FA rail's rescale step).
DECODE_MAX_G = 8
DENSE_DECODE_TILE = 128
# Query rows per block of the tensor-core forward; its grid takes at
# most 65535 such tiles.
DENSE_TC_ROWS = 128
# Launches of the dense forward by kernel: "tc" the tensor-core kernel
# (bf16 inputs), "simt" the CUDA-core kernel (f32 inputs).  A run reads
# which kernel each path took from here.
dense_fwd_launches = {"tc": 0, "simt": 0}
# Rows a block of the tensor-core backward owns (dq: query rows, dk/dv:
# key rows); its grid takes at most 65535 such blocks.
DENSE_BWD_TC_ROWS = 128
# Head dims every kernel takes; the tensor-core sources take TC_HEAD_DIMS
# and the wrappers zero-pad 32 and 96 up to them (fa2.pad_head_dim).
HEAD_DIMS = (32, 64, 96, 128)
TC_HEAD_DIMS = (64, 128)
# Page size the tensor-core paged prefill takes (its rescale step), and
# the widest page table (it holds a slot's page ids in shared memory).
PAGED_TC_PAGE = 16
PAGED_TC_MAX_PAGES = 16384
# Query rows a block of the v2 paged decode and verify takes (64 threads
# a row): decode's G, verify's G K / row_blocks.
PAGED_V2_MAX_ROWS = 16
# The largest page the H-FA rail takes, a shared-memory ceiling: the
# CUDA-core paged body, which takes every H-FA page size other than 16,
# rescales once a page (as the reference does); above page 16 it keeps a
# page's scores in shared memory, 16 rows x (page + 16) f32, beside a
# 64-key K/V stage - 207.6 KB of the 227 KB a block at page 2048, d 128.
HFA_MAX_PAGE = 2048
# What the kernels read the pools as, beside q (the C entry points' kv
# argument): 0 q's dtype; 1 int8 with per-row f32 scales (the int8
# codec, decoded tile by tile: value * scale, one rounded multiply); 2
# bf16 under an f32 q (a log16 pool's bits at f32 compute).
KV_SAME, KV_INT8, KV_BF16 = 0, 1, 2
# Launches of the paged kernels by route.  prefill: "tc" the tensor-core
# kernel (paged_prefill_fwd_tc), "simt" the CUDA-core one
# (paged_prefill_fwd); decode: "v2" paged_decode_fwd_v2, "simt"
# paged_decode_fwd (the H-FA rail at a page size other than 16, and the
# checks); verify: "v2" paged_verify_fwd_v2, "simt" paged_verify_fwd
# (more than 16 rows a (slot, kv head), the H-FA rail at a page size
# other than 16, and the checks).
paged_launches = {"prefill": {"tc": 0, "simt": 0},
                  "decode": {"v2": 0, "simt": 0},
                  "verify": {"v2": 0, "simt": 0}}
# Router replicas step their engines on threads of their own, so a count
# is taken under a lock (``+=`` on a dict entry can lose an update).
_count_lock = threading.Lock()


def _count_paged(kind: str, route: str) -> None:
    with _count_lock:
        paged_launches[kind][route] += 1


# Launches of the FA-2 backward by kernel: "tc" the tensor-core kernels
# (bf16 inputs and cotangent), "simt" the CUDA-core ones (an f32
# cotangent).
dense_dq_launches = {"tc": 0, "simt": 0}
dense_dkv_launches = {"tc": 0, "simt": 0}


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# Argument types of every C entry point; each returns its first CUDA error.
SIGNATURES = {
    "paged_decode_fwd": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _I, _P, _P],
    "paged_prefill_fwd": [_P] * 11 + [_I] * 7 + [_F, _I, _I, _I, _P, _P],
    "paged_verify_fwd": [_P] * 11 + [_I] * 7 + [_F, _I, _I, _I, _P, _P],
    "paged_prefill_fwd_tc": [_P] * 9 + [_I] * 8 + [_F, _I, _P, _P],
    "paged_decode_fwd_v2": [_P] * 12 + [_I] * 7 + [_F, _I, _I, _I, _P, _P],
    "paged_verify_fwd_v2": [_P] * 13 + [_I] * 9 + [_F, _I, _I, _I, _P, _P],
    "dense_attn_fwd": [_P] * 5 + [_I] * 7 + [_F, _I, _P, _P],
    "dense_attn_fwd_tc": [_P] * 6 + [_I] * 7 + [_F, _I, _P, _P],
    "dense_attn_dq": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    "dense_attn_dkv": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
    "dense_attn_dq_tc": [_P] * 7 + [_I] * 7 + [_F, _P],
    "dense_attn_dkv_tc": [_P] * 8 + [_I] * 7 + [_F, _P],
    "dense_decode_fwd_v2": [_P] * 8 + [_I] * 5 + [_L] * 3 + [
        _I, _I, _F, _I, _I, _P, _P],
    "hfa_datapath_fwd": [_P] * 4 + [_I] * 7 + [_F, _I, _P, _P],
    "hfa_datapath_scores": [_P] * 3 + [_I] * 7 + [_F, _I, _P],
    "lns_eval": [_P] * 13 + [_I, _P, _P],
    **{name: [_P] * 4 + [_I, _P, _P] for name in RAIL_ENTRIES.values()},
}


def bind(lib: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Set the argument and result types of the entry points ``names``
    (default: all of :data:`SIGNATURES`) on ``lib``; returns ``lib``."""
    for name in names or SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build(force: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` for sm_90a (in parallel) and link them
    into one library; returns its path."""
    global build_log, build_seconds
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode() + src.read_bytes())
    out = BUILD_DIR / f"libhfa_kernels_{h.hexdigest()[:12]}.so"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    units = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in units]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(units, objs)]
    errs, seconds = {}, {}

    def drain(src, proc):                # each source's time as it ends
        errs[src] = proc.communicate()[1]
        seconds[src.name] = round(time.perf_counter() - t0, 1)
    threads = [threading.Thread(target=drain, args=sp)
               for sp in zip(units, procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    logs = [errs[src] for src in units]
    failed = [f"nvcc failed on {src}:\n{errs[src]}"
              for src, proc in zip(units, procs) if proc.returncode != 0]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_log = "".join(logs)
    build_seconds = seconds
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use).  Raises without a
    card: these kernels have no CPU fallback.  Threads that make their
    first call at once (the engine steps of several replicas, each on its
    own executor thread) build once: ``build`` names its object files by
    pid, which threads share."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                if not torch.cuda.is_available():
                    raise RuntimeError("no CUDA device: the attention "
                                       "kernels run only on the card")
                lib = ctypes.CDLL(str(build()))
                _lib = bind(lib)
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


def _check_head_dim(entry: str, d: int) -> None:
    _require(d in HEAD_DIMS, f"{entry}: head dim {d} not in {HEAD_DIMS}")


def _check_paged(entry, q, k_pages, v_pages, page_table, lens,
                 k_scales=None, v_scales=None) -> int:
    """Check a paged launch's tensors; returns the kv argument
    (:data:`KV_SAME`, :data:`KV_INT8` or :data:`KV_BF16`)."""
    b, hkv = q.shape[:2]
    d = q.shape[-1]
    scales = [t for t in (k_scales, v_scales) if t is not None]
    tensors = [q, k_pages, v_pages, page_table, *lens, *scales]
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             f"{entry}: every tensor must be on the same CUDA device")
    kv_dt = k_pages.dtype
    _require(q.dtype in (torch.bfloat16, torch.float32)
             and v_pages.dtype == kv_dt
             and kv_dt in (q.dtype, torch.int8, torch.bfloat16),
             f"{entry}: q in (bf16, f32) and pools in q's dtype, int8 or "
             f"bf16, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    kv = KV_SAME if kv_dt == q.dtype else \
        KV_INT8 if kv_dt == torch.int8 else KV_BF16
    _require((kv == KV_INT8) == (len(scales) == 2)
             and all(t.dtype == torch.float32
                     and t.shape == (*k_pages.shape[:3], 1) for t in scales),
             f"{entry}: int8 pools take f32 scales (P, page, Hkv, 1) for K "
             f"and V, other pools none")
    _check_head_dim(entry, d)
    _require(k_pages.dim() == 4 and k_pages.shape == v_pages.shape
             and k_pages.shape[2] == hkv and k_pages.shape[3] == d,
             f"{entry}: pools {tuple(k_pages.shape)} do not match q "
             f"{tuple(q.shape)}")
    _require(page_table.dim() == 2 and page_table.shape[0] == b,
             f"{entry}: page_table {tuple(page_table.shape)} for batch {b}")
    _require(all(t.dtype == torch.int32 for t in [page_table, *lens]),
             f"{entry}: page table and lengths must be int32")
    _require(all(t.is_contiguous() for t in tensors),
             f"{entry}: every tensor must be contiguous")
    return kv


def _triplet(q, lead):
    """Empty f32 (o~, m, l) for query rows ``lead`` = q.shape[:-1]."""
    o = torch.empty((*lead, q.shape[-1]), dtype=torch.float32,
                    device=q.device)
    m = torch.empty(lead, dtype=torch.float32, device=q.device)
    return o, m, torch.empty_like(m)


def check_hfa_page(page: int, use_hfa: bool) -> None:
    """Refuse an H-FA page above :data:`HFA_MAX_PAGE`, the shared-memory
    ceiling (the engine checks it when it is built on the card; the
    routes check it again)."""
    _require(not use_hfa or page <= HFA_MAX_PAGE,
             f"paged attention: page size {page} on the H-FA rail; the rail "
             f"rescales once a page, as the reference does, and the paged "
             f"kernel keeps a page's scores in shared memory, which holds "
             f"them up to page {HFA_MAX_PAGE}")


def _opt_ptr(t: torch.Tensor | None):
    return None if t is None else _ptr(t)


def launch_paged(entry: str, q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 lens_a: torch.Tensor, lens_b: torch.Tensor | None, *,
                 scale: float, use_hfa: bool,
                 k_scales: torch.Tensor | None = None,
                 v_scales: torch.Tensor | None = None):
    """Launch one entry point of the CUDA-core paged kernel
    (``paged_attention.cu``) on the current stream.

    q: (B, Hkv, G, L, d) bf16 or f32; the pools in q's dtype, int8 with
    their f32 scales (P, page, Hkv, 1), or bf16 under an f32 q.  Returns
    the f32 triplet o~ (B, Hkv, G, L, d), m and l (B, Hkv, G, L).  Every
    launch is counted in :data:`paged_launches` as "simt".
    """
    b, hkv, g, ell, d = q.shape
    lens = [lens_a] + ([] if lens_b is None else [lens_b])
    kv = _check_paged(entry, q, k_pages, v_pages, page_table, lens,
                      k_scales, v_scales)
    check_hfa_page(k_pages.shape[1], use_hfa)
    o, m, l = _triplet(q, q.shape[:-1])
    if o.numel() == 0:
        return o, m, l
    lib = library()
    j, page = page_table.shape[1], k_pages.shape[1]
    ptrs = [_ptr(q), _ptr(k_pages), _ptr(v_pages), _opt_ptr(k_scales),
            _opt_ptr(v_scales), _ptr(page_table), _ptr(lens_a)] + (
        [] if lens_b is None else [_ptr(lens_b)]) + [
        _ptr(o), _ptr(m), _ptr(l)]
    dims = [b, hkv, g] + ([] if entry == "paged_decode_fwd" else [ell]) \
        + [d, j, page]
    err = getattr(lib, entry)(*ptrs, *dims, ctypes.c_float(scale),
                              int(use_hfa), int(q.dtype == torch.bfloat16),
                              kv, ctypes.cast(_LUT, ctypes.c_void_p),
                              _stream())
    check(err, entry)
    kind = {"paged_decode_fwd": "decode", "paged_prefill_fwd": "prefill",
            "paged_verify_fwd": "verify"}
    _count_paged(kind[entry], "simt")
    return o, m, l


def paged_prefill_route(q: torch.Tensor, k_pages: torch.Tensor,
                        page_table: torch.Tensor, *,
                        use_hfa: bool = False) -> str:
    """Which kernel takes a paged prefill: "tc" (``paged_prefill_fwd_tc``,
    the tensor cores) for a bf16 q over bf16 pools (fp, or a log16 pool's
    bf16 view) at d 64 or 128, page 16 and at most
    :data:`PAGED_TC_MAX_PAGES` pages a slot; "simt" (``paged_prefill_fwd``,
    the CUDA cores, which on the H-FA rail rescales once a page) for
    everything else - f32 q, int8 pools (decoded tile by tile there), d
    32 or 96, other page sizes.  An H-FA page above :data:`HFA_MAX_PAGE`
    raises a ValueError."""
    check_hfa_page(k_pages.shape[1], use_hfa)
    if (q.dtype == torch.bfloat16 and k_pages.dtype == torch.bfloat16
            and q.shape[-1] in TC_HEAD_DIMS
            and k_pages.shape[1] == PAGED_TC_PAGE
            and page_table.shape[1] <= PAGED_TC_MAX_PAGES):
        return "tc"
    return "simt"


def launch_paged_prefill(q, k_pages, v_pages, page_table, start_pos,
                         kv_lens, *, scale: float, use_hfa: bool,
                         k_scales=None, v_scales=None):
    """Paged chunked prefill on the current stream, on the kernel
    :func:`paged_prefill_route` picks; counted in :data:`paged_launches`.
    q (B, Hkv, G, L, d); pools and scales as :func:`launch_paged` takes
    them; returns the f32 triplet o~ (B, Hkv, G, L, d), m and l (B, Hkv,
    G, L)."""
    if paged_prefill_route(q, k_pages, page_table,
                           use_hfa=use_hfa) == "simt":
        return launch_paged("paged_prefill_fwd", q, k_pages, v_pages,
                            page_table, start_pos, kv_lens, scale=scale,
                            use_hfa=use_hfa, k_scales=k_scales,
                            v_scales=v_scales)
    entry = "paged_prefill_fwd_tc"
    _check_paged(entry, q, k_pages, v_pages, page_table,
                 [start_pos, kv_lens])
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
             f"{entry}: q and the pools must be 16-byte aligned (TMA)")
    b, hkv, g, ell, d = q.shape
    o, m, l = _triplet(q, q.shape[:-1])
    if o.numel() == 0:
        return o, m, l
    err = library().paged_prefill_fwd_tc(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_table),
        _ptr(start_pos), _ptr(kv_lens), _ptr(o), _ptr(m), _ptr(l), b, hkv,
        g, ell, d, page_table.shape[1], k_pages.shape[1], k_pages.shape[0],
        ctypes.c_float(scale), int(use_hfa),
        ctypes.cast(_LUT, ctypes.c_void_p), _stream())
    check(err, entry)
    _count_paged("prefill", "tc")
    return o, m, l


# (device, stream) -> the split counters of the v2 paged decode and
# verify and of the dense decode (decode_common.cuh): launches on one
# stream run in order, so no two share a counter at once, and each kernel
# leaves them at zero.
_counters: dict = {}
_sm_count: dict = {}      # device -> streaming multiprocessors


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_count[device]


def split_runs(pairs: int, max_runs: int, sms: int,
               blocks_per_sm: int = 2) -> int:
    """Runs a split walk cuts each of ``pairs`` walks into: about enough
    for ``blocks_per_sm`` blocks an SM, at most ``max_runs`` (one run a
    step or tile of the longest walk), at least 1, and rounded so that
    the longest walk's runs are all the same whole number of steps (9
    runs of a 32-step walk would leave the last a part step: 8 runs of 4
    steps instead)."""
    max_runs = max(1, max_runs)
    target = min(-(-blocks_per_sm * sms // pairs), max_runs)
    per = -(-max_runs // target)
    return -(-max_runs // per)


def decode_splits(q: torch.Tensor, page_table: torch.Tensor, page: int,
                  use_hfa: bool, pairs: int | None = None) -> int:
    """Runs of the page walk the v2 decode splits each (slot, kv head)
    into: on the FA-2 rail about four blocks an SM (two waves of two; 8
    runs took 0.022 ms where 5 took 0.028 at the kernels-phase shape,
    ``chip_smoke.py decode_variants``), at most one run per 64-key step
    of the longest walk; 1 on the H-FA rail, whose result depends on
    where the rescales fall.  ``pairs`` (default: q's B Hkv) is the
    number of (slot, kv head) walks the rule sizes the grid for: a
    tensor- or data-parallel shard passes the whole call's, so that each
    of its walks is split as the single-shard call splits it (the split
    moves the Eq. 16 merge's rounding)."""
    if use_hfa:
        return 1
    return split_runs(q.shape[0] * q.shape[1] if pairs is None else pairs,
                      -(-page_table.shape[1] * page // 64),
                      sm_count(q.device), blocks_per_sm=4)


def paged_decode_route(page: int, use_hfa: bool) -> str:
    """Which kernel takes a paged decode at page size ``page``: "v2"
    (``paged_decode_fwd_v2``) on the FA-2 rail at any page size and on the
    H-FA rail at page 16, where its 16-key tiles are the pages; "simt"
    (``paged_decode_fwd``, the CUDA cores, which rescale once a page as
    the reference does) on the H-FA rail at any other page size.  An
    H-FA page above :data:`HFA_MAX_PAGE` raises a ValueError."""
    check_hfa_page(page, use_hfa)
    return "simt" if use_hfa and page != PAGED_TC_PAGE else "v2"


def paged_verify_route(g: int, k: int, page: int, use_hfa: bool) -> str:
    """Which kernel takes a paged verify of ``g`` query heads per KV head
    and ``k`` positions a slot at page size ``page``: "v2"
    (``paged_verify_fwd_v2``, the v2 decode's body) when the G K rows of a
    (slot, kv head) fit one of its blocks (at most
    :data:`PAGED_V2_MAX_ROWS`), at any dtype and head dim, on the FA-2
    rail at any page size and on the H-FA rail at page 16; else "simt"
    (``paged_verify_fwd``, the CUDA cores, which on the H-FA rail rescale
    once a page).  An H-FA page above :data:`HFA_MAX_PAGE` raises a
    ValueError."""
    if paged_decode_route(page, use_hfa) == "simt":
        return "simt"
    return "v2" if g * k <= PAGED_V2_MAX_ROWS else "simt"


def verify_row_blocks(g: int, k: int, use_hfa: bool) -> int:
    """Blocks the v2 verify gives the G K rows of a (slot, kv head): on
    the H-FA rail, whose walk stays unsplit, one per query head (K rows
    each), so that the grid holds G times the blocks; 1 on the FA-2 rail,
    whose walk is split instead."""
    return g if use_hfa else 1


def verify_splits(pairs: int, max_keys: int, use_hfa: bool,
                  sms: int) -> int:
    """Runs of the page walk the v2 verify splits each (slot, kv head)
    into, for ``pairs`` (slot, kv head) walks of at most ``max_keys``
    keys: on the FA-2 rail about four blocks of G K rows an SM, as the
    decode (fewer runs left SMs idle behind the longest walks, more paid
    for the merge: ``chip_smoke.py decode_variants``), at most one run per
    64-key step; 1 on the H-FA rail."""
    if use_hfa:
        return 1
    return split_runs(pairs, -(-max_keys // 64), sms, blocks_per_sm=4)


def dense_decode_splits(pairs: int, kv_len: int, use_hfa: bool,
                        sms: int) -> int:
    """Runs the dense decode splits each of ``pairs`` (sequence, KV head)
    walks of ``kv_len`` keys into: on the FA-2 rail about two blocks an
    SM, at most one run per 128-key tile; 1 on the H-FA rail, whose
    rescales fall every 128 keys from key 0."""
    if use_hfa:
        return 1
    return split_runs(pairs, -(-max(kv_len, 0) // DENSE_DECODE_TILE), sms)


def _split_buffers(device: torch.device, n_counters: int, ws_numel: int):
    """(workspace, counters) of a split launch on the current stream: a
    fresh f32 workspace and the stream's zeroed counters."""
    ws = torch.empty(ws_numel, dtype=torch.float32, device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros(n_counters, dtype=torch.int32, device=device)
        _counters[key] = cnt
    return ws, cnt


def _launch_v2(entry: str, q, k_pages, v_pages, page_table, lens, *,
               rows: int, row_blocks: int, splits: int, scale: float,
               use_hfa: bool, k_scales=None, v_scales=None):
    """One launch of the v2 paged decode or verify (``paged_attention_tc.cu``);
    ``rows`` = G K rows a (slot, kv head); pools and scales as
    :func:`launch_paged` takes them."""
    kv = _check_paged(entry, q, k_pages, v_pages, page_table, lens,
                      k_scales, v_scales)
    _require(all(t.data_ptr() % 16 == 0 for t in (k_pages, v_pages)),
             f"{entry}: the pools must be 16-byte aligned (cp.async)")
    b, hkv, d = q.shape[0], q.shape[1], q.shape[-1]
    _require(row_blocks >= 1 and rows % row_blocks == 0
             and rows // row_blocks <= PAGED_V2_MAX_ROWS,
             f"{entry}: {rows} rows in {row_blocks} blocks, a block takes "
             f"1..{PAGED_V2_MAX_ROWS}")
    _require(splits >= 1 and not (use_hfa and splits > 1),
             f"{entry}: {splits} splits (the H-FA rail runs unsplit)")
    o, m, l = _triplet(q, q.shape[:-1])
    if o.numel() == 0:
        return o, m, l
    ws = cnt = None
    if splits > 1:
        ws, cnt = _split_buffers(q.device, b * hkv * row_blocks,
                                 b * hkv * splits * rows * (d + 2))
    dims = [b, hkv, q.shape[2]] + ([q.shape[3]] if q.dim() == 5 else []) \
        + [d, page_table.shape[1], k_pages.shape[1], splits] \
        + ([row_blocks] if q.dim() == 5 else [])
    err = getattr(library(), entry)(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _opt_ptr(k_scales),
        _opt_ptr(v_scales), _ptr(page_table), *map(_ptr, lens), _ptr(o),
        _ptr(m), _ptr(l), _opt_ptr(ws), _opt_ptr(cnt), *dims,
        ctypes.c_float(scale), int(use_hfa), int(q.dtype == torch.bfloat16),
        kv, ctypes.cast(_LUT, ctypes.c_void_p), _stream())
    check(err, entry)
    return o, m, l


def launch_paged_decode(q, k_pages, v_pages, page_table, kv_lens, *,
                        scale: float, use_hfa: bool,
                        splits: int | None = None, k_scales=None,
                        v_scales=None, pairs: int | None = None):
    """Paged decode on the current stream, on the kernel
    :func:`paged_decode_route` picks; counted in :data:`paged_launches`.
    q (B, Hkv, G, d); returns the f32 triplet o~ (B, Hkv, G, d), m and l
    (B, Hkv, G).  On the v2 route ``splits`` (default
    :func:`decode_splits` for ``pairs`` walks) > 1 splits each page walk
    across blocks, FA-2 rail only; 1 is the unsplit walk."""
    if paged_decode_route(k_pages.shape[1], use_hfa) == "simt":
        _require(q.dim() == 4 and splits in (None, 1),
                 f"paged_decode_fwd: q {tuple(q.shape)} (B, Hkv, G, d), "
                 f"{splits} splits (the CUDA-core walk is unsplit)")
        o, m, l = launch_paged("paged_decode_fwd", q[:, :, :, None, :],
                               k_pages, v_pages, page_table, kv_lens, None,
                               scale=scale, use_hfa=use_hfa,
                               k_scales=k_scales, v_scales=v_scales)
        return o[:, :, :, 0], m[..., 0], l[..., 0]
    _require(q.dim() == 4 and 1 <= q.shape[2] <= PAGED_V2_MAX_ROWS,
             f"paged_decode_fwd_v2: q {tuple(q.shape)}: (B, Hkv, G, d) with "
             f"1..{PAGED_V2_MAX_ROWS} query heads per KV head")
    if splits is None:
        splits = decode_splits(q, page_table, k_pages.shape[1], use_hfa,
                               pairs)
    out = _launch_v2("paged_decode_fwd_v2", q, k_pages, v_pages, page_table,
                     [kv_lens], rows=q.shape[2], row_blocks=1, splits=splits,
                     scale=scale, use_hfa=use_hfa, k_scales=k_scales,
                     v_scales=v_scales)
    _count_paged("decode", "v2")
    return out


def launch_paged_verify(q, k_pages, v_pages, page_table, seq_lens,
                        chunk_lens, *, scale: float, use_hfa: bool,
                        splits: int | None = None,
                        row_blocks: int | None = None, k_scales=None,
                        v_scales=None, pairs: int | None = None):
    """Paged verify on the current stream, on the kernel
    :func:`paged_verify_route` picks; counted in :data:`paged_launches`.
    q (B, Hkv, G, K, d); returns the f32 triplet o~ (B, Hkv, G, K, d), m
    and l (B, Hkv, G, K).  On the v2 route ``splits`` (default
    :func:`verify_splits` for ``pairs`` (slot, kv head) walks, default B
    Hkv; > 1 on the FA-2 rail only) and ``row_blocks`` (default
    :func:`verify_row_blocks`) shape the grid; 1 and 1 is one unsplit
    walk a (slot, kv head)."""
    b, hkv, g, kw = q.shape[:4]
    if paged_verify_route(g, kw, k_pages.shape[1], use_hfa) == "simt":
        return launch_paged("paged_verify_fwd", q, k_pages, v_pages,
                            page_table, seq_lens, chunk_lens, scale=scale,
                            use_hfa=use_hfa, k_scales=k_scales,
                            v_scales=v_scales)
    if row_blocks is None:
        row_blocks = verify_row_blocks(g, kw, use_hfa)
    if splits is None:
        splits = verify_splits((b * hkv if pairs is None else pairs)
                               * row_blocks,
                               page_table.shape[1] * k_pages.shape[1],
                               use_hfa, sm_count(q.device))
    out = _launch_v2("paged_verify_fwd_v2", q, k_pages, v_pages, page_table,
                     [seq_lens, chunk_lens], rows=g * kw,
                     row_blocks=row_blocks, splits=splits, scale=scale,
                     use_hfa=use_hfa, k_scales=k_scales, v_scales=v_scales)
    _count_paged("verify", "v2")
    return out


def _check_dense(entry: str, q, k, v, *extra) -> None:
    tensors = [q, k, v, *extra]
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             f"{entry}: every tensor must be on the same CUDA device")
    _require(q.dtype in (torch.bfloat16, torch.float32)
             and k.dtype == q.dtype and v.dtype == q.dtype,
             f"{entry}: q, k, v must share a dtype in (bf16, f32), got "
             f"{q.dtype}/{k.dtype}/{v.dtype}")
    _require(q.dim() == 3 and k.dim() == 3 and k.shape == v.shape
             and k.shape[0] == q.shape[0] and k.shape[2] == q.shape[2],
             f"{entry}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
             f"{tuple(v.shape)} are not (BH, Lq, d) / (BH, Lkv, d)")
    _check_head_dim(entry, q.shape[2])
    _require(all(t.is_contiguous() for t in tensors),
             f"{entry}: every tensor must be contiguous")


def _dims(q, k, kv_len, q_offset, causal):
    bh, lq, d = q.shape
    return [bh, lq, k.shape[1], d, int(kv_len), int(q_offset), int(causal)]


def launch_dense_fwd(q, k, v, *, causal: bool, scale: float, kv_len: int,
                     q_offset: int, use_hfa: bool):
    """Dense attention forward on the current stream: O (BH, Lq, d) f32
    and, on the fa2 rail, LSE (BH, Lq) f32 (None on the H-FA rail).

    The dtype picks the kernel, with no fallback between them: bf16
    inputs go to the tensor-core kernel (``dense_attn_fwd_tc``), which
    raises on what it cannot take; f32 inputs to the CUDA-core kernel
    (``dense_attn_fwd``).  :data:`dense_fwd_launches` counts each."""
    _check_dense("dense_attn_fwd", q, k, v)
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = None if use_hfa else torch.empty(q.shape[:2], dtype=torch.float32,
                                           device=q.device)
    args = (*_dims(q, k, kv_len, q_offset, causal), ctypes.c_float(scale),
            int(use_hfa), ctypes.cast(_LUT, ctypes.c_void_p), _stream())
    lse_ptr = None if lse is None else _ptr(lse)
    if q.dtype == torch.bfloat16:
        _check_tc(q, k, v)
        err = library().dense_attn_fwd_tc(_ptr(q), _ptr(k), _ptr(v), _ptr(o),
                                          lse_ptr, None, *args)
        check(err, "dense_attn_fwd_tc")
        dense_fwd_launches["tc"] += 1
    else:
        err = library().dense_attn_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(o),
                                       lse_ptr, *args)
        check(err, "dense_attn_fwd")
        dense_fwd_launches["simt"] += 1
    return o, lse


def launch_dense_fwd_scores(q, k, v, *, causal: bool, scale: float,
                            kv_len: int, q_offset: int):
    """The tensor-core H-FA forward's scores-out instantiation, for the
    checks (not counted in :data:`dense_fwd_launches`): O (BH, Lq, d)
    f32 and the bf16 scores (BH, Lq, Lkv) it formed (after the scale and
    the bf16 rounding; zero where it formed none: tiles it skipped)."""
    _check_dense("dense_attn_fwd_tc", q, k, v)
    _require(q.dtype == torch.bfloat16,
             "dense_attn_fwd_tc: the scores-out variant takes bf16 inputs")
    _check_tc(q, k, v)
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    scores = torch.zeros((q.shape[0], q.shape[1], k.shape[1]),
                         dtype=torch.bfloat16, device=q.device)
    err = library().dense_attn_fwd_tc(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), None, _ptr(scores),
        *_dims(q, k, kv_len, q_offset, causal), ctypes.c_float(scale), 1,
        ctypes.cast(_LUT, ctypes.c_void_p), _stream())
    check(err, "dense_attn_fwd_tc (scores out)")
    return o, scores


def _check_tc(q, k, v) -> None:
    _require(q.shape[2] in TC_HEAD_DIMS,
             f"dense_attn_fwd_tc: head dim {q.shape[2]} not in "
             f"{TC_HEAD_DIMS} (fa2.pad_head_dim pads 32 and 96)")
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
             "dense_attn_fwd_tc: q, k, v must be 16-byte aligned (TMA)")
    _require(-(-q.shape[1] // DENSE_TC_ROWS) <= 65535,
             f"dense_attn_fwd_tc: {q.shape[1]} query rows exceed the grid")


def _bwd_inputs(entry, q, k, v, do, lse, delta, do_dtype=torch.float32):
    _check_dense(entry, q, k, v, do, lse, delta)
    _require(do.dtype == do_dtype and do.shape == q.shape
             and lse.dtype == torch.float32 and delta.dtype == torch.float32
             and lse.shape == q.shape[:2] and delta.shape == q.shape[:2],
             f"{entry}: do must be {do_dtype} like q, lse and delta f32 "
             f"(BH, Lq)")
    return [_ptr(t) for t in (q, k, v, do, lse, delta)]


def launch_dense_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                    kv_len: int, q_offset: int) -> torch.Tensor:
    """FA-2 backward dq (BH, Lq, d) in q's dtype on the current stream,
    on the CUDA cores (f32 ``do``)."""
    ptrs = _bwd_inputs("dense_attn_dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    err = library().dense_attn_dq(
        *ptrs, _ptr(dq), *_dims(q, k, kv_len, q_offset, causal),
        ctypes.c_float(scale), int(q.dtype == torch.bfloat16), _stream())
    check(err, "dense_attn_dq")
    dense_dq_launches["simt"] += 1
    return dq


def launch_dense_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                     kv_len: int, q_offset: int):
    """FA-2 backward (dk, dv) (BH, Lkv, d) in k's dtype on the current
    stream, on the CUDA cores (f32 ``do``)."""
    ptrs = _bwd_inputs("dense_attn_dkv", q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = library().dense_attn_dkv(
        *ptrs, _ptr(dk), _ptr(dv), *_dims(q, k, kv_len, q_offset, causal),
        ctypes.c_float(scale), int(q.dtype == torch.bfloat16), _stream())
    check(err, "dense_attn_dkv")
    dense_dkv_launches["simt"] += 1
    return dk, dv


def _tc_bwd_inputs(entry, q, k, v, do, lse, delta):
    """What the tensor-core backward takes, checked before any launch:
    bf16 q, k, v and do, f32 lse and delta, every one 16-byte aligned
    (TMA), and a grid within range."""
    ptrs = _bwd_inputs(entry, q, k, v, do, lse, delta, torch.bfloat16)
    _require(q.shape[2] in TC_HEAD_DIMS,
             f"{entry}: head dim {q.shape[2]} not in {TC_HEAD_DIMS} "
             f"(fa2.pad_head_dim pads 32 and 96)")
    _require(q.dtype == torch.bfloat16,
             f"{entry}: q, k, v must be bf16 (f32 goes to the CUDA cores)")
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v, do, lse, delta)),
             f"{entry}: q, k, v, do, lse and delta must be 16-byte aligned "
             f"(TMA)")
    bh, lq, _ = q.shape
    blocks = max(-(-n // DENSE_BWD_TC_ROWS) for n in (lq, k.shape[1]))
    _require(blocks <= 65535 and bh * lq < 2 ** 31,
             f"{entry}: BH {bh} x Lq {lq} / Lkv {k.shape[1]} exceed the grid")
    return ptrs


def launch_dense_dq_tc(q, k, v, do, lse, delta, *, causal: bool,
                       scale: float, kv_len: int,
                       q_offset: int) -> torch.Tensor:
    """FA-2 backward dq (BH, Lq, d) bf16 on the tensor cores, on the
    current stream; raises a ValueError on what the kernel cannot take."""
    ptrs = _tc_bwd_inputs("dense_attn_dq_tc", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    err = library().dense_attn_dq_tc(
        *ptrs, _ptr(dq), *_dims(q, k, kv_len, q_offset, causal),
        ctypes.c_float(scale), _stream())
    check(err, "dense_attn_dq_tc")
    dense_dq_launches["tc"] += 1
    return dq


def launch_dense_dkv_tc(q, k, v, do, lse, delta, *, causal: bool,
                        scale: float, kv_len: int, q_offset: int):
    """FA-2 backward (dk, dv) (BH, Lkv, d) bf16 on the tensor cores, on
    the current stream; raises a ValueError on what the kernel cannot
    take."""
    ptrs = _tc_bwd_inputs("dense_attn_dkv_tc", q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = library().dense_attn_dkv_tc(
        *ptrs, _ptr(dk), _ptr(dv), *_dims(q, k, kv_len, q_offset, causal),
        ctypes.c_float(scale), _stream())
    check(err, "dense_attn_dkv_tc")
    dense_dkv_launches["tc"] += 1
    return dk, dv


def rail_eval(x: torch.Tensor, source: str = "paged"):
    """The rail device functions of one source (a key of
    :data:`RAIL_ENTRIES`; ``dense_tc`` is the tensor-core forward's
    integer form) over an f32 CUDA tensor: (quant_rail(x),
    exp2_hfa_rail(quant_rail(x)), recip_logdiv(x))."""
    _require(x.is_cuda and x.dtype == torch.float32 and x.is_contiguous(),
             "rail_eval: needs a contiguous f32 CUDA tensor")
    outs = [torch.empty_like(x) for _ in range(3)]
    entry = RAIL_ENTRIES[source]
    err = getattr(library(), entry)(_ptr(x), *map(_ptr, outs), x.numel(),
                                    ctypes.cast(_LUT, ctypes.c_void_p),
                                    _stream())
    check(err, entry)
    return tuple(outs)


def launch_dense_decode(q, k, v, *, scale: float, kv_len: int,
                        use_hfa: bool, splits: int | None = None):
    """Dense decode triplet on the current stream (``dense_decode_fwd_v2``).
    q (..., G, d) contiguous; k, v (..., S, d) with the same one or two
    leading dims, sharing strides, each key's d values contiguous and
    every stride and base 16-byte aligned (the ring is read in place by
    cp.async).  ``splits`` (default :func:`dense_decode_splits`) > 1
    splits each walk into runs of 128-key tiles, FA-2 rail only.
    Returns o~ (..., G, d), m and l (..., G), f32."""
    entry = "dense_decode_fwd_v2"
    _require(all(t.is_cuda and t.device == q.device for t in (k, v)),
             f"{entry}: every tensor must be on the same CUDA device")
    _require(q.dtype in (torch.bfloat16, torch.float32)
             and k.dtype == q.dtype and v.dtype == q.dtype,
             f"{entry}: q, k, v must share a dtype in (bf16, f32), got "
             f"{q.dtype}/{k.dtype}/{v.dtype}")
    _require(q.dim() in (3, 4) and k.dim() == q.dim()
             and k.shape == v.shape and k.stride() == v.stride()
             and k.shape[:-2] == q.shape[:-2] and k.shape[-1] == q.shape[-1]
             and k.stride(-1) == 1,
             f"{entry}: q {tuple(q.shape)} and k/v {tuple(k.shape)} are not "
             f"(..., G, d) / (..., S, d) with shared strides and a "
             f"contiguous last dim")
    _check_head_dim(entry, q.shape[-1])
    _require(1 <= q.shape[-2] <= DECODE_MAX_G,
             f"{entry}: {q.shape[-2]} query heads per KV head, the kernel "
             f"takes 1..{DECODE_MAX_G}")
    size = k.element_size()
    _require(all(t.data_ptr() % 16 == 0 for t in (k, v))
             and all(st * size % 16 == 0 for st in k.stride()[:-1]),
             f"{entry}: the ring's base and strides {k.stride()} must be "
             f"16-byte aligned (cp.async of 16-byte chunks)")
    q = q.contiguous()
    lead = q.shape[:-2]
    n0, n1 = (1, lead[0]) if len(lead) == 1 else lead
    s0, s1 = (0, k.stride(0)) if len(lead) == 1 else (k.stride(0),
                                                      k.stride(1))
    g, d, s_len = q.shape[-2], q.shape[-1], k.shape[-2]
    if splits is None:
        splits = dense_decode_splits(n0 * n1, min(kv_len, s_len), use_hfa,
                                     sm_count(q.device))
    _require(splits >= 1 and not (use_hfa and splits > 1),
             f"{entry}: {splits} splits (the H-FA rail runs unsplit)")
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    l = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, m, l
    ws = cnt = None
    if splits > 1:
        ws, cnt = _split_buffers(q.device, n0 * n1,
                                 n0 * n1 * splits * g * (d + 2))
    err = library().dense_decode_fwd_v2(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(m), _ptr(l),
        None if ws is None else _ptr(ws), None if cnt is None else _ptr(cnt),
        n0, n1, g, s_len, d, s0, s1, k.stride(-2), int(kv_len), splits,
        ctypes.c_float(scale), int(use_hfa), int(q.dtype == torch.bfloat16),
        ctypes.cast(_LUT, ctypes.c_void_p), _stream())
    check(err, entry)
    return o, m, l


def _check_datapath(entry, q, k, v) -> None:
    _check_dense(entry, q, k, v)
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
             f"{entry}: q, k, v must be 16-byte aligned (cp.async)")


def launch_hfa_datapath(q, k, v, *, causal: bool, scale: float,
                        kv_len: int, q_offset: int) -> torch.Tensor:
    """Per-element LNS H-FA on the current stream: (BH, Lq, d) bf16."""
    _check_datapath("hfa_datapath_fwd", q, k, v)
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    err = library().hfa_datapath_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        *_dims(q, k, kv_len, q_offset, causal), ctypes.c_float(scale),
        int(q.dtype == torch.bfloat16), ctypes.cast(_CORR, ctypes.c_void_p),
        _stream())
    check(err, "hfa_datapath_fwd")
    return out


def launch_hfa_datapath_scores(q, k, *, causal: bool, scale: float,
                               kv_len: int, q_offset: int) -> torch.Tensor:
    """The bf16 scores (BH, Lq, Lkv) ``hfa_datapath_fwd`` forms for the
    same call, from the same code; zero where it forms none."""
    _check_datapath("hfa_datapath_scores", q, k, k)
    scores = torch.zeros((q.shape[0], q.shape[1], k.shape[1]),
                         dtype=torch.bfloat16, device=q.device)
    err = library().hfa_datapath_scores(
        _ptr(q), _ptr(k), _ptr(scores), *_dims(q, k, kv_len, q_offset, causal),
        ctypes.c_float(scale), int(q.dtype == torch.bfloat16), _stream())
    check(err, "hfa_datapath_scores")
    return scores


def lns_eval(sign_a, raw_a, sign_b, raw_b, x, bits):
    """The LNS device functions of the datapath source over n elements
    (CUDA tensors: int32 signs and bf16 bit patterns, f32 rail values and
    score differences): (lns_add sign, lns_add raw, quant_scorediff(x),
    blinn_log2 sign, blinn_log2 raw, lns_to_bf16(sign_a, raw_a),
    exp2_neg(bits & 0xFFFF) from the correction table)."""
    ins = (sign_a, raw_a, sign_b, raw_b, x, bits)
    dts = (torch.int32, torch.float32, torch.int32, torch.float32,
           torch.float32, torch.int32)
    n = raw_a.numel()
    _require(all(t.is_cuda and t.dtype == dt and t.is_contiguous()
                 and t.numel() == n for t, dt in zip(ins, dts)),
             "lns_eval: needs contiguous CUDA tensors of one length "
             "(int32 signs and bits, f32 rails)")
    outs = (torch.empty_like(sign_a), torch.empty_like(raw_a),
            torch.empty_like(x), torch.empty_like(bits),
            torch.empty_like(raw_a),
            torch.empty(n, dtype=torch.int16, device=raw_a.device),
            torch.empty_like(raw_a))
    err = library().lns_eval(*map(_ptr, ins), *map(_ptr, outs), n,
                             ctypes.cast(_CORR, ctypes.c_void_p), _stream())
    check(err, "lns_eval")
    return outs[:5] + (outs[5].view(torch.bfloat16), outs[6])
