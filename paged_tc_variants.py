"""Where the time of the redesigned kernels goes, on one NVIDIA GPU.

  python3 paged_tc_variants.py [variant ...]

Builds variants of ``src/repro_torch/csrc/paged_attention_tc.cu`` and of
``src/repro_torch/csrc/hfa_datapath.cu`` - each a text edit of the source
or of a header it includes that removes or changes one part of the work
- with nvcc into ``build/paged_tc_variants/<variant>/``, and times every
variant in this one process, on one card: the paged ones at the
kernels-phase shapes of ``chip_smoke.py`` (prefill: B 2, Hkv 8, G 2,
512-token chunks at 520 and 1000, d 128, bf16, page 16; decode: B 8, kv
up to 2048, split 5 and 8 on the FA-2 rail and unsplit; verify: B 8, K
5, split 8 on the FA-2 rail, one block a query head on the H-FA rail),
the datapath (``dp_`` variants) at the dense-serve prefill shape (BH 128,
L 512, d 128, bf16, causal).  Each time is the best of 5 CUDA-event
windows of back-to-back launches (50 paged, 10 datapath) called straight
through ctypes, so the host adds no gap.  The variants that remove work
give wrong results: they exist only to be timed.

  base        the source as it is
  no_pv       no P V wgmma (the rescale stays)
  no_s        no S = Q K^T wgmma (the rail runs on zeros)
  no_rail     no rail: alpha 1, P the raw scores
  no_rail_pv  neither the rail nor P V
  ring2       a 2-stage K/V ring (the source has 4)
  units1      one warpgroup (one query head) a block, 2-stage ring
  tiles4      the unsplit bf16 decode at G 2 in 4-tile steps (the source
              takes 8)
  dc_ring3    a 3-step cp.async ring in the decode and verify (the source
              has 2)
  dc_rpt1     the FA-2 verify one row a thread (the source takes two)
  dc_hfa_rpt2 the H-FA verify at one query head a block two rows a
              thread (the source takes one)
  dc_abs      the decode and verify walks cut into runs at tile indices
              fixed by the table width, not by each slot's length
  dp_base     the datapath source as it is (the correction from a
              1,024-byte table at min(d, 1023), 16 rows a block, 4 a
              thread, 32-key tiles)
  dp_g7shift  the correction as g7[d & 127] >> (d >> 7) from the table's
              first 128 bytes (32 words: no bank conflicts)
  dp_arith    the correction computed: the reference's 8-segment PWL
              with select chains, no table
  dp_rows32   32 rows a block, 8 a thread
  dp_rpt2     2 rows a thread (twice the threads)
  dp_keys64   64-key tiles
  dp_no_c     no column pass (the scores, V's LNS form and the row pass
              alone)

Without a card, or without nvcc, it exits non-zero.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import cuda_lib  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "paged_tc_variants"

PV = "        pf_issue_pv<D, HFA>(o, ph[j], pl[j], v_addr, j);\n"
S = "      pf_issue_qk<D>(sc, q_addr, smem_u32(k_s + s * kStage));\n"
RAIL = ("      pf_rail_stage<HFA>(sc, m, l, alpha, ph, pl, bar->tab, p.scale, key_s, t, "
        "lim);\n")
NO_RAIL = """#pragma unroll
      for (int j = 0; j < kPfPages; ++j) {
        alpha[j][0] = alpha[j][1] = 1.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ph[j][q] = pack_bf16(sc[8 * j + 2 * q], sc[8 * j + 2 * q + 1]);
          pl[j][q] = ph[j][q];
        }
      }
"""
RING2 = ("constexpr int kPfStages = 4; ", "constexpr int kPfStages = 2; ")
TAB = "  return tab[min(d, kCorrTab - 1)];\n"


def _pwl_correction() -> str:
    """exp2_neg(d) in integer arithmetic: the reference's PWL with its
    Q1.15 coefficients as literals in select chains."""
    from repro_torch.core import lns
    lut = [int(x) for x in lns.pwl_lut16()]
    body = ["  const int f7 = d & 127, seg = f7 >> 4;",
            f"  int a = {lut[0]}, b = {lut[8]};"]
    for i in range(1, 8):
        body.append(f"  a = seg >= {i} ? {lut[i]} : a;")
        body.append(f"  b = seg >= {i} ? {lut[8 + i]} : b;")
    body.append("  return (((((a * f7) >> 7) + b) + 128) >> 8) >> "
                "min(d >> 7, 8);")
    return "\n".join(body) + "\n"


COLUMN = ("    if (masked)\n      column_pass<D, true>(vl_s + c, w_s + g * kRpt, "
          "nk, sa, ra, tab);\n    else\n      column_pass<D, false>(vl_s + c, "
          "w_s + g * kRpt, nk, sa, ra, tab);\n")
# Source of each variant: the datapath's start with dp_; the paged ones
# link the v2 kernel's codec instantiations beside it.
DP_SRC, PAGED_SRC = "hfa_datapath.cu", "paged_attention_tc.cu"
PAGED_CODEC_SRC = "paged_decode_v2_codec.cu"
VARIANTS = {
    "base": [],
    "no_pv": [(PV, "")],
    "no_s": [(S, "")],
    "no_rail": [(RAIL, NO_RAIL)],
    "no_rail_pv": [(RAIL, NO_RAIL), (PV, "")],
    "ring2": [RING2],
    "units1": [("constexpr int kPfUnits = 2; ", "constexpr int kPfUnits = 1; "),
               RING2],
    "tiles4": [("  constexpr int kWideStep = sizeof(T) <= 2 ? 8 : 4;",
                "  constexpr int kWideStep = 4;")],
    "dc_ring3": [("constexpr int kDcRing = 2;", "constexpr int kDcRing = 3;")],
    "dc_rpt1": [("return launch_dc<TQ, T, D, false, kWide, 4, 2>(p, lut, B, s);",
                 "return launch_dc<TQ, T, D, false, 2 * kWide, 4, 1>(p, lut, B, "
                 "s);")],
    "dc_hfa_rpt2": [(": launch_dc<TQ, T, D, true, kWide, 4, 1>(p, lut, B, s);",
                     ": launch_dc<TQ, T, D, true, kWide, 4, 2>(p, lut, B, s);")],
    "dc_abs": [("const int per = (n_tiles + p.splits - 1) / p.splits;",
                "const int per = ((p.J * p.page + kDcTile - 1) / kDcTile + "
                "p.splits - 1) / p.splits;")],
    "dp_base": [],
    "dp_g7shift": [(TAB, "  return tab[d & 127] >> min(d >> 7, 8);\n")],
    "dp_arith": [(TAB, None)],            # filled in from the LUT at build
    "dp_rows32": [("constexpr int kRows = 16;", "constexpr int kRows = 32;"),
                  ("constexpr int kRpt = 4;", "constexpr int kRpt = 8;")],
    "dp_rpt2": [("constexpr int kRpt = 4;", "constexpr int kRpt = 2;")],
    "dp_keys64": [("constexpr int kKeys = 32;", "constexpr int kKeys = 64;")],
    "dp_no_c": [(COLUMN, "")],
}


def build(names: list[str]) -> dict:
    """Build every variant in parallel; returns name -> loaded library.
    An edit applies to the source or to the headers that hold its text."""
    nvcc = cuda_lib._nvcc()
    procs = {}
    for name in names:
        src = DP_SRC if name.startswith("dp_") else PAGED_SRC
        files = {"k.cu": (CSRC / src).read_text()}
        if src == PAGED_SRC:
            files["k_codec.cu"] = (CSRC / PAGED_CODEC_SRC).read_text()
        files.update({h.name: h.read_text() for h in CSRC.glob("*.cuh")})
        for old, new in VARIANTS[name]:
            new = _pwl_correction() if new is None else new
            hits = [f for f, text in files.items() if old in text]
            if not hits:
                raise RuntimeError(f"variant {name}: the sources no longer "
                                   f"hold {old.strip()[:60]!r}")
            for f in hits:
                files[f] = files[f].replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             *(str(d / f) for f in files if f.endswith(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed:\n{err}")
        entries = (("hfa_datapath_fwd",) if name.startswith("dp_") else
                   ("paged_prefill_fwd_tc", "paged_decode_fwd_v2",
                    "paged_verify_fwd_v2"))
        libs[name] = cuda_lib.bind(ctypes.CDLL(str(OUT / name / "lib.so")),
                                   entries)
    return libs


def shapes():
    """The kernels-phase inputs (seeded) and the launch argument lists."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    hkv, g, d, page, j = 8, 2, 128, 16, 128

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def pools(b):
        n = b * j + 16
        pt = rng.permutation(n)[:b * j].reshape(b, j)
        return (rnd(n, page, hkv, d), rnd(n, page, hkv, d),
                torch.tensor(pt, dtype=torch.int32, device="cuda"))

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device="cuda")
    kp, vp, pt = pools(2)
    start = i32([520, 1000])
    pf = [rnd(2, hkv, g, 512, d), kp, vp, pt, start,
          start + i32([512, 300])]
    pf += [torch.empty((2, hkv, g, 512, d), device="cuda")] + [
        torch.empty((2, hkv, g, 512), device="cuda") for _ in range(2)]
    kvl = rng.integers(1, 2049, 8)
    kvl[3], kvl[5] = 0, 2048
    kp, vp, pt = pools(8)
    dc = [rnd(8, hkv, g, d), kp, vp, pt, i32(kvl),
          torch.empty((8, hkv, g, d), device="cuda")] + [
        torch.empty((8, hkv, g), device="cuda") for _ in range(2)] + [
        torch.empty(8 * hkv * 8 * g * (d + 2), device="cuda"),
        torch.zeros(8 * hkv, dtype=torch.int32, device="cuda")]
    sl = rng.integers(1, 2048 - 5, 8)
    cl = rng.integers(1, 6, 8)
    sl[3], cl[3], cl[0] = 0, 0, 5
    vf = [rnd(8, hkv, g, 5, d), kp, vp, pt, i32(sl), i32(cl),
          torch.empty((8, hkv, g, 5, d), device="cuda")] + [
        torch.empty((8, hkv, g, 5), device="cuda") for _ in range(2)] + [
        torch.empty(8 * hkv * 8 * g * 5 * (d + 2), device="cuda"),
        torch.zeros(8 * hkv * g, dtype=torch.int32, device="cuda")]
    return pf, dc, vf, (hkv, g, d, page, j, pf[1].shape[0])


def datapath_inputs():
    """The dense-serve prefill's datapath inputs (seeded) and output."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((128, 512, 128), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    return [q, k, v, torch.empty_like(q)]


def timed(fn, n: int = 50) -> float:
    for _ in range(5):
        if fn() != 0:
            raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / n)
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_tc_variants: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    libs = build(names)
    pf, dc, vf, (hkv, g, d, page, j, n_pages) = shapes()
    lut = ctypes.cast(cuda_lib._LUT, ctypes.c_void_p)
    scale = ctypes.c_float(d ** -0.5)

    def ptrs(ts):
        return [ctypes.c_void_p(t.data_ptr()) for t in ts]

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dp = datapath_inputs()
    corr = ctypes.cast(cuda_lib._CORR, ctypes.c_void_p)
    for name, lib in libs.items():
        if name.startswith("dp_"):
            def datapath(lib=lib):
                return lib.hfa_datapath_fwd(*ptrs(dp), 128, 512, 512, 128,
                                            512, 0, 1, scale, 1, corr,
                                            stream())
            print(f"{name:12s} datapath ms (BH 128, L 512, d 128, causal) "
                  f"{timed(datapath, n=10):.4f}", flush=True)
            continue

        def prefill(hfa, lib=lib):
            return lib.paged_prefill_fwd_tc(*ptrs(pf), 2, hkv, g, 512, d, j,
                                            page, n_pages, scale, hfa, lut,
                                            stream())

        def decode(hfa, splits, lib=lib):
            return lib.paged_decode_fwd_v2(*ptrs(dc[:3]), None, None,
                                           *ptrs(dc[3:]), 8, hkv, g, d, j,
                                           page, splits, scale, hfa, 1, 0,
                                           lut, stream())
        def verify(hfa, splits, row_blocks, lib=lib):
            return lib.paged_verify_fwd_v2(*ptrs(vf[:3]), None, None,
                                           *ptrs(vf[3:]), 8, hkv, g, 5, d, j,
                                           page, splits, row_blocks, scale,
                                           hfa, 1, 0, lut, stream())
        print(f"{name:12s} prefill ms fa2 {timed(lambda: prefill(0)):.4f} "
              f"hfa {timed(lambda: prefill(1)):.4f} | decode ms fa2 split 5 "
              f"{timed(lambda: decode(0, 5)):.4f}, split 8 "
              f"{timed(lambda: decode(0, 8)):.4f}, unsplit fa2 "
              f"{timed(lambda: decode(0, 1)):.4f} hfa "
              f"{timed(lambda: decode(1, 1)):.4f} | verify ms fa2 split 8 "
              f"{timed(lambda: verify(0, 8, 1)):.4f}, hfa {g} row blocks "
              f"{timed(lambda: verify(1, 1, g)):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
