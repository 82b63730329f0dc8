"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. Print the card's name and power limit (``nvidia-smi``), then build
   the kernels from ``src/repro_torch/csrc/`` with nvcc for sm_90a.
2. Kernels.  The rail device functions of both sources must equal the
   plain torch rail bit for bit over every finite bf16 value.  Each
   paged kernel, on both rails, runs at the main path's shapes
   (qwen3-1.7b: 16 query heads over 8 KV heads, d_head 128, page 16,
   bf16 pools, shuffled page tables, ragged lengths up to 2048, a free
   slot) and is held against its plain version on the same CUDA
   tensors: the decode and the verify the main path runs
   (``paged_decode_fwd_v2`` and ``paged_verify_fwd_v2``, split on the fa2
   rail; verify one block a query head on the hfa rail) and the CUDA-core
   ones (``_simt``), the tensor-core prefill (``paged_prefill_fwd_tc``)
   and the CUDA-core one.  The v2 decode and verify unsplit must equal
   the CUDA-core decode and verify bit for bit on both rails, and split
   be within 1e-5 (decode) and 2e-7 (verify) of unsplit; a verify of G K
   = 20 rows must take the CUDA-core route; the tensor-core prefill on a
   dyadic grid within 1e-5 of the CUDA-core one.  On the H-FA rail at
   pages 4, 3, 32, 128 and 256 decode, verify and prefill must each take
   the CUDA-core body, which rescales once a page as the reference does
   (above page 16 a page staged 64 keys at a time), and lie within 1e-5
   of the per-page models on a dyadic grid, m equal; on the FA-2 rail at
   page 4 decode and verify stay on v2.  The H-FA decode and verify at
   pages 4, 16, 32, 128 and 256 are timed on the route they take and on
   v2 unsplit, the route the H-FA rail took at every page size before it
   rescaled once a page.  The page codecs: every paged row again on
   int8 and log16 pools (rows ``<row>_int8``, ``<row>_log16``), both
   rails, against its plain version with the codec's decode (FA-2
   within 1e-5, H-FA as the fp rows), each launch counted on its route
   (int8 prefill on the CUDA cores, log16 prefill - a bf16 view - on the
   tensor cores, decode and verify on v2); the int8 rows, built with
   power-of-two scales, bit-equal to the same kernel on the bf16 pool of
   their decoded values, and the int8 v2 decode and verify unsplit
   bit-equal to the CUDA-core body; timed as the fp rows, bounded on the
   codec's bytes (int8 d + 4 a row).
   One line per kernel: its time (events, and the device's own from
   torch.profiler), the plain version's, one
   ``F.scaled_dot_product_attention`` call on a pre-gathered dense view
   (fa2 rail; a yardstick the port never calls) and the bound.  Then
   the bf16 dense forward on the tensor cores, both rails, at the
   training shape (B 4, H 16 after the GQA expand, L 2048, d 128,
   causal) and at the dense-serve prefill shape (BH 128, L 512): (1)
   fa2: O and LSE within 1e-5 of the plain version; (2) hfa on a dyadic
   grid, where no summation order can move a score: O within 1e-5; (3)
   hfa on random inputs through the scores-out variant: every score the
   kernel formed within one bf16 ulp of the plain f32 score (the share
   that round apart is printed) and O within 1e-5 of the plain walk fed
   those scores; both rails timed beside SDPA and the bound (products at
   the bf16 peak, and on hfa the rail on the CUDA cores, overlapped).
   Then dq and dk/dv at the training shape against their plain
   versions, both routes of ``fa2_backward``: bf16 ``do`` on the tensor
   cores (dense_attention_bwd_tc.cu, the training path) and f32 ``do``
   on the CUDA cores, each launch and each route's whole backward timed
   beside SDPA's autograd backward.  Then the
   dense decode kernel (``dense_decode_fwd_v2``) at the dense-serve
   decode shape (B 8 x Hkv 8, G 2, kv_len 576 of a 640-slot bf16 ring read
   in place, d 128) on both rails (fa2 split, and within 1e-5 of its
   unsplit walk; hfa on a dyadic grid within 1e-5 of the plain 128-key
   walk), beside SDPA on the same decode, and the per-element LNS
   datapath kernel at the dense-serve prefill shape (BH 128, L 512, d
   128, causal): bit for bit on inputs whose scores are exact (a
   dyadic grid), and on random inputs every row bit for bit against the
   plain walk fed the scores the kernel forms (``hfa_datapath_scores``;
   the share of rows whose kernel scores differ from the einsum's is
   printed), also at d 32, 64, 96 and 128, bf16 and f32; its device time
   beside its bound (the LNS updates at the instructions of the
   reference's definition).  The LNS device functions must equal the
   plain ones bit for bit over every bf16 pattern and rail value, and the
   correction table the plain exp2_neg over all 65,536 d.  Last, every kernel
   at d 96 (hfa-paper-mini's head dim, G 1) and d 32 (G 2), bf16 and f32,
   against its plain version.  The LNS ablations of Table III: every
   ``LNSConfig`` (the default, EXACT and each single switch) through
   ``core.hfa.hfa_attention`` and ``hfa_blockparallel`` at d 64 (q and k
   on a dyadic grid), card against CPU, the differing output bits
   counted (none allowed; under exact_mitchell one rail step, reported).
   Pools: int8 data and scales and log16 bits encoded on the card equal
   the CPU's bit for bit.
3. Reference check on a small input: the reduced qwen3-1.7b (f32) gives
   the same logits through the kernels on the card as through the plain
   versions on the CPU - paged prefill, decode and verify (on fp, int8
   and log16 pools: an f32 q over int8 and over bf16 pools), and the dense
   ring's prefill and decode steps on fa2, hfa_pallas, hfa and
   hfa_datapath - and the same training loss and gradients; those f32
   runs must reach the dense forward and backward and the paged prefill
   through the CUDA-core kernels only, and the paged decode and verify
   (page 4) through v2 on the FA-2 rail and through the CUDA-core body on
   the H-FA rail.
4. Engine.  Full-width qwen3-1.7b (28 layers, random bf16 weights from
   seed 0) serves 16 requests sharing a 520-token system prompt through
   ``ServingEngine`` on both rails with spec_k 0 and 4.  Every request
   must finish with its token count, every logit must be finite, the
   cache invariants must hold, and each kernel's launch counter must
   grow on every run whose path uses it: every prefill on the tensor
   cores, every decode (spec_k 0) and every verify (spec_k 4) on v2, none
   on a CUDA-core paged kernel.  On fa2 a further spec_k 0 run with every
   decode
   walk unsplit prints how far its streams agree with the spec_k 4 and
   the split spec_k 0 runs.
   Engine, codecs (``engine_codecs``).  The same model and workload with
   ``kv_codec`` int8 at spec_k 0 and 4 and log16 at spec_k 0, both rails:
   the pool's bytes a token must be the codec's; every int8 prefill runs
   on the CUDA cores, every log16 prefill on the tensor cores, every
   decode and verify on v2; log16's streams must equal the fp spec_k 0
   run's token for token (at bf16 compute a log16 pool holds the K/V's
   bf16 bits); int8's agreement with fp is printed, not asserted.
   Engine, sampled (``engine_sampled``).  The same workload with seeded
   sampling (temperature 0.8, top-k 50, top-p 0.95,
   repetition penalty 1.1, seed = rid), rid 0 an n=4 group, rid 1
   best_of=3, rid 2 a beam-4 search returning 4 hypotheses, rid 3 with
   logprobs, on both rails at spec_k 0, 4 and "auto": every request and
   completion finishes with its 64 tokens, every logit is finite, the
   cache invariants hold after every step, beam scores are ranked and
   negative, every logprob is finite and <= 0, and every prefill (the
   all-position logprob prefill included) runs on the tensor cores and
   every decode and verify on v2.  These sampled runs take rail_model's
   weights cut to their first 4 of 28 layers (``CUT_LAYERS``, full width,
   the same kernels at the same shapes): a cut of depth, because at full
   depth this phase took 226-308 s and the script up to 1,049.2 s of its
   1,200 s limit.  The rest is at full depth: a temperature-0.8 top_k=1
   run must equal the engine phase's greedy run token for token (a
   greedy run of its own when that phase did not run); the whole-prompt
   prefill (no start_pos) must run every layer on the tensor cores and
   give the chunked prefill's last logits; JAX's threefry keys, bits, uniform
   draws and randint on the card must equal the CPU's bit for bit; and
   ``sample_tokens`` on a captured batch of card logits must choose the
   CPU's tokens, a row whose choice sits within 1e-6 of the top-p
   boundary excepted (counted).  Walls, tok/s, launches and the
   sampler's time are printed.  The engine phases share each rail's
   model (``rail_model``).
   Serving stack (``serving_stack``).  The engine phases' settings
   behind the stack a user calls, on rail_model's weights cut to their
   first 4 of 28 layers (``CUT_LAYERS``, full width) since the families
   phase joined the script (its checks hold at any depth).  HTTP: the
   16-request workload as concurrent SSE streams through ``HttpServer``
   over an ``AsyncFrontend``, fp, spec_k 0, both rails; a probe against
   a cap of 1 answers 429 while requests wait for a slot; then a sampled
   tenant stream, a ``stream: false`` request and a disconnect after 4
   tokens.
   The engine's submits and cancels are recorded with its step count
   (``record_arrivals``) and replayed through ``ServingEngine.step`` on a
   fresh engine: every stream must equal the replay token for token (on
   the card decode rounding depends on the batch, ROADMAP Queue 3 B6),
   the disconnect's tokens a prefix of it; the pool clean, the frontend
   not failed.  TTFT p50 / p99 and tok/s by the client's clock and the
   walls of both are printed.  Router: two replicas over the fa2 model,
   two 520-token system prompts, a first request and three follow-ups on
   each; every follow-up must land on the replica holding its prompt's
   prefix; replica 1 is marked down with its requests in flight, the
   rids it hands back are sent again and land on replica 0; each
   replica's streams equal the replay of its own record, both pools
   clean.  Disaggregation: ``DisaggPair`` of two engines over the
   workload (16 new tokens a request) on fa2 with fp, int8 and log16
   pools and on hfa with fp: every imported page bit-equal to the
   exporter's in every leaf (int8's scales too), the streams equal a
   single engine's that first ran each prompt alone with
   max_new_tokens=1, a mid-handoff abort and a stage fallback leave both
   pools clean; the copy's ms a handoff by events beside its bound (the
   pages' bytes read and written at 3.35 TB/s).
   Tensor and data parallel (``tp``).  The workload and engine settings
   of the engine phase on a serving mesh (``launch/mesh.py``), at full
   width with rail_model's weights cut to their first 4 of 28 layers
   (``CUT_LAYERS``: sharing one card, a run costs about a second a layer):
   rank 0 is this process and drives the engine, the other ranks are
   spawned and follow it (``launch/ranks.py``), every rank on this card
   with the gloo backend, which moves the collectives' tensors through
   host memory.
   First, on this rank alone and without collectives: each shard's
   decode, verify and prefill over its KV heads at the kernels phase's
   shapes, padded with the merge's neutral element and merged by Eq. 16,
   must equal the single call's finalize on every live row, both rails,
   tp 2 and 4.  Then the 16-request greedy workload at tp 2 on both rails
   at spec_k 0 and 4, at tp 2 x dp 2 (4 ranks) on both rails at spec_k 0,
   and at tp 2 on int8 pools on fa2: every rank's streams must equal the
   single-shard engine's token for token (the same cut model run here
   first, in this process).  That
   equality is expected, not lucky: a head's triplet comes from one
   shard, the merge with the neutral element is an fp identity, and each
   shard's v2 decode and verify split its walks as the single call does
   (the split rule is sized by the whole call's (slot, kv head) pairs,
   ``cuda_lib.decode_splits``), so every head is computed as the single
   shard computes it.  Each rank's measured pool (``pool_bytes_per_shard``)
   must be half the single shard's, ``triplet_bytes`` the reference's
   formula over the run's paged calls, the ranks' stats equal, and each
   rank's paged launches on the engine phase's routes.  Walls and the
   tp-over-single ratio are printed beside the card's name and power
   limit.  What one card cannot check: NCCL (it refuses two ranks on one
   device) and anything across cards; the walls time gloo through host
   memory, not NVLink.
   Families (``families``).  Every other config the reference's paged
   engine serves.  First, on small inputs as phase 3: the reduced
   granite-moe-1b-a400m and the reduced hfa-paper-mini at its d_head 96
   (f32, page 4) give the same logits through the kernels on the card as
   through the plain versions on the CPU, both rails (the MoE model's CPU
   run takes the card's routing, ``card_routing``: a router choice is
   discontinuous, and the H-FA rail moves a router logit by up to a rail
   step; the tokens the CPU would have routed otherwise are counted).
   Then hfa-paper-mini (32 layers, d_model 3072, 32 heads over 32 KV
   heads, d_head 96, vocab 32064) and granite-moe-1b-a400m (24 layers,
   d 1024, 32 experts top-8, d_ff 512, vocab 49155) at full width and
   full depth serve 8 requests of the engine phase's workload (32 new
   tokens each) on the engine phase's settings: hfa-paper-mini on hfa at
   spec_k 0 and 4 and on fa2 at 0, every prefill on the CUDA cores (d
   96 is not a tensor-core head dim), decode and verify (G K = 5) on
   v2, then ``serve --dense``'s loop (8 x 256 prompts, 16 steps,
   hfa_pallas: the tensor-core forward at d 96 and the dense decode);
   granite on fa2 at spec_k 0 and 4 and on hfa at 0, prefill on the
   tensor cores, decode and verify (G K = 10) on v2, and its fa2 spec_k
   0 run again, equal token for token.  On layer 0's captured MoE input
   (the first decode batch and the last prefill chunk, free and padding
   rows included) ``moe_apply`` on the card and on the CPU (the same
   bf16 inputs upcast to f32) route every assignment to the same
   experts and drop the same ones - a token within 1e-6 of a tie and
   the slots such a tie moved excepted, counted - and their outputs
   agree within 2^-7 of the largest; the drops are printed.  Then
   qwen1.5-4b, minitron-8b, phi3.5-moe-42b-a6.6b and command-r-plus-104b
   at full width cut to their first 2 layers (``FAMILY_CUT_LAYERS``: one
   card holds neither phi3.5-moe, ~84 GB in bf16, nor command-r-plus,
   ~208 GB), 4 requests of 16 tokens on fa2 at spec_k 0 and 4: verify
   of G K = 20 (minitron, phi3.5-moe) and 60 (command-r-plus) rows on
   the CUDA cores, of 5 (qwen1.5-4b) on v2.  Every run finishes each
   request with its tokens, finite logits and the cache invariants, and
   launches exactly its routes (``family_routes``); walls, tok/s,
   launches and each model's parameter bytes are printed.  hfa-paper-mini's
   hfa spec_k 0 run and command-r-plus's spec_k 4 run go again under
   torch.profiler: the CUDA-core paged kernel's device time beside the
   device's busy time and the wall (launches not counted).
5. Dense serve.  Full-width qwen3-1.7b (random bf16 weights from seed
   0) through ``repro_torch.launch.serve._serve_dense``, the fixed-batch
   loop of ``serve --dense``: 8 prompts of 512 tokens from
   ``DataPipeline`` (seed 0), 64 greedy decode steps, a 640-slot dense
   ring, on impls fa2, hfa_pallas and hfa_datapath.  Each run must
   launch the dense decode kernel (``dense_decode_fwd_v2``, the only
   one) on every step of every layer and its
   prefill kernel on every layer (fa2 and hfa_pallas: the tensor-core
   forward, 28 launches, none on the CUDA-core one), give finite logits
   and 8 x 64 tokens; prefill ms, decode ms/token, tok/s, launches and the tokens that
   agree with the fa2 run are printed.
6. Train.  Full-width qwen3-1.7b (random bf16 weights from seed 0) on
   the fa2_pallas and hfa_pallas rails: 2 warm and 3 timed
   ``make_train_step`` steps at global batch 4 x seq 2048 from
   ``DataPipeline``; loss and grad norm must be finite, each dense
   kernel of the rail must launch, and the forward 56 times a step
   (forward and remat of 28 layers), every time on the tensor-core
   kernel; on fa2_pallas dq and dk/dv 28 times a step each, every time
   on the tensor-core kernels.  Step time, tokens/s and peak memory
   are printed.  Then ``Trainer.run`` on the reduced (f32) config with
   an injected failure restarts from its step-4 checkpoint (under
   ``build/``); its backward runs on the CUDA-core kernels.
7. Adafactor.  command-r-plus-104b at full width (d_model 12288, 96
   heads over 8 KV heads, d_head 128, vocab 256,000) cut to 2 of 64
   layers (``ADAFACTOR_LAYERS``; 64 layers are ~208 GB in bf16), bf16,
   impl fa2, its own optimizer, ``microbatches`` 1 (a second one adds f32
   gradient sums of 37.8 GB): 3 ``Trainer`` steps at batch 2 x seq 1024
   from ``DataPipeline``, no checkpoint.  The loss must be finite, the
   watched rows of the embedding and wq must move (a bf16 norm scale of
   1 does not at this lr: no f32 master copy), and the forward (12), dq (6)
   and dk/dv (6) must all run on the tensor-core kernels.  Step walls,
   losses and peak memory are printed.  Then one Adafactor update of the
   embedding (3.15e9 values, in chunks of 2^26), the stacked wq, the
   norm scales (factored across the layers) and the final norm from the
   same bf16 parameters and gradients: chunked on the card against the
   unchunked plain update on the CPU, the moments within 1e-5 of their
   scale and the new parameters at most one bf16 rounding apart.
8. SSM.  mamba2-2.7b (random bf16 weights from seed 0): ``serve
   --dense``'s loop at all 64 layers, 8 x 128 prompts and 16 steps
   (prefill ms and ms/token printed); the model cut to 2 layers at f32,
   card against CPU on the same weights (prefill of 2 x 128 and 8 greedy
   steps: logits and the SSM state within 1e-4 of their scale, the greedy
   tokens equal); layer 0's chunked scan against its token-by-token
   recurrence over 256 tokens on the card (1e-4); 3 AdamW ``Trainer``
   steps at 4 of 64 layers, batch 4 x seq 512.  No attention kernel may
   launch.
9. Print ``{"kernels": [...]}``, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Opt-in phases, named on the command line (``python3 chip_smoke.py
kernels profile_train`` runs just those): ``profile`` traces engine
steps, ``profile_train`` one full-width training step per rail (with
the dense attention kernels' share of the step) and
``profile_dense`` full-width dense decode steps under torch.profiler;
``decode_variants`` times the v2 verify and the dense decode at other
grids (runs of the walk, blocks of the rows).

There is no CPU fallback: without a card the script stops at once.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import functools
import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import decode as decode_k  # noqa: E402
from repro_torch.kernels import page_codec  # noqa: E402
from repro_torch.kernels import bitmath  # noqa: E402
from repro_torch.kernels import fa2 as fa2_k  # noqa: E402
from repro_torch.kernels import fa2_bwd  # noqa: E402
from repro_torch.kernels import hfa as hfa_k  # noqa: E402
from repro_torch.kernels import hfa_datapath as dp_k  # noqa: E402
from repro_torch.kernels import paged_decode as pd  # noqa: E402
from repro_torch.kernels import paged_prefill as pp  # noqa: E402
from repro_torch.kernels import paged_verify as pv  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.core import jax_random as jr  # noqa: E402
from repro_torch.core import lns  # noqa: E402
from repro_torch.data import DataPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import ranks as rank_programs  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import (make_tp_dp_mesh,  # noqa: E402
                                     make_tp_mesh, run_ranks)
from repro_torch.models import mamba2, moe  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import (Adafactor, AdamW,  # noqa: E402
                               build_optimizer)
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.runtime.trainer import (  # noqa: E402
    Trainer, TrainerConfig, make_train_step)
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AsyncFrontend, DisaggPair, HttpServer, Router, stream_generate)
from repro_torch.serving import SamplingParams  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12          # H100 SXM f32 on the CUDA cores
SRC = "src/repro_torch/csrc/paged_attention.cu"
PAGED_TC_SRC = "src/repro_torch/csrc/paged_attention_tc.cu"
DENSE_SRC = "src/repro_torch/csrc/dense_attention.cu"
DENSE_BWD_TC_SRC = "src/repro_torch/csrc/dense_attention_bwd_tc.cu"
DECODE_SRC = "src/repro_torch/csrc/dense_decode.cu"
DATAPATH_SRC = "src/repro_torch/csrc/hfa_datapath.cu"
REPLACES = {"paged_decode": "src/repro/kernels/paged_decode.py:51",
            "paged_decode_simt": "src/repro/kernels/paged_decode.py:51",
            "paged_prefill": "src/repro/kernels/paged_prefill.py:38",
            "paged_prefill_simt": "src/repro/kernels/paged_prefill.py:38",
            "paged_verify": "src/repro/kernels/paged_verify.py:47",
            "paged_verify_simt": "src/repro/kernels/paged_verify.py:47",
            "fa2_fwd": "src/repro/kernels/fa2.py:26",
            "fa2_bwd_dq": "src/repro/kernels/fa2_bwd.py:30",
            "fa2_bwd_dkv": "src/repro/kernels/fa2_bwd.py:73",
            "fa2_bwd_dq_simt": "src/repro/kernels/fa2_bwd.py:30",
            "fa2_bwd_dkv_simt": "src/repro/kernels/fa2_bwd.py:73",
            "hfa_fwd": "src/repro/kernels/hfa.py:38",
            "dense_decode": "src/repro/kernels/decode.py:33",
            "hfa_datapath": "src/repro/kernels/hfa_datapath.py:31"}
MODULES = {"paged_decode": pd, "paged_prefill": pp, "paged_verify": pv}
# The paged kernels' rows: (kind, source, the route's key in
# cuda_lib.paged_launches, the kernel's name in a trace).  paged_decode,
# paged_prefill and paged_verify are the redesigned kernels the main path
# runs; the _simt rows the CUDA-core ones, which the decode path no
# longer launches, the prefill path launches for f32 pools and d 32 / 96
# and the verify path for more than 16 rows a (slot, kv head).
PAGED_ROWS = {"paged_decode": ("paged_decode", PAGED_TC_SRC,
                               ("decode", "v2"), "paged_decode_v2_kernel"),
              "paged_decode_simt": ("paged_decode", SRC, ("decode", "simt"),
                                    "paged_attention_kernel"),
              "paged_prefill": ("paged_prefill", PAGED_TC_SRC,
                                ("prefill", "tc"), "paged_prefill_tc_kernel"),
              "paged_prefill_simt": ("paged_prefill", SRC,
                                     ("prefill", "simt"),
                                     "paged_attention_kernel"),
              "paged_verify": ("paged_verify", PAGED_TC_SRC, ("verify", "v2"),
                               "paged_decode_v2_kernel"),
              "paged_verify_simt": ("paged_verify", SRC, ("verify", "simt"),
                                    "paged_attention_kernel")}
# Launch counter of each dense kernel: (module, attribute) or (dict,
# key).  The backward counts by route: "fa2_bwd_dq" and "fa2_bwd_dkv" are
# the tensor-core kernels, "..._simt" the CUDA-core ones.
DENSE_COUNTERS = {"fa2_fwd": (fa2_k, "launches"),
                  "fa2_bwd_dq": (cuda_lib.dense_dq_launches, "tc"),
                  "fa2_bwd_dkv": (cuda_lib.dense_dkv_launches, "tc"),
                  "fa2_bwd_dq_simt": (cuda_lib.dense_dq_launches, "simt"),
                  "fa2_bwd_dkv_simt": (cuda_lib.dense_dkv_launches, "simt"),
                  "hfa_fwd": (hfa_k, "launches"),
                  "dense_decode": (decode_k, "launches"),
                  "hfa_datapath": (dp_k, "launches")}
RAIL_KERNELS = {"fa2_pallas": ("fa2_fwd", "fa2_bwd_dq", "fa2_bwd_dkv"),
                "hfa_pallas": ("hfa_fwd",)}
# Tolerances on the finalized attention output, kernel vs plain version
# on the same CUDA tensors.  fa2: both are exact softmax in f32, differing
# only in summation order (online over 16-position tiles vs one shot).
# hfa: the kernel rescales online on the rail, so a key's weight is a
# product of quantized exponentials where the plain version quantizes
# once; one rail step is 2^(1/128) - 1 = 0.54% and a dot-order difference
# can flip a step.  m (the running max) is plain f32 on both rails.
ATOL_OUT = {"fa2": 1e-3, "hfa": 1e-2}
ATOL_M = 1e-3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 20, inner: int = 5) -> float:
    """Median ms per call over ``reps`` CUDA-event windows of ``inner``
    calls each, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_ms(fn, key: str = "", calls: int = 20) -> float:
    """Device time per call of the kernels whose name holds ``key`` (all
    that ``fn`` launches by default), from torch.profiler over ``calls``
    calls after a warm-up: the kernels' own time, where :func:`timed`
    also counts the gaps a host-bound caller leaves between launches.
    A window in which the profiler recorded no device time (it drops a
    window now and then) is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and key in e.key)
        if us > 0:
            return us / 1e3 / calls
    raise RuntimeError(f"torch.profiler recorded no device time for "
                       f"{key or 'the call'} in three windows")


# ------------------------------------------------------------- phase 2
def check_rail() -> None:
    bits = torch.arange(1 << 16, dtype=torch.int32) << 16
    x = bits.view(torch.float32)
    # Every finite bf16 value, and a sweep that reaches every rail value.
    x = torch.cat([x[torch.isfinite(x)],
                   torch.linspace(-20.0, 5.0, 1_000_003)]).cuda()
    want_rail = bitmath.quant_rail(x)
    want = (want_rail, bitmath.exp2_hfa_rail(want_rail),
            bitmath.recip_logdiv(x))
    for source in cuda_lib.RAIL_ENTRIES:
        got_all = cuda_lib.rail_eval(x, source)
        for name, got, w in zip(("quant_rail", "exp2_hfa_rail",
                                 "recip_logdiv"), got_all, want):
            bad = int((got.view(torch.int32) != w.view(torch.int32)).sum())
            if bad:
                raise AssertionError(f"rail {name} ({source} source): {bad} "
                                     f"of {x.numel()} values differ from the "
                                     "plain version")
        print(f"rail ({source} source): quant_rail, exp2_hfa_rail, "
              f"recip_logdiv bit-equal to the plain torch rail over "
              f"{x.numel()} values (every finite bf16, every rail value)")


def kernel_cases(gen: torch.Generator):
    """Main-path shapes of qwen3-1.7b: (name, args, rows, live mask)."""
    hkv, g, d, page, j = 8, 2, 128, 16, 128           # 2048 tokens/slot
    rng = np.random.default_rng(0)

    def pools(b):
        num_pages = b * j + 16
        kp = torch.randn((num_pages, page, hkv, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
        vp = torch.randn((num_pages, page, hkv, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
        pt = rng.permutation(num_pages)[:b * j].reshape(b, j)
        return kp, vp, torch.tensor(pt, dtype=torch.int32, device="cuda")

    def q(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device="cuda")

    cases = {}
    b = 8
    kvl = rng.integers(1, 2049, b)
    kvl[3], kvl[5] = 0, 2048                          # free slot, full slot
    cases["paged_decode"] = ((q(b, hkv, g, d), *pools(b), i32(kvl)),
                             (kvl > 0)[:, None], kvl - 1, kvl)
    sl = rng.integers(1, 2048 - 5, b)
    cl = rng.integers(1, 6, b)
    sl[3], cl[3] = 0, 0                               # free slot
    cl[0] = 5
    cases["paged_verify"] = ((q(b, hkv, g, 5, d), *pools(b), i32(sl),
                              i32(cl)),
                             np.arange(5)[None] < cl[:, None], sl, sl + cl)
    start = np.array([520, 1000])
    chunk = np.array([512, 300])
    cases["paged_prefill"] = ((q(2, hkv, g, 512, d), *pools(2), i32(start),
                               i32(start + chunk)),
                              np.arange(512)[None] < chunk[:, None],
                              start, start + chunk)
    return cases


def _bound(args, live, base, limit, row_bytes=None):
    """Least time for the same work: bytes (live K/V pages, q, triplet
    out) over the memory rate vs flops (QK and PV over visible keys)
    over the bf16 peak.  ``row_bytes``: stored bytes of one K or V row of
    one KV head (default 2 d, bf16; the int8 codec's d + 4)."""
    q, kp = args[0], args[1]
    b, hkv, g = q.shape[:3]
    ell = 1 if q.dim() == 4 else q.shape[3]
    d, page = q.shape[-1], kp.shape[1]
    row_bytes = 2 * d if row_bytes is None else row_bytes
    pos = base[:, None] + np.arange(ell)[None]              # (B, L)
    vis = np.clip(np.minimum(pos + 1, limit[:, None]), 0, None)
    n_kv = vis.max(axis=1)                                  # per slot
    kv_bytes = int(np.sum(-(-n_kv // page))) * page * hkv * row_bytes * 2
    io_bytes = q.numel() * 2 + b * hkv * g * ell * (d + 2) * 4
    flops = 4 * d * hkv * g * float(np.sum(vis * live))
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _sdpa(args, name):
    """One SDPA call on a pre-gathered dense view: (fn, inputs built
    outside the timed region)."""
    q, kp, vp, pt = args[:4]
    b, hkv, g = q.shape[:3]
    d = q.shape[-1]
    ell = 1 if q.dim() == 4 else q.shape[3]
    # (B, S, Hkv, d) -> (B, H, S, d), kv heads repeated kv-major.
    kd = pd.gather_pages(kp, pt).permute(0, 2, 1, 3).repeat_interleave(
        g, dim=1).contiguous()
    vd = pd.gather_pages(vp, pt).permute(0, 2, 1, 3).repeat_interleave(
        g, dim=1).contiguous()
    qd = q.reshape(b, hkv * g, ell, d)
    s = kd.shape[2]
    kv = torch.arange(s, device="cuda")
    if name == "paged_decode":
        base, limit = args[4] - 1, args[4]
    elif name == "paged_prefill":
        base, limit = args[4], args[5]
    else:
        base, limit = args[4], args[4] + args[5]
    pos = base[:, None] + torch.arange(ell, device="cuda")[None]
    mask = (kv[None, None] <= pos[..., None]) & \
        (kv[None, None] < limit[:, None, None])
    mask = mask[:, None]                                    # (B,1,L,S)
    return lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                  attn_mask=mask)


def _prefill_simt(q, *args, use_hfa=False):
    """The paged prefill on the CUDA-core kernel, for the checks (the
    wrapper's rule picks the tensor cores for bf16 at d 64 / 128)."""
    return cuda_lib.launch_paged("paged_prefill_fwd", q, *args,
                                 scale=q.shape[-1] ** -0.5, use_hfa=use_hfa)


def _decode_split(q, *args, splits, use_hfa=False):
    """The v2 paged decode with its walk split into ``splits`` runs (1:
    unsplit), for the checks."""
    return cuda_lib.launch_paged_decode(q, *args, scale=q.shape[-1] ** -0.5,
                                        use_hfa=use_hfa, splits=splits)


def _verify_v2(q, *args, splits, row_blocks, use_hfa=False):
    """The v2 paged verify at a given grid: ``splits`` runs of the walk
    (1: unsplit) and ``row_blocks`` blocks of the rows, for the checks."""
    return cuda_lib.launch_paged_verify(q, *args, scale=q.shape[-1] ** -0.5,
                                        use_hfa=use_hfa, splits=splits,
                                        row_blocks=row_blocks)


def _bits_differ(got, want) -> int:
    return sum(int((a.view(torch.int32) != w.view(torch.int32)).sum())
               for a, w in zip(got, want))


def _paged_fns(row: str):
    """(kernel call, plain version) of a paged row: the wrapper the main
    path calls, or for a _simt row the CUDA-core kernel."""
    kind = PAGED_ROWS[row][0]
    plain = getattr(MODULES[kind], f"{kind}_partial_plain")
    if row == "paged_decode_simt":
        return pd.paged_decode_partial_simt, plain
    if row == "paged_prefill_simt":
        return _prefill_simt, plain
    if row == "paged_verify_simt":
        return pv.paged_verify_partial_simt, plain
    return getattr(MODULES[kind], f"{kind}_partial"), plain


def _check_paged_exact(cases) -> dict:
    """The checks that hold the redesigned kernels to the CUDA-core ones
    at the kernels-phase shapes: (a) the v2 decode, unsplit, bit-equal
    to paged_decode_fwd on both rails, and split (the main path's
    splits) within 1e-5 of its unsplit walk after finalize, m exact;
    (b) the tensor-core prefill on a dyadic grid (q and the K pool
    within +-0.5: every score and every page's sum of p exact in any
    order) within 1e-5 of the CUDA-core prefill after finalize, m exact,
    on both rails; (c) the v2 verify, unsplit, bit-equal to
    paged_verify_fwd on both rails, in one block of the G K rows and in
    one block a query head, and split (the main path's splits, FA-2)
    within 2e-7 of its unsplit walk after finalize, m exact; (d) a verify
    of G K = 20 rows on the CUDA-core route, against its plain version."""
    out = {}
    args = cases["paged_decode"][0]
    splits = cuda_lib.decode_splits(args[0], args[3], args[1].shape[1],
                                    False)
    for rail in ("fa2", "hfa"):
        use_hfa = rail == "hfa"
        got = _decode_split(*args, splits=1, use_hfa=use_hfa)
        want = pd.paged_decode_partial_simt(*args, use_hfa=use_hfa)
        torch.cuda.synchronize()
        bad = _bits_differ(got, want)
        if bad:
            raise AssertionError(f"paged_decode v2 unsplit [{rail}]: {bad} "
                                 "values differ from paged_decode_fwd")
    o1, m1, l1 = _decode_split(*args, splits=1)
    o2, m2, l2 = _decode_split(*args, splits=splits)
    err_split = float((decode_k.finalize_decode(o2, l2) -
                       decode_k.finalize_decode(o1, l1)).abs().max())
    if not (torch.equal(m1, m2) and err_split <= 1e-5
            and bool(torch.isfinite(o2).all())):
        raise AssertionError(f"paged_decode v2 split {splits}: max |out - "
                             f"unsplit| {err_split:.3g} (atol 1e-5), m equal "
                             f"{torch.equal(m1, m2)}")
    out["decode_splits"] = splits
    out["decode_split_err"] = err_split
    print(f"check paged_decode: v2 unsplit bit-equal to paged_decode_fwd on "
          f"both rails; split into {splits} runs (FA-2) vs unsplit: max "
          f"|out err| {err_split:.3g} (atol 1e-5), m equal")
    args = cases["paged_verify"][0]
    q = args[0]
    b, hkv, g, kw = q.shape[:4]
    for rail in ("fa2", "hfa"):
        use_hfa = rail == "hfa"
        want = pv.paged_verify_partial_simt(*args, use_hfa=use_hfa)
        for rb in (1, g):
            got = _verify_v2(*args, splits=1, row_blocks=rb, use_hfa=use_hfa)
            torch.cuda.synchronize()
            bad = _bits_differ(got, want)
            if bad:
                raise AssertionError(f"paged_verify v2 unsplit, {rb} row "
                                     f"blocks [{rail}]: {bad} values differ "
                                     "from paged_verify_fwd")
    v_splits = cuda_lib.verify_splits(
        b * hkv, args[3].shape[1] * args[1].shape[1], False,
        cuda_lib.sm_count(q.device))
    o1, m1, l1 = _verify_v2(*args, splits=1, row_blocks=1)
    o2, m2, l2 = _verify_v2(*args, splits=v_splits, row_blocks=1)
    err_v = float((decode_k.finalize_decode(o2, l2) -
                   decode_k.finalize_decode(o1, l1)).abs().max())
    if not (torch.equal(m1, m2) and err_v <= 2e-7
            and bool(torch.isfinite(o2).all())):
        raise AssertionError(f"paged_verify v2 split {v_splits}: max |out - "
                             f"unsplit| {err_v:.3g} (atol 2e-7), m equal "
                             f"{torch.equal(m1, m2)}")
    out["verify_splits"] = v_splits
    out["verify_split_err"] = err_v
    print(f"check paged_verify: v2 unsplit bit-equal to paged_verify_fwd on "
          f"both rails (1 and {g} row blocks); split into {v_splits} runs "
          f"(FA-2) vs unsplit: max |out err| {err_v:.3g} (atol 2e-7), m "
          f"equal")
    # G K = 20 rows: the CUDA-core route, against the plain version.
    gen = torch.Generator(device="cuda").manual_seed(5)
    q20 = torch.randn((b, hkv, 4, kw, q.shape[-1]), generator=gen,
                      device="cuda").to(q.dtype)
    live = torch.tensor(cases["paged_verify"][1], device="cuda")
    mask = live[:, None, None].expand(q20.shape[:4])
    assert cuda_lib.paged_verify_route(4, kw, 16, False) == "simt"
    for rail in ("fa2", "hfa"):
        use_hfa = rail == "hfa"
        before = dict(cuda_lib.paged_launches["verify"])
        res = [fn(q20, *args[1:], use_hfa=use_hfa) for fn in
               (pv.paged_verify_partial, pv.paged_verify_partial_plain)]
        torch.cuda.synchronize()
        err = float((decode_k.finalize_decode(res[0][0], res[0][2],
                                              use_hfa=use_hfa) -
                     decode_k.finalize_decode(res[1][0], res[1][2],
                                              use_hfa=use_hfa))[mask]
                    .abs().max())
        err_m = float((res[0][1] - res[1][1])[mask].abs().max())
        if cuda_lib.paged_launches["verify"] != {
                "v2": before["v2"], "simt": before["simt"] + 1} or not (
                err <= ATOL_OUT[rail] and err_m <= ATOL_M):
            raise AssertionError(f"paged_verify G K 20 [{rail}]: launches "
                                 f"{cuda_lib.paged_launches['verify']}, out "
                                 f"err {err:.3g}, m err {err_m:.3g}")
        print(f"check paged_verify G K 20 [{rail}]: CUDA-core route, max "
              f"|out err| {err:.3g} (atol {ATOL_OUT[rail]}), m {err_m:.3g}")
    q, kp, vp, pt, start, kvl = cases["paged_prefill"][0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    qa = hfa_k.dyadic_bf16(q.shape, gen, "cuda", bound=0.5)
    ka = hfa_k.dyadic_bf16(kp.shape, gen, "cuda", bound=0.5)
    live = torch.tensor(cases["paged_prefill"][1], device="cuda")
    mask = live[:, None, None].expand(q.shape[:4])
    for rail in ("fa2", "hfa"):
        use_hfa = rail == "hfa"
        assert cuda_lib.paged_prefill_route(qa, ka, pt) == "tc"
        res = [fn(qa, ka, vp, pt, start, kvl, use_hfa=use_hfa)
               for fn in (pp.paged_prefill_partial, _prefill_simt)]
        torch.cuda.synchronize()
        o_tc, o_simt = (decode_k.finalize_decode(o, l, use_hfa=use_hfa)[mask]
                        for o, _, l in res)
        err = float((o_tc - o_simt).abs().max())
        same_m = torch.equal(res[0][1][mask], res[1][1][mask])
        if not (err <= 1e-5 and same_m):
            raise AssertionError(f"paged_prefill tc [{rail}] on the dyadic "
                                 f"grid: max |out - CUDA-core| {err:.3g} "
                                 f"(atol 1e-5), m equal {same_m}")
        out[f"prefill_dyadic_{rail}_err"] = err
        print(f"check paged_prefill [{rail}]: tensor cores vs CUDA cores on "
              f"the dyadic grid: max |out err| {err:.3g} (atol 1e-5), m "
              f"equal")
    return out


# Page sizes at which the H-FA rail's paged calls take the CUDA-core body,
# which rescales once a page as the reference does: below 16 (4; 3, whose
# tiles of 15 keys hold five pages) and above it (32, 128, 256: the page
# kernel, a page staged 64 keys at a time, its scores in shared memory).
PAGE_STEP_PAGES = (4, 3, 32, 128, 256)


def check_paged_page_step() -> dict:
    """The H-FA rail at page sizes other than 16 (PAGE_STEP_PAGES) at the
    main path's widths (Hkv 8, G 2, d 128, bf16 pools, shuffled page
    tables, a free slot): decode, verify (K 5) and prefill (a 128-token
    chunk at 300) through the wrappers must each launch the CUDA-core
    body once (paged_launches "simt") and, on a dyadic grid within +-0.5
    (every score and every page's sum of p exact), lie within 1e-5 of the
    per-page models (kernels/ref.py) after finalize, m bit for bit (the
    values of o~ and l that differ from the model at all are counted).
    On the FA-2 rail at page 4 decode and verify keep v2.  Returns the
    worst errors."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rng = np.random.default_rng(11)
    b, hkv, g, d, keys = 4, 8, 2, 128, 640
    out, bits = {}, {}
    for page in PAGE_STEP_PAGES:
        j = -(-keys // page)
        n = b * j + 8
        kp = hfa_k.dyadic_bf16((n, page, hkv, d), gen, "cuda", bound=0.5)
        vp = torch.randn((n, page, hkv, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
        pt = torch.tensor(rng.permutation(n)[:b * j].reshape(b, j),
                          dtype=torch.int32, device="cuda")

        def i32(a):
            return torch.tensor(a, dtype=torch.int32, device="cuda")
        kvl = i32([600, 0, 257, 33])
        sl, cl = i32([590, 0, 250, 30]), i32([5, 0, 3, 5])
        start, chunk = i32([300, 0, 0, 500]), i32([128, 0, 77, 100])
        cases = {
            "decode": ((hfa_k.dyadic_bf16((b, hkv, g, d), gen, "cuda",
                                          bound=0.5), kp, vp, pt, kvl),
                       pd.paged_decode_partial, ref.paged_decode_split_model,
                       (kvl > 0)[:, None, None]),
            "verify": ((hfa_k.dyadic_bf16((b, hkv, g, 5, d), gen, "cuda",
                                          bound=0.5), kp, vp, pt, sl, cl),
                       pv.paged_verify_partial, ref.paged_verify_split_model,
                       (torch.arange(5, device="cuda")[None] <
                        cl[:, None])[:, None, None]),
            "prefill": ((hfa_k.dyadic_bf16((b, hkv, g, 128, d), gen, "cuda",
                                           bound=0.5), kp, vp, pt, start,
                         start + chunk),
                        pp.paged_prefill_partial, ref.paged_prefill_model,
                        (torch.arange(128, device="cuda")[None] <
                         chunk[:, None])[:, None, None])}
        for kind, (args, wrapper, model, live) in cases.items():
            before = {k: dict(v) for k, v in cuda_lib.paged_launches.items()}
            got = wrapper(*args, use_hfa=True)
            torch.cuda.synchronize()
            before[kind]["simt"] += 1
            if cuda_lib.paged_launches != before:
                raise AssertionError(f"page {page} {kind} [hfa]: launches "
                                     f"{cuda_lib.paged_launches}, need one "
                                     "more on the CUDA cores only")
            kw = {} if kind == "prefill" else {"splits": 1}
            want = model(*args, use_hfa=True, **kw)
            mask = live.expand(got[1].shape)
            go, wo = (decode_k.finalize_decode(o, l, use_hfa=True)[mask]
                      for o, _, l in (got, want))
            err = float((go - wo).abs().max())
            same_m = torch.equal(got[1][mask], want[1][mask])
            bits[f"{kind}_{page}"] = sum(
                int((a[mask].view(torch.int32) != w[mask].view(torch.int32))
                    .sum()) for a, w in ((got[0], want[0]),
                                         (got[2], want[2])))
            if not (err <= 1e-5 and same_m
                    and bool(torch.isfinite(go).all())):
                raise AssertionError(f"page {page} {kind} [hfa]: CUDA-core "
                                     f"body vs the per-page model {err:.3g} "
                                     f"(atol 1e-5), m equal {same_m}")
            out[f"{kind}_{page}"] = err
        if page == 4:
            for kind in ("decode", "verify"):
                args, wrapper = cases[kind][:2]
                before = dict(cuda_lib.paged_launches[kind])
                wrapper(*args, use_hfa=False)
                if cuda_lib.paged_launches[kind] != {
                        "v2": before["v2"] + 1, "simt": before["simt"]}:
                    raise AssertionError(f"page 4 {kind} [fa2] left v2: "
                                         f"{cuda_lib.paged_launches[kind]}")
    print(f"check paged page step [hfa]: decode, verify, prefill at pages "
          f"{PAGE_STEP_PAGES} on the CUDA-core body (one page a rescale) vs "
          f"the per-page models on the dyadic grid: max |out err| "
          f"{max(out.values()):.3g} (atol 1e-5), m equal; o~ and l values "
          f"that differ from the model at all: {bits}; fa2 at page 4 stays "
          f"on v2")
    return out


# Pages at which the H-FA decode and verify are timed on the route each
# takes and on v2 (paged_attention_tc.cu, whose 16-key rescale the H-FA
# rail took at every page size before it rescaled once a page).
HFA_TIMED_PAGES = (4, 16, 32, 128, 256)


def _repage(pool, pt, page: int, perm: np.ndarray) -> torch.Tensor:
    """The keys a page-16 pool holds for the slots of ``pt``, in slot
    order, cut into pages of ``page`` keys and stored at ``perm``."""
    pages = pool[pt.long()].reshape(-1, page, *pool.shape[2:])
    out = torch.empty_like(pages)
    out[torch.as_tensor(perm, device=pool.device)] = pages
    return out


def time_hfa_page_routes(cases) -> dict:
    """The cost of the H-FA page rule: at the kernels-phase decode and
    verify shapes, the same slots' keys laid out at HFA_TIMED_PAGES, the
    device and event ms of the wrapper (the route the rule picks: the
    CUDA-core body at a page other than 16) beside v2 launched directly,
    unsplit, one block a query head for verify - the kernel and grid the
    H-FA rail took at every page size before the rule.  Timed only: at a
    page other than 16, v2 on the H-FA rail is not the reference's walk."""
    rng = np.random.default_rng(19)
    out = {}
    for kind, wrapper in (("decode", pd.paged_decode_partial),
                          ("verify", pv.paged_verify_partial)):
        q, kp16, vp16, pt16, *lens = cases[f"paged_{kind}"][0]
        g, kw = q.shape[2], q.shape[3] if kind == "verify" else 1
        for page in HFA_TIMED_PAGES:
            perm = rng.permutation(pt16.numel() * kp16.shape[1] // page)
            kp, vp = (_repage(x, pt16, page, perm) for x in (kp16, vp16))
            pt = torch.tensor(perm.reshape(pt16.shape[0], -1),
                              dtype=torch.int32, device="cuda")
            route = (cuda_lib.paged_decode_route(page, True)
                     if kind == "decode" else
                     cuda_lib.paged_verify_route(g, kw, page, True))

            def on_route(args=(q, kp, vp, pt, *lens)):
                return wrapper(*args, use_hfa=True)

            def on_v2(args=(q, kp, vp, pt, lens)):
                return cuda_lib._launch_v2(
                    f"paged_{kind}_fwd_v2", *args, rows=g * kw,
                    row_blocks=cuda_lib.verify_row_blocks(g, kw, True)
                    if kind == "verify" else 1, splits=1,
                    scale=q.shape[-1] ** -0.5, use_hfa=True)
            # The CUDA-core body's kernels: paged_attention_kernel, and
            # above page 16 paged_attention_page_kernel.
            kname = ("paged_attention" if route == "simt" else
                     "paged_decode_v2_kernel")
            t = {"route": route, "ms": timed(on_route),
                 "device_ms": device_ms(on_route, kname),
                 "v2_ms": timed(on_v2),
                 "v2_device_ms": device_ms(on_v2, "paged_decode_v2_kernel")}
            out[f"{kind}_{page}"] = t
            print(f"time hfa page rule [{kind}]: page {page}: route "
                  f"{route} {t['device_ms']:.4f} ms device ({t['ms']:.4f} "
                  f"events) | v2 unsplit {t['v2_device_ms']:.4f} "
                  f"({t['v2_ms']:.4f}) | route / v2 device "
                  f"{t['device_ms'] / t['v2_device_ms']:.2f}x")
            del kp, vp
    return out


CODECS = ("int8", "log16")
# The codec rows: (base row, codec) -> each paged row on int8 and log16
# pools.  The route row of an int8 prefill is the CUDA-core kernel: the
# tensor cores take bf16 pools only.
CODEC_ROWS = {f"{row}_{c}": (row, c) for c in CODECS for row in PAGED_ROWS}
# FA-2: the codec rows against their plain versions (the same decoded
# values, summation order only); H-FA: as the fp rows (ATOL_OUT).
ATOL_CODEC = {"fa2": 1e-5, "hfa": ATOL_OUT["hfa"]}


V2_CODEC_SRC = "src/repro_torch/csrc/paged_decode_v2_codec.cu"


def codec_row(row: str):
    """(kind, source, route key, trace name) of a paged row, codec rows
    included: the v2 kernel on int8 pools is instantiated in its own
    source."""
    base, codec = CODEC_ROWS.get(row, (row, None))
    if base == "paged_prefill" and codec == "int8":
        return PAGED_ROWS["paged_prefill_simt"]
    kind, src, key, kname = PAGED_ROWS[base]
    if codec == "int8" and src == PAGED_TC_SRC and kind != "paged_prefill":
        src = V2_CODEC_SRC
    return kind, src, key, kname


def dyadic_int8_bf16(shape, gen: torch.Generator) -> torch.Tensor:
    """bf16 rows whose int8 encoding is exact: each row is n 2^-j with n
    in [-127, 127], one |n| = 127, j in 7..10 per row (values within +-1)
    - so every scale (absmax / 127) is the power of two 2^-j, every value
    has at most 7 significant bits (exact in bf16), and decode (n * 2^-j)
    gives the row back bit for bit."""
    n = torch.randint(-127, 128, shape, generator=gen, device="cuda")
    n[..., 0] = 127 * (2 * torch.randint(0, 2, shape[:-1], generator=gen,
                                         device="cuda") - 1)
    j = torch.randint(7, 11, shape[:-1] + (1,), generator=gen, device="cuda")
    return (n.to(torch.float32) * torch.exp2(-j.to(torch.float32))).to(
        torch.bfloat16)


def _codec_fn(row: str, codec: str, pools: dict):
    """(kernel call, plain version) of a codec row, the encoded pools
    bound: each takes the case's (q, pt, *lens) around the pools."""
    base = CODEC_ROWS[row][0]
    wrapper, plain = _paged_fns(base)
    kw = dict(codec=codec, k_scales=pools["ks"], v_scales=pools["vs"])
    if base == "paged_prefill_simt":
        def wrapper(q, kd, vd, pt, *lens, use_hfa=False):
            kp, vp, ks, vs = pd.kernel_pools(codec, kd, vd, pools["ks"],
                                             pools["vs"])
            return cuda_lib.launch_paged(
                "paged_prefill_fwd", q, kp, vp, pt, *lens,
                scale=q.shape[-1] ** -0.5, use_hfa=use_hfa, k_scales=ks,
                v_scales=vs)
        return wrapper, lambda *a, **k: plain(*a, **k, **kw)
    return (lambda *a, **k: wrapper(*a, **k, **kw),
            lambda *a, **k: plain(*a, **k, **kw))


def check_codec_kernels(cases) -> list[dict]:
    """Each paged row on int8 and log16 pools at the kernels-phase
    shapes, both rails: (a) against its plain version with the codec's
    decode (FA-2 within 1e-5, H-FA within the fp rows' ATOL_OUT); (b) the
    int8 rows, whose K and V are built so that every scale is a power of
    two (``dyadic_int8_bf16``), bit-equal to the same kernel on the bf16
    pool of the decoded values - the tile decode is exact - and the v2
    decode and verify (unsplit) bit-equal to the CUDA-core ones; (c) the
    routes: int8 prefill on the CUDA cores, log16 prefill (a bf16 view) on
    the tensor cores, decode and verify on v2.  Times as the fp rows,
    bounds on the codec's bytes (int8: d + 4 a row, log16: 2 d)."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    pools = {}          # (kind, codec) -> encoded pools and the bf16 view
    for name in ("paged_decode", "paged_verify", "paged_prefill"):
        args = cases[name][0]
        for codec in CODECS:
            c = page_codec.get_codec(codec)
            if codec == "int8":
                kv = [dyadic_int8_bf16(tuple(args[1].shape), gen)
                      for _ in range(2)]
            else:
                kv = [args[1], args[2]]
            (kd, ks), (vd, vs) = (c.encode(x) for x in kv)
            if codec == "int8" and not all(torch.equal(
                    c.decode(d_, s_).to(torch.bfloat16), x)
                    for d_, s_, x in ((kd, ks, kv[0]), (vd, vs, kv[1]))):
                raise AssertionError("int8 pools on power-of-two scales do "
                                     "not decode to their values exactly")
            pools[(name, codec)] = dict(kd=kd, vd=vd, ks=ks, vs=vs,
                                        kp=kv[0], vp=kv[1])
    rows = []
    for row, (base, codec) in CODEC_ROWS.items():
        kind, src, key, kname = codec_row(row)
        args, live, base_pos, limit = cases[kind]
        pl = pools[(kind, codec)]
        cargs = (args[0], pl["kd"], pl["vd"], *args[3:])
        fn, plain = _codec_fn(row, codec, pl)
        entry = {"name": row, "route": "cuda", "source": src,
                 "replaces": REPLACES[base], "codec": codec}
        for rail in ("fa2", "hfa"):
            use_hfa = rail == "hfa"
            before = {k: dict(v) for k, v in cuda_lib.paged_launches.items()}
            got = fn(*cargs, use_hfa=use_hfa)
            torch.cuda.synchronize()
            before[key[0]][key[1]] += 1
            if cuda_lib.paged_launches != before:
                raise AssertionError(f"{row}[{rail}]: launches "
                                     f"{cuda_lib.paged_launches}, need one "
                                     f"more on {key}")
            want = plain(*cargs, use_hfa=use_hfa)
            shape = got[0].shape[:3] + ((1,) if got[0].dim() == 4
                                        else got[0].shape[3:4])
            mask = torch.tensor(np.broadcast_to(live[:, None, None, :],
                                                shape), device="cuda")
            ko, po = (decode_k.finalize_decode(o, l, use_hfa=use_hfa)
                      .reshape(*shape, -1) for o, _, l in (got, want))
            err = float((ko - po)[mask].abs().max())
            err_m = float((got[1].reshape(shape) - want[1].reshape(shape))[
                mask].abs().max())
            if not (torch.isfinite(ko[mask]).all() and err <= ATOL_CODEC[rail]
                    and err_m <= ATOL_M):
                raise AssertionError(f"{row}[{rail}] disagrees with its plain "
                                     f"version: max |out| err {err:.3g} (atol "
                                     f"{ATOL_CODEC[rail]}), m {err_m:.3g}")
            if codec == "int8":
                # The same kernel on the bf16 pool of the decoded values.
                same = "paged_prefill_simt" if base == "paged_prefill" \
                    else base
                ref_out = _paged_fns(same)[0](args[0], pl["kp"], pl["vp"],
                                              *args[3:], use_hfa=use_hfa)
                torch.cuda.synchronize()
                bad = _bits_differ(got, ref_out)
                if bad:
                    raise AssertionError(f"{row}[{rail}]: {bad} values differ "
                                         "from the bf16 pool of the decoded "
                                         "values")
            def call(use_hfa=use_hfa):
                return fn(*cargs, use_hfa=use_hfa)
            entry[f"{rail}_ms"] = timed(call)
            entry[f"{rail}_device_ms"] = device_ms(call, kname)
            entry[f"{rail}_plain_ms"] = timed(
                lambda: plain(*cargs, use_hfa=use_hfa), reps=5, inner=2)
            entry[f"{rail}_max_abs_err"] = err
        d = args[0].shape[-1]
        lib = _sdpa(args, kind)
        entry.update(
            ms=entry["fa2_ms"], plain_ms=entry["fa2_plain_ms"],
            device_ms=entry["fa2_device_ms"],
            max_abs_err=max(entry["fa2_max_abs_err"],
                            entry["hfa_max_abs_err"]),
            library_ms=timed(lib), library_device_ms=device_ms(lib))
        entry["bound_ms"], entry["bound_by"] = _bound(
            args, live, base_pos, limit,
            row_bytes=d + 4 if codec == "int8" else 2 * d)
        print(f"kernel {row} ({src.rsplit('/', 1)[1]}, {codec} pools): "
              f"kernel_ms fa2 {entry['fa2_ms']:.4f} hfa {entry['hfa_ms']:.4f} "
              f"(device {entry['fa2_device_ms']:.4f} / "
              f"{entry['hfa_device_ms']:.4f}) | plain_ms fa2 "
              f"{entry['fa2_plain_ms']:.4f} hfa {entry['hfa_plain_ms']:.4f} | "
              f"library_ms {entry['library_ms']:.4f} (SDPA on bf16 pools; "
              f"device {entry['library_device_ms']:.4f}) | bound_ms "
              f"{entry['bound_ms']:.4f} ({entry['bound_by']}) | max_abs_err "
              f"fa2 {entry['fa2_max_abs_err']:.3g} hfa "
              f"{entry['hfa_max_abs_err']:.3g}"
              + (" | bit-equal to the bf16 pool of its decoded values"
                 if codec == "int8" else ""))
        rows.append(entry)
    # The int8 tile decode in v2 is the CUDA-core body's, unsplit.
    for kind in ("paged_decode", "paged_verify"):
        args = cases[kind][0]
        pl = pools[(kind, "int8")]
        kw = dict(scale=args[0].shape[-1] ** -0.5, splits=1,
                  k_scales=pl["ks"], v_scales=pl["vs"])
        mod = pd if kind == "paged_decode" else pv
        for rail in ("fa2", "hfa"):
            use_hfa = rail == "hfa"
            cargs = (args[0], pl["kd"], pl["vd"], *args[3:])
            if kind == "paged_decode":
                got = cuda_lib.launch_paged_decode(*cargs, use_hfa=use_hfa,
                                                   **kw)
            else:
                got = cuda_lib.launch_paged_verify(*cargs, use_hfa=use_hfa,
                                                   row_blocks=1, **kw)
            want = getattr(mod, f"{kind}_partial_simt")(
                *cargs, use_hfa=use_hfa, codec="int8", k_scales=pl["ks"],
                v_scales=pl["vs"])
            torch.cuda.synchronize()
            bad = _bits_differ(got, want)
            if bad:
                raise AssertionError(f"{kind} int8 [{rail}]: v2 unsplit "
                                     f"differs from the CUDA-core body in "
                                     f"{bad} values")
    print("check codecs: int8 rows (power-of-two scales) bit-equal to the "
          "same kernels on the bf16 pools of their decoded values, both "
          "rails; int8 v2 decode and verify unsplit bit-equal to the "
          "CUDA-core body; every codec row within its plain version")
    return rows


def check_pools() -> None:
    """The codecs' encode on the card against the CPU's, bit for bit, at
    the engine's K/V shapes (a 512-token chunk of 8 slots, Hkv 8, d 128),
    bf16 and f32, with an all-zero row and bf16 subnormals."""
    gen = torch.Generator().manual_seed(17)
    x = torch.randn((8, 512, 8, 128), generator=gen)
    x[1, 2] = 0.0
    x[2, 3, 0, :16] = 1e-39
    for dt in (torch.bfloat16, torch.float32):
        for codec in CODECS:
            c = page_codec.get_codec(codec)
            (cd, cs), (gd, gs) = (c.encode(x.to(dt).to(dev))
                                  for dev in ("cpu", "cuda"))
            same = torch.equal(gd.cpu(), cd) and (cs is None or torch.equal(
                gs.cpu().view(torch.int32), cs.view(torch.int32)))
            if not same:
                raise AssertionError(f"pools: {codec} encode of {dt} differs "
                                     "between the card and the CPU")
    print("pools: int8 data and scales and log16 bits encoded on the card "
          "equal the CPU's bit for bit (bf16 and f32 K/V, 8 x 512 x 8 x 128)")


def check_kernels() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = kernel_cases(gen)
    exact = _check_paged_exact(cases)
    check_paged_page_step()
    time_hfa_page_routes(cases)
    codec_rows = check_codec_kernels(cases)
    rows = []
    measured = {}                 # kind -> (bound, bound_by, library_ms)
    for row_name, (name, src, _, kname) in PAGED_ROWS.items():
        args, live, base, limit = cases[name]
        wrapper, plain = _paged_fns(row_name)
        entry = {"name": row_name, "route": "cuda", "source": src,
                 "replaces": REPLACES[row_name]}
        for rail in ("fa2", "hfa"):
            use_hfa = rail == "hfa"
            ko, km, kl = wrapper(*args, use_hfa=use_hfa)
            po, pm, pl_ = plain(*args, use_hfa=use_hfa)
            torch.cuda.synchronize()
            shape = ko.shape[:3] + ((1,) if ko.dim() == 4 else ko.shape[3:4])
            mask = torch.tensor(np.broadcast_to(live[:, None, None, :],
                                                (shape[0], shape[1],
                                                 shape[2], shape[3])),
                                device="cuda")
            kout = decode_k.finalize_decode(ko, kl, use_hfa=use_hfa)
            pout = decode_k.finalize_decode(po, pl_, use_hfa=use_hfa)
            kout, pout = kout.reshape(*shape, -1), pout.reshape(*shape, -1)
            err = float((kout - pout)[mask].abs().max())
            err_m = float((km.reshape(shape) - pm.reshape(shape))[mask]
                          .abs().max())
            if not (torch.isfinite(kout[mask]).all() and err <= ATOL_OUT[rail]
                    and err_m <= ATOL_M):
                raise AssertionError(
                    f"{row_name}[{rail}] disagrees with its plain version: "
                    f"max |out| err {err:.3g} (atol {ATOL_OUT[rail]}), "
                    f"max |m| err {err_m:.3g} (atol {ATOL_M})")

            def call(use_hfa=use_hfa):
                return wrapper(*args, use_hfa=use_hfa)
            ms = timed(call)
            dev_ms = device_ms(call, kname)
            plain_ms = timed(lambda: plain(*args, use_hfa=use_hfa), reps=5,
                             inner=2)
            if rail == "fa2":
                entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             device_ms=dev_ms)
            entry[f"{rail}_ms"] = ms
            entry[f"{rail}_device_ms"] = dev_ms
            entry[f"{rail}_plain_ms"] = plain_ms
            entry[f"{rail}_max_abs_err"] = err
        entry["max_abs_err"] = max(entry["fa2_max_abs_err"],
                                   entry["hfa_max_abs_err"])
        if name not in measured:
            lib = _sdpa(args, name)
            measured[name] = (*_bound(args, live, base, limit), timed(lib),
                              device_ms(lib))
        (entry["bound_ms"], entry["bound_by"], entry["library_ms"],
         entry["library_device_ms"]) = measured[name]
        if row_name == "paged_decode":
            entry.update(splits=exact["decode_splits"],
                         split_err=exact["decode_split_err"])
        if row_name == "paged_verify":
            q = args[0]
            entry.update(splits=exact["verify_splits"],
                         split_err=exact["verify_split_err"],
                         row_blocks_hfa=cuda_lib.verify_row_blocks(
                             q.shape[2], q.shape[3], True))
        if row_name == "paged_prefill":
            entry.update(dyadic_err_fa2=exact["prefill_dyadic_fa2_err"],
                         dyadic_err_hfa=exact["prefill_dyadic_hfa_err"])
        print(f"kernel {row_name} ({src.rsplit('/', 1)[1]}): kernel_ms fa2 "
              f"{entry['fa2_ms']:.4f} hfa {entry['hfa_ms']:.4f} (device "
              f"{entry['fa2_device_ms']:.4f} / {entry['hfa_device_ms']:.4f}) "
              f"| plain_ms fa2 {entry['fa2_plain_ms']:.4f} hfa "
              f"{entry['hfa_plain_ms']:.4f} | library_ms "
              f"{entry['library_ms']:.4f} (SDPA; device "
              f"{entry['library_device_ms']:.4f}) | bound_ms "
              f"{entry['bound_ms']:.4f} ({entry['bound_by']}) | max_abs_err "
              f"fa2 {entry['fa2_max_abs_err']:.3g} hfa "
              f"{entry['hfa_max_abs_err']:.3g}")
        rows.append(entry)
    return rows + codec_rows


# Head dims every kernel takes beside 64 and 128, each with the G of a
# model that has it: 96 is hfa-paper-mini's d_head (32 query heads over
# 32 KV heads, G 1); 32 at G 2.
HEAD_DIM_CASES = {96: 1, 32: 2}
HEAD_DIMS_ALL = (32, 64, 96, 128)


def _paged_err(out, want, live, use_hfa):
    """Max |finalized output| and |m| errors over the live rows."""
    (ko, km, kl), (po, pm, pl_) = out, want
    mask = live.expand(km.shape)
    k = decode_k.finalize_decode(ko, kl, use_hfa=use_hfa)[mask]
    w = decode_k.finalize_decode(po, pl_, use_hfa=use_hfa)[mask]
    if not bool(torch.isfinite(k).all()):
        return float("inf"), float("inf")
    return float((k - w).abs().max()), float((km[mask] - pm[mask]).abs().max())


def check_head_dims() -> None:
    """Every kernel at d 96 and d 32 on the card against its plain version
    (the tolerances of the main-shape checks): the paged decode and
    verify (v2, split on the FA-2 rail, and the CUDA-core kernel), prefill
    (at these widths the CUDA-core route), bf16 and f32 pools, both
    rails; the dense forward on both
    rails, bf16 (the tensor-core kernel on inputs zero-padded to 128 /
    64) and f32 (the CUDA cores); the FA-2 backward with a bf16 (tensor
    cores, padded) and an f32 (CUDA cores) cotangent; the dense decode;
    the LNS datapath bit for bit on exact scores.  The dense decode is
    split on the FA-2 rail (2 runs at kv_len 250)."""
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def i32(a):
        return torch.tensor(a, dtype=torch.int32, device="cuda")

    for d, g in HEAD_DIM_CASES.items():
        worst = {}

        def hold(name, err, tol):
            worst[name] = max(worst.get(name, 0.0), err)
            if not err <= tol:
                raise AssertionError(f"d {d}: {name} differs from its plain "
                                     f"version by {err:.3g} (atol {tol})")
        b, hkv, page, j = 3, 4, 16, 16
        pt = torch.tensor(np.random.default_rng(d).permutation(b * j + 4)[
            :b * j].reshape(b, j), dtype=torch.int32, device="cuda")
        kvl, start, chunk = [200, 0, 77], [160, 0, 60], [40, 0, 17]
        for dtype in (torch.bfloat16, torch.float32):
            kp, vp = (rnd(b * j + 4, page, hkv, d, dtype=dtype)
                      for _ in range(2))
            q4, q5 = rnd(b, hkv, g, d, dtype=dtype), rnd(b, hkv, g, 40, d,
                                                         dtype=dtype)
            live1 = torch.tensor([True, False, True],
                                 device="cuda")[:, None, None]
            live = (torch.arange(40, device="cuda")[None] <
                    i32(chunk)[:, None])[:, None, None]
            for rail in ("fa2", "hfa"):
                use_hfa = rail == "hfa"
                dec = (q4, kp, vp, pt, i32(kvl))
                want = pd.paged_decode_partial_plain(*dec, use_hfa=use_hfa)
                for name, fn in (("paged_decode", pd.paged_decode_partial),
                                 ("paged_decode_simt",
                                  pd.paged_decode_partial_simt)):
                    e, em = _paged_err(fn(*dec, use_hfa=use_hfa), want,
                                       live1, use_hfa)
                    hold(name, e, ATOL_OUT[rail])
                    hold(name + " m", em, ATOL_M)
                pre = (q5, kp, vp, pt, i32(start),
                       i32(start) + i32(chunk))
                e, em = _paged_err(
                    pp.paged_prefill_partial(*pre, use_hfa=use_hfa),
                    pp.paged_prefill_partial_plain(*pre, use_hfa=use_hfa),
                    live, use_hfa)
                hold("paged_prefill_simt", e, ATOL_OUT[rail])
                hold("paged_prefill_simt m", em, ATOL_M)
                ver = (q5[:, :, :, :5].contiguous(), kp, vp, pt,
                       i32([150, 0, 60]), i32([5, 0, 3]))
                vlive = (torch.arange(5, device="cuda")[None] <
                         i32([5, 0, 3])[:, None])[:, None, None]
                want = pv.paged_verify_partial_plain(*ver, use_hfa=use_hfa)
                for name, fn in (("paged_verify", pv.paged_verify_partial),
                                 ("paged_verify_simt",
                                  pv.paged_verify_partial_simt)):
                    e, em = _paged_err(fn(*ver, use_hfa=use_hfa), want,
                                       vlive, use_hfa)
                    hold(name, e, ATOL_OUT[rail])
                    hold(name + " m", em, ATOL_M)
            # Dense forward, both rails.
            bh, ell = 4, 300
            q, k, v = (rnd(bh, ell, d, dtype=dtype) for _ in range(3))
            fwd0 = dict(cuda_lib.dense_fwd_launches)
            ko, klse = fa2_k.fa2_forward(q, k, v, causal=True,
                                         return_lse=True)
            po, plse = fa2_k.fa2_forward_plain(q, k, v, causal=True)
            hold("fa2_fwd", float((ko - po).abs().max()), ATOL_FA2_FWD)
            hold("fa2_fwd lse", float((klse - plse).abs().max()),
                 ATOL_FA2_FWD)
            qa, ka = (hfa_k.dyadic_bf16((bh, ell, d), gen, "cuda",
                                        bound=0.5).to(dtype)
                      for _ in range(2))
            hold("hfa_fwd (dyadic)",
                 float((hfa_k.hfa_forward(qa, ka, v, causal=True) -
                        hfa_k.hfa_forward_plain(qa, ka, v, causal=True))
                       .abs().max()), ATOL_HFA_FWD)
            route = "tc" if dtype == torch.bfloat16 else "simt"
            if cuda_lib.dense_fwd_launches[route] != fwd0[route] + 2:
                raise AssertionError(f"d {d}: the {dtype} dense forwards "
                                     f"went to {cuda_lib.dense_fwd_launches}")
            # FA-2 backward, both routes.
            for do in (rnd(bh, ell, d), rnd(bh, ell, d, dtype=torch.float32)):
                if dtype == torch.float32 and do.dtype == torch.bfloat16:
                    continue
                got = fa2_bwd.fa2_backward(q, k, v, ko, do, klse,
                                           causal=True)
                delta = torch.sum(do.float() * ko, dim=-1)
                want = fa2_bwd.fa2_backward_plain(q, k, v, do, klse, delta,
                                                  causal=True)
                for name, gt, w in zip(("dq", "dk", "dv"), got, want):
                    rel = float((gt.float() - w).abs().max() /
                                w.abs().max())
                    bound = REL_BWD if dtype == torch.bfloat16 else 1e-4
                    hold(f"fa2_bwd {name} ({do.dtype} do, rel)", rel, bound)
            # Dense decode on a ring read in place.
            ring_k, ring_v = (rnd(b, 300, hkv, d, dtype=dtype)
                              for _ in range(2))
            dq_ = rnd(b, hkv, g, d, dtype=dtype)
            for rail in ("fa2", "hfa"):
                use_hfa = rail == "hfa"
                args = (dq_, ring_k.transpose(1, 2), ring_v.transpose(1, 2))
                (ko_, _, kl_), (po_, _, pl__) = (
                    f(*args, kv_len=250, use_hfa=use_hfa) for f in (
                        decode_k.decode_partial,
                        decode_k.decode_partial_plain))
                hold(f"dense_decode [{rail}]", float((
                    decode_k.finalize_decode(ko_, kl_, use_hfa=use_hfa) -
                    decode_k.finalize_decode(po_, pl__, use_hfa=use_hfa))
                    .abs().max()), ATOL_DEC[rail])
            # LNS datapath, exact scores: bit for bit.
            qa, ka = (hfa_k.dyadic_bf16((2, 64, d), gen, "cuda").to(dtype)
                      for _ in range(2))
            va = rnd(2, 64, d, dtype=dtype)
            got = dp_k.hfa_datapath(qa, ka, va, causal=True)
            want = dp_k.hfa_datapath_plain(qa, ka, va, causal=True)
            hold("hfa_datapath (bits differing)", float(
                (got.view(torch.int16) != want.view(torch.int16)).sum()), 0)
        torch.cuda.synchronize()
        print(f"check head dim {d} (G {g}; bf16 and f32, both rails): every "
              "kernel within its tolerance of its plain version; worst "
              + ", ".join(f"{n} {e:.3g}" for n, e in worst.items()))


# The training shape of qwen3-1.7b at global batch 4 x seq 2048: 16 query
# heads (8 KV heads repeated), d_head 128, bf16, causal.
DENSE_B, DENSE_H, DENSE_L, DENSE_D = 4, 16, 2048, 128
# The dense-serve prefill of qwen3-1.7b: batch 8 x 16 heads (GQA
# expanded), 512 tokens, d_head 128, bf16, causal.
DP_BH, DP_L, DP_D = 128, 512, 128
# Tolerances, kernel vs plain version on the same CUDA tensors.  The bf16
# forwards run on the tensor cores (dense_attention_tc.cu): each score is
# the same bf16 x bf16 products as the plain version's f32 einsum, summed
# in another order.  (1) FA-2 rail: O and LSE within 1e-5 (P V on p split
# into bf16 hi + lo, within 2^-16 of p).  (2) H-FA rail on a dyadic grid
# (bound 0.5), where every product and partial sum is exact, so no
# summation order can move a score, and every tile's sum of p is exact,
# so none can move l across a LogDiv rounding boundary: O within 1e-5 on
# every row.  (3) H-FA rail on random
# inputs, through the scores-out variant: each score the kernel formed is
# within one bf16 ulp of the plain f32 score - plus the f32 dot product's
# own summation bound, d 2^-24 sum|q_i k_i| scale, which matters only for
# scores near 0 (their count is printed) - and O within 1e-5 of the plain
# walk fed those scores.  A score near a bf16 tie can round to the other
# neighbour (the share is printed): that moves the key's weight by a rail
# step (0.54%), so O cannot be held to 1e-5 against the plain version's
# own scores.  dq/dk/dv: the kernels round their f32 sums to bf16, so each
# is held to one bf16 ulp at the top of its range: 2^-7 of its max
# magnitude.  On the tensor cores P and dS also enter their products as
# bf16 (each within 2^-8 of its f32 value), which moves the sums by less
# than 2^-8 of their max (tests/test_torch_dense_backward_tc.py).
ATOL_FA2_FWD = 1e-5
REL_BWD = 2.0 ** -7
ATOL_HFA_FWD = 1e-5
DENSE_TC_SRC = "src/repro_torch/csrc/dense_attention_tc.cu"
# Non-tensor instructions per second: one f32 or int32 instruction per
# lane per clock on 128 lanes x 132 SMs at 1.98 GHz (the 67 TFLOP/s f32
# rate counts an FMA as two operations; int32 runs at half this rate, so
# the figure is optimistic and the bound stays a lower bound).
CORE_OPS_PER_S = F32_OPS_PER_S / 2
# Instructions the H-FA rail takes per computed score in the integer form
# the tensor-core kernel runs (csrc/hfa_rail.cuh): s - m and
# quant_rail_int (clamp x2, two multiplies, the rounding add, the bias
# subtract) = 7; exp2_hfa_rail_tab (negate, mask, shift and address of
# the word, the table load, the byte selector (mask, shift, or), the
# byte permute, the exponent (shift, subtract, shift), the final add) =
# 13.  The select-chain form (quant_rail, exp2_hfa_rail) takes 59.
RAIL_OPS_PER_SCORE = 20


def _dense_bound(kind: str, q, do_size: int = 4) -> tuple[float, str, dict]:
    """Least time for the same work: the bytes each input is read once
    and each output written once, over the memory rate, against the
    operations - the products over the causal visible (query, key) pairs
    at the bf16 peak (QK and PV forward; 3 products for dq, 4 for dk/dv)
    and, on the H-FA forward, the rail per visible score on the CUDA
    cores beside them (overlapped: the larger of the two).  ``do_size``
    is the bytes of one element of the backward's cotangent (2 on the
    tensor-core route, 4 on the CUDA-core one)."""
    bh, ell, d = q.shape
    pairs = bh * ell * (ell + 1) / 2
    bf16 = q.numel() * 2                      # one (BH, L, d) bf16 tensor
    f32 = q.numel() * 4
    row = bh * ell * 4                        # one (BH, L) f32 vector
    t_rail = 0.0
    if kind in ("fa2_fwd", "hfa_fwd"):
        nbytes = 3 * bf16 + f32 + (row if kind == "fa2_fwd" else 0)
        flops = 4 * d * pairs
        if kind == "hfa_fwd":
            t_rail = pairs * RAIL_OPS_PER_SCORE / CORE_OPS_PER_S * 1e3
    elif kind.startswith("fa2_bwd_dq"):
        nbytes = 3 * bf16 + q.numel() * do_size + 2 * row + bf16
        flops = 6 * d * pairs
    else:
        nbytes = 3 * bf16 + q.numel() * do_size + 2 * row + 2 * bf16
        flops = 8 * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / BF16_FLOPS_PER_S * 1e3, t_rail)
    parts = {"bytes_ms": t_bytes, "products_ms": flops / BF16_FLOPS_PER_S * 1e3,
             "rail_ms": t_rail}
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), parts


def _check_forward_rails(bh: int, ell: int, d: int, gen, label: str) -> dict:
    """Checks (1)-(3) of the bf16 dense forward at (BH, L, d), causal, and
    the times of both rails beside SDPA and the bound.  Returns
    {rail: {ms, plain_ms, library_ms, bound_ms, bound_by, max_abs_err,
    ...}}."""
    def normal():
        return torch.randn((bh, ell, d), generator=gen, device="cuda").to(
            torch.bfloat16)
    q, k, v = normal(), normal(), normal()
    out = {}
    # (1) FA-2 rail, random inputs.
    ko, klse = fa2_k.fa2_forward(q, k, v, causal=True, return_lse=True)
    po, plse = fa2_k.fa2_forward_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err_o, err_lse = (float((a - b).abs().max()) for a, b in
                      ((ko, po), (klse, plse)))
    if not (err_o <= ATOL_FA2_FWD and err_lse <= ATOL_FA2_FWD
            and bool(torch.isfinite(ko).all())):
        raise AssertionError(f"fa2_fwd {label}: O {err_o:.3g}, LSE "
                             f"{err_lse:.3g} (atol {ATOL_FA2_FWD})")
    del po, plse
    # (2) H-FA rail, dyadic-grid q and k: exact scores and sums of p.
    qa, ka = (hfa_k.dyadic_bf16((bh, ell, d), gen, "cuda", bound=0.5)
              for _ in range(2))
    err_dy = float((hfa_k.hfa_forward(qa, ka, v, causal=True) -
                    hfa_k.hfa_forward_plain(qa, ka, v, causal=True))
                   .abs().max())
    del qa, ka
    if not err_dy <= ATOL_HFA_FWD:
        raise AssertionError(f"hfa_fwd {label}: dyadic-grid O differs from "
                             f"the plain version by {err_dy:.3g} (atol "
                             f"{ATOL_HFA_FWD})")
    # (3) H-FA rail, random inputs, the kernel's own scores.
    so, s_k = hfa_k.hfa_forward_scores(q, k, v, causal=True)
    ho = hfa_k.hfa_forward(q, k, v, causal=True)
    walk = hfa_k.hfa_forward_plain_from_scores(s_k, v, causal=True)
    err_walk = float((ho - walk).abs().max())
    same_o = torch.equal(so, ho)
    gap = float((ho - ko).abs().max())      # the rail's distance to softmax
    del walk, so, ko
    n_vis, n_differ, n_beyond, n_sum_term, worst = hfa_k.score_errors(
        q, k, s_k, causal=True)
    del s_k
    if n_beyond:
        raise AssertionError(f"hfa_fwd {label}: {n_beyond} scores beyond one "
                             "bf16 ulp (+ the f32 summation bound) of the "
                             "plain f32 score")
    if not (err_walk <= ATOL_HFA_FWD and same_o
            and bool(torch.isfinite(ho).all())):
        raise AssertionError(f"hfa_fwd {label}: O vs the plain walk fed the "
                             f"kernel's scores {err_walk:.3g} (atol "
                             f"{ATOL_HFA_FWD}), scores-out O equal {same_o}")
    share = n_differ / n_vis
    # Times: both rails beside one SDPA call on (B, H, L, d) views.
    q4, k4, v4 = (t.view(1, bh, ell, d) for t in (q, k, v))
    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    lib_ms = timed(sdpa)
    lib_dev = device_ms(sdpa)
    kernels = {"fa2_fwd": (lambda: fa2_k.fa2_forward(q, k, v, causal=True,
                                                     return_lse=True),
                           lambda: fa2_k.fa2_forward_plain(q, k, v,
                                                           causal=True)),
               "hfa_fwd": (lambda: hfa_k.hfa_forward(q, k, v, causal=True),
                           lambda: hfa_k.hfa_forward_plain(q, k, v,
                                                           causal=True))}
    for name, (kernel, plain) in kernels.items():
        ms = timed(kernel)
        dev_ms = device_ms(kernel, "dense_fwd_tc_kernel")
        plain_ms = timed(plain, reps=3, inner=1)
        bound_ms, bound_by, parts = _dense_bound(name, q)
        err = max(err_o, err_lse) if name == "fa2_fwd" else max(err_dy,
                                                                err_walk)
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_dev,
                     "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err,
                     "bound_parts": parts}
        print(f"kernel {name} ({label}, bf16, causal, tensor cores): "
              f"kernel_ms {ms:.4f} (device {dev_ms:.4f}) | plain_ms "
              f"{plain_ms:.4f} | library_ms {lib_ms:.4f} (SDPA; device "
              f"{lib_dev:.4f}) | bound_ms {bound_ms:.4f} ({bound_by}: "
              f"products {parts['products_ms']:.4f}, rail "
              f"{parts['rail_ms']:.4f} overlapped, bytes "
              f"{parts['bytes_ms']:.4f}) | kernel/SDPA {ms / lib_ms:.2f} "
              f"(device {dev_ms / lib_dev:.2f})")
    # Twice the products at the same shape: how the time scales with the
    # work, against the causal run's shorter and unequal blocks.
    def full():
        return fa2_k.fa2_forward(q, k, v, causal=False, return_lse=True)
    full_ms = timed(full)
    full_dev = device_ms(full, "dense_fwd_tc_kernel")
    print(f"kernel fa2_fwd ({label}, bf16, not causal: twice the products): "
          f"kernel_ms {full_ms:.4f} (device {full_dev:.4f})")
    out["fa2_fwd"].update(o_err=err_o, lse_err=err_lse,
                          noncausal_ms=full_ms, noncausal_device_ms=full_dev)
    out["hfa_fwd"].update(dyadic_o_err=err_dy, walk_o_err=err_walk,
                          scores_differ_share=share)
    print(f"check fa2_fwd ({label}): (1) random inputs: max |O err| "
          f"{err_o:.3g}, max |LSE err| {err_lse:.3g} (atol {ATOL_FA2_FWD})")
    print(f"check hfa_fwd ({label}): (2) dyadic grid: max |O err| "
          f"{err_dy:.3g} (atol {ATOL_HFA_FWD}) | (3) random inputs: "
          f"{n_vis} visible scores, {share:.4%} differ from bf16(plain f32 "
          f"score), all within one bf16 ulp ({n_sum_term} needed the f32 "
          f"summation term; worst |diff| {worst:.3g} ulp), max |O - plain "
          f"walk on the kernel's scores| {err_walk:.3g} (atol "
          f"{ATOL_HFA_FWD}) | max |O hfa - O fa2| {gap:.3g}")
    return out


def check_dense_kernels() -> list[dict]:
    """The bf16 dense forward on both rails (checks (1)-(3)) at the
    training shape and at the dense-serve prefill shape, and the
    backward kernels at the training shape, each against its plain
    version on the same CUDA tensors, timed beside its SDPA yardstick.
    dq and dk/dv share one wrapper, ``fa2_backward`` (delta and both
    launches), which is checked and timed as a whole on each route: a
    bf16 cotangent on the tensor cores (rows ``fa2_bwd_dq``,
    ``fa2_bwd_dkv``), the same values in f32 on the CUDA cores (rows
    ``..._simt``); each row also times its own launch."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, ell, d = DENSE_B, DENSE_H, DENSE_L, DENSE_D
    fwd = _check_forward_rails(b * h, ell, d, gen,
                               f"B {b}, H {h}, L {ell}, d {d}")
    prefill = _check_forward_rails(DP_BH, DP_L, DP_D, gen,
                                   f"dense-serve prefill BH {DP_BH}, L "
                                   f"{DP_L}, d {DP_D}")
    rows = []
    for name in ("fa2_fwd", "hfa_fwd"):
        row = {"name": name, "route": "cuda", "source": DENSE_TC_SRC,
               "replaces": REPLACES[name]}
        row.update({k: v for k, v in fwd[name].items() if k != "bound_parts"})
        row["prefill"] = {k: v for k, v in prefill[name].items()
                          if k != "bound_parts"}
        rows.append(row)

    def rnd(dtype=torch.bfloat16):
        return torch.randn((b * h, ell, d), generator=gen,
                           device="cuda").to(dtype)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    kw = dict(causal=True, kv_len=ell, q_offset=0, scale=d ** -0.5)
    o, lse = fa2_k.fa2_forward(q, k, v, return_lse=True, causal=True)
    q4, k4, v4 = (t.view(b, h, ell, d) for t in (q, k, v))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    do4 = do.view(b, h, ell, d)

    def sdpa_backward():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), do4,
                                   retain_graph=True)

    lib_bwd = timed(sdpa_backward)
    lib_dev = device_ms(sdpa_backward)
    # Both routes of fa2_backward on the same inputs: the bf16 cotangent
    # (the training path) on the tensor cores, the same values as f32 on
    # the CUDA cores.  The plain version is the same for both.  route ->
    # (cotangent, source, row-name suffix, dq launch, dk/dv launch, end of
    # the kernels' names in a trace, bytes of one cotangent element).
    routes = {"tc": (do, DENSE_BWD_TC_SRC, "", cuda_lib.launch_dense_dq_tc,
                     cuda_lib.launch_dense_dkv_tc, "_tc_kernel", 2),
              "simt": (do.float(), DENSE_SRC, "_simt",
                       cuda_lib.launch_dense_dq, cuda_lib.launch_dense_dkv,
                       "_kernel", 4)}
    delta = torch.sum(do.float() * o, dim=-1)

    def plain_backward():
        return fa2_bwd.fa2_backward_plain(q, k, v, do, lse, delta, **kw)

    bwd_plain = plain_backward()
    bwd_plain_ms = timed(plain_backward, reps=3, inner=1)
    for route, (do_r, src, suffix, dq_launch, dkv_launch, kname,
                do_size) in routes.items():
        def backward(do_r=do_r):
            return fa2_bwd.fa2_backward(q, k, v, o, do_r, lse, causal=True)

        before = (dict(cuda_lib.dense_dq_launches),
                  dict(cuda_lib.dense_dkv_launches))
        bwd = backward()
        torch.cuda.synchronize()
        took = (cuda_lib.dense_dq_launches[route] - before[0][route],
                cuda_lib.dense_dkv_launches[route] - before[1][route])
        if took != (1, 1):
            raise AssertionError(f"fa2_backward ({route} route) launched "
                                 f"{took} dq, dk/dv kernels of that route")
        bwd_ms = timed(backward)
        cases = {"fa2_bwd_dq": ([(bwd[0], bwd_plain[0])],
                                lambda: dq_launch(q, k, v, do_r, lse, delta,
                                                  **kw), "dense_dq"),
                 "fa2_bwd_dkv": (list(zip(bwd[1:], bwd_plain[1:])),
                                 lambda: dkv_launch(q, k, v, do_r, lse, delta,
                                                    **kw), "dense_dkv")}
        for name, (pairs, launch, kernel) in cases.items():
            err, ok, finite, parts = 0.0, True, True, []
            for got, want in pairs:
                e = float((got.float() - want).abs().max())
                bound = REL_BWD * float(want.abs().max())
                err, ok = max(err, e), ok and e <= bound
                finite = finite and bool(torch.isfinite(got.float()).all())
                parts.append(f"{e:.3g} (bound {bound:.3g})")
            what = "max |err| " + ", ".join(parts)
            if not (ok and finite):
                raise AssertionError(f"{name}{suffix} disagrees with its plain "
                                     f"version: {what}, finite {finite}")
            ms = timed(launch)
            dev_ms = device_ms(launch, kernel + kname)
            bound_ms, bound_by, _ = _dense_bound(name, q, do_size)
            rows.append({"name": name + suffix, "route": "cuda",
                         "source": src, "replaces": REPLACES[name],
                         "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                         "plain_ms": bwd_plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib_bwd,
                         "library_device_ms": lib_dev, "wrapper_ms": bwd_ms})
            print(f"kernel {name}{suffix} (B {b}, H {h}, L {ell}, d {d}, bf16, "
                  f"causal, {do_r.dtype} do, {route}): kernel_ms {ms:.4f} "
                  f"(device {dev_ms:.4f}) | fa2_backward (dq + dk/dv + delta) "
                  f"{bwd_ms:.4f} | plain_ms {bwd_plain_ms:.4f} | library_ms "
                  f"{lib_bwd:.4f} (SDPA backward; device {lib_dev:.4f}) | "
                  f"bound_ms {bound_ms:.4f} ({bound_by}) | kernel/bound "
                  f"{ms / bound_ms:.2f} | {what}")
    return rows


def check_lns() -> None:
    """The LNS device functions of the datapath source against the plain
    torch LNS functions, bit for bit: lns_to_bf16 over every rail value
    (both signs), blinn_log2 over every bf16 pattern, lns_add over signed
    pairs on a rail grid, quant_scorediff over a sweep of differences, and
    the exp2_neg table (the kernel's Mitchell correction) against the
    plain exp2_neg over all 65,536 d."""
    raw = torch.arange(-32768, 32768, dtype=torch.float32, device="cuda")
    grid = torch.cat([torch.arange(-1500., 1500., 2., device="cuda"),
                      torch.tensor([-32768., -32767., 32767., 0.],
                                   device="cuda")])
    ra, rb = (t.reshape(-1) for t in torch.meshgrid(grid, grid,
                                                    indexing="ij"))
    n = ra.numel()
    gen = torch.Generator(device="cuda").manual_seed(3)
    sa, sb = (torch.randint(0, 2, (n,), generator=gen, device="cuda",
                            dtype=torch.int32) for _ in range(2))
    x = torch.linspace(-20.0, 1.0, n, device="cuda")
    bits = torch.arange(n, device="cuda", dtype=torch.int32) & 0xFFFF
    sc, rc, quant, bsign, braw, _, corr = cuda_lib.lns_eval(sa, ra, sb, rb,
                                                            x, bits)
    ws, wr = lns.lns_add(sa, ra, sb, rb)
    pat = (torch.where(bits >= 0x8000, bits - 0x10000, bits)
           .to(torch.int16).view(torch.bfloat16))
    bs, br = lns.blinn_log2(pat)
    bad = {"lns_add": int((sc != ws).sum() + (rc != wr).sum()),
           "quant_scorediff": int((quant != lns.quant_scorediff(x)).sum()),
           "blinn_log2": int((bsign != bs).sum() + (braw != br).sum()),
           "exp2_neg table": int((corr != lns.exp2_neg(bits.float())).sum())}
    for sign in (0, 1):
        sg = torch.full_like(raw, sign, dtype=torch.int32)
        packed = cuda_lib.lns_eval(sg, raw, sg, raw, raw, sg)[5]
        bad[f"lns_to_bf16 sign {sign}"] = int(
            (packed.view(torch.int16)
             != lns.lns_to_bf16(sg, raw).view(torch.int16)).sum())
    if any(bad.values()):
        raise AssertionError(f"LNS device functions differ from the plain "
                             f"versions: {bad}")
    assert n >= 1 << 16
    print(f"lns (datapath source): lns_add over {n} signed pairs, "
          f"quant_scorediff over {n} differences, blinn_log2 over every bf16 "
          f"pattern, lns_to_bf16 over all 65536 rail values x 2 signs, the "
          f"exp2_neg table over every d in [0, 65535]: bit-equal to the plain "
          f"torch LNS")


# The dense-serve decode of qwen3-1.7b: batch 8 x 8 KV heads, 2 query
# heads each, the 576th token of a 640-slot bf16 ring, d_head 128.
DEC_B, DEC_HKV, DEC_G, DEC_S, DEC_KV, DEC_D = 8, 8, 2, 640, 576, 128
# fa2: summation order only - the finalized output to 2e-5, o~ and l to
# 2e-5 of their scale, m to 2e-6.  hfa: the kernel's and cuBLAS's dot
# products round differently, and a score on the other side of a rail
# step moves that key's p by 0.54%.  At this shape that moved the
# finalized output by 1.5e-5 (H100); it is held to 1e-4, far below what
# a lost rail quantization moves (the tiled rail is 0.38 from exact
# softmax at the training shape), and m to 2e-6.
ATOL_DEC = {"fa2": 2e-5, "hfa": 1e-4}


def check_decode_kernel() -> dict:
    """Kernel 4 at the dense-serve decode shape against its plain
    version on the same CUDA tensors, both rails (fa2 split as the main
    path splits it, and its split within 1e-5 of the unsplit walk, m
    exact), on the H-FA rail on a dyadic grid (q and the K ring within
    +-0.5: every score and every tile's sum of p exact in any order)
    within 1e-5 of the plain 128-key walk, m exact, beside one SDPA call
    on the same decode."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, hkv, g, s_len, kvl, d = DEC_B, DEC_HKV, DEC_G, DEC_S, DEC_KV, DEC_D

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    q = rnd(b, hkv, g, d)
    ring_k, ring_v = rnd(b, s_len, hkv, d), rnd(b, s_len, hkv, d)
    k, v = ring_k.transpose(1, 2), ring_v.transpose(1, 2)   # in place
    splits = cuda_lib.dense_decode_splits(b * hkv, kvl, False,
                                          cuda_lib.sm_count(q.device))
    row = {"name": "dense_decode", "route": "cuda", "source": DECODE_SRC,
           "replaces": REPLACES["dense_decode"], "splits": splits}
    for rail in ("fa2", "hfa"):
        use_hfa = rail == "hfa"

        def kernel():
            return decode_k.decode_partial(q, k, v, kv_len=kvl,
                                           use_hfa=use_hfa)

        def plain():
            return decode_k.decode_partial_plain(q, k, v, kv_len=kvl,
                                                 use_hfa=use_hfa)
        (ko, km, kl), (po, pm, pl_) = kernel(), plain()
        torch.cuda.synchronize()
        kout = decode_k.finalize_decode(ko, kl, use_hfa=use_hfa)
        pout = decode_k.finalize_decode(po, pl_, use_hfa=use_hfa)
        err = float((kout - pout).abs().max())
        err_m = float((km - pm).abs().max())
        errs = [float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
                for a, w in ((ko, po), (kl, pl_))]
        ok = err <= ATOL_DEC[rail] and err_m <= 2e-6 and bool(
            torch.isfinite(kout).all())
        if rail == "fa2":
            ok = ok and max(errs) <= 2e-5
        if not ok:
            raise AssertionError(
                f"dense_decode[{rail}] disagrees with its plain version: "
                f"out {err:.3g} (atol {ATOL_DEC[rail]}), m {err_m:.3g} "
                f"(atol 2e-6), o~/l relative {max(errs):.3g}")
        row[f"{rail}_ms"] = timed(kernel)
        row[f"{rail}_device_ms"] = device_ms(kernel, "dense_decode_v2_kernel")
        row[f"{rail}_plain_ms"] = timed(plain, reps=5, inner=2)
        row[f"{rail}_max_abs_err"] = err
        row[f"{rail}_triplet_rel_err"] = max(errs)
        if rail == "fa2":
            row.update(ms=row["fa2_ms"], plain_ms=row["fa2_plain_ms"],
                       device_ms=row["fa2_device_ms"])
    row["max_abs_err"] = max(row["fa2_max_abs_err"], row["hfa_max_abs_err"])
    # The split walk against one walk, and the H-FA rail on the dyadic
    # grid against the plain walk.
    one = cuda_lib.launch_dense_decode(q, k, v, scale=d ** -0.5, kv_len=kvl,
                                       use_hfa=False, splits=1)
    split = decode_k.decode_partial(q, k, v, kv_len=kvl)
    err_split = float((decode_k.finalize_decode(split[0], split[2]) -
                       decode_k.finalize_decode(one[0], one[2])).abs().max())
    qa = hfa_k.dyadic_bf16(q.shape, gen, "cuda", bound=0.5)
    ka = hfa_k.dyadic_bf16(ring_k.shape, gen, "cuda", bound=0.5).transpose(
        1, 2)
    got, want = (f(qa, ka, v, kv_len=kvl, use_hfa=True) for f in (
        decode_k.decode_partial, decode_k.decode_partial_plain))
    err_dy = float((decode_k.finalize_decode(got[0], got[2], use_hfa=True) -
                    decode_k.finalize_decode(want[0], want[2], use_hfa=True))
                   .abs().max())
    if not (err_split <= 1e-5 and torch.equal(split[1], one[1])
            and err_dy <= 1e-5 and torch.equal(got[1], want[1])):
        raise AssertionError(f"dense_decode: split {splits} vs unsplit "
                             f"{err_split:.3g} (atol 1e-5, m equal "
                             f"{torch.equal(split[1], one[1])}); hfa dyadic "
                             f"vs plain {err_dy:.3g} (atol 1e-5, m equal "
                             f"{torch.equal(got[1], want[1])})")
    row.update(split_err=err_split, hfa_dyadic_err=err_dy)
    # SDPA on the same decode: (B, H, 1, d) against the live keys, the
    # KV heads repeated kv-major, built outside the timed region.
    q4 = q.reshape(b, hkv * g, 1, d)
    k4, v4 = (t[:, :, :kvl].repeat_interleave(g, dim=1).contiguous()
              for t in (k, v))

    def lib():
        return F.scaled_dot_product_attention(q4, k4, v4)
    row["library_ms"] = timed(lib)
    row["library_device_ms"] = device_ms(lib)
    kv_bytes = b * hkv * kvl * d * 2 * 2
    io_bytes = q.numel() * 2 + b * hkv * g * (d + 2) * 4
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * d * b * hkv * g * kvl / BF16_FLOPS_PER_S * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"kernel dense_decode (B {b}, Hkv {hkv}, G {g}, kv_len {kvl} of a "
          f"{s_len}-slot bf16 ring, d {d}; fa2 split {splits}): kernel_ms "
          f"fa2 {row['fa2_ms']:.4f} hfa {row['hfa_ms']:.4f} (device "
          f"{row['fa2_device_ms']:.4f} / {row['hfa_device_ms']:.4f}) | "
          f"plain_ms fa2 {row['fa2_plain_ms']:.4f} hfa "
          f"{row['hfa_plain_ms']:.4f} | library_ms {row['library_ms']:.4f} "
          f"(SDPA; device {row['library_device_ms']:.4f}) | bound_ms "
          f"{row['bound_ms']:.4f} ({row['bound_by']}, {kv_bytes / 1e6:.2f} MB "
          f"of live K/V) | max |out| err fa2 {row['fa2_max_abs_err']:.3g} "
          f"hfa {row['hfa_max_abs_err']:.3g} | o~/l rel err fa2 "
          f"{row['fa2_triplet_rel_err']:.3g} hfa "
          f"{row['hfa_triplet_rel_err']:.3g} | split vs unsplit "
          f"{err_split:.3g}, hfa dyadic vs plain {err_dy:.3g}, m equal")
    return row


# Instructions one LNS update takes in the reference's definition (the
# two rescales of src/repro/kernels/hfa_datapath.py and lns_add of
# src/repro/core/lns.py), each item at the fewest CUDA-core instructions
# it needs: the two rescales (an add and a max each) 4, the max of the
# operands 1, |diff| (min, subtract) 2, the correction as one lookup 1,
# the add or subtract (the sign compare, the signed add) 2, the sign
# select (compare, select) 2, the zero bypasses (two tests, two selects)
# 4, the cancellation (test, select) 2, the clamp (min, max) 2.
LNS_OPS_PER_UPDATE = 20


def _datapath_bound(bh: int, ell: int, d: int) -> tuple[float, str, dict]:
    """Least time for the datapath's work: q, k, v read and the bf16
    output written once over the memory rate, against its operations -
    the QK products over the causal visible pairs at the bf16 tensor
    peak plus LNS_OPS_PER_UPDATE instructions per LNS update (one per
    visible pair and column of [l, o]) at the CUDA-core instruction rate
    (they have no tensor-core form) - summed."""
    pairs = bh * ell * (ell + 1) / 2
    nbytes = 4 * bh * ell * d * 2
    updates = pairs * (d + 1)
    t_qk = 2 * d * pairs / BF16_FLOPS_PER_S * 1e3
    t_lns = updates * LNS_OPS_PER_UPDATE / CORE_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = t_qk + t_lns
    parts = {"bytes_ms": t_bytes, "qk_ms": t_qk, "lns_ms": t_lns,
             "lns_updates": updates}
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), parts


def _datapath_given_scores(q, k, v, **kw) -> tuple[int, float]:
    """(rows of the kernel not bit-equal to the plain walk fed the
    kernel's own scores, share of rows with a visible kernel score that
    differs from the plain f32 einsum's)."""
    got = dp_k.hfa_datapath(q, k, v, **kw)
    s_kernel = dp_k.hfa_datapath_scores(q, k, **kw)
    want = dp_k.hfa_datapath_from_scores(s_kernel, v, causal=kw["causal"],
                                         kv_len=kw.get("kv_len"))
    bad = int((got.view(torch.int16) != want.view(torch.int16)).any(-1)
              .sum())
    lq, lkv, d = q.shape[1], k.shape[1], q.shape[2]
    s_plain = (torch.einsum("bqd,bkd->bqk", q.float(), k.float())
               * d ** -0.5).to(torch.bfloat16)
    kv_len = kw.get("kv_len") or lkv
    vis = (torch.arange(lkv, device=q.device) < kv_len)[None].expand(lq, lkv)
    if kw["causal"]:
        vis = vis & torch.ones(lq, lkv, dtype=torch.bool,
                               device=q.device).tril(lkv - lq)
    differ = ((s_kernel != s_plain) & vis).any(-1)
    if not bool(torch.isfinite(got.float()).all()):
        bad = max(bad, 1)
    return bad, float(differ.float().mean())


def check_datapath_kernel() -> dict:
    """Kernel 9 at the dense-serve prefill shape against its plain
    version (the core.hfa emulation) on the same CUDA tensors: (a) bit
    for bit on a dyadic grid, where no summation order can change a
    score; (b) on random normal inputs, every row bit for bit against
    the plain walk fed the scores the kernel forms (hfa_datapath_scores,
    the same code), with no exception, and the share of rows whose
    kernel scores differ from the plain einsum's printed; (c) the same
    at d 32, 64, 96 and 128, bf16 and f32, causal and not, with a kv_len
    mask, at BH 4, Lq 200, Lkv 260."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bh, ell, d = DP_BH, DP_L, DP_D

    def dyadic():
        return hfa_k.dyadic_bf16((bh, ell, d), gen, "cuda")

    def normal():
        return torch.randn((bh, ell, d), generator=gen, device="cuda").to(
            torch.bfloat16)
    # (a) exact scores.
    qa, ka, va = dyadic(), dyadic(), normal()
    got = dp_k.hfa_datapath(qa, ka, va, causal=True)
    want = dp_k.hfa_datapath_plain(qa, ka, va, causal=True)
    torch.cuda.synchronize()
    bad_a = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    if bad_a:
        raise AssertionError(f"hfa_datapath: {bad_a} of {got.numel()} output "
                             "bits differ from the plain version on exact "
                             "scores")
    del qa, ka, va, got, want
    # (b) random normal inputs, given the kernel's own scores.
    q, k, v = normal(), normal(), normal()
    bad_b, differ_share = _datapath_given_scores(q, k, v, causal=True)
    if bad_b:
        raise AssertionError(f"hfa_datapath: {bad_b} rows differ from the "
                             "plain walk fed the kernel's own scores")
    # (c) every head dim, both dtypes, both masks.
    worst_c = []
    for dd in HEAD_DIMS_ALL:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (False, True):
                qc, kc, vc = (torch.randn((4, n, dd), generator=gen,
                                          device="cuda").to(dtype)
                              for n in (200, 260, 260))
                bad_c, share = _datapath_given_scores(
                    qc, kc, vc, causal=causal, kv_len=230)
                worst_c.append(share)
                if bad_c:
                    raise AssertionError(
                        f"hfa_datapath d {dd} {dtype} causal {causal}: "
                        f"{bad_c} rows differ from the plain walk fed the "
                        "kernel's own scores")

    def kernel():
        return dp_k.hfa_datapath(q, k, v, causal=True)

    def plain():
        return dp_k.hfa_datapath_plain(q, k, v, causal=True)
    err = float((kernel().float() - plain().float()).abs().max())
    ms = timed(kernel, reps=10, inner=2)
    dev_ms = device_ms(kernel, "hfa_datapath_kernel", calls=10)
    plain_ms = timed(plain, reps=1, inner=1)
    bound_ms, bound_by, parts = _datapath_bound(bh, ell, d)
    row = {"name": "hfa_datapath", "route": "cuda", "source": DATAPATH_SRC,
           "replaces": REPLACES["hfa_datapath"], "max_abs_err": err,
           "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "rows_scores_differ": differ_share}
    print(f"kernel hfa_datapath (BH {bh}, L {ell}, d {d}, bf16, causal): "
          f"kernel_ms {ms:.4f} (device {dev_ms:.4f}) | plain_ms "
          f"{plain_ms:.4f} | library_ms none | bound_ms {bound_ms:.4f} "
          f"({bound_by}: QK {parts['qk_ms']:.4f} + {parts['lns_updates']:.4g} "
          f"LNS updates x {LNS_OPS_PER_UPDATE} instructions at "
          f"{CORE_OPS_PER_S:.3g}/s {parts['lns_ms']:.4f}; bytes "
          f"{parts['bytes_ms']:.4f}) | (a) exact scores: all output bits "
          f"equal | (b) random: every row bit-equal to the plain walk fed "
          f"the kernel's scores; {differ_share:.4%} of rows hold a kernel "
          f"score that differs from the einsum's; max |err| vs the plain "
          f"version {err:.3g} | (c) d {HEAD_DIMS_ALL}, bf16 and f32, causal "
          f"and not, kv_len 230: every row bit-equal given its scores "
          f"(rows whose scores differ: up to {max(worst_c):.2%})")
    return row


# ------------------------------------------------------------- phase 3
# Card vs CPU logits on a reduced f32 model.  fa2: f32 on both sides,
# summation order only.  hfa: the kernels rescale online on the rail (see
# ATOL_OUT), which moves attention outputs by up to ~1e-2 and the logits
# of this model by less.
SMALL_REF_TOLS = {"fa2": 1e-4, "hfa": 2e-2}


def check_small_reference() -> dict:
    """Reduced qwen3-1.7b in f32: kernels on the card vs plain versions
    on the CPU, one chunked prefill, one decode and one verify step, at
    page 4, on fp, int8 and log16 pools.  Returns each rail's paged
    launches by route (the fp runs')."""
    return {rail: small_reference(get_config("qwen3-1.7b"), rail,
                                  ("fp",) + CODECS)
            for rail in SMALL_REF_TOLS}


def small_reference(full_cfg, rail: str, codecs=("fp",), **kw) -> dict:
    """``full_cfg`` reduced (f32; ``kw`` replaces fields, e.g. d_head) on
    ``rail``: one chunked prefill, one decode and one verify step at page
    4 through the kernels on the card and through the plain versions on
    the CPU, the same weights (seed 0) and tokens, on each codec's pools;
    the logits within SMALL_REF_TOLS.  Returns the fp calls' paged
    launches by route."""
    # The int8 and log16 pools quantize each K/V value: a value the card
    # and the CPU compute a few f32 ulps apart next to a rounding
    # boundary lands a quantization step apart (int8: its row's absmax /
    # 127; log16: a bf16 ulp), which moved fa2's logits by 3.9e-4.
    tol = SMALL_REF_TOLS[rail]
    _reset_paged_counters()
    cfg = dataclasses.replace(full_cfg.reduced(), attn_impl=rail, **kw)
    name = full_cfg.name + "".join(f" {k} {v}" for k, v in kw.items())
    cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = LM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    pt = rng.permutation(40)[:32].reshape(2, 16).astype(np.int32)
    toks = rng.integers(1, cfg.vocab_size, (2, 40)).astype(np.int32)
    calls = (("paged_prefill", (toks, pt), dict(
                last_pos=np.array([39, 30], np.int32),
                start_pos=np.array([0, 0], np.int32))),
             ("paged_decode_step", (toks[:, :1], pt,
                                    np.array([40, 31], np.int32)), {}),
             ("paged_verify_step", (toks[:, 1:6], pt,
                                    np.array([41, 32], np.int32),
                                    np.array([5, 5], np.int32)), {}))
    # fp, then int8 (f32 q over int8 pools) and log16 (f32 q over the
    # pools' bf16 view); the route counts are the fp run's.
    counts = None
    for codec in codecs:
        caches = {m: m.init_paged_cache(40, 4, codec=codec)
                  for m in (cpu, gpu)}
        for meth, args, kwargs in calls:
            out = {}
            # The card first: an MoE model's CPU run takes the card's
            # routing (see card_routing).
            with card_routing(cfg.family == "moe") as flips:
                for m in (gpu, cpu):
                    dev = m.device
                    t = [torch.tensor(a, device=dev) for a in args]
                    k = {key: torch.tensor(v, device=dev)
                         for key, v in kwargs.items()}
                    out[dev.type], caches[m] = getattr(m, meth)(
                        caches[m], *t, codec=codec, **k)
            err = float((out["cuda"].cpu() - out["cpu"]).abs().max())
            atol = tol if codec == "fp" else max(tol, 5e-3)
            if not err <= atol:
                raise AssertionError(f"reduced {name} {meth}[{rail} "
                                     f"{codec}]: card vs CPU logits "
                                     f"differ by {err:.3g} (atol {atol})")
            print(f"reference: reduced {name} {meth} [{rail} {codec}] card "
                  f"kernels vs CPU plain: max |logit| diff {err:.3g}"
                  + (f"; MoE tokens the CPU routed otherwise (it took the "
                     f"card's routing) {flips['n']} of {flips['of']}"
                     if cfg.family == "moe" else ""))
        if codec == "fp":
            counts = _paged_counts()
    return counts


@contextlib.contextmanager
def card_routing(on: bool):
    """Within the block, the MoE layers of a card run record their
    routing and those of the CPU run after it take that routing (each
    layer's experts, slots and drops, with gates from its own router
    probabilities at those experts).  A router choice is discontinuous:
    on the H-FA rail the card's and the CPU's attention differ by up to a
    rail step, which moves a router logit and can swap a token's k-th
    expert, and then that token's output by its whole FFN.  Holding the
    routing fixed keeps the check on the kernels; the routing itself is
    held by :func:`check_moe_layer` on the same inputs.  Yields {"n":
    tokens whose experts or drops the CPU's own routing changed, "of":
    tokens routed}."""
    flips = {"n": 0, "of": 0}
    if not on:
        yield flips
        return
    orig = moe.route
    taken: list = []

    def route(p, x, cfg):
        r = orig(p, x, cfg)
        if x.device.type == "cuda":
            taken.append({k: r[k].cpu() for k in ("idx", "pos", "keep")})
            return r
        card = taken.pop(0)
        own = torch.zeros(r["probs"].shape, dtype=torch.int8)
        own.scatter_(2, r["idx"], torch.where(r["keep"], 2, 1).to(
            torch.int8))
        forced = torch.zeros_like(own)
        forced.scatter_(2, card["idx"], torch.where(card["keep"], 2, 1).to(
            torch.int8))
        flips["n"] += int((own != forced).any(-1).sum())
        flips["of"] += own.shape[0] * own.shape[1]
        gate = torch.gather(r["probs"], -1, card["idx"])
        return dict(r, idx=card["idx"], pos=card["pos"], keep=card["keep"],
                    gate=gate / torch.sum(gate, dim=-1, keepdim=True))

    moe.route = route
    try:
        yield flips
    finally:
        moe.route = orig
    if taken:
        raise AssertionError("card_routing: the CPU run made fewer MoE "
                             "calls than the card's")


def check_small_routes(paged: dict, label: str) -> None:
    """The routes of the reduced f32 models at page 4: every prefill on
    the CUDA cores; decode and verify on v2 on the FA-2 rail, on the CUDA
    cores (a rescale a page) on the H-FA rail."""
    for rail, c in paged.items():
        on = "simt" if rail == "hfa" else ""
        need = {"paged_prefill_simt", f"paged_decode{on and '_simt'}",
                f"paged_verify{on and '_simt'}"}
        if any((c[n] > 0) != (n in need) for n in c):
            raise AssertionError(f"{label} [{rail}]: the reduced f32 "
                                 f"model's paged launches {c}, need "
                                 f"exactly {sorted(need)}")
    print(f"{label}: paged launches of the reduced f32 model (page 4) by "
          f"route {paged}")


# Dense ring on the reduced model, card vs CPU: fa2 is f32 on both sides;
# the H-FA impls move a rail step where a score rounds the other way
# (tiled rail in decode, bf16 scores in the datapath prefill).
RING_TOLS = {"fa2": 1e-4, "hfa_pallas": 2e-2, "hfa": 2e-2,
             "hfa_datapath": 2e-2}


def check_ring_reference() -> None:
    """Reduced qwen3-1.7b (f32): the dense ring's prefill and 8 decode
    steps through the kernels on the card (prefill kernels 5, 8 or 9,
    decode kernel 4) against the plain versions on the CPU, same
    greedy tokens fed to both."""
    toks = DataPipeline.for_config(get_config("qwen3-1.7b").reduced(), 40,
                                   2).batch(0)["tokens"]
    for impl, tol in RING_TOLS.items():
        cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                                  attn_impl=impl)
        cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        gpu = LM(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        caches = {m: m.init_cache(2, 64) for m in (cpu, gpu)}
        errs, tok = [], None
        for step in range(9):
            out = {}
            for m in (cpu, gpu):
                if step == 0:
                    logits, caches[m] = m.prefill(
                        caches[m], torch.tensor(toks, device=m.device))
                else:
                    logits, caches[m] = m.decode_step(
                        caches[m], tok.to(m.device))
                out[m.device.type] = logits.cpu()
            errs.append(float((out["cuda"] - out["cpu"]).abs().max()))
            tok = torch.argmax(out["cpu"][:, -1], dim=-1)[:, None]
        if not max(errs) <= tol:
            raise AssertionError(f"reduced model dense ring [{impl}]: card vs "
                                 f"CPU logits differ by {max(errs):.3g} "
                                 f"(atol {tol})")
        print(f"reference: reduced qwen3-1.7b dense ring [{impl}] prefill + "
              f"8 decode steps, card kernels vs CPU plain: max |logit| diff "
              f"prefill {errs[0]:.3g}, decode {max(errs[1:]):.3g}")


def _leaf_errors(got: dict, want: dict) -> tuple[float, float]:
    """(max over leaves of max|g - w| / max|w|, min cosine)."""
    worst, cos_min = 0.0, 1.0
    for name, w in want.items():
        g = got[name].to(w.device, torch.float32)
        w = w.to(torch.float32)
        worst = max(worst, float((g - w).abs().max() / w.abs().max()))
        cos_min = min(cos_min, float(torch.sum(g * w) / torch.sqrt(
            torch.sum(g * g) * torch.sum(w * w))))
    return worst, cos_min


def check_train_reference() -> None:
    """Reduced qwen3-1.7b (f32): training loss and every gradient through
    the kernels on the card against the plain versions on the CPU."""
    # fa2: f32 on both sides.  hfa: a bf16 score flip between the card's
    # and the CPU's f32 dot products moves a rail step, and the STE
    # gradient splits row-max ties differently (tests/test_torch_train.py
    # holds the CPU packages to 3e-2 for the same reason).
    tols = {"fa2_pallas": (1e-4, 1e-3, 0.9999),
            "hfa_pallas": (1e-3, 5e-2, 0.999)}
    toks = np.random.default_rng(2).integers(1, 512, (2, 256))
    for rail, (loss_tol, grad_tol, cos_tol) in tols.items():
        cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                                  attn_impl=rail)
        cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        gpu = LM(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        out = {}
        for m in (cpu, gpu):
            loss, _ = m.loss({"tokens": torch.tensor(toks, device=m.device)})
            loss.backward()
            out[m.device.type] = (float(loss.detach()), {
                k: p.grad for k, p in m.named_parameters()})
        lerr = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        gerr, cos = _leaf_errors(out["cuda"][1], out["cpu"][1])
        if not (lerr <= loss_tol and gerr <= grad_tol and cos >= cos_tol):
            raise AssertionError(
                f"reduced model training [{rail}]: card vs CPU loss rel "
                f"{lerr:.3g} (tol {loss_tol}), grad rel {gerr:.3g} (tol "
                f"{grad_tol}), min cosine {cos:.6f} (tol {cos_tol})")
        print(f"reference: reduced qwen3-1.7b loss+grads [{rail}] card "
              f"kernels vs CPU plain: loss rel {lerr:.3g}, worst grad leaf "
              f"rel {gerr:.3g}, min cosine {cos:.6f}")


# ------------------------------------------------------------- phase 4
# The engine phases' settings (``serve``, and the serving stack's engines).
STACK_KW = dict(max_batch=8, page_size=16, max_seq=2048, prefill_budget=512)


def stack_engine(model, **kw) -> ServingEngine:
    return ServingEngine(model, device=model.device, **{**STACK_KW, **kw})


def workload(vocab: int, n: int = 16,
             new_tokens: int = 64) -> list[Request]:
    """The engine phase's requests (the first ``n`` of them): a 520-token
    system prompt, tails of 32-256 tokens, ``new_tokens`` each."""
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, vocab, 520).tolist()
    return [Request(rid=i, prompt=sysp + rng.integers(
        1, vocab, int(rng.integers(32, 257))).tolist(),
        max_new_tokens=new_tokens) for i in range(n)]


def serve(model, reqs: list, spec_k, capture=None,
          kv_codec: str = "fp", mesh=None) -> tuple[dict, dict]:
    """Serve ``reqs`` (one arrival a step) through ``ServingEngine`` at
    full width (max_batch 8, page 16, prefill budget 512, pools of
    ``kv_codec``), the cache invariants checked after every step and
    every logit checked finite; under a ``mesh`` as its rank 0, ending
    with ``close()``.
    ``capture(eng, logits)`` sees each decode and verify step's logits.
    Returns (finished by rid, {"launches", "wall_s", "stats",
    "all_logits_prefill": the prefill launches by route of the calls
    with ``return_all_logits``, "calls": each paged call's (batch,
    rows), "pool_bytes_per_shard"})."""
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    all_logits = {"calls": 0, "tc": 0, "simt": 0}
    calls = []
    holder = {}
    originals = {}
    for meth in ("paged_prefill", "paged_decode_step", "paged_verify_step"):
        orig = getattr(model, meth)
        originals[meth] = orig

        def checked(*a, _orig=orig, _meth=meth, **k):
            nonlocal finite
            before = dict(cuda_lib.paged_launches["prefill"])
            calls.append(tuple(a[1].shape))
            logits, layers = _orig(*a, **k)
            finite = finite & torch.isfinite(logits).all()
            if k.get("return_all_logits"):
                all_logits["calls"] += 1
                for r in ("tc", "simt"):
                    all_logits[r] += cuda_lib.paged_launches["prefill"][r] \
                        - before[r]
            if capture is not None and _meth != "paged_prefill":
                capture(holder["eng"], logits)
            return logits, layers
        setattr(model, meth, checked)
    try:
        eng = stack_engine(model, spec_k=spec_k, kv_codec=kv_codec, mesh=mesh)
        holder["eng"] = eng
        cfg = model.cfg
        kv_bytes = eng.bytes_per_token()      # 114,688 B at qwen3-1.7b (fp)
        if kv_bytes != cfg.n_layers * page_codec.bytes_per_token(
                kv_codec, cfg.n_kv_heads, cfg.d_head, torch.bfloat16):
            raise AssertionError(f"{kv_codec} pool holds {kv_bytes} B per "
                                 "token")
        _reset_paged_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = []
        step = 0
        arrivals = [(i, r) for i, r in enumerate(reqs)]
        try:
            while arrivals or eng.sched.has_work:
                while arrivals and arrivals[0][0] <= step:
                    eng.submit(arrivals.pop(0)[1])
                done.extend(eng.step())
                eng.cache.check_invariants()
                step += 1
        finally:
            eng.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _paged_counts()
    finally:
        for meth in originals:
            model.__dict__.pop(meth, None)
    if not bool(finite):
        raise AssertionError("non-finite logits in the engine run")
    return {f.rid: f for f in done}, {
        "launches": launches, "wall_s": wall, "stats": dict(eng.stats),
        "all_logits_prefill": all_logits, "pool_bytes": eng.pool_bytes(),
        "bytes_per_token": kv_bytes, "calls": calls,
        "pool_bytes_per_shard": eng.pool_bytes_per_shard()}


def run_engine(model, spec_k: int, kv_codec: str = "fp", mesh=None,
               n: int = 16, new_tokens: int = 64,
               capture=None) -> tuple[dict, dict, float]:
    reqs = workload(model.cfg.vocab_size, n, new_tokens)
    done, info = serve(model, reqs, spec_k, capture=capture,
                       kv_codec=kv_codec, mesh=mesh)
    streams = {rid: f.tokens for rid, f in done.items()}
    if sorted(streams) != list(range(len(reqs))) or any(
            len(t) != new_tokens for t in streams.values()):
        raise AssertionError(f"not every request finished with "
                             f"{new_tokens} tokens")
    return streams, info, info["wall_s"]


@functools.lru_cache(maxsize=None)
def rail_model(rail: str) -> LM:
    """Full-width qwen3-1.7b on ``rail`` (random bf16 weights from seed 0),
    built once for the engine, engine_codecs and engine_sampled phases
    (``rail_model.cache_clear()`` frees them)."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), attn_impl=rail)
    t0 = time.perf_counter()
    model = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model [{rail}]: qwen3-1.7b full width, {cfg.n_layers} layers, "
          f"{n_params} parameters, init {time.perf_counter() - t0:.1f} s")
    return model


# Depth of the engine_sampled phase's sampled runs, of the serving_stack
# phase's models and of the tp phase's model: rail_model's weights, their
# first 4 of 28 layers, at full width.  The engine phase runs the main
# path at full depth; these runs' checks hold at any depth, and the
# script's walls vary up to 1.6x between machines (878.6 and 1,049.2 s
# of the 1,200 s limit on two of them with the sampled runs at full
# depth, PERF.md; the serving stack at 4 layers makes room for the
# families phase).  The tp phase's ranks share one card and a gather a
# layer: ~1-1.4 s a layer a tp 2 run (28 layers: 26-55 s).
CUT_LAYERS = 4

# The engine phase's greedy fp spec_k 0 streams and wall by rail (full
# depth), which the engine_sampled phase's top_k=1 run is held to.
GREEDY_RUNS: dict = {}


def cut_spec(rail: str) -> dict:
    """The cut model as every rank builds it (``launch/ranks.py``):
    rail_model's config and seed, cut to CUT_LAYERS layers."""
    return {"cfg": dataclasses.replace(get_config("qwen3-1.7b"),
                                       attn_impl=rail),
            "seed": 0, "layers": CUT_LAYERS}


@functools.lru_cache(maxsize=None)
def cut_model(rail: str) -> LM:
    return rank_programs.build_lm(cut_spec(rail), torch.device("cuda", 0))


def _reset_paged_counters() -> None:
    for mod in MODULES.values():
        mod.launches = 0
    for routes in cuda_lib.paged_launches.values():
        for r in routes:
            routes[r] = 0


def _paged_counts() -> dict:
    """Launches of each paged row since the last reset."""
    return {row: cuda_lib.paged_launches[key[0]][key[1]]
            for row, (_, _, key, _) in PAGED_ROWS.items()}


def _agreement(a: dict, b: dict) -> str:
    """Tokens and whole streams two engine runs agree on."""
    agree = sum(int(x == y) for rid in a for x, y in zip(a[rid], b[rid]))
    total = sum(len(t) for t in a.values())
    same = sum(a[rid] == b[rid] for rid in a)
    return f"{agree}/{total} tokens, {same}/{len(a)} whole streams"


# The codec runs of the engine_codecs phase: (codec, spec_k).
CODEC_RUNS = (("int8", 0), ("int8", 4), ("log16", 0))


def _row_launches(la: dict, codec: str) -> dict:
    """A run's launches by route (``_paged_counts``) as rows of the
    kernels line: the fp rows, or the codec's rows (int8's prefill route:
    the CUDA cores)."""
    if codec == "fp":
        return {n: la[n] for n in PAGED_ROWS}
    return {row: la["paged_prefill_simt" if (base, c) == (
        "paged_prefill", "int8") else base]
        for row, (base, c) in CODEC_ROWS.items() if c == codec}


def _check_codec_launches(rail, codec, spec_k, la) -> None:
    """The route counts of a codec run: every int8 prefill on the CUDA
    cores (the tensor cores take bf16 pools), every log16 prefill (a bf16
    view) on the tensor cores; every decode (spec_k 0) or verify (spec_k
    4) on v2; nothing else."""
    pf = "paged_prefill_simt" if codec == "int8" else "paged_prefill"
    step = "paged_decode" if spec_k == 0 else "paged_verify"
    if any((la[n] > 0) != (n in (pf, step)) for n in la):
        raise AssertionError(f"engine [{rail} {codec} spec_k={spec_k}]: "
                             f"launches {la}, need exactly {pf} and {step}")


def check_engine(fp_runs: bool = True, codecs: bool = False) -> dict:
    """The engine phase (``fp_runs``: fp pools at spec_k 0 and 4, and the
    FA-2 unsplit witness) and the engine_codecs phase (``codecs``: int8 at
    spec_k 0 and 4 and log16 at spec_k 0 on the same model, log16's
    streams equal to the fp spec_k 0 run's token for token - at bf16
    compute a log16 pool holds the bf16 K/V bits - and int8's agreement
    with fp printed), both rails.  Returns the launches by row."""
    totals = {n: 0 for n in list(PAGED_ROWS) + list(CODEC_ROWS)}
    for rail in ("fa2", "hfa"):
        model = rail_model(rail)
        runs = {}
        for spec_k in ((0, 4) if fp_runs else (0,)):
            streams, info, wall = run_engine(model, spec_k)
            runs[spec_k] = streams
            if spec_k == 0:
                GREEDY_RUNS[rail] = (streams, wall)
            la = info["launches"]
            # bf16 pools at d 128, page 16: every prefill on the tensor
            # cores and every decode (spec_k 0) or verify (spec_k 4) on
            # v2, none on the CUDA-core kernels.
            need = ["paged_prefill",
                    "paged_decode" if spec_k == 0 else "paged_verify"]
            simt = [n for n in PAGED_ROWS if n.endswith("_simt")]
            if any(la[n] <= 0 for n in need) or any(la[n] for n in simt):
                raise AssertionError(f"[{rail} spec_k={spec_k}] launches "
                                     f"{la}: need {need} > 0 and none of "
                                     f"{simt}")
            if fp_runs:
                for n in PAGED_ROWS:
                    totals[n] += la[n]
            st = info["stats"]
            print(f"engine [{rail} spec_k={spec_k}]: wall {wall:.3f} s, "
                  f"{st['steps']} steps, {st['generated_tokens']} tokens "
                  f"({st['generated_tokens'] / wall:.1f} tok/s), prefill "
                  f"{st['prefill_tokens']} computed + "
                  f"{st['cached_prefill_tokens']} cached, drafts "
                  f"{st['draft_accepted']}/{st['draft_tokens']}, launches "
                  f"{la}")
        if fp_runs:
            print(f"engine [{rail}]: spec_k=4 vs spec_k=0 streams agree on "
                  f"{_agreement(runs[0], runs[4])}")
        if fp_runs and rail == "fa2":
            # Witness for the split decode: spec_k 0 again with every
            # decode walk unsplit (v2 then bit-equal to paged_decode_fwd),
            # against spec_k 4 (which decodes through verify) and the
            # split run.  Not counted as a main-path run.
            rule = cuda_lib.decode_splits
            cuda_lib.decode_splits = lambda *a: 1
            try:
                unsplit, _, wall = run_engine(model, 0)
            finally:
                cuda_lib.decode_splits = rule
            print(f"engine [fa2 spec_k=0, decode unsplit]: wall {wall:.3f} "
                  f"s; agrees with spec_k=4 on {_agreement(unsplit, runs[4])}"
                  f", with the split spec_k=0 run on "
                  f"{_agreement(unsplit, runs[0])}")
        for codec, spec_k in (CODEC_RUNS if codecs else ()):
            streams, info, wall = run_engine(model, spec_k, kv_codec=codec)
            la = info["launches"]
            _check_codec_launches(rail, codec, spec_k, la)
            for row, n in _row_launches(la, codec).items():
                totals[row] += n
            st = info["stats"]
            agree = _agreement(streams, runs[0]) if spec_k == 0 else \
                _agreement(streams, runs.get(4, runs[0]))
            print(f"engine_codecs [{rail} {codec} spec_k={spec_k}]: wall "
                  f"{wall:.3f} s, {st['generated_tokens']} tokens "
                  f"({st['generated_tokens'] / wall:.1f} tok/s), drafts "
                  f"{st['draft_accepted']}/{st['draft_tokens']}, pool "
                  f"{info['pool_bytes']} B ({info['bytes_per_token']} B a "
                  f"token), launches {la}; streams agree with fp spec_k="
                  f"{spec_k if spec_k in runs else 0} on {agree}")
            if codec == "log16" and streams != runs[0]:
                raise AssertionError(f"engine_codecs [{rail}]: the log16 "
                                     f"streams differ from fp's: {agree}")
    return totals


# ------------------------------------------------------------ phase 4b
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, repetition_penalty=1.1)
SAMPLED_SPEC_K = (0, 4, "auto")
TOP_P_MARGIN = 1e-6


def sampled_workload(vocab: int) -> list[Request]:
    """The engine phase's 16 requests with seeded sampling (SAMPLED, seed
    = rid): rid 0 an n=4 group, rid 1 best_of=3 (n=1), rid 2 a
    beam_width=4 search returning 4 hypotheses (greedy: beam search is
    deterministic), rid 3 with logprobs."""
    out = []
    for r in workload(vocab):
        sp = SamplingParams(**SAMPLED, seed=r.rid)
        kw = {0: dict(n=4), 1: dict(best_of=3),
              2: dict(beam_width=4, n=4, sampling=None),
              3: dict(logprobs=True)}.get(r.rid, {})
        out.append(dataclasses.replace(r, **dict(dict(sampling=sp), **kw)))
    return out


def _check_sampled_run(done: dict, reqs: list, label: str) -> None:
    """Every request finished with its tokens (each completion of a
    group), beam scores ranked and negative, every logprob <= 0 and
    finite."""
    if sorted(done) != [r.rid for r in reqs]:
        raise AssertionError(f"{label}: finished {sorted(done)}")
    for r in reqs:
        f = done[r.rid]
        width = r.n if (r.beam_width or r.n > 1 or r.best_of) else 0
        comps = f.completions or []
        if len(comps) != width or any(len(c.tokens) != 64 for c in comps) \
                or len(f.tokens) != 64:
            raise AssertionError(f"{label}: rid {r.rid} finished with "
                                 f"{len(f.tokens)} tokens, "
                                 f"{len(comps)} completions")
        scores = [c.score for c in comps]
        if r.beam_width and (scores != sorted(scores, reverse=True)
                             or not all(np.isfinite(x) and x < 0
                                        for x in scores)):
            raise AssertionError(f"{label}: beam scores {scores}")
        if r.logprobs:
            lps = [x for x in f.prompt_logprobs + f.token_logprobs
                   if x is not None]
            if len(f.token_logprobs) != 64 or f.prompt_logprobs[0] is not \
                    None or not all(np.isfinite(x) and x <= 0 for x in lps):
                raise AssertionError(f"{label}: logprobs rid {r.rid}")


def check_threefry() -> None:
    """JAX's threefry draws on the card equal the CPU's bit for bit: the
    per-(seed, position) keys, the bits and the uniform draw of a
    153,600-entry row, and randint; the gumbel noise (torch's log on each
    device) is printed."""
    v = get_config("qwen3-1.7b").padded_vocab
    seeds = torch.tensor([0, 1, 7, 314, -1, -5, 2 ** 31 - 1, -2 ** 31])
    pos = torch.tensor([0, 3, 520, 776, 1, 2047, 64, 9])
    out = {}
    for dev in ("cuda", "cpu"):
        keys = jr.fold_in(jr.prng_keys(seeds.to(dev)), pos.to(dev))
        out[dev] = (keys, jr.random_bits(keys, v),
                    jr.uniform(keys, v, float(torch.finfo(
                        torch.float32).tiny), 1.0).view(torch.int32),
                    jr.randint(keys, (7,), 0, sampler.INT32_MAX),
                    jr.gumbel(keys, v))
    for name, a, b in zip(("keys", "bits", "uniform", "randint"),
                          out["cuda"], out["cpu"]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"threefry {name}: card and CPU differ")
    gdiff = (out["cuda"][4].cpu() - out["cpu"][4]).abs().max().item()
    print(f"engine_sampled: threefry keys, bits ({len(seeds)} x {v}), "
          f"uniform and randint bit-equal card vs CPU; gumbel max |card - "
          f"CPU| {gdiff:.3g}")


def _top_p_gap(logits, top_k, top_p, temperature, presence, penalty):
    """How far the mass strictly before each token (after penalty,
    temperature and top-k, in the stable descending order, f64 on the
    CPU) lies from its row's top_p: (B, V) in token order."""
    lg = sampler.apply_repetition_penalty(logits.float(), presence, penalty)
    t = temperature[:, None]
    lg = sampler.apply_top_k(lg / torch.where(t > 0, t, torch.ones_like(t)),
                             top_k).double()
    order = torch.argsort(-lg, dim=-1, stable=True)
    p = torch.softmax(torch.gather(lg, -1, order), dim=-1)
    gap = (torch.cumsum(p, dim=-1) - p - top_p.double()[:, None]).abs()
    return torch.empty_like(gap).scatter_(-1, order, gap)


def check_sampler_card_vs_cpu(captured: dict) -> dict:
    """``sample_tokens`` on one captured batch of card logits (a decode
    step of the sampled spec_k 0 run, with its presence rows), on the
    card and on the CPU, under three settings: the same tokens, except
    on a row where either chosen token sits at the top-p boundary (the
    mass before it within 1e-6 of top_p), which the exponentials' last
    bits may move; such rows are counted.  Also the sampler's device
    time at the decode (8 rows) and verify (40) shapes."""
    lg = captured["logits"]
    b = lg.shape[0]
    settings = [SAMPLED, dict(temperature=1.0, top_k=0, top_p=0.9,
                              repetition_penalty=1.0),
                dict(temperature=0.6, top_k=5, top_p=1.0,
                     repetition_penalty=1.3)]
    near_rows = moved = 0
    for i, sp in enumerate(settings):
        args = dict(
            presence=captured["presence"],
            seeds=torch.arange(b, dtype=torch.int32) * 7 + i,
            positions=torch.arange(b, dtype=torch.int32) + 600,
            temperature=torch.full((b,), sp["temperature"]),
            top_k=torch.full((b,), sp["top_k"], dtype=torch.int32),
            top_p=torch.full((b,), sp["top_p"]),
            repetition_penalty=torch.full((b,), sp["repetition_penalty"]))
        card = sampler.sample_tokens(
            lg, **{k: v.cuda() for k, v in args.items()}).cpu()
        cpu = sampler.sample_tokens(lg.cpu(), **{
            k: v.cpu() for k, v in args.items()})
        gap = _top_p_gap(lg.cpu(), args["top_k"], args["top_p"],
                         args["temperature"], args["presence"].cpu(),
                         args["repetition_penalty"])
        rows = torch.arange(b)
        near = ((gap[rows, card.long()] < TOP_P_MARGIN)
                | (gap[rows, cpu.long()] < TOP_P_MARGIN)) \
            & (args["temperature"] > 0)
        diff = card != cpu
        near_rows += int(near.sum())
        moved += int(diff.sum())
        if (diff & ~near).any():
            raise AssertionError(f"sampler card vs CPU, setting {sp}: rows "
                                 f"{diff.nonzero().flatten().tolist()} "
                                 f"differ away from a top-p boundary")
    times, kernels = {}, {}
    for rows in (b, 5 * b):
        rep = lambda x: torch.repeat_interleave(  # noqa: E731
            x.cuda(), rows // b, dim=0)
        a = [rep(lg), rep(captured["presence"]),
             rep(torch.arange(b, dtype=torch.int32)),
             rep(torch.arange(b, dtype=torch.int32) + 600),
             rep(torch.full((b,), 0.8)), rep(torch.full((b,), 50,
                                                       dtype=torch.int32)),
             rep(torch.full((b,), 0.95)), rep(torch.full((b,), 1.1))]
        times[rows] = timed(lambda: sampler.sample_tokens(*a), reps=5,
                            inner=2)
        kernels[rows] = _kernel_breakdown(lambda: sampler.sample_tokens(*a))
    for rows, (dev, n, top) in kernels.items():
        print(f"engine_sampled: sample_tokens at {rows} rows: device "
              f"{dev:.4f} ms in {n:.0f} kernels a call (torch.profiler); "
              f"most time: {top}")
    print(f"engine_sampled: sample_tokens on {b} captured card logit rows "
          f"x {lg.shape[1]}, 3 settings: card and CPU choose the same "
          f"tokens on every row whose choice is away from the top-p "
          f"boundary; rows choosing a token within {TOP_P_MARGIN} of it: "
          f"{near_rows}; rows that differ: {moved}; "
          f"sampler {times[b]:.4f} ms at {b} rows, {times[5 * b]:.4f} ms at "
          f"{5 * b} rows (events)")
    return times


def _kernel_breakdown(fn, calls: int = 5) -> tuple[float, float, list]:
    """(device ms a call, kernels a call, the four kernels with the most
    device time) of ``fn`` from one torch.profiler window; a window with
    no device time recorded gives 0 ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    top = sorted(ev, key=us, reverse=True)[:4]
    return (sum(us(e) for e in ev) / 1e3 / calls,
            sum(e.count for e in ev) / calls,
            [(e.key[:48], round(us(e) / 1e3 / calls, 4)) for e in top])


def check_legacy_prefill(model) -> None:
    """The whole-prompt prefill (no start_pos) at full width: every layer
    on the tensor-core prefill, finite logits at every position, and the
    last position's logits equal to the chunked prefill's from position 0
    on the same tokens."""
    cfg = model.cfg
    reqs = workload(cfg.vocab_size)[:2]
    ell = min(len(r.prompt) for r in reqs)
    toks = torch.tensor([r.prompt[:ell] for r in reqs], device="cuda")
    npg = -(-ell // 16)
    pt = torch.arange(2 * npg, dtype=torch.int32,
                      device="cuda").reshape(2, npg)
    _reset_paged_counters()
    logits, _ = model.paged_prefill(model.init_paged_cache(2 * npg, 16),
                                    toks, pt)
    la = _paged_counts()
    last = torch.full((2,), ell - 1, dtype=torch.int32, device="cuda")
    chunked, _ = model.paged_prefill(
        model.init_paged_cache(2 * npg, 16), toks, pt, last_pos=last,
        start_pos=torch.zeros_like(last))
    torch.cuda.synchronize()
    if la["paged_prefill"] != cfg.n_layers or any(
            la[n] for n in la if n != "paged_prefill"):
        raise AssertionError(f"legacy prefill launches {la}")
    if tuple(logits.shape) != (2, ell, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("legacy prefill logits")
    # The layers run the same shapes both ways; only the LM head's GEMM
    # (every position vs the last) may sum in another order: one bf16
    # rounding of the largest logit at most.
    last_lg = logits[:, -1].float()
    diff = (last_lg - chunked[:, 0].float()).abs().max().item()
    bound = 2.0 ** -7 * last_lg.abs().max().item()
    if diff > bound:
        raise AssertionError(f"legacy vs chunked prefill differ by {diff} "
                             f"(bound {bound})")
    print(f"engine_sampled [{cfg.attn_impl}]: whole-prompt prefill 2 x {ell}"
          f": {la['paged_prefill']} launches, all on paged_prefill_fwd_tc; "
          f"last logits within {diff:.3g} of the chunked prefill's (one "
          f"bf16 rounding: {bound:.3g})")


def check_engine_sampled() -> dict:
    """qwen3-1.7b at full width, both rails: the sampled workload at
    spec_k 0, 4 and "auto" cut to CUT_LAYERS layers; at full depth a
    temperature-0.8 top_k=1 run of the engine phase's workload, which must
    equal the engine phase's greedy run token for token, and the
    whole-prompt prefill; threefry and the sampler card vs CPU.  Returns
    the launches of the engine runs."""
    check_threefry()
    totals = {n: 0 for n in PAGED_ROWS}
    for rail in ("fa2", "hfa"):
        model = cut_model(rail)
        cfg = model.cfg
        reqs = sampled_workload(cfg.vocab_size)
        captured = {}

        def capture(eng, logits):
            if not captured and not eng._all_greedy(range(eng.max_batch)):
                captured["logits"] = logits[:, 0].detach().clone()
                captured["presence"] = eng._presence.clone()

        streams = {}
        for spec_k in SAMPLED_SPEC_K:
            done, info = serve(model, reqs, spec_k,
                               capture if spec_k == 0 else None)
            label = f"engine_sampled [{rail} spec_k={spec_k}]"
            _check_sampled_run(done, reqs, label)
            streams[spec_k] = {rid: f.tokens for rid, f in done.items()}
            la, st, alp = info["launches"], info["stats"], \
                info["all_logits_prefill"]
            need = ["paged_prefill",
                    "paged_decode" if spec_k == 0 else "paged_verify"]
            simt = [n for n in PAGED_ROWS if n.endswith("_simt")]
            if any(la[n] <= 0 for n in need) or any(la[n] for n in simt) \
                    or alp["calls"] <= 0 or alp["tc"] != \
                    alp["calls"] * cfg.n_layers or alp["simt"]:
                raise AssertionError(f"{label}: launches {la}, all-position "
                                     f"prefill {alp}")
            for n in PAGED_ROWS:
                totals[n] += la[n]
            wall = info["wall_s"]
            print(f"{label}: wall {wall:.3f} s, {st['steps']} steps, "
                  f"{st['generated_tokens']} tokens "
                  f"({st['generated_tokens'] / wall:.1f} tok/s), drafts "
                  f"{st['draft_accepted']}/{st['draft_tokens']}, spec_k_last "
                  f"{st['spec_k_last']}, groups {st['groups']}, forks "
                  f"{st['forks']}, beam steps {st['beam_steps']}, "
                  f"all-position prefills {alp['calls']} "
                  f"({alp['tc']} launches on paged_prefill_fwd_tc), "
                  f"launches {la}")
            beam = done[2].completions
            lps = [round(x, 3) for x in done[3].token_logprobs[:4]]
            print(f"{label}: beam-4 scores "
                  f"{[round(c.score, 4) for c in beam]}; rid 3 token "
                  f"logprobs {lps}; best_of=3 branch "
                  f"{done[1].completions[0].branch}")
        for spec_k in SAMPLED_SPEC_K[1:]:
            agree = _agreement(streams[0], streams[spec_k])
            print(f"engine_sampled [{rail}]: spec_k={spec_k} vs spec_k=0 "
                  f"streams agree on {agree}")
        full = rail_model(rail)
        if rail in GREEDY_RUNS:    # the engine phase's run of this model
            greedy, wall_g = GREEDY_RUNS[rail]
        else:
            greedy, info_g, wall_g = run_engine(full, 0)
            for n in PAGED_ROWS:
                totals[n] += info_g["launches"][n]
        top1 = [dataclasses.replace(r, sampling=SamplingParams(
            temperature=0.8, top_k=1, seed=r.rid))
            for r in workload(cfg.vocab_size)]
        done, info = serve(full, top1, 0)
        same = {rid: f.tokens for rid, f in done.items()} == greedy
        print(f"engine_sampled [{rail}]: at {full.cfg.n_layers} layers, "
              f"greedy run wall {wall_g:.3f} s, temperature 0.8 top_k=1 run "
              f"wall {info['wall_s']:.3f} s; streams equal: {same}")
        if not same:
            raise AssertionError(f"[{rail}] the top_k=1 run differs from the "
                                 f"greedy run")
        for n in PAGED_ROWS:
            totals[n] += info["launches"][n]
        check_legacy_prefill(full)
        check_sampler_card_vs_cpu(captured)
    return totals


# ------------------------------------------------------------ phase 4c
ROUTER_TOKENS = 32          # new tokens a router request
DISAGG_TOKENS = 16          # new tokens a request of the disagg runs
DISAGG_RUNS = (("fa2", "fp"), ("fa2", "int8"), ("fa2", "log16"),
               ("hfa", "fp"))
WAIT_S = 120.0              # the longest a client waits for a state


def record_arrivals(eng) -> list:
    """Wrap ``eng.submit`` and ``eng.cancel`` (as ``serve`` wraps the
    model's methods) to record each call with the engine's step count at
    the time: the frontend calls both between steps, so the record
    replays exactly through ``ServingEngine.step`` (:func:`replay`)."""
    events = []
    submit, cancel = eng.submit, eng.cancel

    def recorded_submit(req):
        events.append((eng.stats["steps"], "submit",
                       dataclasses.replace(req, prompt=list(req.prompt))))
        return submit(req)

    def recorded_cancel(rid):
        events.append((eng.stats["steps"], "cancel", rid))
        return cancel(rid)

    eng.submit, eng.cancel = recorded_submit, recorded_cancel
    return events


def replay(model, events: list, watch=(), **kw) -> tuple[dict, float]:
    """Replay an arrival record on a fresh engine of the same settings:
    each submit and cancel before the step it came before.  Returns
    (tokens by rid - a cancelled rid's up to its cancel -, the wall until
    every rid of ``watch`` finished)."""
    eng = stack_engine(model, **kw)
    done, watch = {}, set(watch)
    wall = None
    i = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while i < len(events) or eng.sched.has_work:
        while i < len(events) and events[i][0] <= eng.stats["steps"]:
            _, kind, x = events[i]
            i += 1
            if kind == "submit":
                eng.submit(dataclasses.replace(x, prompt=list(x.prompt)))
                continue
            run = [r for r in eng.sched.running.values()
                   if r.req.rid == x and r.group is None]
            done[x] = list(run[0].generated) if run else []
            eng.cancel(x)
        if not eng.sched.has_work:
            if i < len(events):
                raise AssertionError("replay: the record steps an idle "
                                     "engine")
            break
        for fr in eng.step():
            done[fr.rid] = fr.tokens
        eng.cache.check_invariants()
        if wall is None and watch <= done.keys():
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return done, wall


def check_pool_clean(eng, label: str) -> None:
    """No live slot and no work, every page free or cached, bookkeeping
    consistent."""
    eng.cache.check_invariants()
    c = eng.cache
    if eng.sched.has_work or c.free_slot_count != eng.max_batch or \
            c.available_page_count != c.num_pages:
        raise AssertionError(f"{label}: pool not clean ({c.free_slot_count} "
                             f"free slots, {c.available_page_count} of "
                             f"{c.num_pages} pages available)")


async def _until(cond, what: str) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > WAIT_S:
            raise AssertionError(f"serving_stack: waited {WAIT_S} s for "
                                 f"{what}")
        await asyncio.sleep(0.002)


async def sse_client(server, payload: dict, tenant=None, stop=None,
                     first=None) -> dict:
    """One ``/v1/generate`` through ``stream_generate``: the tokens and
    their client-clock times, the done payload (None when ``stop`` - a
    token count or an event - closed the stream first: a disconnect).
    ``first`` is set at the first token."""
    out = {"toks": [], "times": [], "done": None, "t0": time.perf_counter()}
    gen = stream_generate(server.host, server.port, payload, tenant=tenant)
    try:
        async for kind, data in gen:
            if kind == "error":
                raise AssertionError(f"serving_stack: {payload.get('id')} "
                                     f"answered {data}")
            if kind == "done":
                out["done"] = data
                break
            out["toks"].append(data["token"])
            out["times"].append(time.perf_counter())
            if first is not None:
                first.set()
            if stop is not None and (len(out["toks"]) >= stop
                                     if isinstance(stop, int)
                                     else stop.is_set()):
                break
    finally:
        await gen.aclose()
    return out


def _stream_done(c: dict, label: str) -> list:
    """A stream that ended with its done event, which carries its tokens
    (those streamed, unless it was a ``stream: false`` answer)."""
    d = c["done"]
    if d is None or (c["toks"] and d["tokens"] != c["toks"]):
        raise AssertionError(f"{label}: stream without its done event or "
                             f"tokens differing from it")
    return d["tokens"]


def _same(label: str, got: list, want: list, prefix=False) -> None:
    if (got != want[:len(got)]) if prefix else (got != want):
        raise AssertionError(f"{label}: the stream differs from the replay "
                             f"of its arrival record ({len(got)} / "
                             f"{len(want)} tokens)")


async def _http_round(model, rail: str) -> dict:
    """The 16-request workload as concurrent SSE streams through one
    HttpServer, a 429 probe against a cap of 1 while requests wait for a
    slot; then one sampled tenant stream, one ``stream: false`` request
    and one mid-stream disconnect."""
    eng = stack_engine(model)
    events = record_arrivals(eng)
    fe = AsyncFrontend(eng)
    server = await HttpServer(fe).start()
    probe = await HttpServer(fe, queue_caps=1).start()
    reqs = workload(model.cfg.vocab_size)
    _reset_paged_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tasks = [asyncio.ensure_future(sse_client(server, {
        "prompt": r.prompt, "max_new_tokens": r.max_new_tokens,
        "id": r.rid})) for r in reqs]
    await _until(lambda: fe.queue_depth("standard") >= 1,
                 "a request waiting for a slot")
    rejected = [ev async for ev in stream_generate(
        probe.host, probe.port, {"prompt": reqs[0].prompt,
                                 "max_new_tokens": 8})]
    main = await asyncio.gather(*tasks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rejected != [("error", {"status": 429, "body": {
            "error": "queue full for class 'standard'", "class": "standard",
            "cap": 1}})]:
        raise AssertionError(f"http [{rail}]: the probe got {rejected}")
    prompt = reqs[0].prompt
    extra = await asyncio.gather(
        sse_client(server, {"prompt": prompt, "max_new_tokens": 16,
                            "temperature": 0.8, "top_k": 50, "top_p": 0.95,
                            "seed": 7, "id": "sampled"}, tenant="alice"),
        sse_client(server, {"prompt": reqs[1].prompt, "max_new_tokens": 16,
                            "stream": False, "id": "json"}),
        sse_client(server, {"prompt": reqs[2].prompt, "max_new_tokens": 64,
                            "id": "disconnect"}, stop=4))
    await _until(lambda: eng.stats["cancelled"] >= 1, "the disconnect's "
                 "cancel")
    await fe.drain()
    la = _paged_counts()
    failed = fe.failed
    http = dict(server.http_stats)
    await probe.stop()
    await server.stop()
    await fe.close()
    if failed:
        raise AssertionError(f"http [{rail}]: the frontend failed")
    check_pool_clean(eng, f"http [{rail}]")
    return {"main": main, "extra": extra, "events": events, "wall": wall,
            "launches": la, "http": http, "stats": dict(eng.stats)}


def check_http(model, rail: str) -> dict:
    """HTTP over loopback, one replica, fp pools, spec_k 0: every SSE
    stream equals the replay of the frontend's arrival record, token for
    token.  Returns the launches (the served run and its replay)."""
    r = asyncio.run(_http_round(model, rail))
    la = r["launches"]
    simt = [n for n in PAGED_ROWS if n.endswith("_simt")]
    if la["paged_prefill"] <= 0 or la["paged_decode"] <= 0 or any(
            la[n] for n in simt):
        raise AssertionError(f"http [{rail}]: launches {la}")
    main_rids = [c["done"]["rid"] for c in r["main"] if c["done"]]
    _reset_paged_counters()
    want, replay_wall = replay(model, r["events"], watch=main_rids)
    la_replay = _paged_counts()
    for c in r["main"]:
        toks = _stream_done(c, f"http [{rail}] {c['done'] and c['done']['id']}")
        if len(toks) != 64:
            raise AssertionError(f"http [{rail}]: a stream of {len(toks)} "
                                 f"tokens")
        _same(f"http [{rail}] rid {c['done']['rid']}", toks,
              want[c["done"]["rid"]])
    sampled, as_json, cut = r["extra"]
    for c, n in ((sampled, 16), (as_json, 16)):
        toks = _stream_done(c, f"http [{rail}] {c['done']['id']}")
        if len(toks) != n or c["done"]["reason"] != "length":
            raise AssertionError(f"http [{rail}]: {c['done']}")
        _same(f"http [{rail}] {c['done']['id']}", toks,
              want[c["done"]["rid"]])
    if as_json["toks"] or cut["done"] is not None or len(cut["toks"]) != 4:
        raise AssertionError(f"http [{rail}]: the stream: false answer "
                             f"streamed, or the disconnect got its end")
    cancels = [x for _, kind, x in r["events"] if kind == "cancel"]
    if len(cancels) != 1 or r["http"]["disconnects"] < 1:
        raise AssertionError(f"http [{rail}]: cancels {cancels}, "
                             f"{r['http']}")
    _same(f"http [{rail}] disconnect", cut["toks"], want[cancels[0]],
          prefix=True)
    ttft = [c["times"][0] - c["t0"] for c in r["main"]]
    n_tok = sum(len(c["toks"]) for c in r["main"])
    print(f"serving_stack http [{rail}]: 16 concurrent SSE streams, TTFT "
          f"p50 {np.percentile(ttft, 50):.4f} s p99 "
          f"{np.percentile(ttft, 99):.4f} s (client clock), {n_tok} tokens "
          f"in {r['wall']:.3f} s ({n_tok / r['wall']:.1f} tok/s); the replay "
          f"of its arrival record {replay_wall:.3f} s "
          f"({r['wall'] / replay_wall:.3f}x); every stream equal to the "
          f"replay; {r['stats']['steps']} steps; 429 at cap 1, sampled tenant "
          f"stream, stream false, a disconnect after 4 tokens cancelled "
          f"(its first {len(want[cancels[0]])} tokens); launches {la}, "
          f"replay {la_replay}")
    return {n: la[n] + la_replay[n] for n in PAGED_ROWS}


async def _router_round(model) -> dict:
    """Two replicas behind a Router and one HttpServer: two distinct
    520-token system prompts, a first request on each (B0 placed while A0
    decodes on replica 0), three follow-ups each; replica 1 is marked
    down with its requests in flight, their clients disconnect, and the
    requests are sent again."""
    engines = [stack_engine(model), stack_engine(model)]
    events = [record_arrivals(e) for e in engines]
    router = Router([AsyncFrontend(e) for e in engines])
    placements = []                # (rid, prompt, replica) by submission
    submit = router.submit

    def recorded_submit(req):
        gen = submit(req)
        placements.append((req.rid, tuple(req.prompt),
                           router.core.placement[req.rid]))
        return gen

    router.submit = recorded_submit
    server = await HttpServer(router).start()
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(1)
    systems = [rng.integers(1, vocab, 520).tolist() for _ in range(2)]
    payloads = {f"{ab}{i}": {"prompt": systems[k] + rng.integers(
        1, vocab, int(rng.integers(32, 129))).tolist(),
        "max_new_tokens": ROUTER_TOKENS, "id": f"{ab}{i}"}
        for k, ab in enumerate("AB") for i in range(4)}
    clients, firsts = {}, {}
    down = asyncio.Event()

    def start(name, payload, stop=None):
        firsts[name] = asyncio.Event()
        clients[name] = asyncio.ensure_future(sse_client(
            server, payload, first=firsts[name], stop=stop))

    t0 = time.perf_counter()
    for name in ("A0", "B0", "A1", "B1", "A2", "B2", "A3", "B3"):
        start(name, payloads[name], stop=down if name[0] == "B" else None)
        if name[1] == "0":
            await _until(firsts[name].is_set, f"{name}'s first token")
    await _until(lambda: all(firsts[f"B{i}"].is_set() for i in range(4)),
                 "replica 1's follow-ups decoding")
    lost = router.core.down(1)
    down.set()                     # their clients disconnect
    cut = [name for name in ("B0", "B1", "B2", "B3")
           if (await clients[name])["done"] is None]
    for name in cut:               # the caller re-places what came back
        start(name + "'", dict(payloads[name], id=name + "'"))
    out = {name: await c for name, c in clients.items()}
    await router.drain()
    wall = time.perf_counter() - t0
    stats, core = dict(router.stats), router.core
    left = (dict(core.placement), list(core.load))
    await server.stop()
    await router.close()
    for i, e in enumerate(engines):
        check_pool_clean(e, f"router replica {i}")
    return {"out": out, "payloads": payloads, "placements": placements,
            "lost": lost, "cut": cut, "events": events, "stats": stats,
            "left": left, "wall": wall}


def check_router(model) -> dict:
    """Router, two replicas, fa2: follow-ups land on the replica holding
    their system prompt; a replica marked down hands back its in-flight
    rids, which re-route to the live one; each replica's streams equal
    the replay of its own arrival record.  Returns the launches."""
    _reset_paged_counters()
    r = asyncio.run(_router_round(model))
    la = _paged_counts()
    out, cut = r["out"], r["cut"]
    by_prompt: dict = {}
    for rid, prompt, replica in r["placements"]:
        by_prompt.setdefault(prompt, []).append((rid, replica))
    where = {}                     # name -> (rid, replica)
    for name, c in out.items():
        runs = by_prompt[tuple(r["payloads"][name.rstrip("'")]["prompt"])]
        where[name] = runs[1 if name.endswith("'") else 0]
    want = {name: 0 if name[0] == "A" or name.endswith("'") else 1
            for name in out}
    got = {name: replica for name, (_, replica) in where.items()}
    lost_names = sorted(name for name, (rid, _) in where.items()
                        if rid in r["lost"])
    if got != want or not cut or not set(cut) <= set(lost_names) or any(
            n[0] != "B" for n in lost_names) or \
            r["stats"]["prefix_routed"] < 6 or r["left"] != ({}, [0, 0]):
        raise AssertionError(f"router: placements {got}, want {want}; lost "
                             f"{lost_names}, disconnected {cut}; stats "
                             f"{r['stats']}; left {r['left']}")
    replays = [replay(model, ev)[0] for ev in r["events"]]
    la_all = _paged_counts()
    for name, c in out.items():
        rid, replica = where[name]
        if name in cut:
            _same(f"router {name}", c["toks"], replays[replica][rid],
                  prefix=True)
            continue
        toks = _stream_done(c, f"router {name}")
        if len(toks) != ROUTER_TOKENS:
            raise AssertionError(f"router {name}: {len(toks)} tokens")
        _same(f"router {name}", toks, replays[replica][rid])
    print(f"serving_stack router [fa2]: 2 replicas, {len(out)} streams in "
          f"{r['wall']:.3f} s, replicas by request {got}; replica 1 marked "
          f"down with {lost_names} in flight, {cut} re-placed on replica 0; "
          f"stats {r['stats']}; each replica's streams equal the replay of "
          f"its record; launches {la}, with the replays {la_all}")
    return {n: la_all[n] for n in PAGED_ROWS}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}
                  .get(t.dtype, t.dtype))


def check_disagg(model, rail: str, codec: str, lifecycle: bool) -> dict:
    """A DisaggPair of two full-width engines over the 16-request workload
    (``DISAGG_TOKENS`` new tokens each): every imported page bit-equal to
    the exporter's in every layer and leaf; the pair's streams equal a
    single engine's that first ran each prompt alone with
    max_new_tokens=1 in the same order.  ``lifecycle``: a mid-handoff
    abort and a stage fallback leave both pools clean.  Returns the
    launches by row."""
    label = f"disagg [{rail} {codec}]"
    reqs = [dataclasses.replace(r, max_new_tokens=DISAGG_TOKENS)
            for r in workload(model.cfg.vocab_size)]
    pair = DisaggPair(stack_engine(model, kv_codec=codec),
                      stack_engine(model, kv_codec=codec))
    copies = []
    copy, start = pair._copy_pages, pair.start_handoff

    def timed_copy(src, dst):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        copy(src, dst)
        ev[1].record()
        copies.append((len(src), ev))

    def checked_start(req):
        h = start(req)
        if h is None:
            return h
        s = torch.tensor(h.src_pages, dtype=torch.int64, device=model.device)
        d = torch.tensor(h.dst_pages, dtype=torch.int64, device=model.device)
        for name, pools in pair.prefill.layers.items():
            for key, pool in pools.items():
                if not torch.equal(
                        _bits(pair.decode.layers[name][key][:, d]),
                        _bits(pool[:, s])):
                    raise AssertionError(f"{label}: an imported page of "
                                         f"{name}.{key} differs from the "
                                         f"exporter's")
        return h

    pair._copy_pages, pair.start_handoff = timed_copy, checked_start
    _reset_paged_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = {f.rid: f.tokens for f in pair.run([(i, dataclasses.replace(
        r, prompt=list(r.prompt))) for i, r in enumerate(reqs)])}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    la = _paged_counts()
    _check_codec_launches(rail, codec, 0, la)
    pair.check_invariants()
    single = stack_engine(model, kv_codec=codec)
    for r in reqs:
        single.run([(0, Request(rid=r.rid, prompt=list(r.prompt),
                                max_new_tokens=1))])
    want = {f.rid: f.tokens for f in single.run([(i, dataclasses.replace(
        r, prompt=list(r.prompt))) for i, r in enumerate(reqs)])}
    la_all = _paged_counts()
    if sorted(got) != list(range(16)) or any(
            len(t) != DISAGG_TOKENS for t in got.values()):
        raise AssertionError(f"{label}: not every request finished")
    if got != want:
        raise AssertionError(f"{label}: the pair's streams differ from the "
                             f"pre-cached single engine's: "
                             f"{_agreement(got, want)}")
    check_pool_clean(pair.prefill, f"{label} prefill worker")
    check_pool_clean(pair.decode, f"{label} decode worker")
    pages = [n for n, _ in copies]
    ms = [ev[0].elapsed_time(ev[1]) for _, ev in copies]
    page_bytes = STACK_KW["page_size"] * pair.decode.bytes_per_token()
    bound = [2 * n * page_bytes / HBM_BYTES_PER_S * 1e3 for n in pages]
    st = pair.stats
    print(f"{label}: 16 requests, {st['handoffs']} handoffs, "
          f"{st['handoff_pages']} pages published ({st['handoff_dupes']} "
          f"dupes), {sum(pages)} pages copied ({page_bytes} B a page), every "
          f"import bit-equal to its export; copy ms a handoff by events: "
          f"median {statistics.median(ms):.4f} (pages {min(pages)}-"
          f"{max(pages)}), bound median {statistics.median(bound):.4f} "
          f"(read + write at 3.35 TB/s), total {sum(ms):.3f} vs "
          f"{sum(bound):.3f}; pair wall {wall:.3f} s; streams equal the "
          f"pre-cached single engine's; launches {la}, with the single "
          f"engine {la_all}")
    if lifecycle:
        req = Request(rid=100, prompt=list(reqs[0].prompt) + [1, 2, 3],
                      max_new_tokens=1)
        avail = pair.decode.cache.available_page_count
        h = pair.start_handoff(req)
        pair.check_invariants()
        pair.abort(h)
        pair.check_invariants()
        hog = pair.decode.cache.stage_pages(
            pair.decode.cache.available_page_count - 1)
        fell_back = pair.start_handoff(dataclasses.replace(req, rid=101))
        pair.decode.cache.abort_staged(hog)
        pair.check_invariants()
        if h.state != "aborted" or fell_back is not None or \
                st["handoff_fallbacks"] != 1 or st["handoff_aborts"] != 1 \
                or pair.decode.cache.available_page_count != avail or \
                pair.prefill.cache._export_pins.any():
            raise AssertionError(f"{label}: abort / fallback left {st}")
        check_pool_clean(pair.prefill, f"{label} prefill worker")
        check_pool_clean(pair.decode, f"{label} decode worker")
        print(f"{label}: a mid-handoff abort ({len(h.dst_pages)} staged "
              f"pages returned) and a stage fallback left both pools clean")
    del pair, single
    return _row_launches(la_all, codec)


def check_serving_stack() -> dict:
    """The serving stack over the engine at full width (the model cut to
    CUT_LAYERS layers): HTTP/SSE on both rails, the router over two
    replicas, prefill/decode disaggregation on every codec.  Returns the
    launches by row."""
    t0 = time.perf_counter()
    totals = {n: 0 for n in list(PAGED_ROWS) + list(CODEC_ROWS)}

    def add(counts):
        for n, c in counts.items():
            totals[n] += c

    for rail in ("fa2", "hfa"):
        add(check_http(cut_model(rail), rail))
    add(check_router(cut_model("fa2")))
    for i, (rail, codec) in enumerate(DISAGG_RUNS):
        add(check_disagg(cut_model(rail), rail, codec, lifecycle=i == 0))
    # The recording and timing wrappers close over their engines, a cycle
    # each: collect them, so their pools are freed before the next phase.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serving_stack: phase wall {time.perf_counter() - t0:.1f} s")
    return totals


# ------------------------------------------------------------ phase 4d
# The tp phase's runs at tp 2: (dp, rail, spec_k, codec).
TP_RUNS = ((1, "fa2", 0, "fp"), (1, "fa2", 4, "fp"), (1, "hfa", 0, "fp"),
           (1, "hfa", 4, "fp"), (1, "fa2", 0, "int8"), (2, "fa2", 0, "fp"),
           (2, "hfa", 0, "fp"))
TP_TIMEOUT = 300.0      # s a collective or a rank's end may take


def _shard_partials(name: str, args, impl: str, tp: int, shard: int):
    """Shard ``shard`` of ``tp``'s triplet of a kernels-phase case: its
    KV heads of q and of the pools, the split rule sized for the whole
    call (``pairs``), no write and no collective."""
    q, kp, vp, pt, *lens = args
    hkv = kp.shape[2]
    hs = collectives.head_slice(hkv, tp, shard)
    pools = collectives.shard_pools({"k_pages": kp, "v_pages": vp}, tp,
                                    shard)
    qs = q[:, hs].contiguous()
    kw = dict(impl=impl)
    if name != "paged_prefill":
        kw["pairs"] = q.shape[0] * hkv
    fn = {"paged_decode": ops.paged_decode_partials,
          "paged_verify": ops.paged_verify_partials,
          "paged_prefill": ops.paged_prefill_partials}[name]
    return fn(qs, pools["k_pages"], pools["v_pages"], pt, *lens, **kw)


def check_tp_kernels() -> None:
    """On this rank alone, without collectives: each shard's decode,
    verify and prefill over its heads at the kernels phase's shapes,
    padded with the neutral element and merged (Eq. 16, shard 0 first),
    equal to the single call's finalize on every live row, both rails,
    tp 2 and 4."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = kernel_cases(gen)
    for name, (args, live, _, _) in cases.items():
        hkv = args[1].shape[2]
        for impl in ("fa2", "hfa"):
            use_hfa = impl == "hfa"
            o, m, ell = _shard_partials(name, args, impl, 1, 0)
            want = decode_k.finalize_decode(o, ell, use_hfa=use_hfa)
            for tp in (2, 4):
                packed = torch.stack([collectives.pad_neutral(
                    *_shard_partials(name, args, impl, tp, s), hkv,
                    collectives.head_slice(hkv, tp, s)) for s in range(tp)])
                got = collectives.merge_shards(packed, use_hfa=use_hfa)
                rows = torch.as_tensor(np.asarray(live), device="cuda")
                mask = rows[:, None, None, :].expand(*want.shape[:3],
                                                     rows.shape[1])
                g4 = got if got.dim() == 5 else got[:, :, :, None]
                w4 = want if want.dim() == 5 else want[:, :, :, None]
                if not torch.equal(g4[mask], w4[mask]):
                    raise AssertionError(
                        f"tp kernels [{name} {impl} tp={tp}]: the merged "
                        f"shards differ from the single call on "
                        f"{int((g4[mask] != w4[mask]).sum())} values")
        print(f"tp kernels [{name}]: shards at tp 2 and 4, padded and "
              f"merged, equal the single call on every live row, both "
              f"rails")


def _rank_rows(launches: dict) -> dict:
    """A rank's paged launches by kind and route as rows."""
    return {row: launches[key[0]][key[1]]
            for row, (_, _, key, _) in PAGED_ROWS.items()}


def check_tp() -> dict:
    """The tp phase: tensor- and data-parallel serving on gloo ranks on
    this one card.  Returns the launches by row over every rank."""
    t0 = time.perf_counter()
    check_tp_kernels()
    totals = {n: 0 for n in list(PAGED_ROWS) + list(CODEC_ROWS)}
    singles = {}
    for _, rail, spec_k, codec in TP_RUNS:
        if (rail, codec, spec_k) not in singles:
            streams, info, _ = run_engine(cut_model(rail), spec_k,
                                          kv_codec=codec)
            singles[(rail, codec, spec_k)] = (streams, info)
            for row, n in _row_launches(info["launches"], codec).items():
                totals[row] += n
    cfg = cut_model("fa2").cfg
    for dp in (1, 2):
        runs = [r for r in TP_RUNS if r[0] == dp]
        jobs = [dict(mesh=(2, dp), model=rail,
                     engine=dict(STACK_KW, spec_k=spec_k, kv_codec=codec))
                for _, rail, spec_k, codec in runs]
        specs = {rail: cut_spec(rail) for _, rail, _, _ in runs}

        def lead():
            kw = dict(device="cuda", backend="gloo")
            mesh = make_tp_mesh(2, **kw) if dp == 1 else \
                make_tp_dp_mesh(2, dp, **kw)
            return [run_engine(cut_model(rail), spec_k, kv_codec=codec,
                               mesh=mesh)[:2]
                    for _, rail, spec_k, codec in runs]

        t1 = time.perf_counter()
        mine, theirs = run_ranks(
            lead, rank_programs.follow_jobs, 2 * dp,
            args=({"device": "cuda", "backend": "gloo"}, specs, jobs),
            device="cuda", backend="gloo", timeout=TP_TIMEOUT)
        print(f"tp [tp=2 dp={dp}]: {2 * dp} gloo ranks on cuda:0, "
              f"{len(runs)} runs in {time.perf_counter() - t1:.1f} s "
              f"(spawn, model init and the runs)")
        for i, (_, rail, spec_k, codec) in enumerate(runs):
            label = f"tp [{rail} tp=2 dp={dp} spec_k={spec_k} {codec}]"
            streams, info = mine[i]
            want, single = singles[(rail, codec, spec_k)]
            reps = [(streams, info["stats"], info["pool_bytes_per_shard"],
                     info["launches"])] + [
                ({rid: f.tokens for rid, f in t[i]["finished"].items()},
                 t[i]["stats"], t[i]["pool_bytes_per_shard"],
                 _rank_rows(t[i]["launches"])) for t in theirs]
            # The reference's count: tp shards each gather tp padded
            # triplets, (d_head + 2) f32 a (slot, row, head, layer).
            tri = sum(2 * 2 * b * rows * cfg.n_heads * (cfg.d_head + 2) * 4
                      * cfg.n_layers for b, rows in info["calls"])
            per_rank = []
            for rank, (st_, stats, pb, la) in enumerate(reps):
                if st_ != want:
                    raise AssertionError(
                        f"{label}: rank {rank}'s streams differ from the "
                        f"single-shard engine's on {_agreement(st_, want)}")
                if pb * 2 != single["pool_bytes"]:
                    raise AssertionError(f"{label}: rank {rank} holds {pb} "
                                         f"B of pool, the single shard "
                                         f"{single['pool_bytes']}")
                if stats != reps[0][1] or stats["triplet_bytes"] != tri:
                    raise AssertionError(f"{label}: rank {rank}'s stats "
                                         f"differ, or triplet_bytes "
                                         f"{stats['triplet_bytes']} != {tri}")
                if codec == "fp":
                    need = ["paged_prefill",
                            "paged_decode" if spec_k == 0 else "paged_verify"]
                    if any((la[n] > 0) != (n in need) for n in la):
                        raise AssertionError(f"{label}: rank {rank}'s "
                                             f"launches {la}, need only "
                                             f"{need}")
                    rows_ = {n: la[n] for n in PAGED_ROWS}
                else:
                    _check_codec_launches(rail, codec, spec_k, la)
                    rows_ = _row_launches(la, codec)
                for n, c in rows_.items():
                    totals[n] += c
                per_rank.append({n: c for n, c in la.items() if c})
            wall, w1 = info["wall_s"], single["wall_s"]
            print(f"{label}: wall {wall:.3f} s against the single shard's "
                  f"{w1:.3f} s ({wall / w1:.3f}x), "
                  f"{reps[0][1]['generated_tokens']} tokens; every rank's "
                  f"streams equal the single-shard engine's; pool "
                  f"{reps[0][2]} B a shard of {single['pool_bytes']} B; "
                  f"triplets {tri} B; launches by rank {per_rank}")
    print("tp: the collectives are gloo through host memory with every "
          "rank on one card (NCCL takes one rank a card): the walls time "
          "that, not NVLink; " + card_line())
    print(f"tp: launches of the phase, every rank and the single-shard runs, "
          f"by row {({n: c for n, c in totals.items() if c})}")
    print(f"tp: phase wall {time.perf_counter() - t0:.1f} s")
    cut_model.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------ phase 4e
# The families phase: every other config the reference's paged engine
# serves.  hfa-paper-mini and granite-moe-1b-a400m at full width and full
# depth: (rail, spec_k) runs; the others at full width cut to their first
# FAMILY_CUT_LAYERS layers (a cut of depth: one card holds neither
# phi3.5-moe-42b-a6.6b, ~84 GB in bf16, nor command-r-plus-104b, ~208 GB,
# and the script has a time limit), fa2 at spec_k 0 and 4.
FAMILY_FULL = {"hfa-paper-mini": (("hfa", 0), ("hfa", 4), ("fa2", 0)),
               "granite-moe-1b-a400m": (("fa2", 0), ("fa2", 4), ("hfa", 0))}
FAMILY_CUT = ("qwen1.5-4b", "minitron-8b", "phi3.5-moe-42b-a6.6b",
              "command-r-plus-104b")
FAMILY_CUT_LAYERS = 2
FAMILY_REQS = {"full": (8, 32), "cut": (4, 16)}   # (requests, new tokens)
# serve --dense on hfa-paper-mini (its own impl, hfa_pallas): prompts,
# steps, ring.
FAMILY_DENSE = (8, 256, 16, 288)
# The MoE layer check: routing card vs CPU equal up to near ties (the
# router probabilities of a token's k-th and (k+1)-th experts within
# this of each other), outputs within REL_MOE of each tensor's max.
MOE_TIE = 1e-6
REL_MOE = 2.0 ** -7


def family_model(arch: str, layers: int | None = None) -> LM:
    """``arch`` at full width (``layers``: its first layers only) with
    random bf16 weights from seed 0, drawn tensor by tensor on the card."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    model = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"families: {arch} full width, {cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, d_head "
          f"{cfg.d_head}, vocab {cfg.vocab_size}"
          + (f", {cfg.n_experts} experts top-{cfg.moe_top_k}"
             if cfg.family == "moe" else "")
          + f": {nbytes} parameter bytes, init "
          f"{time.perf_counter() - t0:.1f} s")
    return model


def family_routes(cfg, spec_k: int) -> set:
    """The paged rows a run of ``cfg`` at page 16 (bf16 pools) launches:
    its prefill route (``paged_prefill_route``: the tensor cores at d 64
    and 128, the CUDA cores at d 96) and its decode (v2) or its verify of
    G K rows (``paged_verify_route``)."""
    g = cfg.n_heads // cfg.n_kv_heads
    pf = "paged_prefill" if cfg.d_head in cuda_lib.TC_HEAD_DIMS \
        else "paged_prefill_simt"
    if spec_k == 0:
        step = "paged_decode"
    else:
        route = cuda_lib.paged_verify_route(
            g, spec_k + 1, STACK_KW["page_size"],
            cfg.attn_impl.startswith("hfa"))
        step = "paged_verify" + ("_simt" if route == "simt" else "")
    return {pf, step}


def _family_run(model, rail: str, spec_k: int, kind: str, capture=None,
                tag: str = "") -> tuple[dict, dict]:
    """One engine run of the families phase on ``rail``: every request
    finishes with its count, logits finite, invariants kept (``serve``),
    launches on exactly the expected routes.  Returns (streams, info)."""
    model.cfg = dataclasses.replace(model.cfg, attn_impl=rail)
    n, new = FAMILY_REQS[kind]
    streams, info, wall = run_engine(model, spec_k, n=n, new_tokens=new,
                                     capture=capture)
    la = info["launches"]
    need = family_routes(model.cfg, spec_k)
    if any((la[r] > 0) != (r in need) for r in la):
        raise AssertionError(f"families [{model.cfg.name} {rail} spec_k="
                             f"{spec_k}]: launches {la}, need exactly "
                             f"{sorted(need)}")
    st = info["stats"]
    print(f"families{tag} [{model.cfg.name} {rail} spec_k={spec_k}]: wall "
          f"{wall:.3f} s, {st['steps']} steps, {st['generated_tokens']} "
          f"tokens ({st['generated_tokens'] / wall:.1f} tok/s), prefill "
          f"{st['prefill_tokens']} computed + {st['cached_prefill_tokens']} "
          f"cached, drafts {st['draft_accepted']}/{st['draft_tokens']}, "
          f"launches { {r: c for r, c in la.items() if c} }")
    return streams, info


def _simt_share(model, rail: str, spec_k: int, kind: str) -> None:
    """The families run again under torch.profiler: the device time of
    the CUDA-core paged kernel (``paged_attention_kernel``: hfa-paper-mini's
    d 96 prefill, command-r-plus's G K 60 verify) against the device's
    busy time and the run's wall (not a main-path run: its launches are
    not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, info = _family_run(model, rail, spec_k, kind, tag=" profiled")
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    key = PAGED_ROWS["paged_prefill_simt"][3]
    busy = sum(us(e) for e in ev) / 1e3
    simt = sum(us(e) for e in ev if key in e.key) / 1e3
    n = sum(e.count for e in ev if key in e.key)
    wall = info["wall_s"] * 1e3
    print(f"families profile [{model.cfg.name} {rail} spec_k={spec_k}]: "
          f"{key} {simt:.3f} ms in {n} launches = "
          f"{simt / max(busy, 1e-9):.1%} of the device's busy {busy:.3f} ms "
          f"and {simt / wall:.1%} of the run's wall {wall:.1f} ms (profiled)")


def check_moe_layer(model, captured: dict) -> None:
    """Layer 0's MoE on captured inputs (a prefill chunk, a decode batch;
    padding and free rows included): ``moe_apply`` on the card against
    the port's on the CPU, the same bf16 inputs upcast to f32 there.
    Every assignment routes to the same expert and drops alike, but a
    token whose k-th and (k+1)-th router probabilities lie within MOE_TIE
    (a near tie) and an assignment whose slot such a tie moved (counted,
    printed); the outputs of the other tokens within REL_MOE of the
    tensor's max."""
    cfg = model.cfg
    k = cfg.moe_top_k
    cpu = moe.MoE(cfg, torch.float32, "cpu")
    cpu.load_state_dict({n: t.detach().to("cpu", torch.float32) for n, t in
                         model.layers[0].ffn.state_dict().items()})
    for what, x in captured.items():
        with torch.no_grad():
            rg = moe.route(model.layers[0].ffn, x, cfg)
            out_g, _ = moe.moe_apply(model.layers[0].ffn, x, cfg, rg)
            xc = x.to("cpu", torch.float32)
            rc = moe.route(cpu, xc, cfg)
            out_c, _ = moe.moe_apply(cpu, xc, cfg, rc)
        ng, g = rc["idx"].shape[:2]
        e = cfg.n_experts
        sets = {}
        for name, r in (("card", rg), ("cpu", rc)):
            idx = r["idx"].cpu()
            chosen = torch.zeros((ng, g, e), dtype=torch.bool)
            chosen.scatter_(2, idx, True)
            kept = torch.zeros((ng, g, e), dtype=torch.bool)
            kept.scatter_(2, idx, r["keep"].cpu())
            sets[name] = (chosen, kept)
        srt = torch.sort(rc["probs"], dim=-1, descending=True).values
        tie = (srt[..., k - 1] - srt[..., k]).abs() <= MOE_TIE
        moved = (sets["card"][0] != sets["cpu"][0]).any(-1)    # (ng, g)
        if bool((moved & ~tie).any()):
            raise AssertionError(f"moe layer [{what}]: "
                                 f"{int((moved & ~tie).sum())} tokens route "
                                 f"to other experts on the card, no near tie")
        # A slot moves only after (in token order) a token whose experts
        # moved, in its group, and only at an expert that token touched.
        touched = (moved[..., None] & (sets["card"][0] | sets["cpu"][0]))
        after = torch.cumsum(touched.to(torch.int32), dim=1) > 0
        both = sets["card"][0] & sets["cpu"][0]
        keep_diff = both & (sets["card"][1] != sets["cpu"][1])
        slot_moved = keep_diff & after
        if bool((keep_diff & ~after).any()):
            raise AssertionError(f"moe layer [{what}]: "
                                 f"{int((keep_diff & ~after).sum())} "
                                 f"assignments drop on one side only, no "
                                 f"near tie before them")
        excused = (moved | slot_moved.any(-1)).reshape(-1)
        og = out_g.reshape(-1, cfg.d_model).cpu().to(torch.float32)
        oc = out_c.reshape(-1, cfg.d_model)
        if bool(excused.all()):
            raise AssertionError(f"moe layer [{what}]: every token excused")
        err = float((og - oc)[~excused].abs().max())
        scale = float(oc.abs().max())
        drops = int((~rg["keep"]).sum())
        print(f"moe layer [{what}]: x {tuple(x.shape)}, {ng} groups of {g}, "
              f"capacity {rc['cap']}; {drops} of {rg['keep'].numel()} "
              f"assignments drop on the card ({int((~rc['keep']).sum())} on "
              f"the CPU); near-tie tokens routed apart "
              f"{int(moved.sum())}, slots moved by them "
              f"{int(slot_moved.sum())}; max |out card - out CPU| {err:.3g} "
              f"of max {scale:.3g} (tol {REL_MOE:.3g} of it)")
        if not err <= REL_MOE * scale:
            raise AssertionError(f"moe layer [{what}]: outputs differ by "
                                 f"{err:.3g} > {REL_MOE:.3g} x {scale:.3g}")


def _family_dense(model) -> dict:
    """``serve --dense``'s loop on hfa-paper-mini (hfa_pallas): the
    bf16 forward at d 96 once a layer on the tensor cores and the dense
    decode every step of every layer.  Returns the dense launches."""
    cfg = model.cfg = dataclasses.replace(model.cfg, attn_impl="hfa_pallas")
    b, ell, steps, ring = FAMILY_DENSE
    batch = DataPipeline.for_config(cfg, ell, b).batch(0)
    args = argparse.Namespace(batch=b, prompt_len=ell, steps=steps,
                              max_seq=ring)
    _reset_dense_counters()
    res = serve_cli._serve_dense(model, cfg, batch, args)
    counts = _dense_counts()
    variants = dict(cuda_lib.dense_fwd_launches)
    need = {"dense_decode": cfg.n_layers * steps, "hfa_fwd": cfg.n_layers}
    if any(counts[n] != c for n, c in need.items()) or not res["finite"] \
            or variants != {"tc": cfg.n_layers, "simt": 0} \
            or res["tokens"].shape != (b, steps):
        raise AssertionError(f"families dense [{cfg.name}]: launches "
                             f"{counts} (need {need}), forward by kernel "
                             f"{variants}, finite {res['finite']}")
    print(f"families dense [{cfg.name} hfa_pallas]: prefill "
          f"{res['prefill_ms']:.1f} ms ({b}x{ell}), decode "
          f"{res['decode_ms']:.2f} ms/token, {res['tok_s']:.1f} tok/s, "
          f"launches { {n: c for n, c in counts.items() if c} }")
    return counts


def check_families() -> dict:
    """The families phase.  Returns the launches by row."""
    t0 = time.perf_counter()
    totals: dict = {}

    def add(counts):
        for n, c in counts.items():
            totals[n] = totals.get(n, 0) + c

    # The routes these shapes take: hfa-paper-mini's d 96 prefill on the
    # CUDA cores (not a tensor-core head dim), command-r-plus-104b's verify
    # of G K = 12 x 5 = 60 rows on the CUDA cores (> PAGED_V2_MAX_ROWS).
    if "paged_prefill_simt" not in family_routes(
            get_config("hfa-paper-mini"), 0) or "paged_verify_simt" not in \
            family_routes(get_config("command-r-plus-104b"), 4):
        raise AssertionError("families: the route rules changed")
    # Reference checks on small inputs: the reduced granite and the
    # reduced hfa-paper-mini at its own d_head 96 (f32, page 4).
    for arch, kw in (("granite-moe-1b-a400m", {}),
                     ("hfa-paper-mini", {"d_head": 96})):
        check_small_routes({rail: small_reference(get_config(arch), rail,
                                                  **kw)
                            for rail in SMALL_REF_TOLS},
                           f"families reference [{arch}]")
    for arch, runs in FAMILY_FULL.items():
        model = family_model(arch)
        captured: dict = {}
        orig = moe.moe_apply

        def grab(p, x, cfg, routing=None, _m=model):
            # Layer 0's input: the first decode batch (free slots among
            # its rows) and the last prefill chunk (a prompt's tail, its
            # rows padded to the page).
            if p is _m.layers[0].ffn:
                if x.shape[1] > 1:
                    captured["prefill chunk"] = x.detach().clone()
                else:
                    captured.setdefault("decode batch", x.detach().clone())
            return orig(p, x, cfg, routing)

        first = None
        for i, (rail, spec_k) in enumerate(runs):
            moe.moe_apply = grab if (i == 0 and model.cfg.family == "moe") \
                else orig
            try:
                streams, info = _family_run(model, rail, spec_k, "full")
            finally:
                moe.moe_apply = orig
            add(info["launches"])
            if i == 0:
                first = streams
        if model.cfg.family == "moe":
            rail, spec_k = runs[0]
            again, info = _family_run(model, rail, spec_k, "full")
            add(info["launches"])
            print(f"families [{arch} {rail} spec_k={spec_k}] repeated: "
                  f"{_agreement(again, first)}")
            if again != first:
                raise AssertionError(f"families [{arch}]: a repeated run "
                                     f"differs: {_agreement(again, first)}")
            check_moe_layer(model, captured)
        else:
            _simt_share(model, "hfa", 0, "full")
            add(_family_dense(model))
        del model, captured
        gc.collect()
        torch.cuda.empty_cache()
    for arch in FAMILY_CUT:
        model = family_model(arch, FAMILY_CUT_LAYERS)
        for spec_k in (0, 4):
            _, info = _family_run(model, "fa2", spec_k, "cut")
            add(info["launches"])
        if arch == "command-r-plus-104b":
            _simt_share(model, "fa2", 4, "cut")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    print("families: " + card_line())
    print(f"families: launches of the phase by row "
          f"{({n: c for n, c in totals.items() if c})}")
    print(f"families: phase wall {time.perf_counter() - t0:.1f} s")
    return totals


# ------------------------------------------------------------- phase 5
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX_SEQ = 8, 512, 64, 640
SERVE_IMPLS = {"fa2": "fa2_fwd", "hfa_pallas": "hfa_fwd",
               "hfa_datapath": "hfa_datapath"}


def check_dense_serve() -> dict:
    """Full-width qwen3-1.7b through ``serve --dense``'s loop on each
    impl: the prefill kernel must launch once per layer and the dense
    decode kernel once per layer per step.  Returns the launches."""
    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    model = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    batch = DataPipeline.for_config(cfg, SERVE_PROMPT, SERVE_BATCH).batch(0)
    args = argparse.Namespace(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                              steps=SERVE_STEPS, max_seq=SERVE_MAX_SEQ)
    torch.cuda.synchronize()
    print(f"dense_serve: qwen3-1.7b full width, {cfg.n_layers} layers, init "
          f"{time.perf_counter() - t0:.1f} s; ring {cfg.n_layers} x 2 x "
          f"{SERVE_BATCH} x {SERVE_MAX_SEQ} x {cfg.n_kv_heads} x "
          f"{cfg.d_head} bf16 = "
          f"{cfg.n_layers * 2 * SERVE_BATCH * SERVE_MAX_SEQ * cfg.n_kv_heads * cfg.d_head * 2 / 1e9:.2f} GB")
    # One short untimed pass first, so that no timed run pays the card's
    # first-use costs (library handles, lazy module loads).
    warm = model.init_cache(1, 32)
    toks = torch.as_tensor(batch["tokens"][:1, :16], device="cuda")
    _, warm = model.prefill(warm, toks)
    model.decode_step(warm, toks[:, :1])
    del warm
    totals = {n: 0 for n in DENSE_COUNTERS}
    runs = {}
    for impl, prefill_kernel in SERVE_IMPLS.items():
        model.cfg = dataclasses.replace(cfg, attn_impl=impl)
        _reset_dense_counters()
        res = serve_cli._serve_dense(model, model.cfg, batch, args)
        counts = _dense_counts()
        variants = dict(cuda_lib.dense_fwd_launches)
        runs[impl] = res["tokens"]
        need = {"dense_decode": cfg.n_layers * SERVE_STEPS,
                prefill_kernel: cfg.n_layers}
        # Every bf16 prefill forward on the tensor-core kernel, none on
        # the CUDA-core one.
        need_variants = {"tc": cfg.n_layers if prefill_kernel in
                         ("fa2_fwd", "hfa_fwd") else 0, "simt": 0}
        if any(counts[n] != c for n, c in need.items()) or not res["finite"] \
                or any(variants[n] != c for n, c in need_variants.items()) \
                or res["tokens"].shape != (SERVE_BATCH, SERVE_STEPS):
            raise AssertionError(f"dense_serve [{impl}]: launches {counts} "
                                 f"(need {need}), forward by kernel "
                                 f"{variants} (need {need_variants}), finite "
                                 f"{res['finite']}, tokens "
                                 f"{res['tokens'].shape}")
        for n, c in counts.items():
            totals[n] += c
        agree = int((res["tokens"] == runs["fa2"]).sum())
        print(f"dense_serve [{impl}]: prefill {res['prefill_ms']:.1f} ms "
              f"({SERVE_BATCH}x{SERVE_PROMPT}), decode "
              f"{res['decode_ms']:.2f} ms/token, {res['tok_s']:.1f} tok/s, "
              f"launches { {n: c for n, c in counts.items() if c} }, "
              f"forward by kernel {variants}, "
              f"tokens agreeing with the fa2 run {agree}/{res['tokens'].size}")
    model.cfg = cfg
    del model
    torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------- phase 6
TRAIN_BATCH, TRAIN_SEQ = 4, 2048


def _reset_dense_counters() -> None:
    for obj, key in DENSE_COUNTERS.values():
        if isinstance(obj, dict):
            obj[key] = 0
        else:
            setattr(obj, key, 0)
    for variant in cuda_lib.dense_fwd_launches:
        cuda_lib.dense_fwd_launches[variant] = 0


def _dense_counts() -> dict:
    return {n: obj[key] if isinstance(obj, dict) else getattr(obj, key)
            for n, (obj, key) in DENSE_COUNTERS.items()}


def _train_setup(rail: str, n_batches: int):
    """Full-width qwen3-1.7b on one rail with random bf16 weights from
    seed 0: (cfg, carry, step_fn, batches of TRAIN_BATCH x TRAIN_SEQ
    tokens from ``DataPipeline`` on the card)."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), attn_impl=rail)
    model = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    opt = build_optimizer(cfg, warmup_cosine(3e-4, 2, 10))
    params = dict(model.named_parameters())
    carry = {"params": params, "opt_state": opt.init(params)}
    pipe = DataPipeline.for_config(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{"tokens": torch.from_numpy(pipe.batch(i)["tokens"]).cuda()}
               for i in range(n_batches)]
    return cfg, carry, make_train_step(model, opt), batches


def run_train(rail: str, warm: int = 2, timed_steps: int = 3) -> dict:
    """Full-width qwen3-1.7b training steps on one rail; returns the
    launch counts of the timed steps."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, carry, step_fn, batches = _train_setup(rail, warm + timed_steps)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in carry["params"].values())
    print(f"train [{rail}]: qwen3-1.7b full width, {cfg.n_layers} layers, "
          f"{n_params} parameters ({cfg.param_dtype}, f32 AdamW state), "
          f"init {time.perf_counter() - t0:.1f} s")
    losses, times = [], []
    for i, batch in enumerate(batches):
        if i == warm:
            _reset_dense_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, met = step_fn(carry, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"train [{rail}] step {i}: loss {loss}, "
                                 f"grad norm {gnorm}")
        losses.append(loss)
        if i >= warm:
            times.append(dt)
    counts = _dense_counts()
    variants = dict(cuda_lib.dense_fwd_launches)
    peak = torch.cuda.max_memory_allocated()
    need = RAIL_KERNELS[rail]
    # The forward runs twice per layer and step (forward and remat), every
    # time on the tensor-core kernel; on fa2 the backward once per layer
    # and step, on the tensor-core dq and dk/dv, none on the CUDA cores.
    fwd_need = 2 * cfg.n_layers * timed_steps
    bwd_need = cfg.n_layers * timed_steps if "fa2_bwd_dq" in need else 0
    bwd = {n: counts[n] for n in ("fa2_bwd_dq", "fa2_bwd_dkv",
                                  "fa2_bwd_dq_simt", "fa2_bwd_dkv_simt")}
    if any(counts[n] <= 0 for n in need) or counts[need[0]] != fwd_need \
            or variants["tc"] != fwd_need or variants["simt"] != 0 \
            or bwd != {"fa2_bwd_dq": bwd_need, "fa2_bwd_dkv": bwd_need,
                       "fa2_bwd_dq_simt": 0, "fa2_bwd_dkv_simt": 0}:
        raise AssertionError(f"train [{rail}]: launches {counts}, forward by "
                             f"kernel {variants} (need {fwd_need} "
                             f"{need[0]}, all tensor-core; {bwd_need} dq "
                             f"and dk/dv, all tensor-core)")
    step_s = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"train [{rail}]: batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, step "
          f"times {['%.4f' % t for t in times]} s, median {step_s:.4f} s, "
          f"{tokens / step_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB, losses {['%.4f' % x for x in losses]}, "
          f"grad norm {gnorm:.4f}, launches over {timed_steps} steps "
          f"{counts} ({ {n: counts[n] / timed_steps for n in need} } "
          f"per step), forward by kernel {variants}, backward by kernel "
          f"dq {dict(cuda_lib.dense_dq_launches)} dk/dv "
          f"{dict(cuda_lib.dense_dkv_launches)}")
    del carry, step_fn, batches
    torch.cuda.empty_cache()
    return counts


def check_trainer_restart() -> None:
    """Reduced qwen3-1.7b through ``Trainer.run`` on the card: an injected
    failure at step 6 restarts from the step-4 checkpoint and replays."""
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = get_config("qwen3-1.7b").reduced()
    tcfg = TrainerConfig(steps=10, ckpt_every=4, ckpt_dir=str(ckpt),
                         seq_len=128, global_batch=4, warmup=2)
    tr = Trainer(LM(cfg, device="cuda"), tcfg)
    res = tr.run(fail_at={6: RuntimeError("injected node failure")})
    by_step: dict = {}
    for m in res["metrics"]:
        by_step.setdefault(m["step"], []).append(m["loss"])
    replay = {s: v for s, v in by_step.items() if len(v) > 1}
    ok = (res["final_step"] == 10 and res["restarts"] == 1
          and any("restarted from step 4" in e for e in res["events"])
          and sorted(replay) == [4, 5]
          and all(abs(v[0] - v[1]) <= 1e-4 * abs(v[0])
                  for v in replay.values()))
    if not ok:
        raise AssertionError(f"trainer restart: {res['events']}, replayed "
                             f"{replay}")
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"trainer: reduced qwen3-1.7b on the card, injected failure at "
          f"step 6 -> {res['events'][-1]}, replayed losses {replay}, final "
          f"loss {res['metrics'][-1]['loss']:.4f}")


def check_train() -> dict:
    totals = {n: 0 for n in DENSE_COUNTERS}
    for rail in RAIL_KERNELS:
        for n, c in run_train(rail).items():
            totals[n] += c
    # The reduced f32 model's backward: on the CUDA-core kernels only.
    _reset_dense_counters()
    check_trainer_restart()
    restart = _dense_counts()
    simt = ("fa2_bwd_dq_simt", "fa2_bwd_dkv_simt")
    if any(restart[n] <= 0 for n in simt) or restart["fa2_bwd_dq"] \
            or restart["fa2_bwd_dkv"]:
        raise AssertionError(f"trainer: the reduced f32 model's launches "
                             f"{restart}: its backward must run on the "
                             "CUDA-core kernels alone")
    print(f"trainer: backward launches of the reduced f32 model "
          f"{ {n: restart[n] for n in simt} } (CUDA cores), 0 on the "
          "tensor cores")
    for n in simt:
        totals[n] += restart[n]
    return totals


def profile_engine(steps: int = 10, warm: int = 30) -> None:
    """Opt-in phase (``python3 chip_smoke.py profile``): torch.profiler
    over ``steps`` engine steps of the fa2 spec_k=0 run after ``warm``
    steps - device time by kernel, the device's busy share of the wall
    window, and the host-side calls that wait on the card."""
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), attn_impl="fa2")
    model = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    eng = stack_engine(model)
    reqs = workload(cfg.vocab_size)
    for i in range(warm):
        if i < len(reqs):
            eng.submit(reqs[i])
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_profile(prof, wall, steps, "engine fa2 spec_k=0")


def decode_variants() -> None:
    """Opt-in phase (``python3 chip_smoke.py decode_variants``): the
    device time (median of three profiler windows) of the v2 paged verify
    at the kernels-phase shape for several grids - runs of the walk
    (FA-2) and blocks of the rows - and of the dense decode at the
    dense-serve shape for several runs, the verify's held against its
    unsplit walk; the rules in ``kernels/cuda_lib.py`` (``verify_splits``,
    ``verify_row_blocks``, ``dense_decode_splits``) were chosen from
    these times."""

    def dev(fn, key):
        return statistics.median(device_ms(fn, key) for _ in range(3))
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = kernel_cases(gen)["paged_verify"][0]
    g = args[0].shape[2]
    grids = {"fa2": [(1, 1), (3, 1), (5, 1), (8, 1), (9, 1), (16, 1),
                     (8, g)],
             "hfa": [(1, 1), (1, g), (1, 5), (1, 10)]}
    for rail, cells in grids.items():
        use_hfa = rail == "hfa"
        want = _verify_v2(*args, splits=1, row_blocks=1, use_hfa=use_hfa)
        times = []
        for splits, rb in cells:
            def call(splits=splits, rb=rb):
                return _verify_v2(*args, splits=splits, row_blocks=rb,
                                  use_hfa=use_hfa)
            got = call()
            err = float((decode_k.finalize_decode(got[0], got[2],
                                                  use_hfa=use_hfa) -
                         decode_k.finalize_decode(want[0], want[2],
                                                  use_hfa=use_hfa))
                        .abs().max())
            times.append(f"{splits}x{rb}: "
                         f"{dev(call, 'paged_decode_v2_kernel'):.4f} "
                         f"(err {err:.2g})")
        print(f"variants paged_verify [{rail}] (runs x row blocks: device "
              f"ms): " + ", ".join(times))
    b, hkv, g, s_len, kvl, d = DEC_B, DEC_HKV, DEC_G, DEC_S, DEC_KV, DEC_D
    q = torch.randn((b, hkv, g, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    ring = [torch.randn((b, s_len, hkv, d), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2) for _ in range(2)]
    for rail, cells in (("fa2", (1, 2, 3, 5)), ("hfa", (1,))):
        use_hfa = rail == "hfa"
        times = []
        for splits in cells:
            def call(splits=splits):
                return cuda_lib.launch_dense_decode(
                    q, *ring, scale=d ** -0.5, kv_len=kvl, use_hfa=use_hfa,
                    splits=splits)
            times.append(f"{splits}: "
                         f"{dev(call, 'dense_decode_v2_kernel'):.4f}")
        print(f"variants dense_decode [{rail}] (runs: device ms): "
              + ", ".join(times))


# Kernel-name substrings of the port's dense attention kernels in a trace.
ATTENTION_KERNELS = {"forward (tensor cores)": "dense_fwd_tc_kernel",
                     "forward (CUDA cores)": "dense_fwd_kernel",
                     "dq (tensor cores)": "dense_dq_tc_kernel",
                     "dk/dv (tensor cores)": "dense_dkv_tc_kernel",
                     "dq (CUDA cores)": "dense_dq_kernel",
                     "dk/dv (CUDA cores)": "dense_dkv_kernel"}


def _report_profile(prof, wall: float, steps: int, label: str) -> None:
    """From a torch.profiler window: the device's busy share of the wall
    window (the sum of kernel times), the dense attention kernels' share,
    the top kernels, the top ops by the device time of the kernels they
    launched, and the host calls."""
    from torch.autograd import DeviceType
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
    ops = [e for e in ev if e.device_type != DeviceType.CUDA
           and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    print(f"profile [{label}]: {steps} steps, wall {wall * 1e3:.1f} ms "
          f"({wall / steps * 1e3:.2f} ms/step), device busy {busy * 1e3:.1f} "
          f"ms = {busy / wall:.1%} of wall ({len(kernels)} kernel names, "
          f"{sum(e.count for e in kernels)} launches)")
    attn = {}
    for part, key in ATTENTION_KERNELS.items():
        us = sum(dev_us(e) for e in kernels if key in e.key)
        n = sum(e.count for e in kernels if key in e.key)
        if n:
            attn[part] = (us / 1e3, n)
    if attn:
        total = sum(ms for ms, _ in attn.values()) / 1e3
        print(f"profile [{label}]: attention kernels {total * 1e3:.1f} ms = "
              f"{total / busy:.1%} of device time, {total / wall:.1%} of wall: "
              + ", ".join(f"{part} {ms:.1f} ms / {n} launches"
                          for part, (ms, n) in attn.items()))
    for kind, events in (("kernel", kernels), ("op", ops)):
        for e in sorted(events, key=dev_us, reverse=True)[:12]:
            print(f"profile device {kind}: {dev_us(e) / 1e3:9.3f} ms "
                  f"{e.count:6d}x {e.key[:90]}")
    for e in sorted(ev, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        print(f"profile host: {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x {e.key[:90]}")


def profile_dense(steps: int = 8) -> None:
    """Opt-in phase (``python3 chip_smoke.py profile_dense``):
    torch.profiler over ``steps`` full-width dense decode steps (fa2,
    B 8, after the 512-token prefill and 2 warm steps)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("qwen3-1.7b")
    model = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    batch = DataPipeline.for_config(cfg, SERVE_PROMPT, SERVE_BATCH).batch(0)
    cache = model.init_cache(SERVE_BATCH, SERVE_MAX_SEQ)
    logits, cache = model.prefill(cache, torch.as_tensor(batch["tokens"],
                                                         device="cuda"))
    for _ in range(2):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        logits, cache = model.decode_step(cache, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, cache = model.decode_step(cache, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_profile(prof, wall, steps, "dense decode fa2 B 8")
    del model, cache
    torch.cuda.empty_cache()


def profile_train() -> None:
    """Opt-in phase (``python3 chip_smoke.py profile_train``):
    torch.profiler over one full-width training step of each rail (batch
    4 x seq 2048) after one warm step."""
    from torch.profiler import ProfilerActivity, profile
    for rail in RAIL_KERNELS:
        _, carry, step_fn, batches = _train_setup(rail, 2)
        carry, _ = step_fn(carry, batches[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            carry, met = step_fn(carry, batches[1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report_profile(prof, wall, 1, f"train {rail}")
        del carry, step_fn, batches, prof
        torch.cuda.empty_cache()


# ------------------------------------------------------ the LNS ablations
# Table III's configurations through core.hfa at the paper's d 64: two
# rows of 32 queries over 96 keys, q and k on a dyadic grid (multiples of
# 1/4 in [-1, 1]: every score exact in f32 on both devices, so the bf16
# scores agree), v random bf16.
ABLATION_CFGS = (lns.DEFAULT, lns.EXACT, lns.LNSConfig(exact_quant=True),
                 lns.LNSConfig(exact_mitchell=True),
                 lns.LNSConfig(exact_pwl=True))
ABLATION_SHAPE = (2, 32, 96, 64)                  # (BH, Lq, Lkv, d)
RAIL_STEP = 2.0 ** (1 / 128) - 1


def check_lns_ablations() -> None:
    """Every ``LNSConfig`` through ``core.hfa.hfa_attention`` (causal) and
    ``hfa_blockparallel`` (4 blocks) on the card against the CPU: the
    bf16 outputs' differing bits are counted; none may differ, except
    under exact_mitchell, where an ulp of the transcendental may move a
    rail value: such an output is held to one rail step and reported."""
    from repro_torch.core import hfa as core_hfa
    bh, lq, lkv, d = ABLATION_SHAPE
    gen = torch.Generator().manual_seed(11)
    q = torch.randint(-4, 5, (bh, lq, d), generator=gen).float() / 4
    k = torch.randint(-4, 5, (bh, lkv, d), generator=gen).float() / 4
    v = torch.randn((bh, lkv, d), generator=gen).to(torch.bfloat16)
    lines = []
    for cfg in ABLATION_CFGS:
        for name, fn in (("hfa_attention", functools.partial(
                core_hfa.hfa_attention, causal=True)),
                         ("hfa_blockparallel", functools.partial(
                             core_hfa.hfa_blockparallel, num_blocks=4,
                             causal=True))):
            t0 = time.perf_counter()
            got = fn(q.cuda(), k.cuda(), v.cuda(), cfg=cfg).cpu()
            card_s = time.perf_counter() - t0
            want = fn(q, k, v, cfg=cfg)
            diff = got.view(torch.int16) != want.view(torch.int16)
            n = int(diff.sum())
            g, w = got.float(), want.float()
            far = (g - w).abs() > RAIL_STEP * torch.maximum(g.abs(),
                                                            w.abs()) * 1.0001
            if n and (not cfg.exact_mitchell or bool(far.any())):
                raise AssertionError(f"lns ablation {cfg.tag} {name}: {n} "
                                     f"outputs differ card vs CPU, "
                                     f"{int(far.sum())} by more than a "
                                     f"rail step")
            lines.append(f"{cfg.tag} {name}: {n}/{diff.numel()} outputs "
                         f"differ" + (" (each within one rail step: an ulp "
                                      "of log2 moved a rail value)" if n
                                      else "") + f", card {card_s:.2f} s")
    print(f"lns ablations (core.hfa, BH {bh}, Lq {lq}, Lkv {lkv}, d {d}, "
          f"causal, card vs CPU): " + "; ".join(lines))


# ------------------------------------------------------------- adafactor
# command-r-plus-104b at full width cut to 2 of 64 layers, bf16, impl fa2,
# Adafactor, microbatches 1 (a second microbatch adds f32 gradient sums,
# 4 bytes a parameter: 37.8 GB here, more than the card holds beside the
# 18.9 GB of parameters and their bf16 gradients).
ADAFACTOR_LAYERS = 2
ADAFACTOR_BATCH, ADAFACTOR_SEQ, ADAFACTOR_STEPS = 2, 1024, 3
# The leaves one chunked update on the card is held on against the
# unchunked plain update on the CPU: the embedding's first
# ADAFACTOR_EMB_ROWS rows as a leaf of their own (5.5 chunks of 2^26
# values: the chunk boundaries of the whole 3.15e9-value leaf, at a tenth
# of its host time and memory), a stacked 3-D projection, the stacked 1-D
# norm scales (factored across the layers) and the unfactored final norm.
ADAFACTOR_LEAVES = ("embed.emb", "layers.0.mixer.wq", "layers.1.mixer.wq",
                    "layers.0.norm1.scale", "layers.1.norm1.scale",
                    "final_norm.scale")
ADAFACTOR_EMB_ROWS = 30000
# The two updates' sums run in other orders (chunks, devices): moments
# within 1e-5 of each leaf's scale, and the new bf16 parameters equal or
# one bf16 rounding apart (adjacent bf16 values).
ADAFACTOR_REL = 1e-5


def _adafactor_model():
    cfg = dataclasses.replace(get_config("command-r-plus-104b"),
                              n_layers=ADAFACTOR_LAYERS, microbatches=1)
    assert cfg.attn_impl == "fa2" and cfg.optimizer == "adafactor"
    return cfg, LM(cfg, device="cuda")


def _bf16_order(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in their order (adjacent values one
    apart; -0 and +0 both 0)."""
    b = t.view(torch.int16).to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


def check_adafactor_update(model, batch, card) -> None:
    """One Adafactor update of ADAFACTOR_LEAVES on the card (chunked)
    against the unchunked plain update on the CPU, from the same bf16
    parameters and gradients (the embedding cut to its first
    ADAFACTOR_EMB_ROWS rows)."""
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss(batch)
    loss.backward()
    cut = {n: slice(ADAFACTOR_EMB_ROWS) if n == "embed.emb" else slice(None)
           for n in ADAFACTOR_LEAVES}
    params = {n: p.detach()[cut[n]] for n, p in model.named_parameters()
              if n in ADAFACTOR_LEAVES}
    grads = {n: p.grad[cut[n]] for n, p in model.named_parameters()
             if n in ADAFACTOR_LEAVES}
    cpu_p = {n: t.cpu() for n, t in params.items()}
    cpu_g = {n: t.cpu() for n, t in grads.items()}
    grads = {n: t.clone() for n, t in grads.items()}
    emb_rows = int((grads["embed.emb"] != 0).any(-1).sum())
    for p in model.parameters():
        p.grad = None
    plain = dataclasses.replace(card, chunk_elems=None)
    card_p = {n: t.clone() for n, t in params.items()}
    st = card.init(card_p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.update(grads, st, card_p)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pst = plain.init(cpu_p)
    plain.update(cpu_g, pst, cpu_p)
    cpu_s = time.perf_counter() - t0
    worst = {}
    for ref, leaf_st in pst["f"].items():
        for key, want in leaf_st.items():
            got = st["f"][ref][key].cpu()
            err = float((got - want).abs().max() / want.abs().max())
            worst[f"{ref}.{key}"] = err
            if err > ADAFACTOR_REL:
                raise AssertionError(f"adafactor: {ref}.{key} card vs CPU "
                                     f"{err:.3g} of its scale")
    flips = {}
    for n, want in cpu_p.items():
        dist = (_bf16_order(card_p[n].cpu()) - _bf16_order(want)).abs()
        far = dist > 1
        flips[n] = int((dist > 0).sum())
        if bool(far.any()):
            raise AssertionError(f"adafactor: {n} card vs CPU more than one "
                                 f"bf16 rounding apart at {int(far.sum())} "
                                 f"values")
    print(f"adafactor: one update of {len(ADAFACTOR_LEAVES)} leaves (the "
          f"embedding's first {ADAFACTOR_EMB_ROWS} rows, {emb_rows} of "
          f"them with a gradient), card "
          f"chunked ({card.chunk_elems} values a chunk) {card_s:.3f} s vs "
          f"CPU unchunked {cpu_s:.1f} s: moments within "
          f"{max(worst.values()):.3g} of their scale (worst "
          f"{max(worst, key=worst.get)}), new bf16 parameters differing "
          f"by one rounding at {flips} values, none further")


def check_adafactor() -> dict:
    """``Trainer`` on command-r-plus-104b (full width, 2 layers, bf16,
    fa2, Adafactor, microbatches 1): 3 steps, the loss finite, the
    matrices moved (the bf16 norm scales of 1 may not: no f32 master
    copy, as in the reference), every dense forward, dq and dk/dv on the
    tensor-core kernels; then one chunked update against the plain one.
    Returns the launches of the Trainer's steps."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model = _adafactor_model()
    tcfg = TrainerConfig(steps=ADAFACTOR_STEPS, ckpt_every=0,
                         ckpt_dir=str(ROOT / "build" / "chip_smoke_none"),
                         seq_len=ADAFACTOR_SEQ, global_batch=ADAFACTOR_BATCH,
                         warmup=1, async_ckpt=False)
    tr = Trainer(model, tcfg)
    assert isinstance(tr.opt, Adafactor)
    # The Trainer draws the same weights again from its seed: keep a few
    # rows to see them move (the embedding's: rows of the first batch's
    # tokens, the only ones a gradient reaches).
    model.init(torch.Generator(device="cuda").manual_seed(tcfg.seed))
    rows = {n: torch.arange(64, device="cuda") for n in ADAFACTOR_LEAVES}
    rows["embed.emb"] = torch.unique(torch.from_numpy(
        tr.pipeline.batch(0)["tokens"][0, :64]).cuda().long())
    before = {n: p.detach()[rows[n][rows[n] < p.shape[0]]].clone()
              for n, p in model.named_parameters() if n in ADAFACTOR_LEAVES}
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    print(f"adafactor: command-r-plus-104b full width, {cfg.n_layers} of 64 "
          f"layers, {n_params} parameters (bf16), batch {ADAFACTOR_BATCH} x "
          f"seq {ADAFACTOR_SEQ}, microbatches 1, init "
          f"{time.perf_counter() - t0:.1f} s")
    _reset_dense_counters()
    res = tr.run()
    counts = _dense_counts()
    variants = dict(cuda_lib.dense_fwd_launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in res["metrics"]]
    walls = [m["step_time"] for m in res["metrics"]]
    moved = {n: float((p.detach()[rows[n][rows[n] < p.shape[0]]].float()
                       - before[n].float()).abs().max())
             for n, p in model.named_parameters() if n in before}
    fwd_need = 2 * cfg.n_layers * ADAFACTOR_STEPS
    bwd_need = cfg.n_layers * ADAFACTOR_STEPS
    want = {"fa2_fwd": fwd_need, "fa2_bwd_dq": bwd_need,
            "fa2_bwd_dkv": bwd_need, "fa2_bwd_dq_simt": 0,
            "fa2_bwd_dkv_simt": 0}
    if res["final_step"] != ADAFACTOR_STEPS or not np.isfinite(losses).all() \
            or any(counts[n] != c for n, c in want.items()) \
            or variants != {"tc": fwd_need, "simt": 0} \
            or not all(moved[n] > 0 for n in moved if before[n].dim() > 1):
        raise AssertionError(f"adafactor: {res['final_step']} steps, losses "
                             f"{losses}, launches {counts} (need {want}), "
                             f"forward by kernel {variants}, moved {moved}")
    print(f"adafactor: {ADAFACTOR_STEPS} Trainer steps, walls "
          f"{['%.4f' % t for t in walls]} s, losses "
          f"{['%.4f' % x for x in losses]}, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {counts} (forward by kernel "
          f"{variants}), largest move of the watched rows "
          f"{ {n: '%.3g' % v for n, v in moved.items()} } (a bf16 norm scale "
          f"of 1 stays: lr x its RMS x |u| ~ 3e-4 is under half an ulp)")
    batch = {"tokens": torch.from_numpy(tr.pipeline.batch(ADAFACTOR_STEPS)
                                        ["tokens"]).cuda()}
    check_adafactor_update(model, batch, tr.opt)
    del tr, model, res
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------------- ssm
SSM_SERVE = (8, 128, 16)              # serve --dense: prompts, length, steps
SSM_CUT_LAYERS = 2                    # the f32 card-vs-CPU model
SSM_CUT_PROMPT, SSM_CUT_STEPS = (2, 128), 8
SSM_TRAIN_LAYERS, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 4, 4, 512
# f32 on both devices, matmul orders apart: logits within 1e-4 of their
# scale; the chunked scan against the token-by-token recurrence within
# 1e-4 of the output's and the state's scale (tests/test_mamba_moe.py
# holds the reference's own to 2e-4 absolute).
SSM_REL = 1e-4


def _ssm_model(layers=None, dtype=None, device="cuda") -> LM:
    cfg = get_config("mamba2-2.7b")
    kw = {} if layers is None else {"n_layers": layers}
    if dtype:
        kw.update(param_dtype=dtype, compute_dtype=dtype)
    cfg = dataclasses.replace(cfg, **kw)
    return LM(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0))


def _rel(got, want) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / want.float().abs().max())


def check_ssm() -> dict:
    """mamba2-2.7b on the card: ``serve --dense`` at all 64 layers, a
    2-layer f32 cut card against CPU, the chunked scan against the
    recurrence, 3 AdamW Trainer steps at 4 layers.  No attention kernel
    may launch.  Returns the (zero) launches."""
    _reset_dense_counters()
    _reset_paged_counters()
    nb, plen, steps = SSM_SERVE
    t0 = time.perf_counter()
    model = _ssm_model()
    cfg = model.cfg
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"ssm: mamba2-2.7b full width, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.d_inner // cfg.m_headdim}"
          f" heads of {cfg.m_headdim}, d_state {cfg.m_dstate}, "
          f"{nbytes} parameter bytes, init {time.perf_counter() - t0:.1f} s")
    assert not serve_cli._paged_supported(cfg)
    batch = DataPipeline.for_config(cfg, plen, nb).batch(0)
    args = argparse.Namespace(batch=nb, prompt_len=plen, steps=steps,
                              max_seq=plen + steps)
    # One short untimed pass first (the card's first-use costs).
    warm = model.init_cache(1, 18)
    toks = torch.as_tensor(batch["tokens"][:1, :16], device="cuda")
    _, warm = model.prefill(warm, toks)
    model.decode_step(warm, toks[:, :1])
    del warm
    res = serve_cli._serve_dense(model, cfg, batch, args)
    if not res["finite"] or res["tokens"].shape != (nb, steps):
        raise AssertionError(f"ssm serve: finite {res['finite']}, tokens "
                             f"{res['tokens'].shape}")
    print(f"ssm serve --dense: {nb} x {plen} prompts, {steps} steps, "
          f"{cfg.n_layers} layers: prefill {res['prefill_ms']:.1f} ms, decode "
          f"{res['decode_ms']:.2f} ms/token, {res['tok_s']:.1f} tok/s")
    del model
    torch.cuda.empty_cache()

    # The 2-layer f32 cut at full width, the same weights on both devices.
    cpu = _ssm_model(SSM_CUT_LAYERS, "float32", device="cpu")
    card = LM(cpu.cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(DataPipeline.for_config(
        cpu.cfg, SSM_CUT_PROMPT[1], SSM_CUT_PROMPT[0]).batch(1)["tokens"])
    runs = {}
    for name, m in (("card", card), ("cpu", cpu)):
        cache = m.init_cache(SSM_CUT_PROMPT[0], 0)
        logits, cache = m.prefill(cache, toks.to(m.device))
        out, tok = [logits], torch.argmax(logits[:, -1], -1)[:, None]
        picks = [tok]
        for _ in range(SSM_CUT_STEPS):
            logits, cache = m.decode_step(cache, tok)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            out.append(logits)
            picks.append(tok)
        runs[name] = (torch.cat([o.cpu() for o in out], 1),
                      torch.cat([t.cpu() for t in picks], 1),
                      cache["layers"]["l0"]["ssm"].cpu())
    lerr = _rel(runs["card"][0], runs["cpu"][0])
    serr = _rel(runs["card"][2], runs["cpu"][2])
    same = bool(torch.equal(runs["card"][1], runs["cpu"][1]))
    if lerr > SSM_REL or serr > SSM_REL or not same:
        raise AssertionError(f"ssm card vs CPU: logits {lerr:.3g}, state "
                             f"{serr:.3g} of their scale, greedy tokens "
                             f"equal {same}")
    print(f"ssm card vs CPU (f32, {SSM_CUT_LAYERS} layers, full width, "
          f"{SSM_CUT_PROMPT[0]} x {SSM_CUT_PROMPT[1]} prefill + "
          f"{SSM_CUT_STEPS} decode steps): logits within {lerr:.3g}, the "
          f"SSM state within {serr:.3g} of their scale, greedy tokens equal "
          f"({runs['card'][1].numel()})")

    # The chunked scan's final state against the recurrence (layer 0).
    mixer = card.layers[0].mixer
    x = torch.randn((2, 256, card.cfg.d_model), generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda")
    with torch.no_grad():
        y_chunk, st_chunk = mamba2.mamba_apply(mixer, x, card.cfg)
        state = mamba2.mamba_init_state(card.cfg, 2, torch.float32, "cuda")
        ys = []
        for t in range(x.shape[1]):
            y, state = mamba2.mamba_apply(mixer, x[:, t:t + 1], card.cfg,
                                          state=state)
            ys.append(y)
    yerr = _rel(torch.cat(ys, 1), y_chunk)
    herr = _rel(state["ssm"], st_chunk["ssm"])
    if yerr > SSM_REL or herr > SSM_REL:
        raise AssertionError(f"ssm chunked vs recurrent: y {yerr:.3g}, state "
                             f"{herr:.3g} of their scale")
    print(f"ssm chunked scan (chunk {card.cfg.m_chunk}, 256 tokens) vs the "
          f"token-by-token recurrence on the card: outputs within "
          f"{yerr:.3g}, final SSM state within {herr:.3g} of their scale")
    del cpu, card
    torch.cuda.empty_cache()

    # 3 AdamW Trainer steps at 4 layers.
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("mamba2-2.7b"),
                              n_layers=SSM_TRAIN_LAYERS)
    tr = Trainer(LM(cfg, device="cuda"), TrainerConfig(
        steps=3, ckpt_every=0, ckpt_dir=str(ROOT / "build" / "chip_smoke_none"),
        seq_len=SSM_TRAIN_SEQ, global_batch=SSM_TRAIN_BATCH, warmup=1,
        async_ckpt=False))
    res = tr.run()
    losses = [m["loss"] for m in res["metrics"]]
    if res["final_step"] != 3 or not np.isfinite(losses).all() \
            or not isinstance(tr.opt, AdamW):
        raise AssertionError(f"ssm train: {res['final_step']} steps, losses "
                             f"{losses}, optimizer {type(tr.opt).__name__}")
    print(f"ssm train: {SSM_TRAIN_LAYERS} of 64 layers, batch "
          f"{SSM_TRAIN_BATCH} x seq {SSM_TRAIN_SEQ}, AdamW, walls "
          f"{['%.4f' % m['step_time'] for m in res['metrics']]} s, losses "
          f"{['%.4f' % x for x in losses]}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del tr
    torch.cuda.empty_cache()
    counts = _dense_counts()
    paged = _paged_counts()
    if any(counts.values()) or any(paged.values()):
        raise AssertionError(f"ssm: attention kernels launched: {counts}, "
                             f"{paged}")
    print("ssm: no attention kernel launched (mamba2 has no attention)")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    phases = sys.argv[1:] or ["kernels", "pools", "reference", "engine",
                              "engine_codecs", "engine_sampled",
                              "serving_stack", "tp", "families",
                              "dense_serve", "train", "adafactor", "ssm"]
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_lib.build(force=True)
    cuda_lib.library()
    print(f"build: nvcc sm_90a {time.perf_counter() - t0:.1f} s (each "
          f"source's nvcc ended at, s: {cuda_lib.build_seconds})")
    # Each kernel's registers and spills under its (mangled) name, and
    # every ptxas warning (C7513 / C7512: wgmma serialized).
    name = ""
    for line in cuda_lib.build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            print("ptxas:", name, line.strip())
        elif "warning" in line.lower() or "C75" in line:
            print("ptxas warning:", name, line.strip())
    rows = []
    if "kernels" in phases:
        check_rail()
        check_lns()
        check_lns_ablations()
        rows = check_kernels() + check_dense_kernels() + [
            check_decode_kernel(), check_datapath_kernel()]
        check_head_dims()
        print(f"phase kernels done at {time.perf_counter() - t0:.1f} s")
    if "pools" in phases:
        check_pools()
    if "reference" in phases:
        check_small_routes(check_small_reference(), "reference")
        _reset_dense_counters()
        check_ring_reference()
        check_train_reference()
        variants = dict(cuda_lib.dense_fwd_launches)
        bwd = {"dq": dict(cuda_lib.dense_dq_launches),
               "dk/dv": dict(cuda_lib.dense_dkv_launches)}
        if variants["simt"] <= 0 or variants["tc"] != 0 or any(
                c["simt"] <= 0 or c["tc"] != 0 for c in bwd.values()):
            raise AssertionError(f"reference: the reduced f32 model's dense "
                                 f"forwards went to {variants}, its backward "
                                 f"to {bwd}, not the CUDA-core kernels alone")
        print(f"reference: dense launches of the reduced f32 model by kernel:"
              f" forward {variants}, backward {bwd}")
        print(f"phase reference done at {time.perf_counter() - t0:.1f} s")
    if "profile" in phases:
        profile_engine()
    if "profile_train" in phases:
        profile_train()
    if "profile_dense" in phases:
        profile_dense()
    if "decode_variants" in phases:
        decode_variants()
    totals: dict = {}
    # The engine and engine_codecs phases share each rail's model (and
    # the fp spec_k 0 streams the log16 streams must equal).
    engine = functools.partial(check_engine, fp_runs="engine" in phases,
                               codecs="engine_codecs" in phases)
    if "engine" in phases:
        phases = [p for p in phases if p != "engine_codecs"]
    for phase, run in (("engine", engine),
                       ("engine_codecs", engine),
                       ("engine_sampled", check_engine_sampled),
                       ("serving_stack", check_serving_stack),
                       ("tp", check_tp),
                       ("families", check_families),
                       ("dense_serve", check_dense_serve),
                       ("train", check_train),
                       ("adafactor", check_adafactor),
                       ("ssm", check_ssm)):
        if phase in ("families", "dense_serve", "train", "adafactor", "ssm"):
            # The engine phases' models are not used past here.
            rail_model.cache_clear()
            cut_model.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()
        if phase in phases:
            for n, c in run().items():       # launches of the phase's path
                totals[n] = totals.get(n, 0) + c
            print(f"phase {phase} done at {time.perf_counter() - t0:.1f} s")
    for r in rows:
        r["launches"] = totals.get(r["name"], 0)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
