"""The port stands alone and never moves to the CPU on its own.

* Every module of ``repro_torch`` - and ``chip_smoke.py`` - imports in a
  subprocess where ``jax`` and ``repro`` cannot be imported; so do the
  mesh, the collectives and the functions a spawned rank runs.
* Without a card, the default device (``cuda``) raises instead of
  falling back: building the LM, the engine or the trainer (``launch/
  train.py``), the serving CLIs (``serve_async``, ``serve_http``), an
  ``AsyncFrontend`` stepping an engine on a card, and loading or
  launching the kernels.
* ``cuda_lib.library()`` builds once when threads make their first call
  at once.
* What the port does not cover yet is refused with a clear error, and
  every attention impl of the reference runs.
"""
import asyncio
import dataclasses
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import cuda_lib, page_codec
from repro_torch.kernels import decode as tdec
from repro_torch.kernels import fa2 as tfa2
from repro_torch.kernels import fa2_bwd as tfa2_bwd
from repro_torch.kernels import hfa as thfa
from repro_torch.kernels import hfa_datapath as tdp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode as tpd
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_async as tserve_async
from repro_torch.launch import serve_http as tserve_http
from repro_torch.launch import train as ttrain
from repro_torch.optim import Adafactor, build_optimizer
from repro_torch.models.model import LM
from repro_torch.serving import (AsyncFrontend, Request, SamplingParams,
                                 ServingEngine)

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL,
                          str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 35      # the whole package


_IMPORT_TP = """
import pickle, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.launch import mesh, ranks, serve, serve_async, serve_http
from repro_torch.parallel import collectives
# What run_ranks hands a spawned rank, resolved by name there.
for fn in (mesh._follower_main, ranks.follow_jobs, ranks.cli_follower,
           serve.follow, serve_async.follow, serve_http.follow,
           collectives.shardmap_paged_attention):
    assert pickle.loads(pickle.dumps(fn)) is fn
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_tensor_parallel_modules_and_rank_entry_import_alone():
    """The mesh, the collectives and the rank entry points a spawned rank
    imports (``launch/ranks.py``, the CLIs' ``follow``) import with
    ``jax`` and ``repro`` blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_TP],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")


def _small_lm():
    return LM(get_config("qwen3-1.7b").reduced(), device="cpu")


def test_default_device_raises_without_a_card():
    _no_card()
    cfg = get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(_small_lm())          # the engine defaults to cuda


def test_kernel_route_raises_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_lib.library()
    q = torch.zeros(1, 1, 1, 1, 64)
    pool = torch.zeros(2, 4, 1, 64)
    lens = torch.ones(1, dtype=torch.int32)
    pt = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_lib.launch_paged("paged_decode_fwd", q, pool, pool, pt, lens,
                              None, scale=0.125, use_hfa=False)
    with pytest.raises(ValueError, match="no kernel"):
        tpd.paged_decode_partial(q[..., 0, :].to("meta"), pool, pool, pt,
                                 lens)


def test_train_entry_point_defaults_to_the_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])


def test_dense_kernel_routes_raise_without_a_card():
    _no_card()
    x = torch.zeros(1, 128, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_lib.launch_dense_fwd(x, x, x, causal=True, scale=0.125,
                                  kv_len=128, q_offset=0, use_hfa=False)
    m = x.to("meta")
    for fn in (tfa2.fa2_forward, thfa.hfa_forward):
        with pytest.raises(ValueError, match="no kernel"):
            fn(m, m, m)
    with pytest.raises(ValueError, match="no kernel"):
        tfa2_bwd.fa2_backward(m, m, m, m, m, m[..., 0])


def test_dense_decode_and_datapath_routes_raise_without_a_card():
    _no_card()
    q, kv = torch.zeros(2, 2, 64), torch.zeros(2, 128, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_lib.launch_dense_decode(q, kv, kv, scale=0.125, kv_len=128,
                                     use_hfa=False)
    x = torch.zeros(1, 128, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_lib.launch_hfa_datapath(x, x, x, causal=True, scale=0.125,
                                     kv_len=128, q_offset=0)
    with pytest.raises(ValueError, match="no kernel"):
        tdec.decode_partial(q.to("meta"), kv.to("meta"), kv.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tdp.hfa_datapath(*(x.to("meta"),) * 3)


def test_dense_serve_entry_point_defaults_to_the_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen3-1.7b", "--reduced", "--dense",
                     "--steps", "1"])


def test_multihead_attention_takes_every_reference_impl():
    """Every impl of the reference's IMPLS runs (none is refused as not
    ported); an unknown name raises."""
    q = torch.zeros(1, 4, 2, 64)
    for impl in tops.IMPLS:
        out = tops.multihead_attention(q, q, q, impl=impl)
        assert out.shape == q.shape and torch.isfinite(out.float()).all()
    with pytest.raises(ValueError, match="unknown attention impl"):
        tops.multihead_attention(q, q, q, impl="hfa_mxu")
    assert tuple(tserve.IMPLS) == tuple(tops.IMPLS)


def test_engine_refuses_what_is_not_ported():
    """A mesh whose "model" axis does not divide the heads is refused by
    the reference's check (before the mesh is used), an unknown codec by
    name; the int8 and log16 codecs and the request surface the port
    serves are accepted, and ``build_optimizer`` returns the Adafactor for
    a config that names it."""
    lm = _small_lm()
    with pytest.raises(ValueError, match="tp=3 must divide n_kv_heads"):
        ServingEngine(lm, device="cpu",
                      mesh=types.SimpleNamespace(shape={"model": 3,
                                                        "data": 1}))
    with pytest.raises(ValueError, match="unknown page codec"):
        page_codec.get_codec("fp8")
    for codec in ("int8", "log16"):
        eng = ServingEngine(lm, device="cpu", max_seq=32, page_size=4,
                            kv_codec=codec)
        assert eng.kv_codec == codec
    for kw in ({"spec_k": "auto"}, {"prefill_budget": "adaptive"}):
        ServingEngine(lm, device="cpu", max_seq=32, page_size=4, **kw)
    eng = ServingEngine(lm, device="cpu", max_seq=32, page_size=4)
    for rid, kw in enumerate(
            ({"sampling": SamplingParams(temperature=0.7)},
             {"sampling": SamplingParams(repetition_penalty=1.3)},
             {"n": 2}, {"best_of": 2}, {"beam_width": 2},
             {"logprobs": True},
             {"sampling": SamplingParams(top_k=5, top_p=0.9)})):
        eng.submit(Request(rid=rid, prompt=[1, 2, 3], max_new_tokens=2,
                           **kw))
    cfg = get_config("qwen3-1.7b").reduced()
    opt = build_optimizer(dataclasses.replace(cfg, optimizer="adafactor"),
                          lambda step: 1e-3)
    assert isinstance(opt, Adafactor) and opt.period == 1
    assert isinstance(build_optimizer(get_config("command-r-plus-104b"),
                                      lambda step: 1e-3), Adafactor)


def test_serving_stack_entry_points_default_to_the_card():
    """serve_async and serve_http default to cuda and raise without a
    card; a frontend whose engine is on a card fails its stream and its
    later submits when no card is there, instead of stepping on the
    CPU."""
    _no_card()
    for cli in (tserve_async, tserve_http):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--arch", "qwen3-1.7b", "--reduced", "--smoke"])
    eng = ServingEngine(_small_lm(), device="cpu", max_seq=32, page_size=4)
    eng.device = torch.device("cuda", 0)

    async def main():
        fe = AsyncFrontend(eng)
        with pytest.raises(RuntimeError, match="CUDA"):
            async for _ in fe.submit(Request(rid=0, prompt=[1, 2, 3],
                                             max_new_tokens=2)):
                pass
        assert fe.failed
        with pytest.raises(RuntimeError, match="frontend failed"):
            fe.submit(Request(rid=1, prompt=[1], max_new_tokens=1))
        await fe.close()

    asyncio.run(main())
    assert eng.stats["steps"] == 0


def test_kernel_library_builds_once_under_concurrent_first_calls(
        monkeypatch):
    """Eight threads make their first ``library()`` call at once (the
    engines of several replicas, each stepped on its own thread): one
    build, one load, one bind, and every thread gets the same library."""
    calls = {"build": 0, "cdll": 0, "bind": 0}
    lib = object()

    def build():
        calls["build"] += 1
        threading.Event().wait(0.05)     # a build takes a while
        return "libhfa.so"

    def cdll(path):
        calls["cdll"] += 1
        return lib

    def bind(handle):
        calls["bind"] += 1
        return handle

    monkeypatch.setattr(cuda_lib, "_lib", None)
    monkeypatch.setattr(cuda_lib.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_lib, "build", build)
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", cdll)
    monkeypatch.setattr(cuda_lib, "bind", bind)
    start = threading.Barrier(8)
    got = []

    def first_call():
        start.wait(timeout=10)
        got.append(cuda_lib.library())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_call) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "cdll": 1, "bind": 1}
    assert len(got) == 8 and all(g is lib for g in got)
