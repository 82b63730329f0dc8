"""The port's serve entry points against the reference's: the weights
``LM.init_reference(seed)`` draws (the reference's ``LM.init(PRNGKey(
seed))``: f32 within 3 ulps - XLA's f32 erf_inv uses its own log1p -
and bf16 bit for bit) and, for the same flags on the CPU, the same
``sample:`` token ids, dense and paged - greedy, and with seeded
sampling and speculation, a sequence group, beam search and logprobs
(the same ``speculation``, ``sequence groups``, completion and
``logprobs rid`` lines too), and an MoE config (granite-moe-1b-a400m)
with speculation.  ``serve_async`` prints the reference's
``sample:`` line for an open loop whose requests all arrive at once, and
its ``--smoke`` runs; ``serve_http --smoke`` passes its built-in client,
one replica and two behind the router; both refuse a ``--tp`` (and
``serve_http`` a ``--dp``) that the heads or the batch cannot take, and
``--tp 0``.  The CLIs' runs at tp 2 are in test_torch_tp_cli.py."""
import functools
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.launch import serve as jserve
from repro.launch import serve_async as jserve_async
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.core import jax_random as jr
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_async as tserve_async
from repro_torch.launch import serve_http as tserve_http
from repro_torch.models import convert
from repro_torch.models.model import LM
from test_torch_dense_serve import ref_params  # noqa: F401
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_init_reference_draws_the_reference_weights(ref_params):  # noqa: F811
    """``LM.init_reference(0)`` against ``LM.init(PRNGKey(0))``: the key
    tree and the uniform draws are the reference's; XLA's f32 erf_inv
    (its own log1p) and torch's differ by at most 3 ulps here."""
    cfg = get_config("qwen3-1.7b").reduced()
    tm = LM(cfg, device="cpu").init_reference(0)
    want = convert.state_dict_from_reference(ref_params, cfg)
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        a = np.asarray(w, np.float32).view(np.int32).astype(np.int64)
        b = got[name].numpy().view(np.int32).astype(np.int64)
        assert np.abs(a - b).max() <= 3, name
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(7), 5))
    np.testing.assert_array_equal(
        np.stack([k.numpy() for k in jr.split(jr.prng_key(7), 5)]), keys)
    # bf16 (the full-size param dtype): bit for bit, scale included.
    want = jax.random.normal(jnp.asarray(keys[3]), (64, 48), jnp.bfloat16) \
        * (1 / 48 ** 0.5)
    got = jr.normal(jr.split(jr.prng_key(7), 5)[3], (64, 48), torch.bfloat16,
                    scale=1 / 48 ** 0.5)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.fixture(scope="module", autouse=True)
def _one_reference_model_a_config():
    """The reference entry point builds its model once a config in this
    module, so its runs share the compiled serving steps the model keeps
    (it holds no other state; each run draws its weights anew)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "build_model",
                   functools.lru_cache(maxsize=None)(jmodel.build_model))
        yield


def _cli_lines(flags, capsys, keep=("sample:",), cli=(jserve, tserve)):
    """The lines starting with ``keep`` that each package's entry point
    ``cli`` (reference module, port module) prints for ``flags`` (the
    port on the CPU)."""
    lines = {}
    for name in ("ref", "port"):
        if name == "ref":
            argv, sys.argv = sys.argv, ["serve"] + flags
            try:
                cli[0].main()
            finally:
                sys.argv = argv
        else:
            cli[1].main(flags + ["--device", "cpu"])
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith(keep)]
    return lines["ref"], lines["port"]


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "paged"])
def test_serve_cli_prints_the_reference_sample(dense, capsys):
    """The two packages' serve entry points, same flags (the port on the
    CPU): the same ``sample:`` token ids."""
    flags = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "2",
             "--steps", "4"] + (["--dense"] if dense else [])
    want, got = _cli_lines(flags, capsys)
    assert got == want and len(want) == 1


REQUEST_FLAGS = {
    "spec_sampled": ["--spec-k", "4", "--temperature", "0.8", "--top-p",
                     "0.95", "--seed", "7"],
    "n4": ["--n", "4", "--temperature", "0.8", "--top-k", "8"],
    "beam3": ["--beam-width", "3"],
    "logprobs": ["--logprobs", "--temperature", "0.7",
                 "--repetition-penalty", "1.2"],
}


@pytest.mark.parametrize("name", list(REQUEST_FLAGS))
def test_serve_cli_request_flags_print_the_reference_lines(name, capsys):
    """Sampling, speculation, groups, beam and logprobs flags: the same
    sample, speculation, group, completion and logprobs lines."""
    flags = ["--arch", "qwen3-1.7b", "--reduced", "--requests", "4",
             "--steps", "5"] + REQUEST_FLAGS[name]
    want, got = _cli_lines(flags, capsys, keep=(
        "sample:", "speculation:", "sequence groups", "  rid",
        "logprobs rid"))
    assert got == want
    assert len(want) > 1 and want[-1].startswith("sample:")


def test_serve_cli_moe_prints_the_reference_lines(capsys):
    """The reduced granite-moe-1b-a400m through the paged engine with
    speculation: the same ``sample:`` and ``speculation:`` lines."""
    flags = ["--arch", "granite-moe-1b-a400m", "--reduced", "--requests",
             "4", "--steps", "6", "--spec-k", "4"]
    want, got = _cli_lines(flags, capsys, keep=("sample:", "speculation:"))
    assert got == want and len(want) == 2


def test_serve_async_prints_the_reference_sample(capsys):
    """An open loop whose six requests all arrive at t=0 (``--rate 0``):
    the drive loop admits them in one step on both packages, so the
    greedy streams and the ``sample:`` line are the reference's."""
    flags = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "4",
             "--prompt-len", "16", "--steps", "8", "--requests", "6",
             "--rate", "0"]
    want, got = _cli_lines(flags, capsys, cli=(jserve_async, tserve_async))
    assert got == want and len(want) == 1


def test_serve_async_smoke_runs_on_the_cpu(capsys):
    """``--smoke`` with mid-stream cancels: every request ends (its
    length, or cancelled), the pool is clean (``main`` checks it) and
    each latency class is summarised."""
    records = tserve_async.main(["--arch", "qwen3-1.7b", "--reduced",
                                 "--device", "cpu", "--smoke",
                                 "--cancel-every", "3"])
    out = capsys.readouterr().out
    assert len(records) == 6 and "open loop: 6 requests" in out
    assert {r["reason"] for r in records} <= {"length", "eos", "cancelled"}
    assert sum(r["reason"] == "cancelled" for r in records) >= 1
    assert "sample:" in out


@pytest.mark.parametrize("replicas", [1, 2])
def test_serve_http_smoke_passes_on_the_cpu(replicas, capsys):
    """The built-in client over a loopback port: healthz, stats, a greedy
    and a sampled tenant stream, a disconnect that frees its pages; with
    two replicas the router's spread, prefix hit and clean pools."""
    with pytest.raises(SystemExit) as ei:
        tserve_http.main(["--arch", "qwen3-1.7b", "--reduced", "--device",
                          "cpu", "--smoke", "--replicas", str(replicas)])
    out = capsys.readouterr().out
    assert ei.value.code == 0, out
    assert "smoke: OK" in out and f"replicas {replicas}" in out


# What each case refuses before a rank starts: tp 3 does not divide the
# reduced config's heads, tp 0 is no mesh, dp 2 does not divide a batch
# of 3.
_REFUSED = {(tserve_async, "--tp"): (["--tp", "3"], ValueError,
                                     "tp=3 must divide n_kv_heads"),
            (tserve_http, "--tp"): (["--tp", "0"], ValueError,
                                    "tp and dp must be >= 1"),
            (tserve_http, "--dp"): (["--dp", "2", "--batch", "3"],
                                    ValueError, "dp=2 must divide "
                                                "max_batch=3")}


@pytest.mark.parametrize("cli,flag", [(tserve_async, "--tp"),
                                      (tserve_http, "--tp"),
                                      (tserve_http, "--dp")])
def test_serving_clis_refuse_tensor_and_data_parallel(cli, flag):
    """The serving CLIs refuse a mesh the config or the batch cannot
    take, with the reference's checks: ``serve_async --tp 3`` (heads),
    ``serve_http --tp 0`` and ``serve_http --dp 2 --batch 3``."""
    extra, exc, match = _REFUSED[(cli, flag)]
    with pytest.raises(exc, match=match):
        cli.main(["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu",
                  "--smoke"] + extra)
