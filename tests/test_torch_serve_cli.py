"""The port's serve entry point against the reference's: the weights
``LM.init_reference(seed)`` draws (the reference's ``LM.init(PRNGKey(
seed))``: f32 within 3 ulps - XLA's f32 erf_inv uses its own log1p -
and bf16 bit for bit) and, for the same flags on the CPU, the same
``sample:`` token ids, dense and paged - greedy, and with seeded
sampling and speculation, a sequence group, beam search and logprobs
(the same ``speculation``, ``sequence groups``, completion and
``logprobs rid`` lines too)."""
import functools
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.core import jax_random as jr
from repro_torch.launch import serve as tserve
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


def _cli_lines(flags, capsys, keep=("sample:",)):
    """The lines starting with ``keep`` that each package's serve entry
    point prints for ``flags`` (the port on the CPU)."""
    lines = {}
    for name in ("ref", "port"):
        if name == "ref":
            argv, sys.argv = sys.argv, ["serve"] + flags
            try:
                jserve.main()
            finally:
                sys.argv = argv
        else:
            tserve.main(flags + ["--device", "cpu"])
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
