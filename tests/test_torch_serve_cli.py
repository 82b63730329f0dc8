"""The port's serve entry point against the reference's: the weights
``LM.init_reference(seed)`` draws (the reference's ``LM.init(PRNGKey(
seed))``: f32 within 3 ulps - XLA's f32 erf_inv uses its own log1p -
and bf16 bit for bit) and, for the same flags on the CPU, the same
``sample:`` token ids, dense and paged."""
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.launch import serve as jserve
from repro_torch.configs import get_config
from repro_torch.core import jax_random as jr
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models.model import LM
from test_torch_dense_serve import ref_params  # noqa: F401


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


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "paged"])
def test_serve_cli_prints_the_reference_sample(dense, capsys):
    """The two packages' serve entry points, same flags (the port on the
    CPU): the same ``sample:`` token ids."""
    flags = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "2",
             "--steps", "4"] + (["--dense"] if dense else [])
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
                       if ln.startswith("sample:")]
    assert lines["port"] == lines["ref"] and len(lines["ref"]) == 1
