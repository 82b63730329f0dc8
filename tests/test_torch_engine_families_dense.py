"""Greedy token streams of the port's ServingEngine equal the reference
engine's on the dense configs beside qwen3-1.7b (workload and checks in
tests/test_torch_engine_common.py): the reduced hfa-paper-mini at its
own head dim, d_head 96, on both rails at spec_k 0 and 4, and the
reduced qwen1.5-4b (QKV biases, nonzero here), minitron-8b and
command-r-plus-104b on their own rail (fa2) at spec_k 0."""
import pytest

from test_torch_engine_common import (check_engine_parity, family_models,
                                      one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("spec_k", [0, 4])
@pytest.mark.parametrize("impl", ["fa2", "hfa_pallas"])
def test_hfa_paper_mini_d96_streams_match_reference(impl, spec_k):
    models_ = family_models("hfa-paper-mini", impl, d_head=96)
    assert models_[2].cfg.d_head == 96
    check_engine_parity(models_, spec_k)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minitron-8b",
                                  "command-r-plus-104b"])
def test_dense_family_streams_match_reference(arch):
    check_engine_parity(family_models(arch), 0)
