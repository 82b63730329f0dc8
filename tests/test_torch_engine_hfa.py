"""Greedy token streams of the port's ServingEngine equal the reference
engine's on the H-FA rail (FIX16 exponentials, LogDiv), with spec_k 0
and 4 (workload and checks in tests/test_torch_engine_common.py)."""
import pytest

from test_torch_engine_common import check_engine_parity, models


@pytest.fixture(scope="module")
def hfa_models():
    return models("hfa")


@pytest.mark.parametrize("spec_k", [0, 4])
def test_engine_streams_match_reference(hfa_models, spec_k):
    check_engine_parity(hfa_models, spec_k)
