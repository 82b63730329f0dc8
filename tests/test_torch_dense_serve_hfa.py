"""The port's dense fixed-batch serving against the reference on the
H-FA impls: 16 greedy steps of the reduced qwen3-1.7b, streams identical
and logits within 1e-2 (helpers and tolerances in
``tests/test_torch_dense_serve.py``)."""
import pytest

from test_torch_dense_serve import check_streams, ref_params  # noqa: F401


@pytest.mark.parametrize("impl", ["hfa_pallas", "hfa", "hfa_datapath"])
def test_prefill_and_decode_match_reference(ref_params, impl):  # noqa: F811
    check_streams(ref_params, impl)
