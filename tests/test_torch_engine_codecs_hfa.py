"""The int8 and log16 page codecs through the serving engine, H-FA rail:
greedy token streams of the port's ``ServingEngine(kv_codec=...)`` equal
the reference engine's at spec_k 0 and 4 (workload and checks in
tests/test_torch_engine_common.py)."""
import pytest

from test_torch_engine_common import check_engine_parity, models
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def hfa_models():
    return models("hfa")


@pytest.mark.parametrize("spec_k", [0, 4])
@pytest.mark.parametrize("codec", ["int8", "log16"])
def test_codec_streams_match_reference(hfa_models, codec, spec_k):
    check_engine_parity(hfa_models, spec_k, kv_codec=codec)
