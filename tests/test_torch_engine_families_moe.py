"""Greedy token streams of the port's ServingEngine equal the reference
engine's on the MoE configs (workload and checks in
tests/test_torch_engine_common.py): the reduced granite-moe-1b-a400m on
both rails at spec_k 0 and 4, the reduced phi3.5-moe-42b-a6.6b on its own
rail (fa2) at spec_k 0, and granite at a capacity factor low enough that
decode and verify steps drop assignments.

The reference's expert capacity is a call's, over every row the jitted
step sees - free slots, a prefill chunk's padding, a verify's unused
rows - so a request's routing can depend on its batch (ROADMAP.md Queue
3 C6).  The port routes the same rows in the same order; the low
capacity runs hold that where it shows: a different set of rows would
drop different assignments and the streams would part.
"""
import pytest

from repro_torch.models import moe
from test_torch_engine_common import (check_engine_parity, family_models,
                                      one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRANITE = "granite-moe-1b-a400m"


@pytest.mark.parametrize("spec_k", [0, 4])
@pytest.mark.parametrize("impl", ["fa2", "hfa"])
def test_granite_streams_match_reference(impl, spec_k):
    check_engine_parity(family_models(GRANITE, impl), spec_k)


def test_phi35_moe_streams_match_reference():
    check_engine_parity(family_models("phi3.5-moe-42b-a6.6b"), 0)


@pytest.mark.parametrize("spec_k", [0, 4])
def test_granite_low_capacity_drops_as_the_reference(spec_k, monkeypatch):
    """Capacity factor 0.5: the streams equal the reference's while the
    port's decode (spec_k 0) or verify (spec_k 4) steps and its prefill
    chunks drop assignments (counted by step kind)."""
    models_ = family_models(GRANITE, "fa2", capacity_factor=0.5)
    tm = models_[2]
    kind = {"now": None}
    drops = {"paged_prefill": 0, "paged_decode_step": 0,
             "paged_verify_step": 0}
    for meth in drops:
        orig = getattr(tm, meth)

        def tagged(*a, _orig=orig, _meth=meth, **k):
            kind["now"] = _meth
            return _orig(*a, **k)
        monkeypatch.setattr(tm, meth, tagged)
    route = moe.route

    def counted(p, x, cfg):
        r = route(p, x, cfg)
        drops[kind["now"]] += int((~r["keep"]).sum())
        return r
    monkeypatch.setattr(moe, "route", counted)
    check_engine_parity(models_, spec_k)
    step = "paged_verify_step" if spec_k else "paged_decode_step"
    assert drops["paged_prefill"] > 0 and drops[step] > 0, drops
