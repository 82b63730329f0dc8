"""The int8 and log16 page codecs through the serving engine, FA-2 rail.

Greedy token streams of the port's ``ServingEngine(kv_codec=...)`` equal
the reference engine's at spec_k 0 and 4 (workload and checks in
tests/test_torch_engine_common.py: chunked prefill, cached prefix pages,
accepted and rolled-back drafts); a copy-on-write fork copies the int8
scale sidecars with the data; and the serve entry point's ``--kv-codec``
prints the reference's pool line and sample.  The H-FA rail's streams
are in tests/test_torch_engine_codecs_hfa.py.
"""
import sys

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve
from repro_torch.serving import Request, ServingEngine
from test_torch_engine_common import check_engine_parity, models
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def fa2_models():
    return models("fa2")


@pytest.mark.parametrize("spec_k", [0, 4])
@pytest.mark.parametrize("codec", ["int8", "log16"])
def test_codec_streams_match_reference(fa2_models, codec, spec_k):
    check_engine_parity(fa2_models, spec_k, kv_codec=codec)


def test_cow_fork_copies_the_scale_sidecars(fa2_models):
    """fork + divergent append on int8 pools: the pending copy lands in
    the data and the scale pools of every layer, so the fork's pages hold
    the original's encodings and scales bit for bit."""
    _, _, tm = fa2_models
    eng = ServingEngine(tm, max_batch=3, page_size=4, max_seq=32,
                        kv_codec="int8", device="cpu")
    eng.submit(Request(rid=0, prompt=list(range(1, 7)), max_new_tokens=8))
    eng.step()                                   # 6-token KV, partial tail
    [slot] = eng.sched.decoding_slots()
    fork = eng.cache.fork(slot)                  # tail page now shared
    assert eng.cache.ensure_append_capacity(fork)
    assert eng.cache.page_table[fork, 1] != eng.cache.page_table[slot, 1]
    eng._apply_pending_copies()
    assert eng.stats["cow_copies"] == 1
    n = int(eng.cache.seq_lens[slot])
    for pools in eng.layers.values():
        assert set(pools) == {"k_pages", "v_pages", "k_scale", "v_scale"}
        for key, pool in pools.items():
            rows = [pool[:, torch.from_numpy(eng.cache.page_table[s, :2])
                         .long()].flatten(1, 2)[:, :n] for s in (slot, fork)]
            assert torch.equal(rows[0], rows[1]), key
            if key.endswith("scale"):
                assert bool((rows[0] > 0).all()), key
    eng.cache.advance(fork)
    eng.cache.check_invariants()


def test_serve_cli_kv_codec_prints_the_reference_lines(capsys):
    flags = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "2", "--steps",
             "4", "--spec-k", "2", "--kv-codec", "int8"]
    argv, sys.argv = sys.argv, ["serve"] + flags
    try:
        jserve.main()
    finally:
        sys.argv = argv
    keep = ("kv codec", "sample:")
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(keep)]
    tserve.main(flags + ["--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith(keep)]
    assert got == want and len(want) == 2
    assert want[0].startswith("kv codec int8: pool ")
