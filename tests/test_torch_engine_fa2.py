"""Greedy token streams of the port's ServingEngine equal the reference
engine's on the fa2 rail, with spec_k 0 and 4 (workload and checks in
tests/test_torch_engine_common.py), and copy-on-write copies reach every
layer pool."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import page_codec as jcodec
from repro.serving import ServingEngine as JEngine
from repro_torch.kernels import page_codec
from repro_torch.serving import Request, ServingEngine
from test_torch_engine_common import check_engine_parity, models


@pytest.fixture(scope="module")
def fa2_models():
    return models("fa2")


@pytest.mark.parametrize("spec_k", [0, 4])
def test_engine_streams_match_reference(fa2_models, spec_k):
    check_engine_parity(fa2_models, spec_k)


def test_engine_applies_cow_copies_to_every_layer_pool(fa2_models):
    """fork + divergent append: the pending COW copy lands in every
    layer's pools, so the fork reads back the original's KV."""
    _, _, tm = fa2_models
    eng = ServingEngine(tm, max_batch=3, page_size=4, max_seq=32,
                        device="cpu")
    eng.submit(Request(rid=0, prompt=list(range(1, 7)), max_new_tokens=8))
    eng.step()                                   # 6-token KV, partial tail
    [slot] = eng.sched.decoding_slots()
    fork = eng.cache.fork(slot)                  # tail page now shared
    assert eng.cache.ensure_append_capacity(fork)
    eng._apply_pending_copies()
    assert eng.stats["cow_copies"] == 1
    n = int(eng.cache.seq_lens[slot])
    for pool in eng.layers["l0"].values():
        a = pool[:, torch.from_numpy(eng.cache.page_table[slot, :2])
                 .long()].flatten(1, 2)[:, :n]
        b = pool[:, torch.from_numpy(eng.cache.page_table[fork, :2])
                 .long()].flatten(1, 2)[:, :n]
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    eng.cache.advance(fork)
    eng.cache.check_invariants()


def test_pool_bytes_per_token_match_reference(fa2_models):
    jm, params, tm = fa2_models
    cfg = tm.cfg
    per_layer = page_codec.bytes_per_token("fp", cfg.n_kv_heads, cfg.d_head,
                                           torch.float32)
    assert per_layer == jcodec.bytes_per_token("fp", cfg.n_kv_heads,
                                               cfg.d_head, jnp.float32)
    kw = dict(max_batch=2, page_size=4, max_seq=32)
    eng = ServingEngine(tm, device="cpu", **kw)
    assert eng.bytes_per_token() == cfg.n_layers * per_layer
    assert eng.pool_bytes() == JEngine(jm, params, **kw).pool_bytes()
