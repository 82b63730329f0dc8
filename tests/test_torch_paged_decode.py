"""Port parity for ``kernels/paged_decode.py``: the paged decode kernel's
plain version against the reference (see tests/test_torch_paged_common.py for
the tolerances), and the page writes ``append_kv`` / ``write_prefill_kv``
and ``gather_pages`` bit for bit, drop cases included."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import paged_decode as jpd
from repro_torch.kernels import paged_decode as tpd
from test_torch_paged_common import check_dead_rows, check_plain_matches_reference


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_plain_matches_reference(g, d, use_hfa):
    check_plain_matches_reference("decode", g, d, use_hfa)


def test_free_slot_is_the_neutral_triplet():
    check_dead_rows("decode")


def _pools(seed, num_pages=9, page=4, hkv=2, d=8):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((num_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, hkv, d)).astype(np.float32)
    return rng, kp, vp


def _same(j_pools, t_pools):
    for j, t in zip(j_pools, t_pools):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_append_kv_bit_equal_and_drops_free_slots():
    rng, kp, vp = _pools(1)
    pt = np.array([[3, 5, 0], [1, 2, 4], [6, 7, 8]], np.int32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    # Several steps; slot 1 is free (seq_lens 0: its write is dropped).
    for sl in ([1, 0, 4], [2, 0, 5], [7, 0, 11], [8, 0, 3]):
        sl = np.asarray(sl, np.int32)
        kn = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
        vn = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
        jk, jv = jpd.append_kv(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(pt), jnp.asarray(sl))
        tpd.append_kv(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                      torch.from_numpy(pt), torch.from_numpy(sl))
        _same((jk, jv), (tk, tv))
    # The free slot's pages were never touched.
    np.testing.assert_array_equal(tk.numpy()[[1, 2, 4]], kp[[1, 2, 4]])


def test_write_prefill_kv_and_gather_pages_bit_equal():
    rng, kp, vp = _pools(2)
    pt = np.array([[3, 5, 0], [1, 2, 4]], np.int32)
    kn = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    jk, jv = jpd.write_prefill_kv(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(pt))
    tk, tv = tpd.write_prefill_kv(torch.from_numpy(kp.copy()),
                                  torch.from_numpy(vp.copy()),
                                  torch.from_numpy(kn), torch.from_numpy(vn),
                                  torch.from_numpy(pt))
    _same((jk, jv), (tk, tv))
    np.testing.assert_array_equal(
        np.asarray(jpd.gather_pages(jk, jnp.asarray(pt))),
        tpd.gather_pages(tk, torch.from_numpy(pt)).numpy())
