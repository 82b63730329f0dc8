"""Port parity for ``kernels/paged_prefill.py``: the paged prefill
kernel's plain version against the reference (see
tests/test_torch_paged_common.py for the tolerances), and ``write_chunk_kv`` /
``copy_pages`` bit for bit, drop cases included."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import paged_prefill as jpp
from repro_torch.kernels import paged_prefill as tpp
from test_torch_paged_common import check_dead_rows, check_plain_matches_reference


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_plain_matches_reference(g, d, use_hfa):
    check_plain_matches_reference("prefill", g, d, use_hfa)


def test_empty_slot_is_the_neutral_triplet():
    check_dead_rows("prefill")


def test_write_chunk_kv_bit_equal_and_drops_padding_rows():
    rng = np.random.default_rng(7)
    kp = rng.standard_normal((10, 4, 2, 8)).astype(np.float32)
    vp = rng.standard_normal((10, 4, 2, 8)).astype(np.float32)
    pt = np.array([[3, 5, 0], [1, 2, 4], [6, 7, 8]], np.int32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    # (start, chunk_lens) sequences: resumed chunks, padding rows past
    # chunk_lens (dropped), an empty row, positions past the table.
    for start, cl in (([0, 0, 0], [6, 3, 0]), ([6, 3, 0], [5, 4, 2]),
                      ([11, 7, 2], [1, 0, 6])):
        kn = rng.standard_normal((3, 6, 2, 8)).astype(np.float32)
        vn = rng.standard_normal((3, 6, 2, 8)).astype(np.float32)
        args = (np.asarray(start, np.int32), np.asarray(cl, np.int32))
        jk, jv = jpp.write_chunk_kv(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                                    jnp.asarray(pt),
                                    *map(jnp.asarray, args))
        tpp.write_chunk_kv(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                           torch.from_numpy(pt), *map(torch.from_numpy, args))
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(tk.numpy()[9], kp[9])   # unowned page


@pytest.mark.parametrize("axis", [0, 1])
def test_copy_pages_bit_equal_with_padding(axis):
    rng = np.random.default_rng(9)
    shape = (6, 4, 2, 8) if axis == 0 else (3, 6, 4, 2, 8)
    pool = rng.standard_normal(shape).astype(np.float32)
    src = np.array([2, 0, 5, 1], np.int32)
    dst = np.array([4, 3, 6, 6], np.int32)       # 6 = padding, dropped
    want = np.asarray(jpp.copy_pages(jnp.asarray(pool), jnp.asarray(src),
                                     jnp.asarray(dst), axis=axis))
    got = tpp.copy_pages(torch.from_numpy(pool.copy()), torch.from_numpy(src),
                         torch.from_numpy(dst), axis=axis)
    np.testing.assert_array_equal(want, got.numpy())
