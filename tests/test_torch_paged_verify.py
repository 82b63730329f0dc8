"""Port parity for ``kernels/paged_verify.py``: the paged verify
kernel's plain version against the reference's Pallas kernel and jnp
path (see tests/test_torch_paged_common.py for the tolerances), including a
free slot (``chunk_lens == 0``) and ragged chunk lengths."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import paged_verify as jpv
from repro_torch.kernels import paged_verify as tpv
from test_torch_paged_common import (case, check_dead_rows,
                               check_plain_matches_reference, rows)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_plain_matches_reference(g, d, use_hfa):
    check_plain_matches_reference("verify", g, d, use_hfa)


def test_free_slot_is_the_neutral_triplet():
    check_dead_rows("verify")


@pytest.mark.parametrize("use_hfa", [False, True], ids=["fa2", "hfa"])
def test_plain_matches_reference_triplet_oracle(use_hfa):
    """The reference's op-order-free oracle ``paged_verify_partial_ref``
    computes the same one-shot pieces as the plain version."""
    q, kp, vp, pt, sl, cl, live = case("verify", 64, 2, seed=21)
    want = jpv.paged_verify_partial_ref(*map(jnp.asarray,
                                             (q, kp, vp, pt, sl, cl)),
                                        use_hfa=use_hfa)
    got = tpv.paged_verify_partial_plain(*map(torch.from_numpy,
                                              (q, kp, vp, pt, sl, cl)),
                                         use_hfa=use_hfa)
    for w, t, tol in zip(want, got, (1e-3, 1e-6, 1e-4)):
        np.testing.assert_allclose(rows(t.numpy(), live, "verify"),
                                   rows(w, live, "verify"), atol=tol,
                                   rtol=1e-6)
