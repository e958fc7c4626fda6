"""The port's bitmap helpers (``repro_torch.core.bitmap``) against the
reference's ``repro.core.bitmap`` on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as jbm
from repro_torch.core import bitmap as tbm


@pytest.mark.parametrize("num_ranks", [1, 5, 31, 32, 33, 64, 100])
def test_word_helpers_match_reference(num_ranks):
    onehot = np.random.default_rng(num_ranks).random((6, 3, num_ranks)) > 0.6
    words = tbm.encode_onehot(torch.from_numpy(onehot), num_ranks)
    ref = np.asarray(jbm.encode_onehot(jnp.asarray(onehot), num_ranks))
    np.testing.assert_array_equal(words.numpy().astype(np.uint32), ref)
    np.testing.assert_array_equal(tbm.np_encode_rows(onehot, num_ranks), ref)
    np.testing.assert_array_equal(
        tbm.decode_onehot(words, num_ranks).numpy(),
        np.asarray(jbm.decode_onehot(jnp.asarray(ref), num_ranks)))
    np.testing.assert_array_equal(
        tbm.popcount_words(words).numpy(),
        np.asarray(jbm.popcount_words(jnp.asarray(ref))))
    lo, hi = num_ranks // 3, num_ranks - num_ranks // 4
    np.testing.assert_array_equal(
        tbm.mask_range(words, lo, hi, num_ranks).numpy().astype(np.uint32),
        np.asarray(jbm.mask_range(jnp.asarray(ref), lo, hi, num_ranks)))


def test_python_helpers_match_reference():
    for dests, n in (([0, 3, 7], 8), ([], 4), ([63, 64, 1023], 1024)):
        bm = tbm.encode(dests, n)
        assert bm == jbm.encode(dests, n)
        assert tbm.decode(bm, n) == jbm.decode(bm, n) == sorted(dests)
        assert tbm.popcount(bm) == jbm.popcount(bm) == len(dests)
        assert tbm.subset_mask(dests) == jbm.subset_mask(dests)
        assert tbm.metadata_bytes(n) == jbm.metadata_bytes(n)
    for bad in ((lambda: tbm.encode([9], 8)), (lambda: tbm.decode(256, 8))):
        with pytest.raises(ValueError):
            bad()
