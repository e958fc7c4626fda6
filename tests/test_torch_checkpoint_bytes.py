"""The checkpoint's bytes stay what they were before the writer streamed a
device leaf through pinned buffers and the reader read ahead: a seeded
tree saved under a fixed clock (the zip members' and the manifest's
times) gives the SHA-256 that the writer of one host copy a leaf gave for
the same tree, and restores bit for bit.  The device path's bytes are held
against the host path's on the card (``tests/test_torch_gpu.py``)."""

import hashlib
import os
import time
from unittest import mock

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointManager

# the shard and the manifest of ``_tree()`` saved at step 3 by the writer
# of one host copy a leaf, under the clock below
WANT = "e4720bf99911dc198daf119640232913d7d4a9a7c5e6a0128d789ae913b5750a"
CLOCK = time.struct_time((2026, 1, 2, 3, 4, 5, 4, 2, 0))


def _tree() -> dict:
    rng = np.random.default_rng(5)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return {"params": {"w": normal(37, 5).to(torch.bfloat16),
                       "b": normal(7)},
            "opt": {"m": normal(3, 4),
                    "count": torch.tensor(9, dtype=torch.int64)},
            "flag": torch.from_numpy(rng.random(6) > 0.5),
            "step": np.int64(3), "lr": 0.5}


def _saved(directory) -> tuple[str, str]:
    with mock.patch("time.time", return_value=1.7e9), \
            mock.patch("time.localtime", return_value=CLOCK):
        path = CheckpointManager(str(directory)).save(3, _tree(),
                                                      extra={"a": 1})
    h = hashlib.sha256()
    for name in ("shard_00000.npz", "manifest.json"):
        with open(os.path.join(path, name), "rb") as f:
            h.update(f.read())
    return path, h.hexdigest()


def test_checkpoint_bytes_equal_the_one_copy_writers(tmp_path):
    _, digest = _saved(tmp_path)
    assert digest == WANT


def test_checkpoint_restores_bit_for_bit_reading_ahead(tmp_path):
    _saved(tmp_path)
    want = _tree()
    like = {"params": {k: torch.zeros_like(v)
                       for k, v in want["params"].items()},
            "opt": {k: torch.zeros_like(v) for k, v in want["opt"].items()},
            "flag": torch.zeros_like(want["flag"]),
            "step": np.int64(0), "lr": 0.0}
    got, extra = CheckpointManager(str(tmp_path)).restore(3, like)
    assert extra == {"a": 1}
    for part in ("params", "opt"):
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype
            assert torch.equal(got[part][k].view(-1).view(torch.uint8),
                               v.reshape(-1).view(torch.uint8)), k
    assert torch.equal(got["flag"], want["flag"])
    into = {"params": {k: torch.zeros_like(v)
                       for k, v in want["params"].items()}}
    mgr = CheckpointManager(str(tmp_path / "two"))
    mgr.save(1, {"params": want["params"]})
    mgr.restore_into(1, into)
    for k, v in want["params"].items():
        assert torch.equal(into["params"][k], v), k
