"""Checkpoints with atomic commit, per-leaf integrity and GC.

Port of ``src/repro/checkpoint/store.py`` for trees of tensors: nested dicts
(and lists) whose leaves are tensors, numpy arrays or numbers, such as
``{"params": {name: tensor}, "opt": {...}, "step": tensor}``.  Layout of
one checkpoint, as the reference's:

    <dir>/step_000123/
        manifest.json      # step, per-leaf shape, dtype and crc32, extra
        shard_00000.npz    # every leaf, keyed by its path ("params/w")

* **Atomic commit**: a checkpoint is written into ``step_X.tmp-<nonce>``
  and published by one ``rename``; a reader never sees a partial one, and
  a crashed writer leaves a .tmp dir that GC removes after an hour.
* **Integrity**: a crc32 of each leaf's bytes in the manifest; restore
  verifies it and raises ``IOError`` on a mismatch.
* **keep_last_k GC** and optional asynchronous writes (one writer thread).

numpy has no bfloat16: a bf16 leaf is stored as its raw bytes viewed as
``uint16``, with ``bfloat16`` as its dtype in the manifest, so bf16
parameters and optimizer state round-trip bit for bit.  A synchronous save
streams the leaves one at a time from the device into the archive (its
host memory is one leaf), and :meth:`restore_into` copies each leaf into
the tensors of a live tree in place, so a model whose state fills the card
can be saved and restored.  There is one shard: the port's checkpoints are
one process's (the reference's multi-host resharding is training over
ranks, ROADMAP.md queue 1 item 8b).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import time
import zipfile
import zlib
from typing import Any, Iterator, Optional

import numpy as np
import torch

SHARD = "shard_00000.npz"


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a nest of dicts and lists, in traversal order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += _flatten_with_paths(sub, f"{prefix}/{key}" if prefix
                                   else str(key))
    return out


def _unflatten(template, leaves: Iterator):
    """A nest shaped as ``template`` whose leaves come from ``leaves`` in
    :func:`_flatten_with_paths` order."""
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(numpy array of the leaf's bytes, its dtype name); bf16 as
    uint16."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
    t = t.detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B")) \
        & 0xFFFFFFFF


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep_last_k: int = 3
    async_write: bool = False

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if self.async_write else None)
        self._pending: Optional[concurrent.futures.Future] = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        """Save a tree (params/opt state/data step...).  Returns its path.
        An asynchronous save copies every leaf to the host first, then
        writes in the background; a synchronous one streams leaf by
        leaf."""
        manifest = {"step": int(step), "leaves": {}, "extra": extra or {},
                    "time": time.time(), "format": 1}
        leaves = _flatten_with_paths(tree)
        final = os.path.join(self.directory, f"step_{step:08d}")
        if self._pool is not None:
            host = [(key, *_to_host(leaf)) for key, leaf in leaves]
            self.wait()
            self._pending = self._pool.submit(self._write, final, manifest,
                                              iter(host))
            return final
        return self._write(final, manifest,
                           ((key, *_to_host(leaf)) for key, leaf in leaves))

    def _write(self, final: str, manifest: dict, host: Iterator) -> str:
        tmp = final + f".tmp-{os.getpid()}-{int(time.time() * 1e6)}"
        os.makedirs(tmp, exist_ok=True)
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as crcs, \
                zipfile.ZipFile(os.path.join(tmp, SHARD), "w",
                                allowZip64=True) as zf:
            for key, arr, dtype in host:
                crc = crcs.submit(_crc, arr)       # beside the write
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                manifest["leaves"][key] = {"shape": list(arr.shape),
                                           "dtype": dtype,
                                           "crc": crc.result()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()
        return final

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # -- read ----------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and ".tmp" not in name:
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def _manifest(self, step: int) -> dict:
        path = os.path.join(self.directory, f"step_{step:08d}",
                            "manifest.json")
        with open(path) as f:
            return json.load(f)

    def _leaves(self, step: int, template, manifest: dict) -> Iterator:
        """(template leaf, stored tensor on the host) for each leaf of
        ``template``, checked against the manifest."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        with np.load(os.path.join(d, SHARD)) as data:
            for key, tmpl in _flatten_with_paths(template):
                info = manifest["leaves"].get(key)
                if info is None:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = data[key]
                if _crc(arr) != info["crc"]:
                    raise IOError(f"checkpoint corruption in leaf {key}")
                shape = tuple(getattr(tmpl, "shape", ()))
                if tuple(arr.shape) != shape:
                    raise ValueError(
                        f"leaf {key}: stored {arr.shape} vs template "
                        f"{shape}")
                yield tmpl, _from_host(arr, info["dtype"])

    def restore(self, step: int, template: Any) -> tuple[Any, dict]:
        """New tensors in the structure of ``template`` (a tree of tensors),
        each on its template leaf's device in its dtype.  Returns (tree,
        extra)."""
        manifest = self._manifest(step)

        def leaves():
            for tmpl, t in self._leaves(step, template, manifest):
                like = tmpl if isinstance(tmpl, torch.Tensor) else \
                    torch.as_tensor(tmpl)
                yield t.to(device=like.device, dtype=like.dtype)
        tree = _unflatten(template, leaves())
        return tree, manifest.get("extra", {})

    def restore_into(self, step: int, tree: Any) -> dict:
        """Copy checkpoint ``step`` into the tensors of ``tree`` in place,
        one leaf at a time.  Returns the checkpoint's extra."""
        manifest = self._manifest(step)
        with torch.no_grad():
            for dst, t in self._leaves(step, tree, manifest):
                dst.copy_(t)
        return manifest.get("extra", {})

    # -- GC --------------------------------------------------------------------
    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last_k] if self.keep_last_k else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
        # remove orphaned tmp dirs (crashed writers)
        for name in os.listdir(self.directory):
            if ".tmp-" in name:
                full = os.path.join(self.directory, name)
                if time.time() - os.path.getmtime(full) > 3600:
                    shutil.rmtree(full, ignore_errors=True)
