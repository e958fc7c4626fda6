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
* **Integrity**: a crc32 of each leaf's bytes in the manifest, as the
  reference's.  Each way the bytes pass one CRC-32, the zip archive's own:
  a save derives the leaf's crc from the CRC the zip writer computed over
  the leaf's ``.npy`` member (its small header removed, by the linearity
  of CRC-32), and a restore holds the member's recorded CRC to the
  manifest's crc and lets the zip reader check the bytes against it as
  it reads them; either mismatch raises ``IOError``.
* **keep_last_k GC** and optional asynchronous writes (one writer thread).
* **Global leaves over ranks**: with a :class:`ShardLayout` (training over
  a rank mesh) every leaf is stored at its global logical shape, as the
  reference stores its arrays: rank 0 writes each leaf that the ranks
  hold in blocks (experts over the EP ranks, tensor-parallel blocks over
  the model axis, FSDP shards over the data axis) gathered from every
  rank, one leaf at a time, and a restore cuts each rank's block out of
  the stored leaf.  So a checkpoint written over 2 x 2 ranks restores onto
  one rank and one written on one rank restores over 2 x 2, and one
  written under FSDP restores under ``nofsdp`` and the reverse.

numpy has no bfloat16: a bf16 leaf is stored as its raw bytes viewed as
``uint16``, with ``bfloat16`` as its dtype in the manifest, so bf16
parameters and optimizer state round-trip bit for bit.  A synchronous save
streams the leaves one at a time from the device into the archive in
``PIECE`` pieces through two pinned host buffers, the next piece's copy
from the card in flight while the zip writer takes this one (its host
memory is two pieces; the file's bytes are those of one write of the
whole leaf), and :meth:`restore_into` copies each leaf into the tensors of
a live tree in place while a reader thread reads the next leaf ahead, so
a model whose state fills the card can be saved and restored.  There is
one shard file, written by one process (rank 0 over ranks); the
reference's multi-host writers wait.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import io
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
READ_PIECE = 64 << 20             # bytes a read of a stored leaf takes
PIECE = 64 << 20                  # bytes a copy of a device leaf takes


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


def _bytes_of(arr: np.ndarray) -> memoryview:
    return memoryview(np.asarray(arr, order="C").reshape(-1)).cast("B")


_CRC_POLY = 0xEDB88320            # CRC-32, bit-reflected


def _gf2_mult(a: int, b: int) -> int:
    """a * b modulo the CRC-32 polynomial (zlib's ``multmodp``)."""
    p, m = 0, 1 << 31
    while m:
        if a & m:
            p ^= b
        b = (b >> 1) ^ _CRC_POLY if b & 1 else b >> 1
        m >>= 1
    return p


def _crc_shift(crc: int, nbytes: int) -> int:
    """``crc32(a + b) ^ crc32(b)`` for ``crc32(a) = crc`` and ``len(b) =
    nbytes``: CRC-32 is linear over GF(2), so the CRC of a prefix moves
    through ``nbytes`` more bytes as a product by x^(8 nbytes) (zlib's
    ``crc32_combine`` with a zero second CRC)."""
    x8n, sq = 1 << 31, 1 << 23            # x^0, x^8
    while nbytes:
        if nbytes & 1:
            x8n = _gf2_mult(sq, x8n)
        sq = _gf2_mult(sq, sq)
        nbytes >>= 1
    return _gf2_mult(x8n, crc)


def _npy_header(arr: np.ndarray) -> bytes:
    """The ``.npy`` header ``np.save`` writes before ``arr``'s bytes."""
    return _header_of(arr.shape, arr.dtype)


def _header_of(shape, dtype: np.dtype) -> bytes:
    """The ``.npy`` header of a C-ordered array of ``shape`` and
    ``dtype``, as ``np.save`` writes it."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {
        "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
        "fortran_order": False, "shape": tuple(shape)})
    return buf.getvalue()


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a leaf of ``dtype`` is stored as (bf16 as
    ``uint16``)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=dtype).numpy().dtype


class _Pinned:
    """Two pinned host buffers of ``PIECE`` bytes and a side stream: the
    bytes of a device tensor come to the host a piece at a time, the next
    piece's copy in flight while the caller takes this one."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.bufs = [torch.empty(PIECE, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.done = [torch.cuda.Event() for _ in range(2)]

    def _copy(self, flat: torch.Tensor, i: int, lo: int) -> None:
        hi = min(flat.numel(), lo + PIECE)
        with torch.cuda.stream(self.stream):
            self.bufs[i][:hi - lo].copy_(flat[lo:hi], non_blocking=True)
            self.done[i].record(self.stream)

    def pieces(self, t: torch.Tensor) -> Iterator[memoryview]:
        """The bytes of ``t`` (C order) in pieces, each valid until the
        next is asked for."""
        t = t.detach().contiguous()
        flat = t.view(-1).view(torch.uint8) if t.numel() else \
            torch.empty(0, dtype=torch.uint8, device=t.device)
        # the copies wait for the work that made t on its own stream
        self.stream.wait_stream(torch.cuda.current_stream(t.device))
        starts = list(range(0, flat.numel(), PIECE))
        if starts:
            self._copy(flat, 0, 0)
        for j, lo in enumerate(starts):
            if j + 1 < len(starts):
                self._copy(flat, (j + 1) % 2, starts[j + 1])
            self.done[j % 2].synchronize()
            n = min(flat.numel(), lo + PIECE) - lo
            yield memoryview(self.bufs[j % 2][:n].numpy())


def _write_device_leaf(zf: zipfile.ZipFile, key: str, t: torch.Tensor,
                       pinned: _Pinned) -> tuple[list, str, int]:
    """Write the CUDA tensor ``t`` as :func:`_write_leaf` writes its host
    copy (the same bytes), its bytes through ``pinned``: (shape, dtype
    name, crc32 of its bytes)."""
    header = _header_of(t.shape, _np_dtype(t.dtype))
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        f.write(header)
        for piece in pinned.pieces(t):
            f.write(piece)
    member = zf.getinfo(key + ".npy").CRC
    nbytes = t.numel() * t.element_size()
    return (list(t.shape), str(t.dtype).removeprefix("torch."),
            member ^ _crc_shift(zlib.crc32(header), nbytes))


def _write_leaf(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> int:
    """Write ``arr`` as the member ``<key>.npy`` (header, then its bytes
    in one write) and return the crc32 of its bytes, derived from the CRC
    the zip writer computed over the member: one pass over the bytes."""
    arr = np.asarray(arr, order="C")
    header = _npy_header(arr)
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        f.write(header)
        f.write(_bytes_of(arr))
    member = zf.getinfo(key + ".npy").CRC
    return member ^ _crc_shift(zlib.crc32(header), arr.nbytes)


def _read_leaf(zf: zipfile.ZipFile, key: str, crc: int) -> np.ndarray:
    """The array stored as ``<key>.npy``: its member's recorded CRC held
    to the manifest's ``crc`` of the bytes, then the bytes read in
    ``READ_PIECE`` pieces into one array while the zip reader checks them
    against that CRC.  A mismatch either way raises ``IOError``."""
    name = key + ".npy"
    try:
        info = zf.getinfo(name)
        with zf.open(info) as f:
            head = f.read(10)              # magic, version, header length
            if head[6] == 1:
                size = 10 + int.from_bytes(head[8:10], "little")
            else:
                head += f.read(2)
                size = 12 + int.from_bytes(head[8:12], "little")
            head += f.read(size - len(head))
            meta = io.BytesIO(head)
            version = np.lib.format.read_magic(meta)
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0(meta) if version == (1, 0)
                else np.lib.format.read_array_header_2_0(meta))
            arr = np.empty(shape, dtype, order="F" if fortran else "C")
            if info.CRC != crc ^ _crc_shift(zlib.crc32(head), arr.nbytes):
                raise IOError(f"checkpoint corruption in leaf {key}: the "
                              f"archive's CRC is not the manifest's")
            view = memoryview(arr.reshape(-1, order="A")).cast("B")
            for lo in range(0, arr.nbytes, READ_PIECE):
                piece = f.read(min(READ_PIECE, arr.nbytes - lo))
                view[lo:lo + len(piece)] = piece
            f.read()                      # at the end: the CRC checked
    except zipfile.BadZipFile as err:
        raise IOError(f"checkpoint corruption in leaf {key}") from err
    return arr


class ShardLayout:
    """Where one rank's leaves lie in the global ones: for each parameter
    name, the dims cut over the rank mesh as ``(dim, axes, parts, index)``
    (the experts of an MoE layer over its EP axes along dim 0; a
    tensor-parallel block, a module's ``shards``, over the model axis; an
    FSDP shard, a module's ``fsdp_dims``, over the data axis, cut from the
    model-axis block), or as ``(dim, axes, whole, segments)`` for a
    ``shards`` entry of column segments (Mamba2's ``in_proj``), where
    ``segments`` gives the segments of each model rank (the module's
    ``segments_of``).  A leaf of
    a checkpointed tree is cut as the parameter its path names
    (``params/<name>``, ``opt/m/<name>``); every other leaf is whole."""

    def __init__(self, params, pctx):
        from repro_torch.models import moe as M
        from repro_torch.models.transformer import is_expert_weight
        self.mesh = pctx.mesh
        self.cuts: dict = {}
        self.shapes = {n: tuple(p.shape)
                       for n, p in params.named_parameters()}
        for prefix, sub in params.named_modules():
            for name, (dim, parts, index) in getattr(sub, "shards",
                                                     {}).items():
                if not isinstance(index, int):
                    index = sub.segments_of[name]
                self.cuts.setdefault(f"{prefix}.{name}".lstrip("."), []
                                     ).append((dim, (pctx.model_axis,),
                                               parts, index))
        for prefix, sub in params.named_modules():
            for name, dim in getattr(sub, "fsdp_dims", {}).items():
                self.cuts.setdefault(f"{prefix}.{name}".lstrip("."), []
                                     ).append((dim, (pctx.data_axis,),
                                               pctx.data_size,
                                               pctx.mesh.axis_index(
                                                   pctx.data_axis)))
        num_experts = M.num_experts(params)
        if num_experts:
            axes = M.expert_axes(pctx, num_experts)
            ep = self.mesh.axis_size(*axes)
            for name in self.shapes:
                if is_expert_weight(name) and ep > 1:
                    self.cuts.setdefault(name, []).append(
                        (0, axes, ep, self.mesh.axis_index(*axes)))

    def _cuts(self, key: str, shape) -> list:
        for part in key.split("/"):
            if part in self.cuts:
                if tuple(shape) != self.shapes[part]:
                    raise NotImplementedError(
                        f"leaf {key} {tuple(shape)} of a parameter "
                        f"{self.shapes[part]}: only leaves of a parameter's "
                        f"shape are cut")
                return self.cuts[part]
        return []

    def global_shape(self, key: str, shape) -> tuple:
        out = list(shape)
        for dim, _, parts, index in self._cuts(key, shape):
            out[dim] = out[dim] * parts if isinstance(index, int) else parts
        return tuple(out)

    def _index(self, rank: int, axes) -> int:
        dims = tuple(self.mesh.shape.values())
        coords = dict(zip(self.mesh.shape, _unravel(rank, dims)))
        idx = 0
        for a in axes:
            idx = idx * self.mesh.shape[a] + coords[a]
        return idx

    def gather(self, key: str, leaf):
        """The global leaf on rank 0 (None on the others): a leaf held in
        blocks is gathered from every rank (``dist.gather``); a whole one
        is rank 0's own.  Every rank calls it for every leaf, in one
        order."""
        import torch.distributed as dist
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        cuts = self._cuts(key, t.shape)
        rank0 = self.mesh.rank == 0
        if not cuts:
            return t if rank0 else None
        t = t.detach().contiguous()
        world = dist.get_world_size()
        pieces = [torch.empty_like(t) for _ in range(world)] if rank0 \
            else None
        dist.gather(t, pieces, dst=0)
        if not rank0:
            return None
        out = torch.empty(self.global_shape(key, t.shape), dtype=t.dtype,
                          device=t.device)
        for rank, piece in enumerate(pieces):
            out_view, segs = out, None
            for dim, axes, _, index in cuts:
                if not isinstance(index, int):
                    segs = dim, index(self._index(rank, axes))
                    continue
                size = t.shape[dim]
                out_view = out_view.narrow(dim, self._index(rank, axes) * size,
                                           size)
            if segs is None:
                out_view.copy_(piece)
                continue
            dim, at = segs[0], 0
            for lo, hi in segs[1]:
                out_view.narrow(dim, lo, hi - lo).copy_(
                    piece.narrow(dim, at, hi - lo))
                at += hi - lo
        return out

    def cut(self, key: str, whole: torch.Tensor, shape) -> torch.Tensor:
        """This rank's block of the global leaf ``whole`` for a leaf of
        ``shape``."""
        for dim, axes, _, index in self._cuts(key, shape):
            if isinstance(index, int):
                size = shape[dim]
                whole = whole.narrow(dim, index * size, size)
            else:
                whole = torch.cat([
                    whole.narrow(dim, lo, hi - lo) for lo, hi in index(
                        self.mesh.axis_index(*axes))], dim=dim)
        return whole


def _unravel(rank: int, dims) -> tuple:
    out = []
    for d in reversed(dims):
        rank, c = divmod(rank, d)
        out.append(c)
    return tuple(reversed(out))


@dataclasses.dataclass
class CheckpointManager:
    """``layout``: a :class:`ShardLayout` when the tree is one rank's part
    of a model trained over ranks (every rank calls :meth:`save` and
    :meth:`restore_into` alike; rank 0 writes)."""
    directory: str
    keep_last_k: int = 3
    async_write: bool = False
    layout: Optional[ShardLayout] = None

    def __post_init__(self):
        if self.layout is not None and self.async_write:
            raise NotImplementedError("asynchronous writes over ranks")
        os.makedirs(self.directory, exist_ok=True)
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if self.async_write else None)
        self._pending: Optional[concurrent.futures.Future] = None
        self.last_restore_s: Optional[float] = None

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
        if self.layout is not None:
            return self._save_global(final, manifest, leaves)
        if self._pool is not None:
            host = [(key, _to_host(leaf)) for key, leaf in leaves]
            self.wait()
            self._pending = self._pool.submit(self._write, final, manifest,
                                              iter(host))
            return final
        return self._write(final, manifest, iter(leaves))

    def _save_global(self, final: str, manifest: dict, leaves: list) -> str:
        """Every leaf at its global shape, written by rank 0; the other
        ranks take part in the gathers, then every rank waits until the
        checkpoint is published."""
        import torch.distributed as dist
        gathered = ((key, self.layout.gather(key, leaf)) for key, leaf
                    in leaves)
        if self.layout.mesh.rank == 0:
            self._write(final, manifest, gathered)
        else:
            for _ in gathered:
                pass
        dist.barrier()
        return final

    def _write(self, final: str, manifest: dict, leaves: Iterator) -> str:
        """Write ``(key, leaf)`` pairs: a CUDA tensor streamed in pieces
        through pinned buffers, anything else (or a ``_to_host`` pair)
        through one host copy."""
        tmp = final + f".tmp-{os.getpid()}-{int(time.time() * 1e6)}"
        os.makedirs(tmp, exist_ok=True)
        pinned = None
        with zipfile.ZipFile(os.path.join(tmp, SHARD), "w",
                             allowZip64=True) as zf:
            for key, leaf in leaves:
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    pinned = pinned or _Pinned(leaf.device)
                    shape, dtype, crc = _write_device_leaf(zf, key, leaf,
                                                           pinned)
                else:
                    arr, dtype = (leaf if isinstance(leaf, tuple)
                                  else _to_host(leaf))
                    shape, crc = list(arr.shape), _write_leaf(zf, key, arr)
                manifest["leaves"][key] = {"shape": shape, "dtype": dtype,
                                           "crc": crc}
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
        ``template``, checked against the manifest; a reader thread reads
        the next leaf while the caller takes this one."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        items = _flatten_with_paths(template)

        def read(zf, i: int) -> np.ndarray:
            key = items[i][0]
            info = manifest["leaves"].get(key)
            if info is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            return _read_leaf(zf, key, info["crc"])
        with zipfile.ZipFile(os.path.join(d, SHARD)) as zf, \
                concurrent.futures.ThreadPoolExecutor(max_workers=1) as ahead:
            nxt = ahead.submit(read, zf, 0) if items else None
            for i, (key, tmpl) in enumerate(items):
                arr = nxt.result()
                nxt = (ahead.submit(read, zf, i + 1) if i + 1 < len(items)
                       else None)
                info = manifest["leaves"][key]
                shape = tuple(getattr(tmpl, "shape", ()))
                if self.layout is not None:
                    shape = self.layout.global_shape(key, shape)
                if tuple(arr.shape) != shape:
                    raise ValueError(
                        f"leaf {key}: stored {arr.shape} vs template "
                        f"{shape}")
                t = _from_host(arr, info["dtype"])
                if self.layout is not None:
                    t = self.layout.cut(key, t, tuple(getattr(tmpl, "shape",
                                                              ())))
                yield tmpl, t

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
        one leaf at a time.  Returns the checkpoint's extra; the wall of
        the restore, the copies to a device finished, is kept as
        :attr:`last_restore_s`."""
        t0 = time.monotonic()
        manifest = self._manifest(step)
        cards = set()
        with torch.no_grad():
            for dst, t in self._leaves(step, tree, manifest):
                dst.copy_(t)
                if dst.is_cuda:
                    cards.add(dst.device)
        for dev in cards:
            torch.cuda.synchronize(dev)
        self.last_restore_s = time.monotonic() - t0
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
