"""The rank mesh: named axes over the ranks of a process group.

The counterpart of ``shard_map``'s named mesh axes
(``src/repro/launch/mesh.py::make_test_mesh``).  The axes
``("pod", "data", "model")`` are laid out row-major over the world ranks,
as ``jax.make_mesh`` lays out devices: rank = (pod * data + d) * model + m.
Each axis (and the data-parallel pair ``("pod", "data")``) gets one
subgroup per fixed coordinate of the other axes, made with
``dist.new_group`` on every rank, for every group, in one fixed order:
``new_group`` is collective, and a rank that skipped a group would leave
the others waiting in it.  ``torch.distributed`` sorts a group's ranks, so
a member's group rank is its coordinate along the group's axes (asserted).

The model axis also gets the split-TP subgroups of every domain count
``nd`` that divides it (``1 < nd < model``): the ``nd`` blocks of
``model / nd`` coordinates (the reference's
``collectives._domain_groups``) and the cross-domain groups of the
coordinates with one index inside their domain (``[[dd * h + i for dd in
range(nd)] for i in range(h)]``, ``transformer._split_tp_seq_gather``).

``lax.axis_index(name)`` -> :meth:`RankMesh.axis_index`;
``lax.all_to_all(..., axis_name=name)`` and ``lax.pmean(..., name)`` ->
collectives on :meth:`RankMesh.group`; ``lax.all_gather(x, name,
axis_index_groups=...)`` -> :meth:`RankMesh.all_gather`;
``lax.ppermute(x, name, perm)`` -> :meth:`RankMesh.ppermute`.
An axis argument may also name several axes (``("pod", "data")``, the
flattened data-parallel axis, row-major as ``axis_index`` counts it).

With ``dp_servers`` the data-parallel pair also gets the groups that a
two-level reduction over ``s`` servers of ``dp / s`` ranks needs, in fabric
order (server-major, as ``ClusterSpec.build`` numbers its nodes): the
``s`` server groups of consecutive dp indices and the rail groups of the
ranks with one index inside their server (``compression.
hierarchical_psum_flat``).

Differentiable exchanges.  Training differentiates through the
collectives, so each one that moves floating data is also an
``autograd.Function`` whose backward is its transpose over the same
members: the tiled :func:`all_to_all` is its own; :meth:`RankMesh.
all_gather`'s is a reduce-scatter (sum); :meth:`RankMesh.ppermute`'s the
inverse permutation; :func:`reduce_scatter`'s an all-gather.  These are the
transposes of ``lax``'s collectives when every rank's cotangent is its own
(the gradient of the sum of the ranks' objectives).  Over the model axis,
where every rank computes the same loss, the two Megatron operators say
how a value crosses between replicated and partial: :func:`reduce_model`
(*g*: ``all_reduce`` forward, identity backward) ends a row-parallel
product, and :func:`copy_to_model` (*f*: identity forward, ``all_reduce``
backward) starts a column-parallel one on an input whole on every model
rank.  ``torch.distributed.nn.functional.all_reduce`` sums the cotangents
in its backward, so a loss that every model rank computes alike would get
M times its gradient there.  A partial sum that each model rank then uses
differently (the sum of squares of a norm over channels split on the
model axis, which scales only the rank's own channels) takes
:func:`sum_model`: the sum forward and the sum backward, since each
rank's cotangent of the sum is its own channels' and the gradient of its
partial is all of them.  Without ``requires_grad`` (serving) each call
runs the plain collective and records nothing.

Transports.  A :class:`RankMesh` built with ``transport="card"`` (every
rank of the world on one device, under a gloo process group) wraps each of
its groups in a :class:`CardGroup`: the five exchanges below then move
their bytes through memory the group's processes share instead of through
gloo, which stages every CUDA tensor through the host and sends it over
TCP loopback.  A CUDA tensor goes through a staging buffer on the card a
member (a tensor of PyTorch's allocator, opened by its peers from CUDA IPC
handles), a CPU tensor through
host shared memory; the members meet at barriers on a flag array in host
shared memory.  The gloo subgroup stays beside it for control traffic
(:func:`process_group`).  :meth:`CardGroup.exchange` spells out one
exchange.

:class:`ShapeMesh` is a :class:`RankMesh` of the same axes and shape seen
from one chosen rank, with no process group: its groups are
:class:`ShapeGroup` objects, on which every exchange of this module (and its
autograd transpose) returns a tensor of the right shape on the input's
device (the meta device, in the dry run) without moving data, and
appends ``(kind, axis, wire bytes, bytes, shape)`` to the mesh's ``log``:
the output's, and
kind as XLA names it, the slowest axis the group spans, and the bytes
this rank puts on the wire by the ring and pairwise factors of the
reference's HLO reader (``src/repro/launch/hlo_analysis.py``):
all-gather out x (g-1)/g, reduce-scatter out x (g-1), all-reduce 2 x
(g-1)/g, all-to-all (g-1)/g, collective-permute the bytes a rank sends.
"""

from __future__ import annotations

import itertools
import math
import mmap
import os
import secrets
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing  # noqa: F401 — registers the tensor reductions
from multiprocessing.reduction import ForkingPickler

AXES = ("pod", "data", "model")
TRANSPORTS = ("backend", "card")
# the most bytes a member stages in one exchange of the card transport
PIECE_BYTES = 64 << 20
# the groups every rank makes, in this order
GROUPS = (("pod",), ("data",), ("model",), ("pod", "data"))
# the concatenating all-gather (``all_gather_into_tensor`` before torch
# renamed it)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
# and the summing reduce-scatter (``reduce_scatter_tensor`` before)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def split_tp_members(m: int) -> list[tuple[int, ...]]:
    """The member coordinates of every split-TP subgroup of a model axis of
    ``m``: for each domain count ``nd`` with ``1 < nd < m`` dividing ``m``,
    the domains (blocks of ``h = m / nd``) and the cross-domain groups."""
    return two_level_members(m, range(2, m))


class _Axes:
    """The axes of a mesh seen from one rank: sizes, coordinates, and the
    exchanges that take a group of it (``group`` / ``subgroup``)."""

    shape: dict
    coords: dict

    def axis_size(self, *names: str) -> int:
        return math.prod(self.shape[a] for a in names)

    def axis_index(self, *names: str) -> int:
        """This rank's coordinate along ``names`` (row-major over them)."""
        idx = 0
        for a in names:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def all_gather(self, x: torch.Tensor, axis,
                   members=None) -> torch.Tensor:
        """``lax.all_gather(x, axis, axis_index_groups=...)``: ``x`` of every
        rank of ``members`` (default: the whole axis), stacked in member
        order: ``[len(members), *x.shape]``.  Its backward sums each
        member's cotangent of this rank's block (a reduce-scatter)."""
        names = axis_names(axis)
        members = tuple(range(self.axis_size(*names)) if members is None
                        else members)
        if len(members) == 1:
            return x[None]
        group = self.subgroup(names, members)
        if x.requires_grad:
            return _AllGather.apply(x, group, len(members))
        return _all_gather(x, group, len(members))

    def ppermute(self, x: torch.Tensor, axis, perm) -> torch.Tensor:
        """``lax.ppermute(x, axis, perm)``: ``perm`` is ``(source,
        destination)`` pairs of the axis's coordinates, each coordinate at
        most once on each side; a rank that no pair names as destination
        gets zeros.  One ``all_to_all_single`` over the axis in which each
        rank sends ``x`` to at most one rank and receives at most one
        rank's, a single nonzero split each way.  Its backward is the
        inverse permutation of the cotangents."""
        names = axis_names(axis)
        n = self.axis_size(*names)
        dst = dict(perm)
        src = {d: s for s, d in perm}
        if (len(dst) != len(perm) or len(src) != len(perm)
                or not set(dst) | set(src) <= set(range(n))):
            raise ValueError(f"{perm} is not a permutation of {n} ranks")
        args = (self.group(*names), n, self.axis_index(*names), dst, src)
        if x.requires_grad:
            return _PPermute.apply(x, *args)
        return _ppermute(x, *args)


class RankMesh(_Axes):
    """``shape`` = (pods, data, model) over the default process group (a
    mesh of one rank needs none); ``timeout`` bounds each subgroup's
    collectives (``dist.new_group``'s own default is the backend's, which
    may be far longer than the default group's).  ``transport``:
    "backend" (the process group's own collectives) or "card" (every group
    a :class:`CardGroup`; the caller vouches that every rank lies on one
    device, as ``launch.ranks.init_rank`` checks; ``piece_bytes`` its
    exchanges' piece)."""

    def __init__(self, shape, *, timeout=None, dp_servers=(),
                 transport: str = "backend",
                 piece_bytes: int = PIECE_BYTES):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r}: one of {TRANSPORTS}")
        if transport == "card" and dist.is_initialized() and \
                dist.get_backend() != "gloo":
            raise ValueError(f"the card transport runs beside gloo, not "
                             f"{dist.get_backend()}")
        self.transport = transport
        self._piece_bytes = int(piece_bytes)
        self._timeout_s = (timeout.total_seconds() if timeout is not None
                           else 1800.0)
        self.shape = dict(zip(AXES, (int(s) for s in shape), strict=True))
        size = math.prod(self.shape.values())
        world = dist.get_world_size() if dist.is_initialized() else 1
        if size != world:
            raise ValueError(f"mesh {self.shape} holds {size} ranks, the "
                             f"process group {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        dims = tuple(self.shape.values())
        self.coords = dict(zip(AXES, _unravel(self.rank, dims)))
        self._groups = {}
        coords = [dict(zip(AXES, _unravel(r, dims))) for r in range(size)]
        for names in GROUPS:
            if math.prod(self.shape[a] for a in names) == 1:
                continue            # every rank skips the same groups
            others = [a for a in AXES if a not in names]
            for fixed in itertools.product(
                    *(range(self.shape[a]) for a in others)):
                pin = dict(zip(others, fixed))
                ranks = [r for r in range(size)
                         if all(coords[r][a] == c for a, c in pin.items())]
                group = dist.new_group(ranks, timeout=timeout)
                if self.rank in ranks:
                    self._groups[names] = self._wrap(group, ranks)
                    if dist.get_rank(group) != self.axis_index(*names):
                        raise AssertionError(
                            f"group rank {dist.get_rank(group)} of rank "
                            f"{self.rank} is not its {names} coordinate")
        for members in split_tp_members(self.shape["model"]):
            for pod, data in itertools.product(range(self.shape["pod"]),
                                               range(self.shape["data"])):
                ranks = [(pod * self.shape["data"] + data)
                         * self.shape["model"] + c for c in members]
                group = dist.new_group(ranks, timeout=timeout)
                if self.rank in ranks:
                    self._groups[("model", members)] = self._wrap(group,
                                                                  ranks)
        dp = ("pod", "data")
        self.dp_servers = tuple(sorted({int(s) for s in dp_servers}))
        for members in two_level_members(self.axis_size(*dp),
                                         self.dp_servers):
            for m in range(self.shape["model"]):
                ranks = [i * self.shape["model"] + m for i in members]
                group = dist.new_group(ranks, timeout=timeout)
                if self.rank in ranks:
                    self._groups[(dp, members)] = self._wrap(group, ranks)
        self._world = (self._wrap(dist.group.WORLD, list(range(size)))
                       if transport == "card" and size > 1 else None)

    def _wrap(self, group, ranks):
        if self.transport != "card":
            return group
        return CardGroup(group, ranks, timeout_s=self._timeout_s,
                         piece_bytes=self._piece_bytes)

    def staging_bytes(self) -> dict:
        """The card transport's staging this rank holds over its groups
        (:meth:`CardGroup.staging_bytes`, summed)."""
        out = {"card": 0, "host": 0}
        for g in [*self._groups.values(), self._world]:
            if isinstance(g, CardGroup):
                for k, v in g.staging_bytes().items():
                    out[k] += v
        return out

    def close(self) -> None:
        """Free every group's staging (collective over the world, each
        rank's groups in one order)."""
        for g in [*self._groups.values(), self._world]:
            if isinstance(g, CardGroup):
                g.close()

    def group(self, *names: str):
        """The subgroup of the ranks that differ only along ``names``."""
        if self.axis_size(*names) == 1:
            raise ValueError(f"axis {names} has one rank: no group")
        return self._groups[tuple(names)]

    def world_group(self):
        """The group of every rank: the default process group (None), or
        its :class:`CardGroup` under the card transport."""
        return self._world

    def subgroup(self, axis, members) -> object:
        """The group of the ranks at coordinates ``members`` of ``axis`` (a
        name or a tuple of names; this rank's coordinate among them), the
        others fixed at this rank's: the whole axis's group, a split-TP
        subgroup of the model axis, or a server or rail group of the
        data-parallel pair."""
        names = axis_names(axis)
        members = tuple(members)
        if self.axis_index(*names) not in members:
            raise ValueError(f"rank at {names} {self.axis_index(*names)} is "
                             f"not in {members}")
        if members == tuple(range(self.axis_size(*names))):
            return self.group(*names)
        key = (names[0] if len(names) == 1 else names, members)
        if key not in self._groups:
            raise ValueError(f"no group of {names} members {members} (a "
                             f"server count the mesh was not built with: "
                             f"dp_servers={self.dp_servers})")
        return self._groups[key]


class ShapeMesh(_Axes):
    """A :class:`RankMesh`'s axes and shape seen from rank ``rank``, with
    no process group: the dry run's mesh.  Its groups are
    :class:`ShapeGroup` objects (any member set of an axis, as the split-TP,
    server and rail groups of a real mesh), and every exchange over them
    appends its record to :attr:`log` (the module docstring)."""

    def __init__(self, shape, *, rank: int = 0, dp_servers=()):
        self.shape = dict(zip(AXES, (int(s) for s in shape), strict=True))
        size = math.prod(self.shape.values())
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a mesh of {size}")
        self.rank = rank
        self.coords = dict(zip(AXES, _unravel(rank, tuple(
            self.shape.values()))))
        self.dp_servers = tuple(sorted({int(s) for s in dp_servers}))
        self.log: list[tuple] = []

    def group(self, *names: str) -> "ShapeGroup":
        if self.axis_size(*names) == 1:
            raise ValueError(f"axis {names} has one rank: no group")
        return ShapeGroup(self, tuple(names),
                          tuple(range(self.axis_size(*names))))

    def world_group(self) -> "ShapeGroup":
        """The group of every rank of the mesh."""
        return ShapeGroup(self, AXES, tuple(range(self.axis_size(*AXES))))

    def subgroup(self, axis, members) -> "ShapeGroup":
        names = axis_names(axis)
        members = tuple(members)
        if self.axis_index(*names) not in members:
            raise ValueError(f"rank at {names} {self.axis_index(*names)} is "
                             f"not in {members}")
        return ShapeGroup(self, names, members)

    def bytes_by(self, what: str = "axis") -> dict:
        """The log's wire bytes summed by ``axis`` or by ``kind``."""
        col = {"kind": 0, "axis": 1}[what]
        out: dict = {}
        for rec in self.log:
            out[rec[col]] = out.get(rec[col], 0) + rec[2]
        return out


class ShapeGroup:
    """The members ``members`` of the axes ``names`` of a
    :class:`ShapeMesh`, the other coordinates at its rank's."""

    def __init__(self, mesh: ShapeMesh, names: tuple, members: tuple):
        self.mesh, self.names, self.members = mesh, names, members
        # the slowest axis the members span (the reference's
        # ``MeshLayout.classify``)
        dims = tuple(mesh.shape[a] for a in names)
        spans = [len({c[i] for c in (_unravel(m, dims) for m in members)})
                 for i in range(len(names))]
        self.axis = next((a for a, n in zip(names, spans) if n > 1),
                         names[-1])

    def record(self, kind: str, out: torch.Tensor,
               sends: bool = True) -> torch.Tensor:
        g = len(self.members)
        nbytes = out.numel() * out.element_size()
        wire = {"all-gather": nbytes * (g - 1) // g,
                "reduce-scatter": nbytes * (g - 1),
                "all-reduce": 2 * nbytes * (g - 1) // g,
                "all-to-all": nbytes * (g - 1) // g,
                "collective-permute": nbytes if sends else 0}[kind]
        self.mesh.log.append((kind, self.axis, wire, nbytes,
                              tuple(out.shape)))
        return out


class CardGroup:
    """The members ``ranks`` (world ranks, in group-rank order) of the gloo
    subgroup ``pg``, all on one device, exchanging through memory their
    processes share; ``pg`` stays for the setup and for control traffic.

    One exchange (:meth:`exchange`): a member copies its input into its own
    staging slot (a CUDA tensor on its current stream, which it then
    synchronises), meets the group at a barrier, and then copies the blocks
    it takes out of every member's slot into its output, on the device.
    Each member's slot has two halves used in turn, so the next exchange's
    barrier is also the one that comes before this half is written again:
    a member synchronises the reads of its last exchange before it enters
    a barrier.  An exchange moves at most ``piece_bytes`` a member
    (:data:`PIECE_BYTES` by default); a larger collective runs as pieces
    along its elements.  The slots are
    kept for the group and grown on demand to a power of two (every member
    of a collective passes the same bytes, so the members grow together),
    so handles pass once a size.

    On the card a slot is a tensor of each member from PyTorch's
    allocator, opened by its peers from the CUDA IPC handle its pickle
    carries (as ``torch.multiprocessing`` passes CUDA tensors); on the host
    it is shared memory.
    The barrier is a flag a member in host shared memory: a member raises
    its own to the barrier's count and waits until every flag has reached
    it (at most ``timeout_s``, then it raises).  The byte movers give the
    bits gloo gives; the sums add the members' blocks in group-rank order
    in the tensor's dtype, so every member holds the same bits."""

    LEAST_SLOT = 1 << 20

    def __init__(self, pg, ranks, *, timeout_s: float = 1800.0,
                 piece_bytes: int = PIECE_BYTES):
        self.pg = pg
        self.piece_bytes = int(piece_bytes)
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.me = dist.get_rank(pg)
        self.timeout_s = float(timeout_s)
        self.barriers = 0           # met so far: the flags' count
        self._flags = None          # (segment, int64 view), a line a member
        self._host = None           # (slot bytes, segment, uint8 tensor)
        self._card = None           # _CardSlots
        self._half = 0

    def _shared_host(self, nbytes: int) -> mmap.mmap:
        """Host shared memory every member maps (collective): made by
        member 0, opened by name by the others and unlinked once all have
        it, so nothing outlives the processes."""
        import _posixshmem
        name = [f"/repro_card_{os.getpid()}_{secrets.token_hex(8)}"
                if self.me == 0 else None]
        if self.me == 0:
            fd = _posixshmem.shm_open(name[0], os.O_CREAT | os.O_EXCL
                                      | os.O_RDWR, mode=0o600)
            os.ftruncate(fd, nbytes)
        dist.broadcast_object_list(name, src=self.ranks[0], group=self.pg)
        if self.me != 0:
            fd = _posixshmem.shm_open(name[0], os.O_RDWR, mode=0o600)
        try:
            seg = mmap.mmap(fd, nbytes)
        finally:
            os.close(fd)
        dist.barrier(group=self.pg)
        if self.me == 0:
            _posixshmem.shm_unlink(name[0])
        return seg

    def barrier(self) -> None:
        """Meet every member: raise this member's flag to the next count,
        then wait until every flag has reached it."""
        if self._flags is None:
            seg = self._shared_host(64 * self.size)
            self._flags = (seg, np.frombuffer(seg, dtype=np.int64)[::8])
        flags = self._flags[1]
        self.barriers += 1
        count = self.barriers
        flags[self.me] = count
        polls, deadline = 0, None
        while flags.min() < count:
            polls += 1
            if polls < 64:
                continue
            now = time.monotonic()
            if deadline is None:
                deadline = now + self.timeout_s
            elif now > deadline:
                raise TimeoutError(
                    f"card transport: group members "
                    f"{np.flatnonzero(flags < count).tolist()} of "
                    f"{self.ranks} missed barrier {count} for "
                    f"{self.timeout_s} s")
            if polls < 4096:
                os.sched_yield()
            else:
                time.sleep(2e-5)

    def exchange(self, src: torch.Tensor, write: bool = True) -> list:
        """Stage ``src`` (at most ``piece_bytes``; any strides) in this
        member's slot of the current half, unless ``write`` is False, meet
        the group, and return every member's slot as a contiguous tensor of
        ``src``'s dtype and shape, in group-rank order, for the caller to
        read on the device (on its current stream) before its next
        exchange."""
        nbytes = src.numel() * src.element_size()
        slot = _slot_bytes(nbytes, self.LEAST_SLOT)
        if src.is_cuda:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("card transport: an exchange meets its "
                                   "group at a host barrier, which a CUDA "
                                   "graph cannot capture")
            if self._card is None or self._card.slot < nbytes:
                old = self._card
                self._card = _CardSlots(self, src.device, slot)
                if old is not None:
                    self._retire(old)
            slot = self._card.slot
            base = [v[self._half * slot:(self._half + 1) * slot]
                    for v in self._card.views]
        elif src.device.type == "cpu":
            if self._host is None or self._host[0] < nbytes:
                seg = self._shared_host(2 * self.size * slot)
                self._host = (slot, seg, torch.frombuffer(seg,
                                                          dtype=torch.uint8))
            slot, mem = self._host[0], self._host[2]
            at = self._half * self.size
            base = [mem[(at + m) * slot:(at + m + 1) * slot]
                    for m in range(self.size)]
        else:
            raise ValueError(f"card transport: no exchange on {src.device}")
        slots = [b[:nbytes].view(src.dtype).view(src.shape) for b in base]
        if write and nbytes:
            slots[self.me].copy_(src)
        if src.is_cuda:
            self._card.quiesce()    # the staged bytes and the last reads
        self.barrier()
        self._half ^= 1
        return slots

    def _retire(self, slots: "_CardSlots") -> None:
        """Free ``slots`` (collective): every member's reads of them done,
        its peers' mappings closed, then its own buffer."""
        slots.quiesce()
        self.barrier()
        slots.unmap()
        self.barrier()
        slots.release()

    def close(self) -> None:
        """Free this group's staging (collective: every member calls it);
        a later exchange makes it again."""
        if self._card is not None:
            self._retire(self._card)
            self._card = None
        self._host = None

    def staging_bytes(self) -> dict:
        """Bytes this member's staging holds: its own slots on the card,
        and the group's host shared memory it maps."""
        return {"card": 2 * self._card.slot if self._card else 0,
                "host": 2 * self.size * self._host[0] if self._host else 0}

    def _pieces(self, length: int, rows: int, itemsize: int):
        step = max(1, self.piece_bytes // (rows * itemsize))
        return [(lo, min(length, lo + step))
                for lo in range(0, length, step)] or [(0, 0)]

    # the five collectives, each on [rows, L] views pieced along L
    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.view(-1) if x.is_contiguous() else x.contiguous().view(-1)
        out = x.view(-1) if x.is_contiguous() else torch.empty_like(flat)
        for lo, hi in self._pieces(flat.numel(), 1, x.element_size()):
            _sum_into(out[lo:hi], self.exchange(flat[lo:hi]))
        if not x.is_contiguous():
            x.copy_(out.view(x.shape))
        return x

    def all_to_all(self, x: torch.Tensor, out: torch.Tensor
                   ) -> torch.Tensor:
        n, me = self.size, self.me
        x2, out2 = x.view(n, x.numel() // n), out.view(n, x.numel() // n)
        for lo, hi in self._pieces(x2.shape[1], n, x.element_size()):
            slots = self.exchange(x2[:, lo:hi])
            if hi - lo == x2.shape[1]:
                torch.cat([s[me:me + 1] for s in slots], out=out2)
            else:
                for m, s in enumerate(slots):
                    out2[m, lo:hi].copy_(s[me])
        return out

    def all_gather(self, flat: torch.Tensor, out: torch.Tensor
                   ) -> torch.Tensor:
        out2 = out.view(self.size, flat.numel())
        for lo, hi in self._pieces(flat.numel(), 1, flat.element_size()):
            slots = self.exchange(flat[lo:hi])
            if hi - lo == flat.numel():
                torch.cat(slots, out=out)
            else:
                for m, s in enumerate(slots):
                    out2[m, lo:hi].copy_(s)
        return out

    def reduce_scatter(self, x: torch.Tensor, out: torch.Tensor
                       ) -> torch.Tensor:
        x2, flat = x.view(self.size, out.numel()), out.view(-1)
        for lo, hi in self._pieces(x2.shape[1], self.size, x.element_size()):
            slots = self.exchange(x2[:, lo:hi])
            _sum_into(flat[lo:hi], [s[self.me] for s in slots])
        return out

    def ppermute(self, x: torch.Tensor, out: torch.Tensor, me: int,
                 dst: dict, src: dict) -> torch.Tensor:
        flat, oflat = x.view(-1), out.view(-1)
        for lo, hi in self._pieces(flat.numel(), 1, x.element_size()):
            slots = self.exchange(flat[lo:hi], write=me in dst)
            if me in src:
                oflat[lo:hi].copy_(slots[src[me]])
        return out


def _slot_bytes(need: int, least: int) -> int:
    """The slot a member keeps for ``need`` bytes: a power of two."""
    return max(least, 1 << max(0, need - 1).bit_length())


def _sum_into(out: torch.Tensor, parts: list) -> torch.Tensor:
    """``out`` = parts[0] + parts[1] + ..., added in this order in
    ``out``'s dtype."""
    if len(parts) == 1:
        return out.copy_(parts[0])
    torch.add(parts[0], parts[1], out=out)
    for p in parts[2:]:
        out.add_(p)
    return out


def _device_key(device: torch.device) -> tuple:
    p = torch.cuda.get_device_properties(device)
    return (str(getattr(p, "uuid", "")), getattr(p, "pci_domain_id", -1),
            getattr(p, "pci_bus_id", -1), getattr(p, "pci_device_id", -1),
            p.name)


def _allocate_shareable(nbytes: int, device: torch.device) -> torch.Tensor:
    """``nbytes`` of uint8 on ``device`` from PyTorch's allocator, in a
    segment CUDA IPC can share: with expandable segments on (as the rank
    launcher sets them) the allocator is switched to plain segments for
    this one allocation."""
    conf = (os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "") + ","
            + os.environ.get("PYTORCH_ALLOC_CONF", ""))
    expandable = "expandable_segments:True" in conf.replace(" ", "")
    if expandable:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    try:
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    finally:
        if expandable:
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:True")


def _open_slot(raw: bytes, member: int, ranks: tuple) -> torch.Tensor:
    """A peer's slot from its pickled CUDA tensor (``ForkingPickler``: a
    CUDA IPC handle); a handle that does not open raises."""
    try:
        return ForkingPickler.loads(raw)
    except Exception as e:      # noqa: BLE001 — re-raised with the group
        raise RuntimeError(f"card transport: the slot of member {member} "
                           f"of group {list(ranks)} did not open: {e}"
                           ) from e


class _CardSlots:
    """One :class:`CardGroup`'s staging on the card (made collectively):
    this member's buffer of two halves of ``slot`` bytes (``mine``, a
    uint8 tensor of PyTorch's allocator) and every member's (``views``,
    in group-rank order), its peers' opened from the CUDA IPC handles
    their pickled tensors carry."""

    def __init__(self, group: CardGroup, device: torch.device, slot: int):
        self.slot, self.device = slot, device
        self._streams: list = []
        self.mine = _allocate_shareable(2 * slot, device)
        every = [None] * group.size
        dist.all_gather_object(every, (_device_key(device), slot, bytes(
            ForkingPickler.dumps(self.mine))), group=group.pg)
        if len({e[0] for e in every}) != 1:
            raise RuntimeError(f"card transport: the members of group "
                               f"{group.ranks} lie on different devices: "
                               f"{[e[0] for e in every]}")
        if len({e[1] for e in every}) != 1:
            raise RuntimeError(f"card transport: the members of group "
                               f"{group.ranks} passed different bytes: "
                               f"slots {[e[1] for e in every]}")
        self.views = [self.mine if m == group.me else
                      _open_slot(raw, m, group.ranks)
                      for m, (*_, raw) in enumerate(every)]

    def quiesce(self) -> None:
        """Wait for this member's queued copies: the current stream (the
        bytes just staged) and the stream of its last exchange's reads."""
        now = torch.cuda.current_stream(self.device)
        now.synchronize()
        for s in self._streams:
            if s != now:
                s.synchronize()
        self._streams = [now]

    def unmap(self) -> None:
        """Drop the peers' buffers this member opened."""
        self.views = []

    def release(self) -> None:
        """Drop this member's own buffer (once no peer maps it)."""
        self.mine = None


def process_group(group):
    """The process group behind a mesh group, for control traffic through
    ``torch.distributed``: a :class:`CardGroup`'s gloo subgroup, else the
    group itself."""
    return group.pg if isinstance(group, CardGroup) else group


def axis_names(axis) -> tuple[str, ...]:
    """An axis argument as a tuple of axis names."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def two_level_members(n: int, counts) -> list[tuple[int, ...]]:
    """The member coordinates of the groups of an axis of ``n`` split into
    two levels, for each count ``s`` of ``counts`` that does so (``1 < s <
    n`` dividing ``n``): ``s`` blocks of ``p = n / s`` consecutive
    coordinates (split-TP domains, servers), then ``p`` groups of the
    coordinates with one position in their block (cross-domain groups,
    rails)."""
    out: list[tuple[int, ...]] = []
    for s in counts:
        if not 1 < s < n or n % s:
            continue
        p = n // s
        for members in ([tuple(range(sv * p, (sv + 1) * p))
                         for sv in range(s)]
                        + [tuple(sv * p + i for sv in range(s))
                           for i in range(p)]):
            if len(members) > 1 and members not in out:
                out.append(members)
    return out


# ---------------------------------------------------------------------------
# the collectives and their transposes
# ---------------------------------------------------------------------------

def _all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place."""
    if isinstance(group, ShapeGroup):
        return group.record("all-reduce", x)
    if isinstance(group, CardGroup):
        return group.all_reduce_(x)
    dist.all_reduce(x, group=group)
    return x


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    if isinstance(group, ShapeGroup):
        return group.record("all-to-all", out)
    if isinstance(group, CardGroup):
        return group.all_to_all(x, out)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    flat = x.contiguous().reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    if isinstance(group, ShapeGroup):
        return group.record("all-gather", out.view(n, *x.shape))
    if isinstance(group, CardGroup):
        return group.all_gather(flat, out).view(n, *x.shape)
    _ALL_GATHER(out, flat, group=group)
    return out.view(n, *x.shape)


def _reduce_scatter(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n, *rest] summed over the group, this member's block: [*rest]."""
    x = x.contiguous()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    if isinstance(group, ShapeGroup):
        return group.record("reduce-scatter", out)
    if isinstance(group, CardGroup):
        return group.reduce_scatter(x, out)
    _REDUCE_SCATTER(out.view(-1), x.view(-1), group=group)
    return out


def _ppermute(x, group, n, me, dst, src) -> torch.Tensor:
    x = x.contiguous()
    if isinstance(group, ShapeGroup):
        return group.record("collective-permute", torch.empty_like(x),
                            sends=me in dst)
    rows = x.shape[0]
    send, recv = [0] * n, [0] * n
    if me in dst:
        send[dst[me]] = rows
    if me in src:
        recv[src[me]] = rows
    out = torch.empty_like(x) if me in src else torch.zeros_like(x)
    if isinstance(group, CardGroup):
        return group.ppermute(x, out, me, dst, src)
    dist.all_to_all_single(out if me in src else out[:0],
                           x if me in dst else x[:0], recv, send,
                           group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.n), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _reduce_scatter(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.n), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, dst, src):
        ctx.args = (group, n, me, src, dst)      # the inverse permutation
        return _ppermute(x, group, n, me, dst, src)

    @staticmethod
    def backward(ctx, g):
        return (_ppermute(g, *ctx.args),) + (None,) * 5


def _block(x: torch.Tensor, n: int, index: int, dim: int) -> torch.Tensor:
    """Block ``index`` of ``n`` along ``dim`` of ``x``, as a tensor of its
    own: a view would keep all of ``x`` alive as long as the block lives
    (under remat each block's output is kept for the backward)."""
    part = x.shape[dim] // n
    return x.narrow(dim, index * part, part).contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.args = (group, n, dim)
        return _block(x, n, index, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        parts = _all_gather(g.movedim(dim, 0), group, n)  # [n, part, ...]
        return (parts.flatten(0, 1).movedim(0, dim),) + (None,) * 4


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_reduce_(x.clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group) / ctx.n, None, None


class _ReduceModel(torch.autograd.Function):
    """*g*: the sum over the group forward (in place), the identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        _all_reduce_(x, group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumModel(torch.autograd.Function):
    """The sum over the group forward and backward: for a partial that
    every rank of the group then uses differently."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


class _CopyToModel(torch.autograd.Function):
    """*f*: the identity forward, the sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`` over
    ``group``: the R equal blocks of dim 0 go one to each group rank, and
    the blocks received are stacked in group-rank order.  Its own
    transpose."""
    if x.requires_grad:
        return _AllToAll.apply(x, group)
    return _all_to_all(x, group)


def reduce_scatter(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """x [n, *rest] summed over the ``n`` ranks of ``group``, this rank's
    block [*rest] (``lax.psum_scatter(..., tiled=False)``); backward: the
    all-gather of the cotangents."""
    if x.requires_grad:
        return _ReduceScatter.apply(x, group, n)
    return _reduce_scatter(x, group, n)


def split(x: torch.Tensor, group, n: int, index: int,
          dim: int = 1) -> torch.Tensor:
    """This rank's block ``index`` of ``n`` along ``dim`` of a tensor that
    every rank of ``group`` holds alike; backward: the all-gather of the
    blocks' cotangents, so the whole tensor's cotangent is again the same
    on every rank."""
    if x.requires_grad:
        return _Split.apply(x, group, n, index, dim)
    return _block(x, n, index, dim)


def mean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``lax.pmean(x, axis)`` over the ``n`` ranks of ``group``; backward:
    the mean of the cotangents (its transpose when each rank's cotangent is
    its own objective's, as over data-parallel ranks)."""
    if x.requires_grad:
        return _Mean.apply(x, group, n)
    return _all_reduce_(x.clone(), group) / n


def reduce_model(x: torch.Tensor, group) -> torch.Tensor:
    """*g*: ``x`` summed over ``group``, in place; identity backward (the
    sum's value is the same on every rank, and so is its cotangent)."""
    if x.requires_grad:
        return _ReduceModel.apply(x, group)
    return _all_reduce_(x, group)


def sum_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor); backward: the
    cotangents summed over ``group`` too.  For a partial that each rank
    then uses on its own part only, so that each rank's cotangent of the
    sum differs and the gradient of every partial is their sum (where
    what follows the sum is replicated, :func:`reduce_model`'s identity
    backward is the one)."""
    if x.requires_grad:
        return _SumModel.apply(x, group)
    return _all_reduce_(x.clone(), group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """*f*: ``x`` as it is; backward: the cotangents summed over
    ``group`` (each rank's holds the part its own shard of the weights
    produced)."""
    if x.requires_grad:
        return _CopyToModel.apply(x, group)
    return x


def _unravel(rank: int, dims) -> tuple[int, ...]:
    out = []
    for d in reversed(dims):
        rank, c = divmod(rank, d)
        out.append(c)
    return tuple(reversed(out))
