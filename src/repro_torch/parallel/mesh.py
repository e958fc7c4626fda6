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
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")
# the groups every rank makes, in this order
GROUPS = (("pod",), ("data",), ("model",), ("pod", "data"))
# the concatenating all-gather (``all_gather_into_tensor`` before torch
# renamed it)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def split_tp_members(m: int) -> list[tuple[int, ...]]:
    """The member coordinates of every split-TP subgroup of a model axis of
    ``m``: for each domain count ``nd`` with ``1 < nd < m`` dividing ``m``,
    the domains (blocks of ``h = m / nd``) and the cross-domain groups."""
    out: list[tuple[int, ...]] = []
    for nd in range(2, m):
        if m % nd:
            continue
        h = m // nd
        for members in ([tuple(range(i * h, (i + 1) * h)) for i in range(nd)]
                        + [tuple(dd * h + i for dd in range(nd))
                           for i in range(h)]):
            if len(members) > 1 and members not in out:
                out.append(members)
    return out


class RankMesh:
    """``shape`` = (pods, data, model) over the default process group (a
    mesh of one rank needs none); ``timeout`` bounds each subgroup's
    collectives (``dist.new_group``'s own default is the backend's, which
    may be far longer than the default group's)."""

    def __init__(self, shape, *, timeout=None):
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
                    self._groups[names] = group
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
                    self._groups[("model", members)] = group

    def axis_size(self, *names: str) -> int:
        return math.prod(self.shape[a] for a in names)

    def axis_index(self, *names: str) -> int:
        """This rank's coordinate along ``names`` (row-major over them)."""
        idx = 0
        for a in names:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, *names: str):
        """The subgroup of the ranks that differ only along ``names``."""
        if self.axis_size(*names) == 1:
            raise ValueError(f"axis {names} has one rank: no group")
        return self._groups[tuple(names)]

    def subgroup(self, axis: str, members) -> object:
        """The group of the ranks at coordinates ``members`` of ``axis``
        (this rank's among them), the others fixed at this rank's: the whole
        axis's group, or a split-TP subgroup of the model axis."""
        members = tuple(members)
        if self.coords[axis] not in members:
            raise ValueError(f"rank at {axis} {self.coords[axis]} is not in "
                             f"{members}")
        if members == tuple(range(self.shape[axis])):
            return self.group(axis)
        return self._groups[(axis, members)]

    def all_gather(self, x: torch.Tensor, axis: str,
                   members=None) -> torch.Tensor:
        """``lax.all_gather(x, axis, axis_index_groups=...)``: ``x`` of every
        rank of ``members`` (default: the whole axis), stacked in member
        order: ``[len(members), *x.shape]``."""
        members = tuple(range(self.shape[axis]) if members is None
                        else members)
        if len(members) == 1:
            return x[None]
        flat = x.contiguous().reshape(-1)
        out = torch.empty(len(members) * flat.numel(), dtype=x.dtype,
                          device=x.device)
        _ALL_GATHER(out, flat, group=self.subgroup(axis, members))
        return out.view(len(members), *x.shape)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """``lax.ppermute(x, axis, perm)``: ``perm`` is ``(source,
        destination)`` pairs of the axis's coordinates, each coordinate at
        most once on each side; a rank that no pair names as destination
        gets zeros.  One ``all_to_all_single`` over the axis in which each
        rank sends ``x`` to at most one rank and receives at most one
        rank's, a single nonzero split each way."""
        n = self.shape[axis]
        dst = dict(perm)
        src = {d: s for s, d in perm}
        if (len(dst) != len(perm) or len(src) != len(perm)
                or not set(dst) | set(src) <= set(range(n))):
            raise ValueError(f"{perm} is not a permutation of {n} ranks")
        me = self.coords[axis]
        x = x.contiguous()
        rows = x.shape[0]
        send, recv = [0] * n, [0] * n
        if me in dst:
            send[dst[me]] = rows
        if me in src:
            recv[src[me]] = rows
        out = torch.empty_like(x) if me in src else torch.zeros_like(x)
        dist.all_to_all_single(out if me in src else out[:0],
                               x if me in dst else x[:0], recv, send,
                               group=self.group(axis))
        return out


def _unravel(rank: int, dims) -> tuple[int, ...]:
    out = []
    for d in reversed(dims):
        rank, c = divmod(rank, d)
        out.append(c)
    return tuple(reversed(out))
