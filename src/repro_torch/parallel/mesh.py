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

``lax.axis_index(name)`` -> :meth:`RankMesh.axis_index`;
``lax.all_to_all(..., axis_name=name)`` and ``lax.pmean(..., name)`` ->
collectives on :meth:`RankMesh.group`.
"""

from __future__ import annotations

import itertools
import math

import torch.distributed as dist

AXES = ("pod", "data", "model")
# the groups every rank makes, in this order
GROUPS = (("pod",), ("data",), ("model",), ("pod", "data"))


class RankMesh:
    """``shape`` = (pods, data, model) over the default process group (a
    mesh of one rank needs none); ``timeout`` bounds each subgroup's
    collectives (``dist.new_group``'s own default is the backend's, which
    may be far longer than the default group's).  Only a model axis of 1 is
    taken: tensor parallelism inside the experts is a later slice of the
    port."""

    def __init__(self, shape, *, timeout=None):
        self.shape = dict(zip(AXES, (int(s) for s in shape), strict=True))
        if self.shape["model"] != 1:
            raise NotImplementedError(
                "a model axis above 1 (tensor parallelism inside experts, "
                "queue 1 item 6) is not ported yet")
        size = math.prod(self.shape.values())
        world = dist.get_world_size() if dist.is_initialized() else 1
        if size != world:
            raise ValueError(f"mesh {self.shape} holds {size} ranks, the "
                             f"process group {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        dims = tuple(self.shape.values())
        self.coords = dict(zip(AXES, _unravel(self.rank, dims)))
        self._groups = {}
        for names in GROUPS:
            if math.prod(self.shape[a] for a in names) == 1:
                continue            # every rank skips the same groups
            others = [a for a in AXES if a not in names]
            for fixed in itertools.product(
                    *(range(self.shape[a]) for a in others)):
                pin = dict(zip(others, fixed))
                ranks = [r for r in range(size)
                         if all(dict(zip(AXES, _unravel(r, dims)))[a] == c
                                for a, c in pin.items())]
                group = dist.new_group(ranks, timeout=timeout)
                if self.rank in ranks:
                    self._groups[names] = group
                    if dist.get_rank(group) != self.axis_index(*names):
                        raise AssertionError(
                            f"group rank {dist.get_rank(group)} of rank "
                            f"{self.rank} is not its {names} coordinate")

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


def _unravel(rank: int, dims) -> tuple[int, ...]:
    out = []
    for d in reversed(dims):
        rank, c = divmod(rank, d)
        out.append(c)
    return tuple(reversed(out))
