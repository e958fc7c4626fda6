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

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")
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
    may be far longer than the default group's)."""

    def __init__(self, shape, *, timeout=None, dp_servers=()):
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
        dp = ("pod", "data")
        self.dp_servers = tuple(sorted({int(s) for s in dp_servers}))
        for members in two_level_members(self.axis_size(*dp),
                                         self.dp_servers):
            for m in range(self.shape["model"]):
                ranks = [i * self.shape["model"] + m for i in members]
                group = dist.new_group(ranks, timeout=timeout)
                if self.rank in ranks:
                    self._groups[(dp, members)] = group

    def group(self, *names: str):
        """The subgroup of the ranks that differ only along ``names``."""
        if self.axis_size(*names) == 1:
            raise ValueError(f"axis {names} has one rank: no group")
        return self._groups[tuple(names)]

    def world_group(self):
        """The group of every rank: the default process group (None)."""
        return None

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
    dist.all_reduce(x, group=group)
    return x


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    if isinstance(group, ShapeGroup):
        return group.record("all-to-all", out)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    flat = x.contiguous().reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    if isinstance(group, ShapeGroup):
        return group.record("all-gather", out.view(n, *x.shape))
    _ALL_GATHER(out, flat, group=group)
    return out.view(n, *x.shape)


def _reduce_scatter(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n, *rest] summed over the group, this member's block: [*rest]."""
    x = x.contiguous()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    if isinstance(group, ShapeGroup):
        return group.record("reduce-scatter", out)
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
