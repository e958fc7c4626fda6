"""The production meshes (the reference's ``src/repro/launch/mesh.py``).

  single-pod:  (1, 16, 16)   axes (pod, data, model)  = 256 ranks
  multi-pod:   (2, 16, 16)                            = 512 ranks

The port's mesh always has the three axes; a single pod is a pod axis of
one, which :class:`~repro_torch.parallel.context.ParallelContext` reads
as ``pod_axis=None``, as the reference's two-axis mesh.  Importing this
module touches no process group.

:func:`make_pctx` builds a :class:`~repro_torch.parallel.mesh.RankMesh`
over the live process group, which must hold exactly that many ranks
(the mesh's ``ValueError`` otherwise, as the reference fails without 512
devices); :func:`shape_pctx` builds a
:class:`~repro_torch.parallel.mesh.ShapeMesh` seen from one rank, for the
dry run (``launch/dryrun.py``), which needs no process group at all.
"""

from __future__ import annotations

from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.mesh import RankMesh, ShapeMesh


def production_shape(*, multi_pod: bool = False) -> tuple[int, int, int]:
    """(pods, data, model) of the production mesh."""
    return (2, 16, 16) if multi_pod else (1, 16, 16)


def make_production_mesh(*, multi_pod: bool = False, **kw) -> RankMesh:
    """The production mesh over the live process group (``kw``:
    ``RankMesh``'s ``timeout`` and ``dp_servers``)."""
    return RankMesh(production_shape(multi_pod=multi_pod), **kw)


def make_pctx(*, multi_pod: bool = False, **kw) -> ParallelContext:
    """A context over :func:`make_production_mesh` with the knobs ``kw``."""
    return ParallelContext(mesh=make_production_mesh(multi_pod=multi_pod),
                           pod_axis="pod" if multi_pod else None, **kw)


def shape_pctx(*, multi_pod: bool = False, rank: int = 0, shape=None,
               **kw) -> ParallelContext:
    """A context over a :class:`ShapeMesh` of the production mesh (or of
    ``shape``) seen from ``rank``, with the knobs ``kw``."""
    shape = tuple(shape or production_shape(multi_pod=multi_pod))
    return ParallelContext(mesh=ShapeMesh(shape, rank=rank),
                           pod_axis="pod" if shape[0] > 1 else None, **kw)
