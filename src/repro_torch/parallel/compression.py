"""Gradient reductions beyond the flat ring: int8 error feedback and the
two-level (pod-aware) schedules.

Port of ``src/repro/parallel/compression.py`` over a
:class:`~repro_torch.parallel.mesh.RankMesh`: where the reference runs
inside ``shard_map`` with named axes, each function here takes the mesh and
the axis (a name, or a tuple of names such as the data-parallel pair
``("pod", "data")``), and its ``lax`` collectives are ``torch.distributed``
calls on that axis's groups.

* :func:`compressed_psum`: the mean at a quarter of the wire bytes, int8
  with a scale per chunk, and the quantisation residual returned for the
  next step (error feedback).  Lossy: the planner never picks it.
* :func:`hierarchical_psum`: reduce-scatter over the fast axis, ONE
  pre-reduced shard per pod across the slow one, all-gather back (the
  MultiWrite dual, relay-side reduction, applied to gradients).
* :func:`hierarchical_psum_flat`: the same two levels on one flat axis,
  grouped ``num_servers`` x ``npus_per_server`` in fabric order (the mesh's
  ``dp_servers`` groups).
* :func:`tree_compressed_psum`: :func:`compressed_psum` over a dict of
  gradients, a leaf at a time in slices of at most ``CHUNK`` elements (the
  reference concatenates every leaf into one fp32 vector, which for DBRX's
  1.32 G replicated parameters would be 5.3 GB a rank).

Every function returns the same bits on every rank of the axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel import mesh as mesh_ops

CHUNK = 1 << 25        # elements of one slice of a leaf's reduction


def _quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quant.  Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(g: torch.Tensor, ranks, axis,
                    err: Optional[torch.Tensor] = None):
    """Mean-reduce ``g`` over ``axis`` with int8 wire format + error
    feedback.  g: flat [N] (the caller flattens).  Returns (mean, new_err),
    fp32.

    1. chunk the (residual-corrected) gradient into R pieces;
    2. quantize each (int8, its fp32 scale) and ``all_to_all`` so that rank
       r collects every rank's chunk r, the scales riding along;
    3. dequantize and sum: the reduced chunk r;
    4. requantize it and ``all_gather``; the residual is what quantisation
       took from this rank's input in step 2."""
    names = mesh_ops.axis_names(axis)
    group = ranks.group(*names)
    r = ranks.axis_size(*names)
    me = ranks.axis_index(*names)
    n = g.shape[0]
    pad = (-n) % r
    gf = g.float()
    if err is not None:
        gf = gf + err
    gp = F.pad(gf, (0, pad))
    chunks = gp.reshape(r, -1)                                # [R, N/R]

    scales = torch.clamp(chunks.abs().amax(dim=1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(chunks / scales[:, None]), -127, 127
                    ).to(torch.int8)
    sent = q.float() * scales[:, None]                        # what we sent
    new_err = (gp - sent.reshape(-1))[:n]                     # residual

    mine_q = mesh_ops.all_to_all(q, group)                    # [R, N/R]
    # every rank's whole scale vector: row p holds rank p's scales, and
    # column ``me`` rank p's scale of the chunk this rank reduces
    mine_s = mesh_ops.all_to_all(scales.repeat(r), group).reshape(r, r)
    reduced = torch.sum(mine_q.float() * mine_s[:, me, None], dim=0) / r

    q2, s2 = _quantize_int8(reduced)
    full_q = ranks.all_gather(q2, names)                      # [R, N/R]
    full_s = ranks.all_gather(s2.reshape(1), names)           # [R, 1]
    out = (full_q.float() * full_s).reshape(-1)[:n]
    return out, new_err


def hierarchical_psum(g: torch.Tensor, ranks, pod_axis: str,
                      data_axis: str) -> torch.Tensor:
    """Pod-aware gradient mean of a flat ``g``: reduce-scatter over the
    fast intra-pod axis, ONE pre-reduced shard per pod crosses the slow
    axis, all-gather intra-pod.  Slow-axis bytes a rank: N/D (the §3.3
    bottleneck-link principle applied to the reduction direction)."""
    d = ranks.axis_size(data_axis)
    pods = ranks.axis_size(pod_axis)
    n = g.shape[0]
    gp = F.pad(g.float(), (0, (-n) % d)).reshape(d, -1)
    mine = (mesh_ops.reduce_scatter(gp, ranks.group(data_axis), d)
            if d > 1 else gp[0].clone())                      # [N/D]
    if pods > 1:
        mesh_ops._all_reduce_(mine, ranks.group(pod_axis))
    full = ranks.all_gather(mine, data_axis).reshape(-1)[:n]
    return full / (d * pods)


def hierarchical_psum_flat(g: torch.Tensor, ranks, axis,
                           num_servers: int) -> torch.Tensor:
    """:func:`hierarchical_psum` on a single flat axis, with the two levels
    taken from the FABRIC: the axis's ranks are grouped ``num_servers`` x
    ``npus_per_server`` in fabric order (server-major).  Reduce-scatter
    within each server group, exchange the pre-reduced 1/P shard across
    the same-index rail peers, all-gather back within the server group.
    Returns the MEAN over the axis (fp32).  The mesh must hold the groups
    of ``num_servers`` (``RankMesh(dp_servers=...)``)."""
    names = mesh_ops.axis_names(axis)
    r = ranks.axis_size(*names)
    s = max(1, int(num_servers))
    if r % s:
        raise ValueError(f"axis size {r} does not factor into {s} servers")
    p = r // s
    n = g.shape[0]
    gf = g.float()
    if p == 1 or s == 1:
        # one level is trivial: a flat sum IS the two-level schedule
        out = mesh_ops._all_reduce_(gf.clone(), ranks.group(*names))
        return out / r
    me = ranks.axis_index(*names)
    intra = tuple(range((me // p) * p, (me // p + 1) * p))
    inter = tuple(sv * p + me % p for sv in range(s))
    gp = F.pad(gf, (0, (-n) % p)).reshape(p, -1)
    mine = mesh_ops.reduce_scatter(gp, ranks.subgroup(names, intra), p)
    mesh_ops._all_reduce_(mine, ranks.subgroup(names, inter))
    full = ranks.all_gather(mine, names, intra).reshape(-1)[:n]
    return full / r


def tree_compressed_psum(grads: dict, ranks, axis,
                         err_tree: Optional[dict] = None):
    """:func:`compressed_psum` over a dict of gradients: each leaf in flat
    slices of at most ``CHUNK`` elements, each slice with its own scales
    and its own residual.  Returns (means by name, in each leaf's dtype;
    residuals by name, fp32 flat)."""
    out, new_err = {}, {}
    for name, g in grads.items():
        flat = g.reshape(-1)
        err = None if err_tree is None else err_tree.get(name)
        means, errs = [], []
        for lo in range(0, flat.numel(), CHUNK):
            part = flat[lo:lo + CHUNK]
            mean, e = compressed_psum(
                part, ranks, axis,
                None if err is None else err[lo:lo + CHUNK])
            means.append(mean)
            errs.append(e)
        out[name] = torch.cat(means).reshape(g.shape).to(g.dtype)
        new_err[name] = torch.cat(errs)
    return out, new_err
