"""Each leaf's shape on one rank, and the FSDP shard a training rank holds.

The counterpart of the reference's ``src/repro/parallel/sharding.py``,
which assigns ``PartitionSpec`` objects that GSPMD executes.  The port has no
GSPMD: a rank's model is built with its own model-axis cut (each module's
``shards``, the experts of an MoE layer over their EP axes), and that is
what it executes.  On top of it comes the data-axis rule of the
reference's ``_rule_for`` (FSDP / ZeRO-3 over ``data`` when the context's
``fsdp`` is on), with the reference's divisibility guard: an axis that
does not divide a dim leaves it whole.  :func:`leaf_shape` is that rule,
and :func:`shard_fsdp` executes it: training over ranks with ``fsdp`` and
more than one data rank (``launch.train.build_training``, and the dry
run's train cells) keeps each data-cut leaf's ``1/data`` slice, and the
module gathers the leaf over ``data`` whenever its code reads it
(:class:`Gathering`); the gather's backward is the reduce-scatter, so the
gradient comes back at the shard's shape, summed over ``data``, and
AdamW's state is made at the shard's shapes.  Serving never shards over
``data`` (the reference's serving cells turn FSDP off).

Where the port's model-axis cut differs from the reference's spec (the
reference splits any dim the model axis divides; the port splits by
heads and channels as it executes), the port's is reported:

- the embedding and the unembedding stay whole on every model rank
  (``transformer.py``'s docstring), where the reference splits the
  vocabulary (``emb``) and its columns (``unembed``);
- kv projections whose heads do not divide over the model axis are
  replicated (``layers.kv_layout``);
- Mamba2's ``in_proj`` keeps its heads' z, x and dt columns and B/C
  whole (``ssm.in_proj_segments``); its ``A_log``, ``D``, ``dt_bias`` and
  ``out_norm`` are the rank's heads' and channels' (the reference
  replicates them);
- RWKV-6's ``wA`` and ``cr`` stay whole (``rwkv.py``'s docstring); its
  ``w0``, ``u`` and ``gn`` are the rank's heads' (the reference replicates
  them);
- a module whose split width does not divide over the model axis is
  replicated (``layers.splits``), where the reference splits any dim the
  axis divides, mid-head if need be: an attention block whose query
  heads do not divide (``wq``, ``wk``, ``wv``, ``wo`` whole: Qwen2-VL-2B's
  12 heads over 16 ranks, whose ``wq`` [1536, 1536] GSPMD cuts into 96
  columns a rank), an MLP or the experts whose FFN width does not divide
  (``w1``, ``w3``, ``w2``), a Mamba2 block whose SSM heads do not (all of
  it), an RWKV-6 time mix whose heads do not (``wr``, ``wk``, ``wv``,
  ``wg``, ``w0``, ``wB``, ``u``, ``gn``, ``wo``) and a channel mix whose
  width does not (``ck``, ``cv``).

Batches: the batch dim over the data-parallel ranks when it divides
(``batch_specs``).  Caches: the reference's ``cache_specs`` rules on the
global cache shapes (:func:`cache_shapes`), beside the cache the port
builds for a rank (``Model.init_cache`` on the meta device).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.context import ParallelContext


def _rule_for(path_keys: list[str], cfg: ModelConfig,
              pctx: ParallelContext) -> Optional[tuple]:
    """Base (unstacked) spec template for a leaf, by name/context (the
    reference's, verbatim)."""
    name = path_keys[-1]
    in_moe = "moe" in path_keys
    fsdp = pctx.data_axis if pctx.fsdp else None
    model = pctx.model_axis
    if in_moe and name in ("w1", "w3", "w2", "router"):
        use_pod, _ = pctx.ep_ranks(cfg.num_experts)
        ep = ((pctx.pod_axis, pctx.data_axis) if (use_pod and pctx.pod_axis)
              else (pctx.data_axis,))
        if name == "router":
            return (None, None)
        if name == "w2":
            return (ep, model, None)
        return (ep, None, model)                     # w1 / w3
    col = {"wq", "wk", "wv", "w1", "w3", "ck", "cr", "wr", "wg",
           "in_proj", "wA"}
    row = {"wo", "w2", "cv", "out_proj"}
    if name in col:
        return (fsdp, model)
    if name in row:
        return (model, fsdp)
    if name == "emb":
        return (model, fsdp)
    if name == "w" and "unembed" in path_keys:
        return (fsdp, model)
    if name == "wB":
        return (None, model)
    if name == "conv":
        return (None, model)
    if name in ("mu", "cmu", "u"):
        return (None, None)
    if name in ("A_log", "D", "dt_bias", "w0", "w"):
        return (None,)                                # norms & head scalars
    return None                                       # replicate


def reference_keys(name: str) -> list[str]:
    """The reference's path keys of the port's parameter ``name``, without
    the layer index (``blocks.3.attn.wq`` -> ``[blocks, attn, wq]``; the
    port's ``unembed`` is the reference's ``unembed/w``)."""
    keys = [k for k in name.split(".") if not k.isdigit()]
    return keys + ["w"] if keys[-1] == "unembed" else keys


def _axis_size(pctx: ParallelContext, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(_axis_size(pctx, a) for a in axis)
    return pctx.mesh.axis_size(axis)


def _spec(base: tuple, nd: int) -> list:
    spec = list(base)
    while len(spec) < nd:                 # stacked dims lead
        spec.insert(0, None)
    return spec[:nd] if len(spec) > nd else spec


def leaf_shape(name: str, shape, cfg: ModelConfig,
               pctx: ParallelContext) -> tuple:
    """The shape on one rank of the port's parameter ``name`` whose
    model-axis (and expert) cut is ``shape``: each dim the reference's
    rule puts on the data axis divided by it where it divides (FSDP)."""
    base = _rule_for(reference_keys(name), cfg, pctx)
    out = list(shape)
    if base is None or not pctx.fsdp:
        return tuple(out)
    for i, ax in enumerate(_spec(base, len(out))):
        if ax == pctx.data_axis and out[i] % _axis_size(pctx, ax) == 0:
            out[i] //= _axis_size(pctx, ax)
    return tuple(out)


def fsdp_dims(params, cfg: ModelConfig, pctx: ParallelContext) -> dict:
    """{name: the dim the data axis cuts} of the leaves of a rank's
    parameter module (its model-axis cut) that :func:`leaf_shape` cuts
    over ``data``: at most one dim a leaf."""
    out = {}
    for n, p in params.named_parameters():
        held = leaf_shape(n, tuple(p.shape), cfg, pctx)
        cut = [i for i, (a, b) in enumerate(zip(held, p.shape)) if a != b]
        if cut:
            (out[n],) = cut
    return out


class Gathering:
    """The mixin of a module that holds FSDP shards (``fsdp_dims``:
    {leaf: dim}): reading such a leaf as an attribute gathers it over the
    context's data axis (``parallel.mesh``'s differentiable ``all_gather``,
    whose backward is the reduce-scatter), every read of it, so that under
    ``remat="full"`` a block's recompute gathers again and a gathered weight
    lives only while its block runs.  ``named_parameters``, ``state_dict``
    and the optimizer see the shards under their own names."""

    def __getattr__(self, name: str):
        dims = self.__dict__.get("fsdp_dims")
        if dims is not None and name in dims:
            return gather_leaf(self._parameters[name], dims[name],
                               self.__dict__["fsdp_pctx"])
        return super().__getattr__(name)


def gather_leaf(shard, dim: int, pctx: ParallelContext):
    """The whole leaf of ``shard``, this rank's ``1/data`` slice of it
    along ``dim``: the data ranks' slices in order."""
    parts = pctx.mesh.all_gather(shard, pctx.data_axis)   # [data, *shard]
    return parts.movedim(0, dim).flatten(dim, dim + 1)


_GATHERING: dict = {}


def _gathering_class(cls: type) -> type:
    """``cls`` with :class:`Gathering` first in its bases (one class a
    module class, named in this module)."""
    if cls not in _GATHERING:
        name = f"Gathering{cls.__name__}"
        _GATHERING[cls] = type(name, (Gathering, cls), {
            "__module__": __name__, "__qualname__": name})
        globals()[name] = _GATHERING[cls]
    return _GATHERING[cls]


def shard_fsdp(params, cfg: ModelConfig, pctx: ParallelContext):
    """Turn a rank's parameter module, built with its model-axis cut, into
    its FSDP shard, in place (and return it): each leaf that
    :func:`leaf_shape` cuts over ``data`` keeps this rank's ``1/data``
    slice of the dim :func:`fsdp_dims` names (a new parameter of the same
    name, ``requires_grad`` kept), and its module gathers it whenever it
    is read (:class:`Gathering`).  Expert weights (EP-cut), norms, scalars,
    routers and every leaf the rule leaves whole stay as they are.  A
    no-op without ``fsdp`` or with one data rank."""
    if not pctx.fsdp or pctx.data_size == 1:
        return params
    n = pctx.data_size
    at = pctx.mesh.axis_index(pctx.data_axis)
    for name, dim in fsdp_dims(params, cfg, pctx).items():
        prefix, _, leaf = name.rpartition(".")
        mod = params.get_submodule(prefix)
        whole = mod._parameters[leaf]
        size = whole.shape[dim] // n
        mod._parameters[leaf] = torch.nn.Parameter(
            whole.detach().narrow(dim, at * size, size).clone(),
            requires_grad=whole.requires_grad)
        if not isinstance(mod, Gathering):
            mod.__class__ = _gathering_class(type(mod))
            mod.__dict__["fsdp_dims"] = {}
            mod.__dict__["fsdp_pctx"] = pctx
        mod.__dict__["fsdp_dims"][leaf] = dim
    return params


def param_shapes(params, cfg: ModelConfig, pctx: ParallelContext) -> dict:
    """{name: shape on one rank} of a rank's parameter module (built on
    the meta device with ``pctx``)."""
    return {n: leaf_shape(n, tuple(p.shape), cfg, pctx)
            for n, p in params.named_parameters()}


def fsdp_parts(params, cfg: ModelConfig, pctx: ParallelContext) -> dict:
    """{name: (bytes the rank holds with FSDP, bytes of its model-axis
    part)} of the leaves the data axis cuts: what one step's weight
    all-gather brings to a rank and its gradient reduce-scatter takes
    away, per leaf."""
    out = {}
    for n, p in params.named_parameters():
        held = leaf_shape(n, tuple(p.shape), cfg, pctx)
        if held != tuple(p.shape):
            out[n] = (math.prod(held) * p.element_size(),
                      p.numel() * p.element_size())
    return out


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def batch_shapes(batch: dict, pctx: ParallelContext) -> dict:
    """{name: shape on one rank} of a batch of global ``(shape, dtype)``
    leaves: the batch dim over the data-parallel ranks when it divides."""
    dp = _axis_size(pctx, pctx.dp_axes)
    out = {}
    for name, (shape, dtype) in batch.items():
        shape = tuple(shape)
        if shape and shape[0] % dp == 0:
            shape = (shape[0] // dp,) + shape[1:]
        out[name] = (shape, dtype)
    return out


# ---------------------------------------------------------------------------
# caches / decode state
# ---------------------------------------------------------------------------

def cache_shapes(cache: dict, cfg: ModelConfig,
                 pctx: ParallelContext) -> dict:
    """{name: shape on one rank} of a cache of global shapes under the
    reference's ``cache_specs`` rules (per-layer ``k``/``v`` entries
    [B, S, g, dh], stacked ones [L, ...])."""
    msize = _axis_size(pctx, pctx.model_axis)
    dpsize = _axis_size(pctx, pctx.dp_axes)

    def cut(shape, dims):
        out = list(shape)
        for i, n in dims:
            out[i] //= n
        return tuple(out)

    out = {}
    for name, shape in cache.items():
        shape = tuple(shape)
        nd = len(shape)
        key = name.split(".")[0]
        b0 = 1 if nd == 5 or key in ("conv", "ssd", "wkv", "tshift",
                                    "cshift") else 0
        dims = []
        if nd and shape[b0] % dpsize == 0:
            dims.append((b0, dpsize))
        if key in ("k", "v") and nd in (4, 5):
            s_ok = pctx.seq_shard_decode and shape[b0 + 1] % msize == 0
            if s_ok:
                dims.append((b0 + 1, msize))
            elif shape[b0 + 2] % msize == 0:
                dims.append((b0 + 2, msize))
        elif key == "enc_out" and shape[2] % msize == 0:
            dims.append((2, msize))
        elif key == "conv" and shape[3] % msize == 0:
            dims.append((3, msize))
        elif key in ("ssd", "wkv") and shape[2] % msize == 0:
            dims.append((2, msize))
        elif key in ("tshift", "cshift") and shape[2] % msize == 0:
            dims.append((2, msize))
        elif key not in ("k", "v", "enc_out", "conv", "ssd", "wkv",
                         "tshift", "cshift"):
            dims = []
        out[name] = cut(shape, dims)
    return out
