"""Carry the reference's parameters across to the port.

:func:`params_from_jax` takes the JAX package's parameter pytree as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the caller's
side) and returns the port's parameter module of the config's family with
the same values: ``Transformer`` (dense, moe), ``Zamba2`` (hybrid: stacked
``mamba`` [L, ...], ``shared``) or ``RWKV6`` (rwkv: stacked ``layers``).
Stacked [L, ...] trees are unstacked into one block per layer (with
Gemma2's post-norms ``pn1``/``pn2``; the encoder-decoder's stacked
``enc_layers`` into ``enc_blocks``, with ``enc_norm``, and each decoder
block's ``lnx``/``xattn``/``pnx``; a config with tied embeddings, as
Gemma2's and Qwen2-VL's, has no ``unembed``).  Matrices are
rounded once to ``dtype``, which gives the values the reference's per-use
``.astype(dt)`` gives; what the reference keeps or computes with in fp32
(norms, router, ``A_log``, ``D``, ``dt_bias``, ``w0``, ``wA``, ``wB``,
``u``) stays fp32: each module creates those parameters in fp32.  With a
``pctx`` the result is one rank's shard: the experts ``[first, first +
per_rank)`` of each MoE layer and, over a model axis, the tensor-parallel
cut of each split parameter (a module's ``shards``: a block, or Mamba2's
``in_proj`` segments), everything else whole.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.api import param_module
from repro_torch.models.layers import cut_segments


def params_from_jax(np_params: dict, cfg: ModelConfig, *, device=None,
                    dtype: torch.dtype = torch.bfloat16,
                    pctx=None) -> nn.Module:
    dev = resolve_device(device)
    params = param_module(cfg, device=dev, dtype=dtype, pctx=pctx)

    def put(dst: torch.Tensor, src) -> None:
        src = np.array(src, dtype=np.float32)     # a writable copy
        if tuple(dst.shape) != src.shape:
            raise ValueError(f"shape {src.shape} for a {tuple(dst.shape)} "
                             f"parameter")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(src))

    def put_tree(module: nn.Module, tree: dict) -> None:
        """Each parameter from the tree entry of the same dotted name (the
        port's modules name their parameters as the reference's keys), cut
        to this rank's tensor-parallel block where its module splits it."""
        shards = {f"{prefix}.{name}".lstrip("."): shard
                  for prefix, sub in module.named_modules()
                  for name, shard in getattr(sub, "shards", {}).items()}
        for name, dst in module.named_parameters():
            src = tree
            for key in name.split("."):
                src = src[key]
            if name in shards:
                src = block_of(src, shards[name])
            put(dst, src)

    put(params.embed.emb, np_params["embed"]["emb"])
    put(params.final_norm.w, np_params["final_norm"]["w"])
    if params.unembed is not None:
        put(params.unembed, np_params["unembed"]["w"])
    prefix = []
    if cfg.family == "hybrid":
        blocks, stacked = params.mamba, np_params["mamba"]
        put_tree(params.shared, np_params["shared"])
    elif cfg.family == "rwkv":
        blocks, stacked = params.layers, np_params["layers"]
        put(params.ln_in.w, np_params["ln_in"]["w"])
    else:
        blocks, stacked = params.blocks, np_params["layers"]
        prefix = np_params.get("layers_prefix", [])
    if cfg.family == "encdec":
        put(params.enc_norm.w, np_params["enc_norm"]["w"])
        for i, blk in enumerate(params.enc_blocks):
            put_tree(blk, _tree_index(np_params["enc_layers"], i))
    for i, blk in enumerate(blocks):
        tree = (prefix[i] if i < len(prefix)
                else _tree_index(stacked, i - len(prefix)))
        moe = getattr(blk, "moe", None)
        if moe is not None:         # this rank's experts
            lo, hi = moe.first, moe.first + moe.w1.shape[0]
            tree = {**tree, "moe": {key: (val if key == "router"
                                          else val[lo:hi])
                                    for key, val in tree["moe"].items()}}
        put_tree(blk, tree)
    return params


def block_of(src, shard) -> np.ndarray:
    """A module's ``shards`` entry's cut of a whole array
    (``layers.cut_segments``): block ``index`` of ``parts`` along ``dim``
    for ``(dim, parts, index)``, or the column segments of ``(dim, whole,
    ((lo, hi), ...))`` concatenated in their order."""
    src = np.asarray(src)
    dim = shard[0]
    local = src.shape[dim] // shard[1] if isinstance(shard[2], int) else 0
    _, whole, segs = cut_segments(shard, local)
    if src.shape[dim] != whole:
        raise ValueError(f"shape {src.shape} for a cut of {whole} along "
                         f"dim {dim}")
    return np.concatenate([src.take(range(lo, hi), axis=dim)
                           for lo, hi in segs], axis=dim)


def _tree_index(tree, i: int):
    """Layer ``i`` of a pytree of stacked [L, ...] arrays."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]
