"""Carry the reference's parameters across to the port.

:func:`params_from_jax` takes the JAX package's parameter pytree as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the caller's
side) and returns the port's parameter module of the config's family with
the same values: ``Transformer`` (dense, moe), ``Zamba2`` (hybrid: stacked
``mamba`` [L, ...], ``shared``) or ``RWKV6`` (rwkv: stacked ``layers``).
Stacked [L, ...] trees are unstacked into one block per layer.  Matrices are
rounded once to ``dtype``, which gives the values the reference's per-use
``.astype(dt)`` gives; what the reference keeps or computes with in fp32
(norms, router, ``A_log``, ``D``, ``dt_bias``, ``w0``, ``wA``, ``wB``,
``u``) stays fp32: each module creates those parameters in fp32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.api import param_module


def params_from_jax(np_params: dict, cfg: ModelConfig, *, device=None,
                    dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    dev = resolve_device(device)
    params = param_module(cfg, device=dev, dtype=dtype)

    def put(dst: torch.Tensor, src) -> None:
        src = np.array(src, dtype=np.float32)     # a writable copy
        if tuple(dst.shape) != src.shape:
            raise ValueError(f"shape {src.shape} for a {tuple(dst.shape)} "
                             f"parameter")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(src))

    def put_tree(module: nn.Module, tree: dict) -> None:
        """Each parameter from the tree entry of the same dotted name (the
        port's modules name their parameters as the reference's keys)."""
        for name, dst in module.named_parameters():
            src = tree
            for key in name.split("."):
                src = src[key]
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
    for i, blk in enumerate(blocks):
        put_tree(blk, prefix[i] if i < len(prefix)
                 else _tree_index(stacked, i - len(prefix)))
    return params


def _tree_index(tree, i: int):
    """Layer ``i`` of a pytree of stacked [L, ...] arrays."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]
