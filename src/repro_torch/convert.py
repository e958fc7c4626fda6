"""Carry the reference's parameters across to the port.

:func:`params_from_jax` takes the JAX package's parameter pytree as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the caller's
side) and returns the port's ``Transformer`` module with the same values.
The stacked ``params["layers"]`` [L, ...] is unstacked into one block per
layer.  Matrices are rounded once to ``dtype``, which gives the values the
reference's per-use ``.astype(dt)`` gives; router and norm weights stay
fp32, as the reference keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def params_from_jax(np_params: dict, cfg: ModelConfig, *, device=None,
                    dtype: torch.dtype = torch.bfloat16) -> T.Transformer:
    dev = resolve_device(device)
    params = T.Transformer(cfg, device=dev, dtype=dtype)

    def put(dst: torch.Tensor, src) -> None:
        src = np.array(src, dtype=np.float32)     # a writable copy
        if tuple(dst.shape) != src.shape:
            raise ValueError(f"shape {src.shape} for a {tuple(dst.shape)} "
                             f"parameter")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(src))

    def put_block(blk: T.Block, lp: dict) -> None:
        put(blk.ln1.w, lp["ln1"]["w"])
        put(blk.ln2.w, lp["ln2"]["w"])
        for name in ("wq", "wk", "wv", "wo"):
            put(getattr(blk.attn, name), lp["attn"][name])
        if blk.moe is not None:
            for name in ("router", "w1", "w3", "w2"):
                put(getattr(blk.moe, name), lp["moe"][name])
        else:
            for name in ("w1", "w2", "w3"):
                if getattr(blk.mlp, name) is not None:
                    put(getattr(blk.mlp, name), lp["mlp"][name])

    put(params.embed.emb, np_params["embed"]["emb"])
    put(params.final_norm.w, np_params["final_norm"]["w"])
    if params.unembed is not None:
        put(params.unembed, np_params["unembed"]["w"])
    prefix = np_params.get("layers_prefix", [])
    stacked = np_params["layers"]
    for i, blk in enumerate(params.blocks):
        if i < len(prefix):
            put_block(blk, prefix[i])
        else:
            li = i - len(prefix)
            put_block(blk, _tree_index(stacked, li))
    return params


def _tree_index(tree, i: int):
    """Layer ``i`` of a pytree of stacked [L, ...] arrays."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]
