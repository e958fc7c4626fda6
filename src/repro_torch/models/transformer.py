"""Decoder-only transformer stacks (dense and MoE) with KV-cache serving.

Port of the decoder half of ``src/repro/models/transformer.py`` for the
dense and moe families on one rank.  The reference scans stacked [L, ...]
parameters; the port keeps one ``Block`` module per layer (the converter
unstacks the reference's pytree) and runs the layers in a Python loop.
Caches are per-layer buffers updated in place.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M

BIG_WINDOW = 1 << 30


def _dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def check_supported(cfg: ModelConfig) -> None:
    """The families the port serves (dense, moe, hybrid, rwkv) and the
    features of them it implements."""
    if cfg.family not in ("dense", "moe", "hybrid", "rwkv"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    missing = [name for name, on in (
        ("post_norm", cfg.post_norm),
        ("n_shared_experts", cfg.n_shared_experts),
        ("mrope_sections", cfg.mrope_sections),
        ("input_mode=embeddings", cfg.input_mode != "tokens")) if on]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not "
                                  f"ported yet")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One decoder layer: attention, then an MoE or dense FFN."""

    def __init__(self, cfg: ModelConfig, *, moe: bool, device, dtype):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
        self.attn = L.Attention(_dims(cfg), device=device, dtype=dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
        if moe:
            self.moe = M.MoE(cfg.d_model, cfg.expert_d_ff, cfg.num_experts,
                             device=device, dtype=dtype)
            self.mlp = None
        else:
            self.moe = None
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                             device=device, dtype=dtype)


class Transformer(nn.Module):
    """Parameters of a decoder stack: embedding, blocks (the
    ``first_k_dense`` dense layers of an MoE stack first), final norm and
    an untied unembedding [D, V] unless the config ties them."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        check_supported(cfg)
        n_dense = cfg.first_k_dense if cfg.is_moe else cfg.n_layers
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, device=device,
                                 dtype=dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, moe=i >= n_dense, device=device, dtype=dtype)
            for i in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device=device,
                                    eps=cfg.norm_eps)
        self.unembed = (None if cfg.tie_embeddings else
                        L.parameter((cfg.d_model, cfg.vocab), device=device,
                                    dtype=dtype))


def init_transformer(cfg: ModelConfig, *, generator: torch.Generator,
                     device, dtype) -> Transformer:
    """Random weights drawn from ``generator`` (truncated normal at the
    reference's scales; norms start at zero), filled in place."""
    params = Transformer(cfg, device=device, dtype=dtype)
    params.embed.reset_parameters(generator)
    for blk in params.blocks:
        blk.attn.reset_parameters(generator)
        (blk.moe if blk.moe is not None else blk.mlp).reset_parameters(
            generator)
    if params.unembed is not None:
        L.truncated_normal_(params.unembed, cfg.d_model ** -0.5, generator)
    return params


# ---------------------------------------------------------------------------
# per-layer window schedule (gemma2 alternation)
# ---------------------------------------------------------------------------

def window_schedule(cfg: ModelConfig, n_layers: int):
    """None if the arch has no windows; else one int per layer
    (``BIG_WINDOW`` = global)."""
    if cfg.window is None:
        return None
    if not cfg.local_global_alternating:
        return [cfg.window] * n_layers
    return [cfg.window if i % 2 == 0 else BIG_WINDOW
            for i in range(n_layers)]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_part(lp: Block, x, positions, cfg, *, window, causal=True,
               return_kv=False):
    h = lp.ln1(x)
    return L.attention(lp.attn, h, positions, _dims(cfg), causal=causal,
                       window=window, softcap=cfg.attn_softcap,
                       rope_theta=cfg.rope_theta, return_kv=return_kv)


def _ffn_part(lp: Block, x, cfg):
    h = lp.ln2(x)
    if lp.moe is not None:
        return M.moe_ffn(lp.moe, h, cfg)
    return L.mlp(lp.mlp, h, cfg.act), torch.zeros((), device=x.device)


def _decode_attn(lp: Block, x, ck, cv, cur: int, cfg, *, window):
    h = lp.ln1(x)
    return L.decode_attention_block(
        lp.attn, h, ck, cv, cur, _dims(cfg), window=window,
        softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta)


def logits_fn(params: Transformer, cfg, x, last_only=False):
    if last_only:
        x = x[:, -1:]
    return L.unembed(params.embed, x, params.unembed, cfg.final_softcap)


# ---------------------------------------------------------------------------
# prefill / decode (KV caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype=torch.bfloat16):
    """Per-layer KV buffers [B, max_len, G, dh] and the filled length."""
    g, dh = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, max_len, g, dh)
    return {
        "k": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.n_layers)],
        "v": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.n_layers)],
        "len": 0,
    }


def prefill(params: Transformer, cfg, x, positions, cache):
    """Forward pass over the prompt that also fills the cache (in place:
    the reference pads the new k, v into fresh buffers).  x: [B, S, D].
    Returns (last-position logits [B, 1, V], cache)."""
    wins = window_schedule(cfg, cfg.n_layers)
    seq = x.shape[1]
    for i, lp in enumerate(params.blocks):
        a, (k, v) = _attn_part(lp, x, positions, cfg,
                               window=None if wins is None else wins[i],
                               return_kv=True)
        x = x + a
        f, _ = _ffn_part(lp, x, cfg)
        x = x + f
        cache["k"][i][:, :seq] = k.to(cache["k"][i].dtype)
        cache["v"][i][:, :seq] = v.to(cache["v"][i].dtype)
    cache["len"] = seq
    x = params.final_norm(x)
    return logits_fn(params, cfg, x, last_only=True), cache


def decode_step(params: Transformer, cfg, x, cache):
    """One decode token.  x: [B, 1, D] hidden input; the caches are
    updated in place.  Returns (logits [B, 1, V], cache)."""
    wins = window_schedule(cfg, cfg.n_layers)
    cur = cache["len"]
    for i, lp in enumerate(params.blocks):
        a = _decode_attn(lp, x, cache["k"][i], cache["v"][i], cur, cfg,
                         window=None if wins is None else wins[i])
        x = x + a
        f, _ = _ffn_part(lp, x, cfg)
        x = x + f
    cache["len"] = cur + 1
    x = params.final_norm(x)
    return logits_fn(params, cfg, x, last_only=True), cache
