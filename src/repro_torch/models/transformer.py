"""Decoder-only transformer stacks (dense and MoE) with KV-cache serving.

Port of the decoder half of ``src/repro/models/transformer.py`` for the
dense and moe families.  The reference scans stacked [L, ...] parameters;
the port keeps one ``Block`` module per layer (the converter unstacks the
reference's pytree) and runs the layers in a Python loop.  Caches are
per-layer buffers updated in place.  With a ``pctx`` each rank holds its
data-parallel rows and its experts; every layer but the MoE exchange is
rank-local (the model axis is 1).
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
        ("mrope_sections", cfg.mrope_sections),
        ("input_mode=embeddings", cfg.input_mode != "tokens")) if on]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not "
                                  f"ported yet")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One decoder layer: attention, then an MoE or dense FFN.  An MoE
    layer of a config with shared experts also holds ``shared_mlp``, the
    always-on experts as one MLP of width ``expert_d_ff *
    n_shared_experts``, whole on every rank (EP does not shard it)."""

    def __init__(self, cfg: ModelConfig, *, moe: bool, device, dtype,
                 pctx=None, experts: bool = True):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
        self.attn = L.Attention(_dims(cfg), device=device, dtype=dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
        self.moe = self.mlp = self.shared_mlp = None
        if moe:
            first, local = M.expert_shard(pctx, cfg.num_experts)
            self.moe = M.MoE(cfg.d_model, cfg.expert_d_ff, cfg.num_experts,
                             device=device, dtype=dtype, first=first,
                             local=local if experts else 0)
            if cfg.n_shared_experts:
                self.shared_mlp = L.MLP(
                    cfg.d_model, cfg.expert_d_ff * cfg.n_shared_experts,
                    cfg.mlp_gated, device=device, dtype=dtype)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                             device=device, dtype=dtype)


class Transformer(nn.Module):
    """Parameters of a decoder stack: embedding, blocks (the
    ``first_k_dense`` dense layers of an MoE stack first), final norm and
    an untied unembedding [D, V] unless the config ties them.  With a
    ``pctx`` the MoE blocks hold this rank's experts only; with
    ``experts=False`` they hold none (the weights every rank shares)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, pctx=None,
                 experts: bool = True):
        super().__init__()
        check_supported(cfg)
        n_dense = cfg.first_k_dense if cfg.is_moe else cfg.n_layers
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, device=device,
                                 dtype=dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, moe=i >= n_dense, device=device, dtype=dtype,
                  pctx=pctx, experts=experts)
            for i in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device=device,
                                    eps=cfg.norm_eps)
        self.unembed = (None if cfg.tie_embeddings else
                        L.parameter((cfg.d_model, cfg.vocab), device=device,
                                    dtype=dtype))


def init_transformer(cfg: ModelConfig, *, generator: torch.Generator,
                     device, dtype, pctx=None, shared=None) -> Transformer:
    """Random weights drawn from ``generator`` (truncated normal at the
    reference's scales; norms start at zero), filled in place.  Experts
    come from generators of their own (``moe.expert_seed``), so a rank's
    experts equal the one-rank model's.

    With ``shared`` (:func:`shared_weights` of the same config and seed)
    the module holds those tensors themselves, copying nothing, and only
    this rank's experts are drawn (from ``generator``'s seed alone)."""
    if shared is not None:
        return _around_shared(cfg, shared, generator.initial_seed(),
                              device=device, dtype=dtype, pctx=pctx)
    params = Transformer(cfg, device=device, dtype=dtype, pctx=pctx)
    _draw(params, cfg, generator)
    return params


def _draw(params: Transformer, cfg: ModelConfig,
          generator: torch.Generator) -> None:
    params.embed.reset_parameters(generator)
    for i, blk in enumerate(params.blocks):
        blk.attn.reset_parameters(generator)
        if blk.moe is not None:
            blk.moe.reset_parameters(generator, layer=i)
            if blk.shared_mlp is not None:
                blk.shared_mlp.reset_parameters(generator)
        else:
            blk.mlp.reset_parameters(generator)
    if params.unembed is not None:
        L.truncated_normal_(params.unembed, cfg.d_model ** -0.5, generator)


EXPERT_WEIGHTS = ("w1", "w3", "w2")


def is_expert_weight(name: str) -> bool:
    """Whether a parameter name of :class:`Transformer` is an expert
    weight (``blocks.<i>.moe.w1``, ``.w3``, ``.w2``)."""
    return name.split(".")[-2:] in [["moe", w] for w in EXPERT_WEIGHTS]


def shared_weights(cfg: ModelConfig, *, generator: torch.Generator, device,
                   dtype) -> dict:
    """Every parameter but the experts, by name, drawn from ``generator``
    in :func:`init_transformer`'s order: the same values each rank's own
    draw gives.  Serving only reads them, so the ranks of one card can hold
    one copy (passed to them as CUDA IPC handles)."""
    params = Transformer(cfg, device=device, dtype=dtype, experts=False)
    _draw(params, cfg, generator)
    return {name: t for name, t in params.state_dict().items()
            if not is_expert_weight(name)}


def _around_shared(cfg: ModelConfig, shared: dict, seed: int, *, device,
                   dtype, pctx) -> Transformer:
    """A rank's module made on the meta device, then given the shared
    tensors (assigned, not copied) and its own experts, drawn on
    ``device``."""
    params = Transformer(cfg, device="meta", dtype=dtype, pctx=pctx)
    missing, unexpected = params.load_state_dict(shared, strict=False,
                                                 assign=True)
    if unexpected or not all(is_expert_weight(name) for name in missing):
        raise ValueError(f"shared weights do not fit {cfg.name}: missing "
                         f"{missing}, unexpected {unexpected}")
    for i, blk in enumerate(params.blocks):
        if blk.moe is None:
            continue
        for name in EXPERT_WEIGHTS:
            setattr(blk.moe, name, L.parameter(
                getattr(blk.moe, name).shape, device=device, dtype=dtype))
        blk.moe.reset_experts(seed, layer=i)
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


def _ffn_part(lp: Block, x, cfg, pctx=None):
    """The FFN half of a block; serving drops the MoE aux loss, so it is
    never computed (nor averaged over the ranks)."""
    h = lp.ln2(x)
    if lp.moe is None:
        return L.mlp(lp.mlp, h, cfg.act)
    out = M.moe_ffn(lp.moe, h, cfg, pctx, with_aux=False)[0]
    if lp.shared_mlp is not None:
        out = out + L.mlp(lp.shared_mlp, h, cfg.act)
    return out


def _decode_attn(lp: Block, x, ck, cv, pos, cfg, *, window):
    h = lp.ln1(x)
    return L.decode_attention_block(
        lp.attn, h, ck, cv, pos, _dims(cfg), window=window,
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
    """Per-layer KV buffers [B, max_len, G, dh] and the filled length, as
    an int64 scalar on the device (``pos``, what decode reads) and as a
    host int (``len``, bookkeeping)."""
    g, dh = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, max_len, g, dh)
    return {
        "k": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.n_layers)],
        "v": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.n_layers)],
        "pos": L.position(device),
        "len": 0,
    }


def prefill(params: Transformer, cfg, x, positions, cache, pctx=None):
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
        f = _ffn_part(lp, x, cfg, pctx)
        x = x + f
        cache["k"][i][:, :seq] = k.to(cache["k"][i].dtype)
        cache["v"][i][:, :seq] = v.to(cache["v"][i].dtype)
    cache["pos"].fill_(seq)
    cache["len"] = seq
    x = params.final_norm(x)
    return logits_fn(params, cfg, x, last_only=True), cache


def decode_step(params: Transformer, cfg, x, cache, pctx=None):
    """One decode token.  x: [B, 1, D] hidden input; the caches and the
    device position are updated in place (the host ``len`` is the
    caller's: ``Model.decode``).  Returns (logits [B, 1, V], cache)."""
    wins = window_schedule(cfg, cfg.n_layers)
    pos = cache["pos"]
    for i, lp in enumerate(params.blocks):
        a = _decode_attn(lp, x, cache["k"][i], cache["v"][i], pos, cfg,
                         window=None if wins is None else wins[i])
        x = x + a
        f = _ffn_part(lp, x, cfg, pctx)
        x = x + f
    pos.add_(1)
    x = params.final_norm(x)
    return logits_fn(params, cfg, x, last_only=True), cache
