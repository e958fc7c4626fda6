"""Decoder-only transformer stacks (dense and MoE) with KV-cache serving.

Port of the decoder half of ``src/repro/models/transformer.py`` for the
dense and moe families.  The reference scans stacked [L, ...] parameters;
the port keeps one ``Block`` module per layer (the converter unstacks the
reference's pytree) and runs the layers in a Python loop.  Caches are
per-layer buffers updated in place.  With a ``pctx`` each rank holds its
data-parallel rows, its experts and, over a model axis, its tensor-parallel
blocks of the attention and FFN weights (``layers``); the embedding and
unembedding stay whole on every rank.

Sequence parallelism (the reference's ``shard_residual`` between blocks):
when the prompt divides over the model axis, each rank keeps its block of
the positions between blocks, and each block's entry gathers the sequence
back (:func:`_split_tp_seq_gather`: through the split-TP MultiWrite
AllGather with ``tp_subgroups > 1``, plainly otherwise).  The decode KV
caches lie in ``layers.kv_layout``'s layout, which the prefill writes.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.parallel.context import seq_sharded, shard_residual

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
    n_shared_experts``, on every EP rank (EP does not shard it; TP splits
    it like a dense MLP)."""

    def __init__(self, cfg: ModelConfig, *, moe: bool, device, dtype,
                 pctx=None, experts: bool = True):
        super().__init__()
        tp = L.tp_of(pctx)
        self.ln1 = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
        self.attn = L.Attention(_dims(cfg), device=device, dtype=dtype,
                                tp=tp)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
        self.moe = self.mlp = self.shared_mlp = None
        if moe:
            first, local = M.expert_shard(pctx, cfg.num_experts)
            self.moe = M.MoE(cfg.d_model, cfg.expert_d_ff, cfg.num_experts,
                             device=device, dtype=dtype, first=first,
                             local=local if experts else 0, tp=tp)
            if cfg.n_shared_experts:
                self.shared_mlp = L.MLP(
                    cfg.d_model, cfg.expert_d_ff * cfg.n_shared_experts,
                    cfg.mlp_gated, device=device, dtype=dtype, tp=tp)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                             device=device, dtype=dtype, tp=tp)


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
    experts equal the one-rank model's; a tensor-parallel block is drawn
    whole and cut, so it equals the one-rank model's slice.

    With ``shared`` (:func:`shared_weights` of the same config and seed)
    the module holds those tensors themselves, copying nothing, and only
    this rank's experts are drawn (from ``generator``'s seed alone)."""
    if shared is not None:
        if L.tp_of(pctx)[0] > 1:
            raise NotImplementedError(
                "shared non-expert weights are whole tensors; over a model "
                "axis every rank draws its own blocks")
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
               return_kv=False, pctx=None):
    h = lp.ln1(x)
    return L.attention(lp.attn, h, positions, _dims(cfg), causal=causal,
                       window=window, softcap=cfg.attn_softcap,
                       rope_theta=cfg.rope_theta, return_kv=return_kv,
                       pctx=pctx)


def _ffn_part(lp: Block, x, cfg, pctx=None, *, with_aux=False,
              valid=None):
    """The FFN half of a block: (out, the MoE aux loss, or None for a dense
    block or without ``with_aux``).  Serving drops the aux, so it is never
    computed there (nor averaged over the ranks).  ``valid`` [B] bool: the
    rows whose tokens take expert capacity (a cohort's padding rows do
    not)."""
    h = lp.ln2(x)
    if lp.moe is None:
        return L.mlp(lp.mlp, h, cfg.act, pctx), None
    out, aux = M.moe_ffn(lp.moe, h, cfg, pctx, with_aux=with_aux,
                         valid=valid)
    if lp.shared_mlp is not None:
        out = out + L.mlp(lp.shared_mlp, h, cfg.act, pctx)
    return out, aux


def _decode_attn(lp: Block, x, ck, cv, pos, cfg, *, window, pctx=None,
                 layout="whole"):
    h = lp.ln1(x)
    return L.decode_attention_block(
        lp.attn, h, ck, cv, pos, _dims(cfg), window=window,
        softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta, pctx=pctx,
        layout=layout)


def _split_tp_seq_gather(x, pctx):
    """SP -> TP boundary gather: this rank's block of positions [B, S/m, D]
    back to the whole sequence [B, S, D].

    With the model axis divided into ``tp_subgroups`` domains, each domain
    reassembles its own span through :func:`layers.split_tp_allgather`
    (which takes the bound plan's decision, or the planner's under
    "auto"; its MultiWrite plans use the idle cross-domain links), then
    ONE gather over the cross-domain group of the ranks with this rank's
    index in their domain completes the sequence.  With one domain (or
    domains that do not divide the axis) a plain ``all_gather`` over the
    model axis.  Both move data only: the result is the same bits."""
    mesh, axis = pctx.mesh, pctx.model_axis
    m, nd = pctx.model_size, pctx.tp_subgroups
    b, part, d = x.shape
    if nd <= 1 or m % nd:
        return mesh.all_gather(x, axis).transpose(0, 1).reshape(
            b, m * part, d)
    h = m // nd                                      # ranks a TP domain
    frag = L.split_tp_allgather(x, pctx)             # [h, B, S/m, D]
    dom = frag.transpose(0, 1).reshape(b, h * part, d)
    cross = [dd * h + mesh.axis_index(axis) % h for dd in range(nd)]
    full = mesh.all_gather(dom, axis, cross)         # [nd, B, S/nd, D]
    return full.transpose(0, 1).reshape(b, m * part, d)


def _remat(fn, pctx):
    """The reference's remat wrapper: ``torch.utils.checkpoint`` (the
    block's activations recomputed in the backward) when the context asks
    for remat; none without a context, as the reference's one-device path.
    Both of the reference's policies ("full", and dots saved) recompute the
    whole block here."""
    if pctx is None or getattr(pctx, "remat", "none") == "none":
        return fn
    from torch.utils.checkpoint import checkpoint
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _train_block(lp: Block, x, positions, cfg, pctx, window):
    """One block of :func:`forward_hidden`: (x, the MoE aux or None)."""
    x = x + _attn_part(lp, x, positions, cfg, window=window, pctx=pctx)
    f, aux = _ffn_part(lp, x, cfg, pctx, with_aux=True)
    return x + f, aux


def forward_hidden(params: Transformer, cfg, x, positions, pctx=None):
    """Run the decoder stack on hidden states x [B, S, D] without a cache
    (training).  Returns (final-normed hidden, the MoE aux losses summed,
    fp32)."""
    wins = window_schedule(cfg, cfg.n_layers)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params.blocks):
        block = _remat(functools.partial(
            _train_block, lp, positions=positions, cfg=cfg, pctx=pctx,
            window=None if wins is None else wins[i]), pctx)
        x, aux = block(x)
        if aux is not None:
            aux_total = aux_total + aux
    return params.final_norm(x), aux_total


def logits_fn(params: Transformer, cfg, x, last_only=False):
    if last_only:
        x = x[:, -1:]
    return L.unembed(params.embed, x, params.unembed, cfg.final_softcap)


# ---------------------------------------------------------------------------
# prefill / decode (KV caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype=torch.bfloat16, pctx=None):
    """Per-layer KV buffers (this rank's, in ``layers.kv_layout``'s layout
    ``layout``: [B, max_len, G, dh] on one rank) and the filled length, as
    an int64 scalar on the device (``pos``, what decode reads) and as a
    host int (``len``, bookkeeping) of ``max_len`` positions; ``valid`` [B]
    bool marks the rows whose tokens take expert capacity (all of them
    unless a server pads the cohort)."""
    layout = L.kv_layout(cfg.n_kv_heads, pctx, max_len)
    shape = L.kv_cache_shape(cfg.n_kv_heads, cfg.head_dim, batch, max_len,
                             layout, L.tp_of(pctx)[0])
    return {
        "valid": torch.ones(batch, dtype=torch.bool, device=device),
        "k": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.n_layers)],
        "v": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.n_layers)],
        "pos": L.position(device),
        "len": 0,
        "max_len": max_len,
        "layout": layout,
    }


def prefill(params: Transformer, cfg, x, positions, cache, pctx=None):
    """Forward pass over the prompt that also fills the cache (in place:
    the reference pads the new k, v into fresh buffers).  x: [B, S, D].
    Under sequence parallelism the residual is this rank's block of the
    positions between blocks; the last block's output stays whole for the
    final norm and the logits.  Returns (last-position logits [B, 1, V],
    cache)."""
    wins = window_schedule(cfg, cfg.n_layers)
    seq = x.shape[1]
    sp = seq_sharded(pctx, seq)
    if sp:
        x = shard_residual(x, pctx)
    for i, lp in enumerate(params.blocks):
        if sp:
            x = _split_tp_seq_gather(x, pctx)
        a, (k, v) = _attn_part(lp, x, positions, cfg,
                               window=None if wins is None else wins[i],
                               return_kv=True, pctx=pctx)
        x = x + a
        f, _ = _ffn_part(lp, x, cfg, pctx, valid=cache.get("valid"))
        x = x + f
        L.write_prefill_kv(lp.attn, cache["k"][i], cache["v"][i], k, v,
                           cache["layout"], pctx)
        if sp and i + 1 < len(params.blocks):
            x = shard_residual(x, pctx)
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
                         window=None if wins is None else wins[i],
                         pctx=pctx, layout=cache["layout"])
        x = x + a
        f, _ = _ffn_part(lp, x, cfg, pctx, valid=cache.get("valid"))
        x = x + f
    pos.add_(1)
    x = params.final_norm(x)
    return logits_fn(params, cfg, x, last_only=True), cache
