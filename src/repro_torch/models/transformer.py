"""Transformer stacks (dense, MoE, encoder-decoder) with KV-cache serving.

Port of ``src/repro/models/transformer.py`` for the dense, moe and encdec
families.  The reference scans stacked [L, ...] parameters;
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

The encoder-decoder (SeamlessM4T): ``enc_blocks`` run the source
embeddings through non-causal self-attention (:func:`encode`); each decoder
block adds cross-attention (``lnx``, ``xattn``, ``pnx``) over the encoder
output, with no rope and no mask (:func:`_cross_attention`).  Its serving
cache holds the encoder output ``enc_out`` [B, max_len, D] beside the
decoder's k and v, zero past the source's rows, and decode attends over all
of it, zeros included, as the reference does; the cross k and v are
recomputed from ``enc_out`` every step, as there.  Over a model axis the
encoder's and the decoder's self-attention and FFN take the dense
tensor-parallel path, and so does the cross-attention: each rank projects
its query heads and its kv heads from the whole ``enc_out`` and sums its
``wo`` rows' products over the axis.  ``enc_out`` therefore stays whole
on every rank, its batch over the data axes; the reference's cache rule
also shards its width over the model axis where that divides
(``sharding.cache_specs``), but each rank's K/V projection reads all of
D, so a rank would gather it back every step.

Training over a ``pctx`` (:func:`forward_hidden`) has the same structure:
the embedded sequence is cut to this rank's block of positions, each block
gathers it back at its entry, and each block's last row-parallel sum and
the cut that follows it are one reduce-scatter (a whole FFN output, as the
MoE's without ``moe_deferred_tp_reduce``, is cut).  Inside a block every
value and every cotangent is the same on each model rank; the gather's
backward is this rank's block of the cotangent, and the cut's is an
all-gather of the blocks' cotangents.  The final norm and the
cross-entropy run on this rank's positions (``api.Model.loss``), their
weights through *f* (``layers.to_model``), so their gradients, summed over
the model axis in the backward, are again the same on every rank.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.parallel import mesh as mesh_ops
from repro_torch.parallel.context import seq_sharded, shard_residual

BIG_WINDOW = 1 << 30


def _dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def check_supported(cfg: ModelConfig) -> None:
    """The families the port serves: dense, moe, encdec, hybrid and
    rwkv."""
    if cfg.family not in ("dense", "moe", "encdec", "hybrid", "rwkv"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: attention, then an MoE or dense FFN.  An MoE
    layer of a config with shared experts also holds ``shared_mlp``, the
    always-on experts as one MLP of width ``expert_d_ff *
    n_shared_experts``, on every EP rank (EP does not shard it; TP splits
    it like a dense MLP).  Under ``post_norm`` (Gemma2) ``pn1`` and
    ``pn2`` norm the attention and FFN outputs before the residual adds;
    else they are None.  A decoder layer of the encoder-decoder
    (``cross``) also holds ``lnx``, ``xattn`` (cross-attention) and, under
    ``post_norm``, ``pnx``, the reference's ``_init_layer(cross=True)``
    keys; else they are None."""

    def __init__(self, cfg: ModelConfig, *, moe: bool, device, dtype,
                 pctx=None, experts: bool = True, cross: bool = False):
        super().__init__()
        tp = L.tp_of(pctx)
        self.ln1 = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
        self.attn = L.Attention(_dims(cfg), device=device, dtype=dtype,
                                tp=tp)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
        self.pn1 = self.pn2 = None
        if cfg.post_norm:
            self.pn1 = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
            self.pn2 = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
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
        self.lnx = self.xattn = self.pnx = None
        if cross:
            self.lnx = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
            self.xattn = L.Attention(_dims(cfg), device=device, dtype=dtype,
                                     tp=tp)
            if cfg.post_norm:
                self.pnx = L.RMSNorm(cfg.d_model, device=device,
                                     eps=cfg.norm_eps)


class Transformer(nn.Module):
    """Parameters of a decoder stack: embedding, blocks (the
    ``first_k_dense`` dense layers of an MoE stack first), final norm and
    an untied unembedding [D, V] unless the config ties them.  With a
    ``pctx`` the MoE blocks hold this rank's experts only; with
    ``experts=False`` they hold none (the weights every rank shares).
    The encoder-decoder also holds ``enc_blocks`` (``n_enc_layers`` dense
    blocks) and ``enc_norm``, and its decoder blocks cross-attend; else
    ``enc_blocks`` and ``enc_norm`` are None."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, pctx=None,
                 experts: bool = True):
        super().__init__()
        check_supported(cfg)
        n_dense = cfg.first_k_dense if cfg.is_moe else cfg.n_layers
        encdec = cfg.family == "encdec"
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, device=device,
                                 dtype=dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, moe=i >= n_dense, device=device, dtype=dtype,
                  pctx=pctx, experts=experts, cross=encdec)
            for i in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device=device,
                                    eps=cfg.norm_eps)
        self.unembed = (None if cfg.tie_embeddings else
                        L.parameter((cfg.d_model, cfg.vocab), device=device,
                                    dtype=dtype))
        self.enc_blocks = self.enc_norm = None
        if encdec:
            self.enc_blocks = nn.ModuleList(
                Block(cfg, moe=False, device=device, dtype=dtype, pctx=pctx)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = L.RMSNorm(cfg.d_model, device=device,
                                      eps=cfg.norm_eps)


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
        if blk.xattn is not None:
            blk.xattn.reset_parameters(generator)
    for blk in params.enc_blocks or ():
        blk.attn.reset_parameters(generator)
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
    """The attention half of a block, summed over the model axis (so
    ``pn1``, which norms each position over the whole ``d_model``, sees
    the whole output)."""
    h = lp.ln1(x)
    out = L.attention(lp.attn, h, positions, _dims(cfg), causal=causal,
                      window=window, softcap=cfg.attn_softcap,
                      rope_theta=cfg.rope_theta, mrope=cfg.mrope_sections,
                      return_kv=return_kv, pctx=pctx)
    if lp.pn1 is None:
        return out
    if return_kv:
        return lp.pn1(out[0]), out[1]
    return lp.pn1(out)


def _ffn_part(lp: Block, x, cfg, pctx=None, *, with_aux=False,
              valid=None, reduce=True):
    """The FFN half of a block: (out, the MoE aux loss, or None for a dense
    block or without ``with_aux``).  Serving drops the aux, so it is never
    computed there (nor averaged over the ranks).  ``valid`` [B] bool: the
    rows whose tokens take expert capacity (a cohort's padding rows do
    not).  ``reduce=False``: where :func:`_ffn_partial` says so, ``out`` is
    this rank's partial sum over the model axis, and ``pn2`` is left to
    the caller (RMSNorm is not linear: it must see the sum)."""
    h = lp.ln2(x)
    whole = reduce or not _ffn_partial(lp, pctx)
    if lp.moe is None:
        out, aux = L.mlp(lp.mlp, h, cfg.act, pctx, reduce=whole), None
    else:
        out, aux = M.moe_ffn(lp.moe, h, cfg, pctx, with_aux=with_aux,
                             valid=valid, reduce=whole)
        if lp.shared_mlp is not None:
            out = out + L.mlp(lp.shared_mlp, h, cfg.act, pctx, reduce=whole)
    if lp.pn2 is not None and whole:
        out = lp.pn2(out)
    return out, aux


def _ffn_partial(lp: Block, pctx) -> bool:
    """Whether the FFN half leaves partial sums over the model axis when
    asked not to reduce: a dense MLP, and an MoE layer whose combine runs
    on the partials (``moe_deferred_tp_reduce``), unless one of its parts
    is replicated (``layers.splits``): its output is whole, so the half
    reduces the others' itself."""
    parts = [m for m in (lp.mlp, lp.moe, lp.shared_mlp) if m is not None]
    return (pctx is not None and pctx.model_size > 1
            and all(m.split for m in parts)
            and (lp.moe is None or pctx.moe_deferred_tp_reduce))


def _decode_attn(lp: Block, x, ck, cv, pos, cfg, *, window, pctx=None,
                 layout="whole"):
    h = lp.ln1(x)
    out = L.decode_attention_block(
        lp.attn, h, ck, cv, pos, _dims(cfg), window=window,
        softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
        mrope=cfg.mrope_sections, pctx=pctx, layout=layout)
    return out if lp.pn1 is None else lp.pn1(out)


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
    block's activations recomputed in the backward) when the context's
    ``remat`` field asks for it; none without a context, as the
    reference's one-device path.
    Both of the reference's policies ("full", and dots saved) recompute the
    whole block here."""
    if pctx is None or pctx.remat == "none":
        return fn
    from torch.utils.checkpoint import checkpoint
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


class _SeqGather(torch.autograd.Function):
    """:func:`_split_tp_seq_gather` in training: whatever schedule gathers,
    the whole sequence's cotangent is the same on every model rank, so the
    transpose (the reference's ``psum_scatter`` of the cotangent over the
    ranks that share it) is this rank's block of it."""

    @staticmethod
    def forward(ctx, x, pctx):
        ctx.part = x.shape[1]
        ctx.at = pctx.mesh.axis_index(pctx.model_axis) * ctx.part
        return _split_tp_seq_gather(x, pctx)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.at:ctx.at + ctx.part], None


def _cut(x, pctx):
    """This rank's block of the positions of x [B, S, D], whole on every
    model rank (backward: the blocks' cotangents all-gathered)."""
    m = pctx.model_size
    return mesh_ops.split(x, pctx.mesh.group(pctx.model_axis), m,
                          pctx.mesh.axis_index(pctx.model_axis), dim=1)


def _reduce_cut(x, pctx):
    """This rank's block of the positions of the sum over the model axis of
    the partials x [B, S, D]: one reduce-scatter (backward: the
    all-gather of the cotangents)."""
    m = pctx.model_size
    b, s, d = x.shape
    blocks = x.reshape(b, m, s // m, d).transpose(0, 1)    # [m, B, S/m, D]
    return mesh_ops.reduce_scatter(blocks, pctx.mesh.group(pctx.model_axis),
                                   m)


def _train_block(lp: Block, x, positions, cfg, pctx, window, sp=False):
    """One block of :func:`forward_hidden`: (x, the MoE aux or None).
    ``sp``: x is this rank's block of the positions, gathered at the entry
    and cut again at the exit."""
    if sp:
        x = (_SeqGather.apply(x, pctx) if x.requires_grad
             else _split_tp_seq_gather(x, pctx))
    x = x + _attn_part(lp, x, positions, cfg, window=window, pctx=pctx)
    if not sp:
        f, aux = _ffn_part(lp, x, cfg, pctx, with_aux=True)
        return x + f, aux
    f, aux = _ffn_part(lp, x, cfg, pctx, with_aux=True, reduce=False)
    if _ffn_partial(lp, pctx):
        f = _reduce_cut(f, pctx)
        if lp.pn2 is not None:
            # the norm works per position over the whole d_model, so it
            # may follow the cut; its weight through *f*, as the final
            # norm's (each rank's gradient is of its own positions)
            f = L.rmsnorm(L.to_model(lp.pn2.w, pctx), f, lp.pn2.eps)
        return _cut(x, pctx) + f, aux
    return _cut(x + f, pctx), aux


def forward_hidden(params: Transformer, cfg, x, positions, pctx=None):
    """Run the decoder stack on hidden states x [B, S, D] without a cache
    (training).  Returns (final-normed hidden, the MoE aux losses summed,
    fp32).  Under sequence parallelism (``context.seq_sharded``) the
    hidden is this rank's block of the positions."""
    wins = window_schedule(cfg, cfg.n_layers)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    sp = seq_sharded(pctx, x.shape[1])
    if sp:
        x = _cut(x, pctx)
    for i, lp in enumerate(params.blocks):
        block = _remat(functools.partial(
            _train_block, lp, positions=positions, cfg=cfg, pctx=pctx,
            window=None if wins is None else wins[i], sp=sp), pctx)
        x, aux = block(x)
        if aux is not None:
            aux_total = aux_total + aux
    if sp:
        fn = params.final_norm
        return L.rmsnorm(L.to_model(fn.w, pctx), x, fn.eps), aux_total
    return params.final_norm(x), aux_total


def logits_fn(params: Transformer, cfg, x, last_only=False):
    if last_only:
        x = x[:, -1:]
    return L.unembed(params.embed, x, params.unembed, cfg.final_softcap)


# ---------------------------------------------------------------------------
# encoder and cross-attention (enc-dec only)
# ---------------------------------------------------------------------------

def _cross_attention(p: L.Attention, x, enc_out, cfg, pctx=None):
    """Decoder cross-attention (the reference's ``_cross_attention``): q
    from x [B, S, D], k and v from the encoder output [B, T, D], no rope
    and no mask, through the attention kernel on [B, heads, len, dh]
    views of the projections (no transposed copies).  Over a model axis
    this rank's heads, from the whole ``enc_out``, and the row-parallel
    ``wo`` products summed over the axis (a replicated block: every head,
    nothing summed).  Returns [B, S, D]."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    pctx = L.model_ctx(p.split, pctx)
    x = L.to_model(x, pctx)
    enc_out = L.to_model(enc_out.to(x.dtype), pctx)
    wk, wv = p.wk, p.wv
    if not p.kv_split:        # whole on every rank, read in part
        wk, wv = L.to_model(wk, pctx), L.to_model(wv, pctx)
    q = (x @ p.wq).reshape(b, s, p.heads, dh)
    k = (enc_out @ wk).reshape(b, -1, p.kv_heads, dh)
    v = (enc_out @ wv).reshape(b, -1, p.kv_heads, dh)
    k, v = L._local_kv(p, k, v)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False)
    return L.reduce_over_model(
        o.transpose(1, 2).reshape(b, s, p.heads * dh) @ p.wo, pctx)


def _cross_part(lp: Block, x, enc_out, cfg, pctx=None):
    """The cross-attention half of a decoder block: ``lnx``, the
    attention, then ``pnx`` under ``post_norm``."""
    out = _cross_attention(lp.xattn, lp.lnx(x), enc_out, cfg, pctx)
    return out if lp.pnx is None else lp.pnx(out)


def encode(params: Transformer, cfg, src_embeds, pctx=None):
    """The encoder over the source embeddings [B, S, D]: each block's
    non-causal self-attention (rope over the source positions), then its
    FFN; then ``enc_norm``.  Returns [B, S, D] (whole on every model
    rank)."""
    b, s, _ = src_embeds.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=src_embeds.device).expand(b, s)

    def block(lp, x):
        x = x + _attn_part(lp, x, positions, cfg, window=None, causal=False,
                           pctx=pctx)
        f, _ = _ffn_part(lp, x, cfg, pctx)
        return x + f

    x = src_embeds
    for lp in params.enc_blocks:
        x = _remat(functools.partial(block, lp), pctx)(x)
    return params.enc_norm(x)


def forward_hidden_encdec(params: Transformer, cfg, tgt_embeds, positions,
                          enc_out, pctx=None):
    """The decoder stack without a cache (training): causal
    self-attention, cross-attention over ``enc_out``, FFN, a block at a
    time.  Returns the final-normed hidden [B, S, D]."""
    def block(lp, x):
        x = x + _attn_part(lp, x, positions, cfg, window=None, pctx=pctx)
        x = x + _cross_part(lp, x, enc_out, cfg, pctx)
        f, _ = _ffn_part(lp, x, cfg, pctx)
        return x + f

    x = tgt_embeds
    for lp in params.blocks:
        x = _remat(functools.partial(block, lp), pctx)(x)
    return params.final_norm(x)


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
    unless a server pads the cohort).  The encoder-decoder's cache also
    holds ``enc_out`` [B, max_len, D] (the reference's encdec cache)."""
    layout = L.kv_layout(cfg.n_kv_heads, pctx, max_len)
    shape = L.kv_cache_shape(cfg.n_kv_heads, cfg.head_dim, batch, max_len,
                             layout, L.tp_of(pctx)[0])
    cache = {
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
    if cfg.family == "encdec":
        # a top-level tensor, so a reused decode slot zeroes it
        cache["enc_out"] = torch.zeros((batch, max_len, cfg.d_model),
                                       dtype=dtype, device=device)
    return cache


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


# ---------------------------------------------------------------------------
# enc-dec serving
# ---------------------------------------------------------------------------

def prefill_encdec(params: Transformer, cfg, src_embeds, tgt_embeds,
                   positions, cache, pctx=None):
    """Encode the source once, run the decoder over the target prefix,
    fill the decoder's self-attention caches and write the encoder output
    into ``enc_out`` (all in place).  ``enc_out``'s rows past the source
    are zeroed: decode attends over all ``max_len`` rows of it, as the
    reference's zero-padded buffer (whose prefill attends to the source
    rows alone).  A source longer than the cache raises (the reference
    returns an unpadded buffer of the source's length there, which fixed
    buffers cannot hold).  Returns (last-position logits [B, 1, V],
    cache)."""
    src = src_embeds.shape[1]
    buf = cache["enc_out"]
    if src > buf.shape[1]:
        raise ValueError(f"source of {src} rows longer than the cache's "
                         f"{buf.shape[1]}")
    enc_out = encode(params, cfg, src_embeds, pctx)
    x = tgt_embeds
    for i, lp in enumerate(params.blocks):
        a, (k, v) = _attn_part(lp, x, positions, cfg, window=None,
                               return_kv=True, pctx=pctx)
        x = x + a
        x = x + _cross_part(lp, x, enc_out, cfg, pctx)
        f, _ = _ffn_part(lp, x, cfg, pctx)
        x = x + f
        L.write_prefill_kv(lp.attn, cache["k"][i], cache["v"][i], k, v,
                           cache["layout"], pctx)
    buf[:, :src] = enc_out.to(buf.dtype)
    buf[:, src:].zero_()
    seq = tgt_embeds.shape[1]
    cache["pos"].fill_(seq)
    cache["len"] = seq
    x = params.final_norm(x)
    return logits_fn(params, cfg, x, last_only=True), cache


def decode_step_encdec(params: Transformer, cfg, x, cache, pctx=None):
    """One decode token of the encoder-decoder: each block's self-attention
    over its cache, cross-attention over the whole ``enc_out`` (its k and v
    recomputed, as the reference does), FFN.  Reads the position from the
    device scalar only, so a CUDA graph of it replays at any position.
    Returns (logits [B, 1, V], cache)."""
    pos = cache["pos"]
    enc_out = cache["enc_out"]
    for i, lp in enumerate(params.blocks):
        x = x + _decode_attn(lp, x, cache["k"][i], cache["v"][i], pos, cfg,
                             window=None, pctx=pctx, layout=cache["layout"])
        x = x + _cross_part(lp, x, enc_out, cfg, pctx)
        f, _ = _ffn_part(lp, x, cfg, pctx)
        x = x + f
    pos.add_(1)
    x = params.final_norm(x)
    return logits_fn(params, cfg, x, last_only=True), cache
