"""Mamba2 blocks and the Zamba2 hybrid stack.

Port of ``src/repro/models/ssm.py`` (training, prefill and decode with
caches).
Zamba2 interleaves a backbone of Mamba2 (SSD) blocks with ONE shared
attention+MLP block (``transformer.Block(moe=False)``) applied after every
``shared_attn_every`` mamba layers, as long as layers remain: 13 times for
Zamba2-7B's 81 layers.

Mamba2 block: in_proj -> (z gate, x, B, C, dt) -> causal depthwise conv on
x -> SSD scan (the ``mamba2_scan`` kernel at prefill, the plain one-token
update at decode) -> z-gated RMSNorm -> out_proj.  B and C are one group
shared by every head; the kernel reads them per group instead of
repeating them per head as the reference does.  Training runs the
blocks without a cache (:func:`zamba2_hidden`, each block under
``transformer._remat``): the scan's autograd Function takes its backward
kernel (``mamba2_scan_bwd``, which sums dB and dC over each group's
heads), and the final state's gradient is None.

Decode state per layer: the conv tail [B, conv-1, d_inner] (pre-SiLU x, in
the cache dtype) and the SSD state [B, heads, ds, dh] (fp32), stacked over
layers; one KV cache pair per shared-block invocation.  Caches are updated
in place.

Over the model axis of a ``pctx`` (``tp = (m, r)``), as the reference's
``in_proj`` column / ``out_proj`` row split (``sharding.py``): a rank keeps
the z, x and dt columns of its ``heads / m`` heads and the B and C columns
whole (one group, read by every head) as three segments of ``in_proj``,
its x channels of ``conv``, its heads of ``A_log``, ``D`` and ``dt_bias``,
its channels of ``out_norm`` (an RMSNorm over all of ``d_inner``: the sum
of squares is summed over the model axis, one [B, S, 1] fp32 tensor a
block) and its rows of ``out_proj``, whose products are summed over the
model axis.  The residual stays whole on every rank.  In training the B/C
product takes its cotangent summed over the axis (``_in_proj``) and the
norm's sum of squares its cotangents summed too
(``layers.rmsnorm_over_model``), so every rank's gradient of a whole
leaf is the whole gradient, the same bits on every rank.  Its caches are
``conv`` [B, K-1, d_inner / m] and ``ssd`` [B, heads / m, ds, dh]
(``sharding.cache_specs``), and the scan runs at ``B * heads / m`` rows.
The shared block takes the dense layers' tensor-parallel path, its KV
cache in ``layers.kv_layout``'s layout.  Where the SSM heads do not divide
over the model axis the block is replicated (``layers.splits``): every
rank holds and runs all of it, and nothing is summed.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _inner_dims(cfg: ModelConfig, m: int = 1):
    """(d_inner, SSM heads), or a rank's of them over ``m`` model ranks
    (all of them where the heads do not divide over ``m``: the block is
    then replicated, ``layers.splits``)."""
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    if L.splits(heads, m):
        heads //= m
    return heads * cfg.ssm_head_dim, heads


def in_proj_segments(cfg: ModelConfig, m: int, r: int) -> tuple:
    """The column segments of ``in_proj`` (``[z | x | B | C | dt]``) that
    model rank ``r`` of ``m`` keeps: the z and x channels and the dt
    columns of its heads, B and C whole, in that order."""
    d_inner, heads = _inner_dims(cfg)
    di, hl = d_inner // m, heads // m
    ds = cfg.ssm_state
    return ((r * di, (r + 1) * di),                            # z
            (d_inner + r * di, d_inner + (r + 1) * di),        # x
            (2 * d_inner, 2 * d_inner + 2 * ds),               # B, C
            (2 * d_inner + 2 * ds + r * hl,
             2 * d_inner + 2 * ds + (r + 1) * hl))             # dt


def n_shared_calls(cfg: ModelConfig) -> int:
    """Invocations of the shared block per forward pass."""
    return max(0, (cfg.n_layers - 1) // cfg.shared_attn_every)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Mamba2Block(nn.Module):
    """Parameters of one Mamba2 block, named as the reference's pytree.
    Matrices and the conv kernel in the compute dtype; the norms,
    ``A_log`` (A = -exp(A_log)), ``D`` and ``dt_bias`` in fp32.  Over
    ``tp = (m, r)`` model ranks, rank r's part (the module docstring)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, tp=(1, 0)):
        super().__init__()
        d = cfg.d_model
        m, r = tp
        self.width = cfg.ssm_expand * d             # all of d_inner
        self.split = L.splits(self.width // cfg.ssm_head_dim, m)
        d_inner, heads = _inner_dims(cfg, m)
        proj_out = 2 * d_inner + 2 * cfg.ssm_state + heads   # z, x, B, C, dt
        f32 = dict(device=device, dtype=torch.float32)
        self.ln = L.RMSNorm(d, device=device, eps=cfg.norm_eps)
        self.in_proj = L.parameter((d, proj_out), device=device, dtype=dtype)
        self.conv = L.parameter((cfg.ssm_conv, d_inner), device=device,
                                dtype=dtype)
        self.A_log = L.parameter((heads,), **f32)
        self.D = L.parameter((heads,), **f32)
        self.dt_bias = L.parameter((heads,), **f32)
        self.out_norm = L.RMSNorm(d_inner, device=device, eps=cfg.norm_eps)
        self.out_proj = L.parameter((d_inner, d), device=device, dtype=dtype)
        self.shards = {}
        if self.split:
            self.shards = {
                "in_proj": (1, 2 * self.width + 2 * cfg.ssm_state
                            + heads * m, in_proj_segments(cfg, m, r)),
                "conv": (1, m, r), "A_log": (0, m, r), "D": (0, m, r),
                "dt_bias": (0, m, r), "out_proj": (0, m, r)}
            # every model rank's segments (checkpoint.store.ShardLayout,
            # runtime.trainer.GradSync)
            self.segments_of = {"in_proj": functools.partial(
                in_proj_segments, cfg, m)}
            self.out_norm.shards = {"w": (0, m, r)}

    def reset_parameters(self, generator: torch.Generator) -> "Mamba2Block":
        d = self.in_proj.shape[0]
        sh = self.shards.get
        L.truncated_normal_(self.in_proj, 1 / math.sqrt(d), generator,
                            shard=sh("in_proj"))
        L.truncated_normal_(self.conv, 0.5, generator, shard=sh("conv"))
        L.truncated_normal_(self.out_proj, 1 / math.sqrt(self.width),
                            generator, shard=sh("out_proj"))
        with torch.no_grad():
            self.A_log.zero_()
            self.D.fill_(1.0)
            self.dt_bias.zero_()
        return self


class Zamba2(nn.Module):
    """Embedding (tied), the mamba blocks, the one shared attention+MLP
    block and the final norm; with a ``pctx``, a model rank's part of the
    blocks (the embedding and norms whole)."""

    unembed = None      # tied embeddings

    def __init__(self, cfg: ModelConfig, *, device, dtype, pctx=None):
        super().__init__()
        tp = L.tp_of(pctx)
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, device=device,
                                 dtype=dtype)
        self.final_norm = L.RMSNorm(cfg.d_model, device=device,
                                    eps=cfg.norm_eps)
        self.mamba = nn.ModuleList(
            Mamba2Block(cfg, device=device, dtype=dtype, tp=tp)
            for _ in range(cfg.n_layers))
        self.shared = T.Block(cfg, moe=False, device=device, dtype=dtype,
                              pctx=pctx)


def init_zamba2(cfg: ModelConfig, *, generator: torch.Generator, device,
                dtype, pctx=None) -> Zamba2:
    """Random weights drawn from ``generator`` at the reference's scales
    (each split tensor drawn whole and cut: a rank's weights are the
    one-rank model's slices)."""
    params = Zamba2(cfg, device=device, dtype=dtype, pctx=pctx)
    params.embed.reset_parameters(generator)
    for blk in params.mamba:
        blk.reset_parameters(generator)
    params.shared.attn.reset_parameters(generator)
    params.shared.mlp.reset_parameters(generator)
    return params


# ---------------------------------------------------------------------------
# the mamba2 block
# ---------------------------------------------------------------------------

def _split_proj(proj, cfg: ModelConfig, d_inner: int):
    ds = cfg.ssm_state
    z = proj[..., :d_inner]
    x = proj[..., d_inner:2 * d_inner]
    b = proj[..., 2 * d_inner:2 * d_inner + ds]
    c = proj[..., 2 * d_inner + ds:2 * d_inner + 2 * ds]
    dt = proj[..., 2 * d_inner + 2 * ds:]
    return z, x, b, c, dt


def _in_proj(p: Mamba2Block, h, cfg: ModelConfig, d_inner: int,
             pctx=None):
    """(z, x, B, C, dt) of the normed input ``h`` [B, S, D].  Over a model
    axis the z, x and dt columns are this rank's heads', a column-parallel
    product whose input takes *f* (``to_model``); B and C are whole on
    every rank but read by its own heads alone, so their product takes
    *f* on its output instead: their cotangent is summed over the axis
    before it reaches ``in_proj``'s B/C columns (whose gradient is then
    whole, the same on every rank) and ``h`` (whose cotangent from them is
    then whole too, so it must not pass ``to_model``'s sum again).  A
    replicated block takes the whole product, as on one rank."""
    if not p.split:
        return _split_proj(h @ p.in_proj, cfg, d_inner)
    lo, hi = 2 * d_inner, 2 * d_inner + 2 * cfg.ssm_state
    w = p.in_proj
    hm = L.to_model(h, pctx)
    zx = hm @ w[:, :lo]
    bc = L.to_model(h @ w[:, lo:hi], pctx)
    dt = hm @ w[:, hi:]
    return (zx[..., :d_inner], zx[..., d_inner:],
            bc[..., :cfg.ssm_state], bc[..., cfg.ssm_state:], dt)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x [B, S, C]; w [K, C]; state [B, K-1, C],
    the tail of earlier tokens (decode), or None.  Returns (SiLU of the
    conv, the new tail: the last K-1 inputs, before the conv)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(k))
    return F.silu(out), xp[:, -(k - 1):]


def _gated_out(p: Mamba2Block, y, z, cfg, pctx=None):
    """The z-gated RMSNorm over all of d_inner, then ``out_proj`` (over
    the model axis: this rank's rows, the products summed; a replicated
    block's whole, nothing summed)."""
    pctx = L.model_ctx(p.split, pctx)
    y = L.rmsnorm_over_model(p.out_norm.w, y * F.silu(z), p.width, pctx,
                             cfg.norm_eps)
    return L.reduce_over_model(y @ p.out_proj, pctx)


def mamba2_block_prefill(p: Mamba2Block, x, cfg: ModelConfig, pctx=None):
    """x [B, S, D] -> (out [B, S, D], conv tail [B, K-1, d_inner], final
    SSD state [B, heads, ds, dh] fp32), through the ``mamba2_scan``
    kernel (this rank's channels and heads over a model axis)."""
    b, s, _ = x.shape
    d_inner, heads = _inner_dims(cfg, L.tp_of(pctx)[0])
    dh, ds = cfg.ssm_head_dim, cfg.ssm_state
    z, xc, bmat, cmat, dt_raw = _in_proj(p, p.ln(x), cfg, d_inner, pctx)
    xc, conv_tail = _causal_conv(xc, p.conv)
    dt = F.softplus(dt_raw.float() + p.dt_bias)              # [B, S, heads]
    a = -torch.exp(p.A_log)
    # head-major rows for the kernel: [B*heads, S, dh]
    # (a reshape of one sequence's transpose is a strided view: the kernel
    # takes contiguous rows)
    xh = xc.reshape(b, s, heads, dh).transpose(1, 2).reshape(
        b * heads, s, dh).contiguous()
    dth = dt.transpose(1, 2).reshape(b * heads, s).contiguous()
    # B, C: one group per sequence, read by all of its heads
    y, hf = ops.mamba2_scan(xh, dth, a.repeat(b), bmat.contiguous(),
                            cmat.contiguous(), p.D.repeat(b))
    y = y.reshape(b, heads, s, dh).transpose(1, 2).reshape(b, s, d_inner)
    return (_gated_out(p, y, z, cfg, pctx), conv_tail,
            hf.reshape(b, heads, ds, dh))


def mamba2_block(p: Mamba2Block, x, cfg: ModelConfig, pctx=None):
    """The block's output alone, x [B, S, D] -> [B, S, D] (training: the
    reference's ``mamba2_block``): :func:`mamba2_block_prefill` with its
    states dropped."""
    return mamba2_block_prefill(p, x, cfg, pctx)[0]


def mamba2_block_decode(p: Mamba2Block, x, conv_state, ssd_state,
                        cfg: ModelConfig, pctx=None):
    """One token.  x [B, 1, D]; conv_state [B, K-1, d_inner]; ssd_state
    [B, heads, ds, dh] (this rank's over a model axis).  Returns (out, new
    conv tail, new SSD state)."""
    b = x.shape[0]
    d_inner, heads = _inner_dims(cfg, L.tp_of(pctx)[0])
    dh, ds = cfg.ssm_head_dim, cfg.ssm_state
    proj = p.ln(x) @ p.in_proj
    z, xc, bmat, cmat, dt_raw = _split_proj(proj, cfg, d_inner)
    xc, conv_tail = _causal_conv(xc, p.conv, conv_state)
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)        # [B, heads]
    a = -torch.exp(p.A_log)
    bh = bmat[:, 0, None].expand(b, heads, ds).reshape(-1, ds)
    ch = cmat[:, 0, None].expand(b, heads, ds).reshape(-1, ds)
    ssd, y = ref.mamba2_decode_step(
        ssd_state.reshape(b * heads, ds, dh), xc[:, 0].reshape(
            b * heads, dh).float(), dt.reshape(b * heads), a.repeat(b),
        bh.float(), ch.float(), p.D.repeat(b))
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    return (_gated_out(p, y, z, cfg, pctx), conv_tail,
            ssd.reshape(b, heads, ds, dh))


# ---------------------------------------------------------------------------
# the Zamba2 stack: training without a cache
# ---------------------------------------------------------------------------

def _mamba_residual(lp: Mamba2Block, x, cfg: ModelConfig, pctx):
    return x + mamba2_block(lp, x, cfg, pctx)


def _shared_block(shared: T.Block, x, positions, cfg: ModelConfig, pctx):
    x = x + T._attn_part(shared, x, positions, cfg, window=None, pctx=pctx)
    f, _ = T._ffn_part(shared, x, cfg, pctx)
    return x + f


def zamba2_hidden(params: Zamba2, cfg: ModelConfig, x, pctx=None):
    """The hybrid stack without a cache (training; the reference's
    ``zamba2_hidden``): each Mamba2 block, and the shared block after each
    group of ``shared_attn_every`` (:func:`_shared_after`), each call under
    ``transformer._remat``.  The reference leaves its shared block's calls
    outside remat; here they are recomputed too, so that no call keeps its
    activations for the backward.  x [B, S, D].  Returns the final-normed
    hidden [B, S, D]."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    shared = T._remat(functools.partial(
        _shared_block, params.shared, positions=positions, cfg=cfg,
        pctx=pctx), pctx)
    for li, lp in enumerate(params.mamba):
        x = T._remat(functools.partial(_mamba_residual, lp, cfg=cfg,
                                       pctx=pctx), pctx)(x)
        if _shared_after(li, cfg):
            x = shared(x)
    return params.final_norm(x)


# ---------------------------------------------------------------------------
# the Zamba2 stack: prefill / decode with caches
# ---------------------------------------------------------------------------

def zamba2_init_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device, dtype=torch.bfloat16, pctx=None) -> dict:
    """The decode state (a model rank's part of it with a ``pctx``): the
    conv tails and SSD states of its channels and heads, and the shared
    block's KV caches in ``layers.kv_layout``'s layout."""
    m = L.tp_of(pctx)[0]
    d_inner, heads = _inner_dims(cfg, m)
    n_shared = n_shared_calls(cfg)
    layout = L.kv_layout(cfg.n_kv_heads, pctx, max_len)
    kv_shape = L.kv_cache_shape(cfg.n_kv_heads, cfg.head_dim, batch,
                                max_len, layout, m)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, d_inner),
                            dtype=dtype, device=device),
        "ssd": torch.zeros((cfg.n_layers, batch, heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
        "k": [torch.zeros(kv_shape, dtype=dtype, device=device)
              for _ in range(n_shared)],
        "v": [torch.zeros(kv_shape, dtype=dtype, device=device)
              for _ in range(n_shared)],
        "pos": L.position(device),
        "len": 0,
        "max_len": max_len,
        "layout": layout,
    }


def _shared_after(li: int, cfg: ModelConfig) -> bool:
    """Whether the shared block runs after mamba layer ``li``."""
    return (li + 1) % cfg.shared_attn_every == 0 and li + 1 < cfg.n_layers


def zamba2_prefill(params: Zamba2, cfg: ModelConfig, x, cache: dict,
                   pctx=None):
    """Prefill the hybrid stack, filling every layer's decode state in
    place.  x [B, S, D].  Returns (final-normed hidden [B, S, D], cache)."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    layout = cache.get("layout", "whole")
    si = 0
    for li, lp in enumerate(params.mamba):
        y, conv_tail, ssd = mamba2_block_prefill(lp, x, cfg, pctx)
        x = x + y
        cache["conv"][li] = conv_tail.to(cache["conv"].dtype)
        cache["ssd"][li] = ssd
        if _shared_after(li, cfg):
            a, (k, v) = T._attn_part(params.shared, x, positions, cfg,
                                     window=None, return_kv=True, pctx=pctx)
            x = x + a
            f, _ = T._ffn_part(params.shared, x, cfg, pctx)
            x = x + f
            L.write_prefill_kv(params.shared.attn, cache["k"][si],
                               cache["v"][si], k, v, layout, pctx)
            si += 1
    cache["pos"].fill_(s)
    cache["len"] = s
    return params.final_norm(x), cache


def zamba2_decode_step(params: Zamba2, cfg: ModelConfig, x, cache: dict,
                       pctx=None):
    """One token through the hybrid stack; caches and the device position
    updated in place (the host ``len`` is the caller's).  x [B, 1, D].
    Returns (final-normed hidden [B, 1, D], cache)."""
    pos = cache["pos"]
    layout = cache.get("layout", "whole")
    si = 0
    for li, lp in enumerate(params.mamba):
        y, conv_tail, ssd = mamba2_block_decode(
            lp, x, cache["conv"][li], cache["ssd"][li], cfg, pctx)
        x = x + y
        cache["conv"][li] = conv_tail.to(cache["conv"].dtype)
        cache["ssd"][li] = ssd
        if _shared_after(li, cfg):
            a = T._decode_attn(params.shared, x, cache["k"][si],
                               cache["v"][si], pos, cfg, window=None,
                               pctx=pctx, layout=layout)
            x = x + a
            f, _ = T._ffn_part(params.shared, x, cfg, pctx)
            x = x + f
            si += 1
    pos.add_(1)
    return params.final_norm(x), cache
