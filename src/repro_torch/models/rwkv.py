"""RWKV-6 ("Finch") blocks and stack.

Port of ``src/repro/models/rwkv.py`` (training, prefill and decode with
states):
time-mix (WKV6 with a data-dependent per-channel decay from a rank-
``rwkv_decay_lora`` LoRA) and channel-mix (squared ReLU), with static
token-shift mixing coefficients as in the reference.

Prefill runs the ``rwkv6_scan`` kernel, which also returns the final WKV
state; decode is the plain one-token update.  Training runs the blocks
without a state (:func:`rwkv6_hidden`, each block under
``transformer._remat``) through the scan's autograd Function, whose
backward is the ``rwkv6_scan_bwd`` kernel (the final state's gradient
None).  Decode state per layer: two
shift registers [B, D] (cache dtype) and the WKV state [B, H, dk, dv]
(fp32), stacked over layers and updated in place.

Over the model axis of a ``pctx`` (``tp = (m, r)``; ``sharding.py``'s
column/row rules): a rank keeps the head columns of ``wr``, ``wk``, ``wv``
and ``wg`` and the columns of ``wB`` for its ``H / m`` heads, its channels
of ``w0`` and ``gn`` (an RMSNorm over all of D, not per head: its sum of
squares is summed over the model axis) and its heads of ``u``, and the rows
of ``wo``, whose products are summed over the model axis.  ``wA`` stays
whole: ``tanh(x @ wA) @ wB`` contracts over its LoRA columns, which the
reference's spec splits, so a split would need a gather.  The channel
mix splits ``ck``'s columns and ``cv``'s rows and sums ``k @ cv`` over the
model axis before ``sigmoid(xr @ cr)`` gates it; ``cr`` stays whole on
every rank (D x D, 33.6 MB a layer in bf16 at RWKV6-7B's width), so the
gate needs no gather.  The residual and the shift registers stay whole;
``wkv`` is [B, H / m, dk, dv] (``sharding.cache_specs``), and the scan
runs at ``B * H / m`` rows.  Where the heads (or the channel-mix width) do
not divide over the model axis, the time mix (or the channel mix) is
replicated (``layers.splits``): whole on every rank, nothing summed.
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


def _dims(cfg: ModelConfig, m: int = 1):
    """(heads, head dim), or a rank's heads over ``m`` model ranks (all
    of them where they do not divide over ``m``: the time mix is then
    replicated, ``layers.splits``)."""
    dk = cfg.rwkv_head_dim
    heads = cfg.d_model // dk
    return (heads // m if L.splits(heads, m) else heads), dk


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class RWKVBlock(nn.Module):
    """Parameters of one block, named as the reference's pytree.  The
    projections and the mixing coefficients ``mu``/``cmu`` (which the
    reference casts to the activations' dtype at each use) in the compute
    dtype; the norms and the decay and bonus parameters ``w0``, ``wA``,
    ``wB``, ``u`` (used in fp32) in fp32."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, tp=(1, 0)):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        m, r = tp
        heads, dk = _dims(cfg, m)
        self.split = L.splits(cfg.d_model // dk, m)       # the time mix
        self.cmix_split = L.splits(f, m)                 # the channel mix
        dl, fl = heads * dk, (f // m if self.cmix_split else f)
        self.d, self.f = d, f
        lora = cfg.rwkv_decay_lora
        mat = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.ln1 = L.RMSNorm(d, device=device, eps=cfg.norm_eps)
        self.ln2 = L.RMSNorm(d, device=device, eps=cfg.norm_eps)
        self.mu = L.parameter((5, d), **mat)            # r, k, v, w, g mixes
        self.wr = L.parameter((d, dl), **mat)
        self.wk = L.parameter((d, dl), **mat)
        self.wv = L.parameter((d, dl), **mat)
        self.wg = L.parameter((d, dl), **mat)
        self.w0 = L.parameter((dl,), **f32)             # base log-log decay
        self.wA = L.parameter((d, lora), **f32)
        self.wB = L.parameter((lora, dl), **f32)
        self.u = L.parameter((heads, dk), **f32)
        self.gn = L.RMSNorm(dl, device=device, eps=cfg.norm_eps)
        self.wo = L.parameter((dl, d), **mat)
        self.cmu = L.parameter((2, d), **mat)           # k, r mixes
        self.ck = L.parameter((d, fl), **mat)
        self.cr = L.parameter((d, d), **mat)
        self.cv = L.parameter((fl, d), **mat)
        self.shards = {}
        col, row = (1, m, r), (0, m, r)
        if self.split:
            self.shards = {"wr": col, "wk": col, "wv": col, "wg": col,
                           "w0": row, "wB": col, "u": row, "wo": row}
            self.gn.shards = {"w": row}
        if self.cmix_split:
            self.shards.update(ck=col, cv=row)

    def reset_parameters(self, generator: torch.Generator) -> "RWKVBlock":
        d, f = self.d, self.f
        sc = 1.0 / math.sqrt(d)
        for name, scale in (("mu", 0.3), ("wr", sc), ("wk", sc), ("wv", sc),
                            ("wg", sc), ("wA", sc),
                            ("wB", 1.0 / math.sqrt(self.wB.shape[0])),
                            ("u", 0.3), ("wo", sc), ("cmu", 0.3), ("ck", sc),
                            ("cr", sc), ("cv", 1.0 / math.sqrt(f))):
            L.truncated_normal_(getattr(self, name), scale, generator,
                                shard=self.shards.get(name))
        with torch.no_grad():
            self.w0.zero_()
        return self


class RWKV6(nn.Module):
    """Embedding, input norm, the blocks, final norm and the untied
    unembedding [D, V]; with a ``pctx``, a model rank's part of the blocks
    (the rest whole)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype, pctx=None):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, device=device,
                                 dtype=dtype)
        self.ln_in = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
        self.final_norm = L.RMSNorm(cfg.d_model, device=device,
                                    eps=cfg.norm_eps)
        self.layers = nn.ModuleList(
            RWKVBlock(cfg, device=device, dtype=dtype, tp=L.tp_of(pctx))
            for _ in range(cfg.n_layers))
        self.unembed = L.parameter((cfg.d_model, cfg.vocab), device=device,
                                   dtype=dtype)


def init_rwkv6(cfg: ModelConfig, *, generator: torch.Generator, device,
               dtype, pctx=None) -> RWKV6:
    """Random weights drawn from ``generator`` at the reference's scales
    (each split tensor drawn whole and cut: a rank's weights are the
    one-rank model's slices)."""
    params = RWKV6(cfg, device=device, dtype=dtype, pctx=pctx)
    params.embed.reset_parameters(generator)
    for blk in params.layers:
        blk.reset_parameters(generator)
    L.truncated_normal_(params.unembed, cfg.d_model ** -0.5, generator)
    return params


# ---------------------------------------------------------------------------
# time mix / channel mix
# ---------------------------------------------------------------------------

def _shift_train(x):
    """xx[t] = x[t-1], zeros at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _decay_logw(p: RWKVBlock, xw, pctx=None):
    """Data-dependent per-channel log decay (<= 0), in fp32 (this rank's
    channels over a model axis: ``wA`` whole, ``wB``'s columns)."""
    lo = L.to_model(torch.tanh(xw.float() @ p.wA), pctx) @ p.wB
    return -torch.exp(p.w0 + lo)


def _gated_out(p: RWKVBlock, y, g, cfg: ModelConfig, pctx):
    """``gn`` (an RMSNorm over all of D), the SiLU gate, then ``wo`` (over
    the model axis: this rank's rows, the products summed)."""
    y = L.rmsnorm_over_model(p.gn.w, y, p.d, pctx, cfg.norm_eps)
    return L.reduce_over_model((y * F.silu(g)) @ p.wo, pctx)


def time_mix(p: RWKVBlock, x, cfg: ModelConfig, pctx=None):
    """Prefill time-mix through the ``rwkv6_scan`` kernel.  x [B, S, D].
    Returns (out [B, S, D], new shift register x[:, -1], final WKV state
    [B*H, dk, dv] fp32; this rank's heads over a model axis)."""
    b, s, _ = x.shape
    heads, dk = p.u.shape
    d = heads * dk
    xx = _shift_train(x)
    xr, xk, xv, xw, xg = (_mix(x, xx, p.mu[i]) for i in range(5))
    pctx = L.model_ctx(p.split, pctx)
    r, k, v, g = (L.to_model(t, pctx) @ w for t, w in (
        (xr, p.wr), (xk, p.wk), (xv, p.wv), (xg, p.wg)))
    logw = _decay_logw(p, xw, pctx)                        # [B, S, D] fp32

    def to_heads(t):
        # contiguous rows for the kernel (one sequence's is a strided view)
        return t.reshape(b, s, heads, dk).transpose(1, 2).reshape(
            b * heads, s, dk).contiguous()

    y, final = ops.rwkv6_scan(to_heads(r), to_heads(k), to_heads(v),
                              to_heads(logw), p.u.repeat(b, 1))
    y = y.reshape(b, heads, s, dk).transpose(1, 2).reshape(b, s, d)
    return _gated_out(p, y, g, cfg, pctx), x[:, -1], final


def time_mix_decode(p: RWKVBlock, x, shift, wkv, cfg: ModelConfig,
                    pctx=None):
    """One token.  x [B, 1, D]; shift [B, D]; wkv [B, H, dk, dv] (this
    rank's heads over a model axis).  Returns (out, new shift, new WKV
    state [B, H, dk, dv])."""
    b = x.shape[0]
    heads, dk = p.u.shape
    d = heads * dk
    xx = shift[:, None].to(x.dtype)
    xr, xk, xv, xw, xg = (_mix(x, xx, p.mu[i]) for i in range(5))
    r, k, v, g = ((t @ w)[:, 0] for t, w in ((xr, p.wr), (xk, p.wk),
                                            (xv, p.wv), (xg, p.wg)))
    logw = _decay_logw(p, xw)[:, 0]                        # [B, D]

    def to_heads(t):
        return t.reshape(b * heads, dk)

    state, y = ref.rwkv6_decode_step(
        wkv.reshape(b * heads, dk, dk), to_heads(r.float()),
        to_heads(k.float()), to_heads(v.float()), to_heads(logw),
        p.u.repeat(b, 1))
    return (_gated_out(p, y.reshape(b, 1, d).to(x.dtype), g[:, None], cfg,
                       L.model_ctx(p.split, pctx)), x[:, -1],
            state.reshape(b, heads, dk, dk))


def channel_mix(p: RWKVBlock, x, shift=None, pctx=None):
    """x [B, S, D]; shift [B, D] (decode) or None.  Returns (out, new
    shift register x[:, -1]).  Over a model axis ``k @ cv`` is this rank's
    partial sum: it is summed over the axis, then gated by the whole
    ``sigmoid(xr @ cr)``."""
    xx = _shift_train(x) if shift is None else shift[:, None].to(x.dtype)
    xk = _mix(x, xx, p.cmu[0])
    xr = _mix(x, xx, p.cmu[1])
    pctx = L.model_ctx(p.cmix_split, pctx)
    k = torch.square(F.relu(L.to_model(xk, pctx) @ p.ck))
    return (torch.sigmoid(xr @ p.cr)
            * L.reduce_over_model(k @ p.cv, pctx)), x[:, -1]


# ---------------------------------------------------------------------------
# stack: training without a state
# ---------------------------------------------------------------------------

def _block(lp: RWKVBlock, x, cfg: ModelConfig, pctx):
    x = x + time_mix(lp, lp.ln1(x), cfg, pctx)[0]
    return x + channel_mix(lp, lp.ln2(x), pctx=pctx)[0]


def rwkv6_hidden(params: RWKV6, cfg: ModelConfig, x, pctx=None):
    """The stack without a state (training; the reference's
    ``rwkv6_hidden``): ``ln_in``, each block under ``transformer._remat``,
    the final norm.  x [B, S, D].  Returns the final-normed hidden
    [B, S, D]."""
    x = params.ln_in(x)
    for lp in params.layers:
        x = T._remat(functools.partial(_block, lp, cfg=cfg, pctx=pctx),
                   pctx)(x)
    return params.final_norm(x)


# ---------------------------------------------------------------------------
# stack: prefill / decode with states
# ---------------------------------------------------------------------------

def rwkv6_init_state(cfg: ModelConfig, batch: int, *, device,
                     dtype=torch.bfloat16, pctx=None) -> dict:
    """The decode state (a model rank's with a ``pctx``: the shift
    registers whole, the WKV states of its heads)."""
    heads, dk = _dims(cfg, L.tp_of(pctx)[0])
    n = cfg.n_layers
    return {
        "tshift": torch.zeros((n, batch, cfg.d_model), dtype=dtype,
                              device=device),
        "cshift": torch.zeros((n, batch, cfg.d_model), dtype=dtype,
                              device=device),
        "wkv": torch.zeros((n, batch, heads, dk, dk), dtype=torch.float32,
                           device=device),
        "pos": L.position(device),
        "len": 0,
    }


def rwkv6_prefill(params: RWKV6, cfg: ModelConfig, x, cache: dict,
                  pctx=None):
    """Prefill, filling every layer's state in place.  x [B, S, D].
    Returns (final-normed hidden [B, S, D], cache)."""
    x = params.ln_in(x)
    b = x.shape[0]
    heads, dk = cache["wkv"].shape[2:4]
    for li, lp in enumerate(params.layers):
        t, tsh, wkv = time_mix(lp, lp.ln1(x), cfg, pctx)
        x = x + t
        c, csh = channel_mix(lp, lp.ln2(x), pctx=pctx)
        x = x + c
        cache["tshift"][li] = tsh.to(cache["tshift"].dtype)
        cache["cshift"][li] = csh.to(cache["cshift"].dtype)
        cache["wkv"][li] = wkv.reshape(b, heads, dk, dk)
    cache["pos"].fill_(x.shape[1])
    cache["len"] = x.shape[1]
    return params.final_norm(x), cache


def rwkv6_decode_step(params: RWKV6, cfg: ModelConfig, x, cache: dict,
                      pctx=None):
    """One token; states and the device position updated in place (the
    host ``len`` is the caller's).  x [B, 1, D].  Returns (final-normed
    hidden [B, 1, D], cache)."""
    x = params.ln_in(x)
    for li, lp in enumerate(params.layers):
        t, tsh, wkv = time_mix_decode(lp, lp.ln1(x), cache["tshift"][li],
                                      cache["wkv"][li], cfg, pctx)
        x = x + t
        c, csh = channel_mix(lp, lp.ln2(x), cache["cshift"][li], pctx)
        x = x + c
        cache["tshift"][li] = tsh.to(cache["tshift"].dtype)
        cache["cshift"][li] = csh.to(cache["cshift"].dtype)
        cache["wkv"][li] = wkv
    cache["pos"].add_(1)
    return params.final_norm(x), cache
