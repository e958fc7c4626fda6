"""RWKV-6 ("Finch") blocks and stack, on the serving path.

Port of ``src/repro/models/rwkv.py`` (prefill and decode with states):
time-mix (WKV6 with a data-dependent per-channel decay from a rank-
``rwkv_decay_lora`` LoRA) and channel-mix (squared ReLU), with static
token-shift mixing coefficients as in the reference.

Prefill runs the ``rwkv6_scan`` kernel, which also returns the final WKV
state; decode is the plain one-token update.  Decode state per layer: two
shift registers [B, D] (cache dtype) and the WKV state [B, H, dk, dv]
(fp32), stacked over layers and updated in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L


def _dims(cfg: ModelConfig):
    dk = cfg.rwkv_head_dim
    return cfg.d_model // dk, dk


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class RWKVBlock(nn.Module):
    """Parameters of one block, named as the reference's pytree.  The
    projections and the mixing coefficients ``mu``/``cmu`` (which the
    reference casts to the activations' dtype at each use) in the compute
    dtype; the norms and the decay and bonus parameters ``w0``, ``wA``,
    ``wB``, ``u`` (used in fp32) in fp32."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        heads, dk = _dims(cfg)
        lora = cfg.rwkv_decay_lora
        mat = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.ln1 = L.RMSNorm(d, device=device, eps=cfg.norm_eps)
        self.ln2 = L.RMSNorm(d, device=device, eps=cfg.norm_eps)
        self.mu = L.parameter((5, d), **mat)            # r, k, v, w, g mixes
        self.wr = L.parameter((d, d), **mat)
        self.wk = L.parameter((d, d), **mat)
        self.wv = L.parameter((d, d), **mat)
        self.wg = L.parameter((d, d), **mat)
        self.w0 = L.parameter((d,), **f32)              # base log-log decay
        self.wA = L.parameter((d, lora), **f32)
        self.wB = L.parameter((lora, d), **f32)
        self.u = L.parameter((heads, dk), **f32)
        self.gn = L.RMSNorm(d, device=device, eps=cfg.norm_eps)
        self.wo = L.parameter((d, d), **mat)
        self.cmu = L.parameter((2, d), **mat)           # k, r mixes
        self.ck = L.parameter((d, f), **mat)
        self.cr = L.parameter((d, d), **mat)
        self.cv = L.parameter((f, d), **mat)

    def reset_parameters(self, generator: torch.Generator) -> "RWKVBlock":
        d, f = self.ck.shape
        sc = 1.0 / math.sqrt(d)
        for w, scale in ((self.mu, 0.3), (self.wr, sc), (self.wk, sc),
                         (self.wv, sc), (self.wg, sc), (self.wA, sc),
                         (self.wB, 1.0 / math.sqrt(self.wB.shape[0])),
                         (self.u, 0.3), (self.wo, sc), (self.cmu, 0.3),
                         (self.ck, sc), (self.cr, sc),
                         (self.cv, 1.0 / math.sqrt(f))):
            L.truncated_normal_(w, scale, generator)
        with torch.no_grad():
            self.w0.zero_()
        return self


class RWKV6(nn.Module):
    """Embedding, input norm, the blocks, final norm and the untied
    unembedding [D, V]."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, device=device,
                                 dtype=dtype)
        self.ln_in = L.RMSNorm(cfg.d_model, device=device, eps=cfg.norm_eps)
        self.final_norm = L.RMSNorm(cfg.d_model, device=device,
                                    eps=cfg.norm_eps)
        self.layers = nn.ModuleList(
            RWKVBlock(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))
        self.unembed = L.parameter((cfg.d_model, cfg.vocab), device=device,
                                   dtype=dtype)


def init_rwkv6(cfg: ModelConfig, *, generator: torch.Generator, device,
               dtype) -> RWKV6:
    """Random weights drawn from ``generator`` at the reference's scales."""
    params = RWKV6(cfg, device=device, dtype=dtype)
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


def _decay_logw(p: RWKVBlock, xw):
    """Data-dependent per-channel log decay (<= 0), in fp32."""
    lo = torch.tanh(xw.float() @ p.wA) @ p.wB
    return -torch.exp(p.w0 + lo)


def time_mix(p: RWKVBlock, x, cfg: ModelConfig):
    """Prefill time-mix through the ``rwkv6_scan`` kernel.  x [B, S, D].
    Returns (out [B, S, D], new shift register x[:, -1], final WKV state
    [B*H, dk, dv] fp32)."""
    b, s, d = x.shape
    heads, dk = _dims(cfg)
    xx = _shift_train(x)
    xr, xk, xv, xw, xg = (_mix(x, xx, p.mu[i]) for i in range(5))
    r, k, v, g = xr @ p.wr, xk @ p.wk, xv @ p.wv, xg @ p.wg
    logw = _decay_logw(p, xw)                              # [B, S, D] fp32

    def to_heads(t):
        return t.reshape(b, s, heads, dk).transpose(1, 2).reshape(
            b * heads, s, dk)

    y, final = ops.rwkv6_scan(to_heads(r), to_heads(k), to_heads(v),
                              to_heads(logw), p.u.repeat(b, 1))
    y = y.reshape(b, heads, s, dk).transpose(1, 2).reshape(b, s, d)
    y = L.rmsnorm(p.gn.w, y, cfg.norm_eps)
    return (y * F.silu(g)) @ p.wo, x[:, -1], final


def time_mix_decode(p: RWKVBlock, x, shift, wkv, cfg: ModelConfig):
    """One token.  x [B, 1, D]; shift [B, D]; wkv [B, H, dk, dv].
    Returns (out, new shift, new WKV state [B, H, dk, dv])."""
    b, _, d = x.shape
    heads, dk = _dims(cfg)
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
    y = L.rmsnorm(p.gn.w, y.reshape(b, 1, d).to(x.dtype), cfg.norm_eps)
    return ((y * F.silu(g[:, None])) @ p.wo, x[:, -1],
            state.reshape(b, heads, dk, dk))


def channel_mix(p: RWKVBlock, x, shift=None):
    """x [B, S, D]; shift [B, D] (decode) or None.  Returns (out, new
    shift register x[:, -1])."""
    xx = _shift_train(x) if shift is None else shift[:, None].to(x.dtype)
    xk = _mix(x, xx, p.cmu[0])
    xr = _mix(x, xx, p.cmu[1])
    k = torch.square(F.relu(xk @ p.ck))
    return torch.sigmoid(xr @ p.cr) * (k @ p.cv), x[:, -1]


# ---------------------------------------------------------------------------
# stack: prefill / decode with states
# ---------------------------------------------------------------------------

def rwkv6_init_state(cfg: ModelConfig, batch: int, *, device,
                     dtype=torch.bfloat16) -> dict:
    heads, dk = _dims(cfg)
    n = cfg.n_layers
    return {
        "tshift": torch.zeros((n, batch, cfg.d_model), dtype=dtype,
                              device=device),
        "cshift": torch.zeros((n, batch, cfg.d_model), dtype=dtype,
                              device=device),
        "wkv": torch.zeros((n, batch, heads, dk, dk), dtype=torch.float32,
                           device=device),
        "len": 0,
    }


def rwkv6_prefill(params: RWKV6, cfg: ModelConfig, x, cache: dict):
    """Prefill, filling every layer's state in place.  x [B, S, D].
    Returns (final-normed hidden [B, S, D], cache)."""
    x = params.ln_in(x)
    b = x.shape[0]
    heads, dk = _dims(cfg)
    for li, lp in enumerate(params.layers):
        t, tsh, wkv = time_mix(lp, lp.ln1(x), cfg)
        x = x + t
        c, csh = channel_mix(lp, lp.ln2(x))
        x = x + c
        cache["tshift"][li] = tsh.to(cache["tshift"].dtype)
        cache["cshift"][li] = csh.to(cache["cshift"].dtype)
        cache["wkv"][li] = wkv.reshape(b, heads, dk, dk)
    cache["len"] = x.shape[1]
    return params.final_norm(x), cache


def rwkv6_decode_step(params: RWKV6, cfg: ModelConfig, x, cache: dict):
    """One token; states updated in place.  x [B, 1, D].  Returns
    (final-normed hidden [B, 1, D], cache)."""
    x = params.ln_in(x)
    for li, lp in enumerate(params.layers):
        t, tsh, wkv = time_mix_decode(lp, lp.ln1(x), cache["tshift"][li],
                                      cache["wkv"][li], cfg)
        x = x + t
        c, csh = channel_mix(lp, lp.ln2(x), cache["cshift"][li])
        x = x + c
        cache["tshift"][li] = tsh.to(cache["tshift"].dtype)
        cache["cshift"][li] = csh.to(cache["cshift"].dtype)
        cache["wkv"][li] = wkv
    cache["len"] += 1
    return params.final_norm(x), cache
