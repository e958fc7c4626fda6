"""Mamba2 blocks and the Zamba2 hybrid stack, on the serving path.

Port of ``src/repro/models/ssm.py`` (prefill and decode with caches).
Zamba2 interleaves a backbone of Mamba2 (SSD) blocks with ONE shared
attention+MLP block (``transformer.Block(moe=False)``) applied after every
``shared_attn_every`` mamba layers, as long as layers remain: 13 times for
Zamba2-7B's 81 layers.

Mamba2 block: in_proj -> (z gate, x, B, C, dt) -> causal depthwise conv on
x -> SSD scan (the ``mamba2_scan`` kernel at prefill, the plain one-token
update at decode) -> z-gated RMSNorm -> out_proj.  B and C are one group
shared by every head; the kernel reads them per group instead of
repeating them per head as the reference does.

Decode state per layer: the conv tail [B, conv-1, d_inner] (pre-SiLU x, in
the cache dtype) and the SSD state [B, heads, ds, dh] (fp32), stacked over
layers; one KV cache pair per shared-block invocation.  Caches are updated
in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _inner_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    return d_inner, heads


def n_shared_calls(cfg: ModelConfig) -> int:
    """Invocations of the shared block per forward pass."""
    return max(0, (cfg.n_layers - 1) // cfg.shared_attn_every)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Mamba2Block(nn.Module):
    """Parameters of one Mamba2 block, named as the reference's pytree.
    Matrices and the conv kernel in the compute dtype; the norms,
    ``A_log`` (A = -exp(A_log)), ``D`` and ``dt_bias`` in fp32."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        d_inner, heads = _inner_dims(cfg)
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

    def reset_parameters(self, generator: torch.Generator) -> "Mamba2Block":
        d, d_inner = self.in_proj.shape[0], self.out_proj.shape[0]
        L.truncated_normal_(self.in_proj, 1 / math.sqrt(d), generator)
        L.truncated_normal_(self.conv, 0.5, generator)
        L.truncated_normal_(self.out_proj, 1 / math.sqrt(d_inner), generator)
        with torch.no_grad():
            self.A_log.zero_()
            self.D.fill_(1.0)
            self.dt_bias.zero_()
        return self


class Zamba2(nn.Module):
    """Embedding (tied), the mamba blocks, the one shared attention+MLP
    block and the final norm."""

    unembed = None      # tied embeddings

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab, cfg.d_model, device=device,
                                 dtype=dtype)
        self.final_norm = L.RMSNorm(cfg.d_model, device=device,
                                    eps=cfg.norm_eps)
        self.mamba = nn.ModuleList(
            Mamba2Block(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))
        self.shared = T.Block(cfg, moe=False, device=device, dtype=dtype)


def init_zamba2(cfg: ModelConfig, *, generator: torch.Generator, device,
                dtype) -> Zamba2:
    """Random weights drawn from ``generator`` at the reference's scales."""
    params = Zamba2(cfg, device=device, dtype=dtype)
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


def _gated_out(p: Mamba2Block, y, z, cfg):
    y = L.rmsnorm(p.out_norm.w, y * F.silu(z), cfg.norm_eps)
    return y @ p.out_proj


def mamba2_block_prefill(p: Mamba2Block, x, cfg: ModelConfig):
    """x [B, S, D] -> (out [B, S, D], conv tail [B, K-1, d_inner], final
    SSD state [B, heads, ds, dh] fp32), through the ``mamba2_scan``
    kernel."""
    b, s, _ = x.shape
    d_inner, heads = _inner_dims(cfg)
    dh, ds = cfg.ssm_head_dim, cfg.ssm_state
    proj = p.ln(x) @ p.in_proj
    z, xc, bmat, cmat, dt_raw = _split_proj(proj, cfg, d_inner)
    xc, conv_tail = _causal_conv(xc, p.conv)
    dt = F.softplus(dt_raw.float() + p.dt_bias)              # [B, S, heads]
    a = -torch.exp(p.A_log)
    # head-major rows for the kernel: [B*heads, S, dh]
    xh = xc.reshape(b, s, heads, dh).transpose(1, 2).reshape(b * heads, s, dh)
    dth = dt.transpose(1, 2).reshape(b * heads, s)
    # B, C: one group per sequence, read by all of its heads
    y, hf = ops.mamba2_scan(xh, dth, a.repeat(b), bmat.contiguous(),
                            cmat.contiguous(), p.D.repeat(b))
    y = y.reshape(b, heads, s, dh).transpose(1, 2).reshape(b, s, d_inner)
    return _gated_out(p, y, z, cfg), conv_tail, hf.reshape(b, heads, ds, dh)


def mamba2_block_decode(p: Mamba2Block, x, conv_state, ssd_state,
                        cfg: ModelConfig):
    """One token.  x [B, 1, D]; conv_state [B, K-1, d_inner]; ssd_state
    [B, heads, ds, dh].  Returns (out, new conv tail, new SSD state)."""
    b = x.shape[0]
    d_inner, heads = _inner_dims(cfg)
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
    return _gated_out(p, y, z, cfg), conv_tail, ssd.reshape(b, heads, ds, dh)


# ---------------------------------------------------------------------------
# the Zamba2 stack: prefill / decode with caches
# ---------------------------------------------------------------------------

def zamba2_init_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device, dtype=torch.bfloat16) -> dict:
    d_inner, heads = _inner_dims(cfg)
    n_shared = n_shared_calls(cfg)
    kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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
    }


def _shared_after(li: int, cfg: ModelConfig) -> bool:
    """Whether the shared block runs after mamba layer ``li``."""
    return (li + 1) % cfg.shared_attn_every == 0 and li + 1 < cfg.n_layers


def zamba2_prefill(params: Zamba2, cfg: ModelConfig, x, cache: dict):
    """Prefill the hybrid stack, filling every layer's decode state in
    place.  x [B, S, D].  Returns (final-normed hidden [B, S, D], cache)."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    si = 0
    for li, lp in enumerate(params.mamba):
        y, conv_tail, ssd = mamba2_block_prefill(lp, x, cfg)
        x = x + y
        cache["conv"][li] = conv_tail.to(cache["conv"].dtype)
        cache["ssd"][li] = ssd
        if _shared_after(li, cfg):
            a, (k, v) = T._attn_part(params.shared, x, positions, cfg,
                                     window=None, return_kv=True)
            x = x + a
            f, _ = T._ffn_part(params.shared, x, cfg)
            x = x + f
            cache["k"][si][:, :s] = k.to(cache["k"][si].dtype)
            cache["v"][si][:, :s] = v.to(cache["v"][si].dtype)
            si += 1
    cache["pos"].fill_(s)
    cache["len"] = s
    return params.final_norm(x), cache


def zamba2_decode_step(params: Zamba2, cfg: ModelConfig, x, cache: dict):
    """One token through the hybrid stack; caches and the device position
    updated in place (the host ``len`` is the caller's).  x [B, 1, D].
    Returns (final-normed hidden [B, 1, D], cache)."""
    pos = cache["pos"]
    si = 0
    for li, lp in enumerate(params.mamba):
        y, conv_tail, ssd = mamba2_block_decode(
            lp, x, cache["conv"][li], cache["ssd"][li], cfg)
        x = x + y
        cache["conv"][li] = conv_tail.to(cache["conv"].dtype)
        cache["ssd"][li] = ssd
        if _shared_after(li, cfg):
            a = T._decode_attn(params.shared, x, cache["k"][si],
                               cache["v"][si], pos, cfg, window=None)
            x = x + a
            f, _ = T._ffn_part(params.shared, x, cfg)
            x = x + f
            si += 1
    pos.add_(1)
    return params.final_norm(x), cache
