"""Shared neural layers: norms, RoPE, MLPs, GQA attention, KV caches.

Port of ``src/repro/models/layers.py``.  Each layer is a plain function on
tensors whose first argument holds the parameters, plus an ``nn.Module``
that owns those parameters and draws them from an explicit
``torch.Generator`` (``reset_parameters``; ``init_*`` builds and draws).
Matrices are stored in the compute dtype (the reference stores fp32 and
casts at each use, which rounds to the same values); norm weights stay
fp32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops


def truncated_normal_(t: torch.Tensor, scale: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` with N(0, 1) truncated to [-2, 2], times ``scale``.
    Drawn in fp32 one slice of dim 0 at a time for stacked 3-d weights, so
    the fp32 temporary stays one expert's size."""
    with torch.no_grad():
        for part in (t if t.dim() == 3 else (t,)):
            tmp = torch.empty(part.shape, dtype=torch.float32,
                              device=part.device)
            nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            part.copy_(tmp.mul_(scale))
    return t


def parameter(shape, *, device, dtype) -> nn.Parameter:
    """An uninitialised inference parameter (no gradient)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """RMSNorm with a zero-initialised fp32 weight applied as ``1 + w``."""

    def __init__(self, d: int, *, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.w = nn.Parameter(torch.zeros(d, device=device,
                                          dtype=torch.float32),
                              requires_grad=False)

    def forward(self, x):
        return rmsnorm(self.w, x, self.eps)


def rmsnorm(w, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w)).to(dt)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activation(name):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta=1e4):
    """Rotary embedding.  x: [B, S, H, D]; positions: [B, S] int."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                       # [d/2]
    ang = positions[..., None].float() * inv                   # [B, S, d/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int


class Attention(nn.Module):
    """Projections of one GQA attention block: wq [D, H*dh], wk/wv
    [D, G*dh], wo [H*dh, D]."""

    def __init__(self, dims: AttnDims, *, device, dtype):
        super().__init__()
        d, h, g, dh = dims.d_model, dims.n_heads, dims.n_kv, dims.d_head
        self.dims = dims
        self.wq = parameter((d, h * dh), device=device, dtype=dtype)
        self.wk = parameter((d, g * dh), device=device, dtype=dtype)
        self.wv = parameter((d, g * dh), device=device, dtype=dtype)
        self.wo = parameter((h * dh, d), device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> "Attention":
        dims = self.dims
        for w in (self.wq, self.wk, self.wv):
            truncated_normal_(w, 1.0 / math.sqrt(dims.d_model), generator)
        truncated_normal_(self.wo, 1.0 / math.sqrt(dims.n_heads * dims.d_head),
                          generator)
        return self


def init_attention(dims: AttnDims, *, generator, device, dtype) -> Attention:
    return Attention(dims, device=device, dtype=dtype).reset_parameters(
        generator)


def attention(p: Attention, x, positions, dims: AttnDims, *, causal=True,
              window=None, softcap=None, rope_theta=1e4, return_kv=False):
    """Prefill attention through the flash-attention kernel on grouped kv.
    x: [B, S, D] -> [B, S, D] (and the rotated k, v [B, S, G, dh])."""
    b, s, _ = x.shape
    h, g, dh = dims.n_heads, dims.n_kv, dims.d_head
    q = (x @ p.wq).reshape(b, s, h, dh)
    k = (x @ p.wk).reshape(b, s, g, dh)
    v = (x @ p.wv).reshape(b, s, g, dh)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    # [B, S, heads, dh] viewed as [B, heads, S, dh]: the kernel reads
    # strides, so no transposed copies are made
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            softcap=softcap)
    out = o.transpose(1, 2).reshape(b, s, h * dh) @ p.wo
    return (out, (k, v)) if return_kv else out


def position(device) -> torch.Tensor:
    """A decode cache's filled length on the device: an int64 scalar."""
    return torch.zeros((), dtype=torch.int64, device=device)


def decode_attention_block(p: Attention, x, cache_k, cache_v,
                           pos: torch.Tensor, dims: AttnDims, *, window=None,
                           softcap=None, rope_theta=1e4):
    """Single-token decode.  x: [B, 1, D]; cache_[kv]: [B, Smax, G, dh];
    pos: int64 scalar tensor on x's device, the tokens already in the
    cache.

    The position is read on the device only (RoPE, the cache write, the
    mask bound), so a captured step stays right when it is replayed at a
    later position.  The new k, v are written into the caches IN PLACE at
    ``pos`` (the reference returns updated caches from
    ``dynamic_update_slice``), and attention masks over the whole cache by
    comparison, so every shape is static.  Returns out [B, 1, D]."""
    b = x.shape[0]
    h, g, dh = dims.n_heads, dims.n_kv, dims.d_head
    q = (x @ p.wq).reshape(b, 1, h, dh)
    k = (x @ p.wk).reshape(b, 1, g, dh)
    v = (x @ p.wv).reshape(b, 1, g, dh)
    positions = pos.expand(b, 1)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    at = pos.view(1)
    cache_k.index_copy_(1, at, k.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    o = ops.decode_attention(q[:, 0], cache_k, cache_v, kv_len=pos + 1,
                             softcap=softcap, window=window)
    return o.reshape(b, 1, h * dh).to(x.dtype) @ p.wo


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d: int, f: int, gated: bool, *, device, dtype):
        super().__init__()
        self.w1 = parameter((d, f), device=device, dtype=dtype)
        self.w2 = parameter((f, d), device=device, dtype=dtype)
        self.w3 = (parameter((d, f), device=device, dtype=dtype)
                   if gated else None)

    def reset_parameters(self, generator: torch.Generator) -> "MLP":
        d, f = self.w1.shape
        truncated_normal_(self.w1, 1.0 / math.sqrt(d), generator)
        truncated_normal_(self.w2, 1.0 / math.sqrt(f), generator)
        if self.w3 is not None:
            truncated_normal_(self.w3, 1.0 / math.sqrt(d), generator)
        return self


def init_mlp(d, f, gated: bool, *, generator, device, dtype) -> MLP:
    return MLP(d, f, gated, device=device, dtype=dtype).reset_parameters(
        generator)


def mlp(p: MLP, x, act_name: str):
    hidden = activation(act_name)(x @ p.w1)
    if p.w3 is not None:
        hidden = hidden * (x @ p.w3)
    return hidden @ p.w2


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, device, dtype):
        super().__init__()
        self.emb = parameter((vocab, d), device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> "Embedding":
        truncated_normal_(self.emb, self.emb.shape[1] ** -0.5, generator)
        return self


def init_embedding(vocab, d, *, generator, device, dtype) -> Embedding:
    return Embedding(vocab, d, device=device, dtype=dtype).reset_parameters(
        generator)


def embed(p: Embedding, tokens):
    return F.embedding(tokens.long(), p.emb)


def unembed(p_emb: Embedding, x, out_proj=None, final_softcap=None):
    """Logits; tied (x @ emb.T) unless out_proj [D, V] is given."""
    w = p_emb.emb.T if out_proj is None else out_proj
    logits = x @ w
    if final_softcap is not None:
        logits = final_softcap * torch.tanh(
            logits.float() / final_softcap).to(x.dtype)
    return logits
