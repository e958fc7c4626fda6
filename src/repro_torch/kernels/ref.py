"""Plain PyTorch versions of the port's kernels.

These are the correctness references, written for clarity: dense masked
attention, grouped decode attention over a KV cache, and scatter-based
packing.  A kernel wrapper runs its plain version for tensors on the CPU
(the CPU tests, which hold it against the JAX package); for a CUDA tensor it
launches the kernel.  ``chip_smoke.py`` holds each kernel against its plain
version on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None):
    """Dense masked attention.  q/k/v: [BH, S, D] / [BH, T, D] (matched
    heads).  Computes in fp32, returns q's dtype."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qlen, klen = q.shape[1], k.shape[1]
    qpos = torch.arange(qlen, device=q.device)[:, None]
    kpos = torch.arange(klen, device=q.device)[None, :]
    mask = torch.ones((qlen, klen), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.bmm(p, v.float()).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len=None, *, scale=None, softcap=None,
                         window=None):
    """Single-token grouped-GQA decode attention over a (possibly partly
    filled) KV cache.

    q: [B, H, D]; k/v: [B, T, G, D] (cache layout, H = G * rep; the kv
    heads are not repeated).  Scores accumulate in fp32 from the cache
    dtype; the probabilities are rounded to q's dtype before the value
    product, as the reference does.  kv_len: valid prefix length.  window
    masks relative to the current position.  Returns [B, H, D] in q.dtype.
    """
    b, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    rep = h // g
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, g, rep, d)
    s = torch.einsum("bgrd,btgd->bgrt", qg.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(t, device=q.device)
    if kv_len is None:
        kv_len = t
    mask = pos < kv_len
    if window is not None:
        mask &= pos >= (kv_len - window)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", p.to(q.dtype).float(), v.float())
    return out.reshape(b, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# dispatch pack
# ---------------------------------------------------------------------------

def pack_ref(tokens, bitmap, valid, num_dests, capacity):
    """Bitmap-driven packing (the semantics of the reference's
    ``collectives.pack_by_bitmap``).

    tokens [N, H]; bitmap [N] int32 (bit d: row goes to destination d);
    valid [N] bool.  Returns (out [D, C, H] in tokens' dtype, zeros where
    empty; src_idx [D, C] int32, -1 where empty).  Token order decides the
    slot; rows past capacity C are dropped.
    """
    n = tokens.shape[0]
    dev = tokens.device
    d_ids = torch.arange(num_dests, dtype=torch.int32, device=dev)
    want = ((bitmap[None, :] >> d_ids[:, None]) & 1).bool() & valid[None, :]
    pos = torch.cumsum(want.to(torch.int32), dim=1, dtype=torch.int32) - 1
    keep = want & (pos < capacity)
    flat = torch.where(keep, d_ids[:, None] * capacity + pos,
                       num_dests * capacity)
    # one scatter over D*C slots plus one overflow slot that is cut off
    src = torch.full((num_dests * capacity + 1,), -1, dtype=torch.int32,
                     device=dev)
    rows = torch.arange(n, dtype=torch.int32, device=dev).expand(num_dests, n)
    src.scatter_(0, flat.reshape(-1).long(), rows.reshape(-1))
    src_idx = src[:num_dests * capacity].reshape(num_dests, capacity)
    gathered = torch.where((src_idx >= 0)[..., None],
                           tokens[src_idx.clamp(min=0).long()],
                           torch.zeros((), dtype=tokens.dtype, device=dev))
    return gathered, src_idx
