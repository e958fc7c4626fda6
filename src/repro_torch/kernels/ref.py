"""Plain PyTorch versions of the port's kernels.

These are the correctness references, written for clarity: dense masked
attention, grouped decode attention over a KV cache, scatter-based
packing, and the Mamba2 and RWKV-6 scans (per-step recurrences, their
one-token decode steps, and the chunked forms that the reference's serving
path runs), and, for the tests alone, the RWKV-6 kernel's sub-chunk
factorisation.  A kernel wrapper runs its plain version for tensors on the CPU
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


def decode_attention_partial(q, k, v, kv_len, *, scale=None, softcap=None,
                             window=None):
    """:func:`decode_attention_ref` over one block of a KV cache, left
    unnormalised for a merge across blocks (flash-decoding): returns the
    scores' max [B, H], the sum of ``exp(s - max)`` [B, H] and the
    exp-weighted values [B, H, D], all fp32.  ``kv_len`` counts the valid
    positions from the block's start (any int, or a device scalar: at most
    zero leaves the block empty, with max ``NEG_INF`` and zero sums).  The
    weights are rounded to q's dtype before the value product, as the
    one-block version rounds its probabilities."""
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
    mask = pos < kv_len
    if window is not None:
        mask &= pos >= (kv_len - window)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    mx = s.max(dim=-1).values
    p = torch.where(mask[None, None, None, :], torch.exp(s - mx[..., None]),
                    0.0)
    acc = torch.einsum("bgrt,btgd->bgrd", p.to(q.dtype).float(), v.float())
    return (mx.reshape(b, h), p.sum(dim=-1).reshape(b, h),
            acc.reshape(b, h, d))


# ---------------------------------------------------------------------------
# mamba2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_ref(x, dt, a, b, c, d, *, return_final=False):
    """Per-step recurrence, in fp32.  x [BH, S, dh]; dt [BH, S]; a, d [BH];
    b, c [BH, S, ds].  Returns y [BH, S, dh] in x's dtype (and the final
    state [BH, ds, dh] fp32)."""
    bh, s, dh = x.shape
    ds = b.shape[-1]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    af, df = a.float(), d.float()
    h = torch.zeros((bh, ds, dh), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        h, y = mamba2_decode_step(h, xf[:, t], dtf[:, t], af, bf[:, t],
                                  cf[:, t], df)
        ys.append(y)
    y = torch.stack(ys, dim=1).to(x.dtype)
    return (y, h) if return_final else y


def mamba2_decode_step(h, xt, dtt, a, bt, ct, d):
    """One step: returns (h_new, y_t).  h [BH, ds, dh]; xt [BH, dh];
    dtt, a, d [BH]; bt, ct [BH, ds]."""
    decay = torch.exp(dtt * a)[:, None, None]
    h = decay * h + (dtt[:, None] * bt)[:, :, None] * xt[:, None, :]
    y = torch.einsum("bs,bsd->bd", ct, h) + d[:, None] * xt
    return h, y


def mamba2_chunked(x, dt, a, b, c, d, *, chunk=64, return_final=False):
    """Chunk-parallel SSD scan (the reference's ``mamba2_chunked_jnp``).
    Shapes as :func:`mamba2_ref`."""
    bh, s, dh = x.shape
    ds = b.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, pad))
    nc = xf.shape[1] // chunk
    af = a.float()
    ii = torch.arange(chunk, device=x.device)
    tri = ii[:, None] >= ii[None, :]
    h = torch.zeros((bh, ds, dh), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xq, dtq, bq, cq = xf[:, sl], dtf[:, sl], bf[:, sl], cf[:, sl]
        cum = torch.cumsum(dtq * af[:, None], dim=1)            # [bh, Q]
        sqq = torch.einsum("bqs,bks->bqk", cq, bq)
        decay = torch.where(tri[None], torch.exp(cum[:, :, None]
                                                 - cum[:, None, :]), 0.0)
        y = torch.einsum("bqk,bkd->bqd", sqq * decay * dtq[:, None, :], xq)
        y = y + torch.exp(cum)[..., None] * torch.einsum("bqs,bsd->bqd",
                                                         cq, h)
        total = cum[:, -1]
        w = torch.exp(total[:, None] - cum) * dtq
        h = (torch.exp(total)[:, None, None] * h
             + torch.einsum("bqs,bqd->bsd", bq * w[..., None], xq))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    y = (y + d.float()[:, None, None] * xf[:, :s]).to(x.dtype)
    return (y, h) if return_final else y


# ---------------------------------------------------------------------------
# rwkv6
# ---------------------------------------------------------------------------

def rwkv6_ref(r, k, v, logw, u, *, return_final=False):
    """Per-step recurrence, in fp32.  r, k, logw [BH, S, dk]; v [BH, S, dv];
    u [BH, dk].  Returns y [BH, S, dv] in v's dtype (and the final state
    [BH, dk, dv] fp32)."""
    bh, s, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    uf = u.float()
    state = torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        state, y = rwkv6_decode_step(state, rf[:, t], kf[:, t], vf[:, t],
                                     wf[:, t], uf)
        ys.append(y)
    y = torch.stack(ys, dim=1).to(v.dtype)
    return (y, state) if return_final else y


def rwkv6_decode_step(state, rt, kt, vt, logwt, u):
    """One step: returns (state_new, y_t).  state [BH, dk, dv]; rt, kt,
    logwt, u [BH, dk]; vt [BH, dv]."""
    y = torch.einsum("bk,bkv->bv", rt,
                     state + (u * kt)[:, :, None] * vt[:, None, :])
    state = (torch.exp(logwt)[:, :, None] * state
             + kt[:, :, None] * vt[:, None, :])
    return state, y


def rwkv6_chunked(r, k, v, logw, u, *, chunk=32, return_final=False):
    """Chunk-parallel RWKV-6 scan (the reference's ``rwkv6_chunked_jnp``,
    including its r * exp(cum_prev), k * exp(-cum) factorisation).  Shapes
    as :func:`rwkv6_ref`."""
    bh, s, dk = r.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    if pad:
        rf, kf, vf, wf = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                          for t in (rf, kf, vf, wf))
    nc = rf.shape[1] // chunk
    uf = u.float()
    ii = torch.arange(chunk, device=r.device)
    lower = ii[:, None] > ii[None, :]
    state = torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        rq, kq, vq, wq = rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl]
        cum = torch.cumsum(wq, dim=1)
        r_s = rq * torch.exp(cum - wq)
        k_s = kq * torch.exp(-cum)
        att = torch.where(lower[None], torch.einsum("bqk,bsk->bqs", r_s, k_s),
                          0.0)
        bonus = torch.einsum("bqk,bqk->bq", rq * uf[:, None], kq)
        y = torch.einsum("bqs,bsv->bqv", att, vq) + bonus[..., None] * vq
        y = y + torch.einsum("bqk,bkv->bqv", r_s, state)
        k_up = kq * torch.exp(cum[:, -1:] - cum)
        state = (torch.exp(cum[:, -1])[..., None] * state
                 + torch.einsum("bqk,bqv->bkv", k_up, vq))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s].to(v.dtype)
    return (y, state) if return_final else y


def rwkv6_subchunk(r, k, v, logw, u, *, chunk=64, sub=16,
                   return_final=False):
    """The CUDA kernel's factorisation in plain PyTorch, for the tests only
    (no model calls it).  Inside a chunk, the scores of sub-chunk a against
    the columns before it are (r exp(cp - ref_a)) (k exp(ref_a - cum))^T
    with ref_a the cumsum at the step before a.  Inside a diagonal sub x sub
    block the same holds one level down: its second half's rows against its
    first half's columns factorise around the cumsum at the end of the first
    half, and only the two triangles of sub / 2 steps left on the diagonal
    take exp(cp_i - cum_j) per channel.  No exponent is positive.  Shapes
    as :func:`rwkv6_ref`."""
    bh, s, dk = r.shape
    dv = v.shape[-1]
    half = sub // 2
    pad = (-s) % chunk
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    if pad:
        rf, kf, vf, wf = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                          for t in (rf, kf, vf, wf))
    nc = rf.shape[1] // chunk
    uf = u.float()
    ii = torch.arange(half, device=r.device)
    lower = (ii[:, None] > ii[None, :])[None, :, :, None]
    eye = torch.eye(sub, device=r.device)

    def factorised(rq, kq, cp, cum, rows, cols, ref):
        """Scores of ``rows`` against the earlier ``cols`` around the
        cumsum ``ref`` [bh, 1, dk] between them."""
        r_hat = rq[:, rows] * torch.exp(cp[:, rows] - ref)
        k_hat = kq[:, cols] * torch.exp(ref - cum[:, cols])
        return torch.einsum("bic,bjc->bij", r_hat, k_hat)

    state = torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        rq, kq, vq, wq = rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl]
        cum = torch.cumsum(wq, dim=1)
        cp = cum - wq
        att = torch.zeros((bh, chunk, chunk), device=r.device)
        for a0 in range(0, chunk, sub):
            blk = slice(a0, a0 + sub)
            for t0 in (a0, a0 + half):          # the two triangles
                tri = slice(t0, t0 + half)
                gap = torch.where(lower, cp[:, tri, None] - cum[:, None, tri],
                                  float("-inf"))
                att[:, tri, tri] = torch.einsum(
                    "bic,bjc,bijc->bij", rq[:, tri], kq[:, tri],
                    torch.exp(gap))
            lo, hi = slice(a0, a0 + half), slice(a0 + half, a0 + sub)
            att[:, hi, lo] = factorised(rq, kq, cp, cum, hi, lo,
                                        cum[:, a0 + half - 1, None])
            bonus = torch.einsum("bic,bic->bi", rq[:, blk] * uf[:, None],
                                 kq[:, blk])
            att[:, blk, blk] += bonus[:, :, None] * eye
            if a0:
                att[:, blk, :a0] = factorised(rq, kq, cp, cum, blk,
                                              slice(0, a0),
                                              cum[:, a0 - 1, None])
        y = att @ vq + (rq * torch.exp(cp)) @ state
        k_up = kq * torch.exp(cum[:, -1:] - cum)
        state = (torch.exp(cum[:, -1])[..., None] * state
                 + k_up.transpose(1, 2) @ vq)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s].to(v.dtype)
    return (y, state) if return_final else y


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
