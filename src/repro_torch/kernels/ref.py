"""Plain PyTorch versions of the port's kernels.

These are the correctness references, written for clarity: dense masked
attention (and its backward, with the forward's log-sum-exp), grouped
decode attention over a KV cache, scatter-based packing (and its
backward), and the Mamba2 and RWKV-6 scans (per-step recurrences, their
one-token decode steps, the chunked forms that the reference's serving
path runs, and their gradients by autograd), and, for the tests alone,
the RWKV-6 kernel's sub-chunk factorisation and the scans' backward
kernels' algorithm.  A kernel wrapper runs its plain version for tensors on the CPU
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


def _grouped_scores(q, k, *, causal, window, softcap, scale):
    """fp32 scores of q [B, H, S, D] against grouped k [B, G, T, D] (the kv
    heads repeated), after scale and softcap; the mask where a key may
    attend; and tanh of the capped scores (None without a softcap)."""
    h, g = q.shape[1], k.shape[1]
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    kx = k.float().repeat_interleave(h // g, dim=1)
    s = torch.matmul(q.float(), kx.transpose(-1, -2)) * scale
    th = None
    if softcap is not None:
        th = torch.tanh(s / softcap)
        s = softcap * th
    qlen, klen = q.shape[2], k.shape[2]
    qpos = torch.arange(qlen, device=q.device)[:, None]
    kpos = torch.arange(klen, device=q.device)[None, :]
    mask = torch.ones((qlen, klen), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return s, mask, th, scale


def attention_lse(q, k, *, causal=True, window=None, softcap=None,
                  scale=None):
    """Each query row's log-sum-exp of its scores over the keys it may
    attend (natural log, fp32), what the kernel's forward hands its
    backward.  q [B, H, S, D], k [B, G, T, D] -> [B, H, S]; +inf for a row
    that attends no key."""
    s, mask, _, _ = _grouped_scores(q, k, causal=causal, window=window,
                                    softcap=softcap, scale=scale)
    lse = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    return torch.where(mask.any(dim=-1), lse, torch.inf)


def attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, window=None,
                      softcap=None, scale=None, operands=None):
    """The attention backward as explicit fp32 arithmetic (no autograd),
    the kernel's algorithm: P recomputed from the log-sum-exp, then dV,
    dP, dS and dQ, dK, the gradients of grouped kv summed over the q heads
    of each kv head.  q, o, do [B, H, S, D]; k, v [B, G, T, D]; lse
    [B, H, S].  ``operands``: a dtype that P and dS are rounded to before
    the products that take them, as the kernel's tensor cores take them
    (None: fp32 throughout).  Returns (dq, dk, dv) in the dtypes of q, k,
    v."""
    b, h, _, d = q.shape
    g, t = k.shape[1], k.shape[2]
    s, mask, th, scale = _grouped_scores(q, k, causal=causal, window=window,
                                         softcap=softcap, scale=scale)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    dof = do.float()
    vx = v.float().repeat_interleave(h // g, dim=1)
    kx = k.float().repeat_interleave(h // g, dim=1)

    def operand(x):
        return x if operands is None else x.to(operands).float()
    dv = torch.matmul(operand(p).transpose(-1, -2), dof)     # [B, H, T, D]
    dp = torch.matmul(dof, vx.transpose(-1, -2))              # [B, H, S, T]
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if th is not None:
        ds = ds * (1.0 - th * th)
    ds = operand(ds * scale)
    dq = torch.matmul(ds, kx)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dk = dk.reshape(b, g, h // g, t, d).sum(dim=2)
    dv = dv.reshape(b, g, h // g, t, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def grads_of(fn, inputs, dy, dfinal):
    """The gradients of ``fn(*leaves) -> (y, final)`` with respect to fp32
    copies of ``inputs``, given dy and an optional gradient of the final
    state, by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True) for t in inputs]
        y, final = fn(*leaves)
        outs, cot = [y], [dy.float()]
        if dfinal is not None:
            outs.append(final)
            cot.append(dfinal.float())
        return torch.autograd.grad(outs, leaves, cot)


def mamba2_chunked_bwd(x, dt, a, b, c, d, dy, dh_final=None, *, chunk=64):
    """The plain backward of :func:`mamba2_chunked`: the gradients of y
    (and of the final state, where ``dh_final`` is given) with respect to
    x, dt, a, b, c, d, all fp32 in their shapes (b, c per row [BH, S,
    ds])."""
    return grads_of(lambda *t: mamba2_chunked(*t, chunk=chunk,
                                               return_final=True),
                     (x, dt, a, b, c, d), dy, dh_final)


def _pad_steps(s, chunk, *ts):
    pad = (-s) % chunk
    return [torch.nn.functional.pad(t.float(), (0, 0, 0, pad)
                                    if t.dim() == 3 else (0, pad))
            for t in ts]


def split_pair(t, dtype=torch.bfloat16):
    """``t`` as the sum of a pair hi + lo of ``dtype`` (hi = t rounded, lo =
    the rest rounded), in fp32: how the CUDA scans feed an operand made in
    fp32 to the tensor cores (``split2`` in ``csrc/sm90.cuh``)."""
    hi = t.to(dtype).float()
    return hi + (t - hi).to(dtype).float()


def split_three(t, dtype=torch.bfloat16):
    """``t`` as the sum of three parts of ``dtype`` (hi = t rounded, then
    the rest as :func:`split_pair`), in fp32: ``split3`` in
    ``csrc/sm90.cuh``."""
    hi = t.to(dtype).float()
    return hi + split_pair(t - hi, dtype)


def mamba2_bwd_chunks(x, dt, a, b, c, d, dy, dh_final=None, *, chunk=64,
                      operands=None):
    """The CUDA backward kernel's algorithm in plain PyTorch, for the tests
    only (no model calls it).  A first walk keeps each chunk's starting
    state; the reverse walk over chunks carries g, the gradient of the state
    at the chunk's end, and per chunk, with cum the inclusive cumsum of dt a
    and, for j <= i (zero above the diagonal), L_ij = exp(cum_i - cum_j),
    dML_ij = (dy_i . x_j) L_ij and P_ij = dML_ij (C_i . B_j):

      dx_j  = dt_j sum_i (C_i . B_j) L_ij dy_i + D dy_j + w_j g^T B_j
      dC_i  = sum_j dML_ij dt_j B_j + exp(cum_i) h0 dy_i
      dB_j  = dt_j sum_i dML_ij C_i + w_j g x_j,       w_j = exp(cum_Q - cum_j) dt_j
      g    <- exp(cum_Q) g + sum_i exp(cum_i) C_i dy_i^T

    and dt through its two roles: directly (sum_i P_ij + exp(cum_Q - cum_j)
    B_j^T g x_j) and through cum, whose gradient dcum is reverse-summed
    over the chunk (ddt += a dcum_rev, da += dt dcum_rev).  No exponent is
    positive.  ``operands``: a dtype that models the CUDA kernel's tensor-core
    operands (None: fp32 throughout): x, B, C and dy are taken as they are
    (the kernel reads them in bf16, exactly), and each operand that the
    kernel makes in fp32 enters as a pair hi + lo of that dtype
    (:func:`split_pair`): the state h0 in dy h0^T, CBL^T dt, dML^T and dML
    dt, the gradient g of the state in B g, and (C exp(cum))^T in its
    update; (B w)^T in the state update, and g in x g^T and as it is
    carried from chunk to chunk, enter as three parts
    (:func:`split_three`), since both reach dcum, whose terms cancel.
    Shapes as :func:`mamba2_chunked_bwd`."""
    def op(t):
        return t if operands is None else split_pair(t, operands)

    def op3(t):
        return t if operands is None else split_three(t, operands)
    bh, s, dh = x.shape
    xf, bf, cf, dyf = _pad_steps(s, chunk, x, b, c, dy)
    dtf, = _pad_steps(s, chunk, dt)
    af, df = a.float(), d.float()
    nc = xf.shape[1] // chunk
    ii = torch.arange(chunk, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None]
    h = torch.zeros((bh, b.shape[-1], dh), device=x.device)
    starts = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        starts.append(h)
        cum = torch.cumsum(dtf[:, sl] * af[:, None], dim=1)
        w = torch.exp(cum[:, -1:] - cum) * dtf[:, sl]
        h = (torch.exp(cum[:, -1])[:, None, None] * h
             + op3((bf[:, sl] * w[..., None]).transpose(1, 2)) @ xf[:, sl])
    g = (torch.zeros_like(h) if dh_final is None else dh_final.float())
    h_end = h
    grads = [torch.zeros_like(t) for t in (xf, dtf, bf, cf)]
    da = torch.zeros_like(af)
    for ci in reversed(range(nc)):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xq, dtq, bq, cq, dyq = (t[:, sl] for t in (xf, dtf, bf, cf, dyf))
        h0 = starts[ci]
        cum = torch.cumsum(dtq * af[:, None], dim=1)
        gap = torch.where(tri, cum[:, :, None] - cum[:, None, :], -torch.inf)
        decay = torch.exp(gap)
        cb_raw = cq @ bq.transpose(1, 2)                  # C_i . B_j
        cb = cb_raw * decay
        dml = (dyq @ xq.transpose(1, 2)) * decay
        p = dml * cb_raw
        tail = torch.exp(cum[:, -1:] - cum)
        w = tail * dtq
        gs, g3 = op(g), op3(g)
        gx = xq @ g3.transpose(1, 2)                     # g x_j  [Q, ds]
        z = dyq @ op(h0).transpose(1, 2)                 # h0 dy_i [Q, ds]
        ecum = torch.exp(cum)
        dx = (op((cb * dtq[:, None, :]).transpose(1, 2)) @ dyq
              + df[:, None, None] * dyq + w[..., None] * (bq @ gs))
        dc = op(dml * dtq[:, None, :]) @ bq + ecum[..., None] * z
        db = dtq[..., None] * (op(dml.transpose(1, 2)) @ cq
                               + tail[..., None] * gx)
        q = (bq * gx).sum(-1)
        colp = p.sum(1)
        dcum = ((p * dtq[:, None, :]).sum(2) - dtq * colp
                + ecum * (cq * z).sum(-1) - dtq * tail * q)
        dcum[:, -1] += (g * h_end).sum((1, 2))
        rev = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        for grad, val in zip(grads, (dx, colp + tail * q + af[:, None] * rev,
                                     db, dc)):
            grad[:, sl] = val
        da += (dtq * rev).sum(1)
        g = (torch.exp(cum[:, -1])[:, None, None] * g3
             + op((cq * ecum[..., None]).transpose(1, 2)) @ dyq)
        h_end = h0
    dx, ddt, db, dc = (t[:, :s] for t in grads)
    dd = (dyf * xf).sum((1, 2))
    return dx, ddt, da, db, dc, dd


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


def rwkv6_chunked_bwd(r, k, v, logw, u, dy, dstate=None, *, chunk=32):
    """The plain backward of :func:`rwkv6_chunked`: the gradients of y (and
    of the final state, where ``dstate`` is given) with respect to r, k, v,
    logw, u, all fp32 in their shapes.  It inherits the chunked form's
    k exp(-cum) factor: where a chunk's log-decays sum below about -88 it
    is not finite (the kernel's backward is)."""
    return grads_of(lambda *t: rwkv6_chunked(*t, chunk=chunk,
                                              return_final=True),
                     (r, k, v, logw, u), dy, dstate)


def rwkv6_bwd_chunks(r, k, v, logw, u, dy, dstate=None, *, chunk=64,
                     sub=None, operands=None):
    """The CUDA backward kernel's algorithm in plain PyTorch, for the tests
    only (no model calls it).  A first walk keeps each chunk's starting
    state S0 and z = dy S0^T; the reverse walk carries G, the gradient of
    the state at the chunk's end.  With cum the inclusive cumsum of logw in
    the chunk, cp its exclusive one (cum of the step before) and E_ijc =
    exp(cp_ic - cum_jc) for j < i (never a positive exponent; zero
    elsewhere):

      A_ij   = sum_c r_ic k_jc E_ijc,   dA_ij = dy_i . v_j
      drs_i  = sum_j E_ij k_j dA_ij + exp(cp_i) * z_i              (= S_{i-1} dy_i)
      dks_j  = sum_i E_ij r_i dA_ij + exp(cum_Q - cum_j) * (G v_j) (= G_j v_j)
      dv_j   = sum_i A_ij dy_i + (r_j . u k_j) dy_j + G^T (k_j exp(cum_Q - cum_j))
      dr = drs + u k (v . dy),  dk = dks + u r (v . dy),  du = sum r k (v . dy)
      G     <- exp(cum_Q) G + sum_i (r_i exp(cp_i)) dy_i^T

    and the log-decays' gradient as the reverse running sum
    dlogw_t = F + sum_{m>t} r_m drs_m - sum_{m>=t} k_m dks_m, with F the
    final state times its gradient summed over dv (from
    dlogw_t = w_t S_{t-1} . G_t and the telescoping of S_t . G_t), so no
    exponent enters it at all.

    ``sub``: the kernel's sub-chunk reference points (16 there; None: E
    formed whole).  Rows i of sub-chunk a against the columns j before it
    take E_ijc = exp(cp_ic - ref_c) exp(ref_c - cum_jc) around ref = cum at
    the step before a (drs: exp(cp - ref) (dA k^), k^ = k exp(ref - cum));
    the columns j of sub-chunk b against the rows after it, around ref' =
    cum at b's last step (dks: exp(ref' - cum_j) (dA^T r^), r^ = r exp(cp -
    ref'); A^T = k^ r^^T); inside each diagonal block the rows of its
    second half against its first half's columns around the cum at its
    middle; the two triangles of sub / 2 steps left on the diagonal form E
    per channel.  ``operands``: a dtype that models the kernel's
    tensor-core operands (None: fp32 throughout): r, k, v and dy are taken
    as they are (the kernel reads them in bf16, exactly), and each operand
    the kernel makes in fp32 enters as a pair hi + lo of that dtype
    (:func:`split_pair`): the state in dy S0^T and (k exp(cum_Q -
    cum))^T in its update; dA, k^ and r^ in the sub-chunk products; A^T
    (the bonus on its diagonal), k exp(cum_Q - cum) and G in dv; G in
    v G^T; (r exp(cp))^T in G's update, and G as it is carried from chunk
    to chunk.  Shapes as :func:`rwkv6_chunked_bwd`."""
    def op(t):
        return t if operands is None else split_pair(t, operands)
    bh, s, dk = r.shape
    rf, kf, vf, wf, dyf = _pad_steps(s, chunk, r, k, v, logw, dy)
    uf = u.float()
    nc = rf.shape[1] // chunk
    ii = torch.arange(chunk, device=r.device)
    low = ii[:, None] > ii[None, :]
    state = torch.zeros((bh, dk, v.shape[-1]), device=r.device)
    zs = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        zs.append(dyf[:, sl] @ op(state).transpose(1, 2))
        cum = torch.cumsum(wf[:, sl], dim=1)
        k_up = kf[:, sl] * torch.exp(cum[:, -1:] - cum)
        state = (torch.exp(cum[:, -1])[..., None] * state
                 + op(k_up.transpose(1, 2)) @ vf[:, sl])
    g = torch.zeros_like(state) if dstate is None else dstate.float()
    acc = (state * g).sum(-1)                            # F [bh, dk]
    grads = [torch.zeros_like(t) for t in (rf, kf, vf, wf)]
    du = torch.zeros_like(uf)
    for ci in reversed(range(nc)):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        rq, kq, vq, dyq = (t[:, sl] for t in (rf, kf, vf, dyf))
        cum = torch.cumsum(wf[:, sl], dim=1)
        cp = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
        tail = torch.exp(cum[:, -1:] - cum)
        da_ = torch.where(low, dyq @ vq.transpose(1, 2), 0.0)
        drs = torch.exp(cp) * zs[ci]
        dks = tail * (vq @ op(g).transpose(1, 2))
        if sub is None:
            e = torch.exp(torch.where(low[None, :, :, None],
                                      cp[:, :, None] - cum[:, None],
                                      -torch.inf))       # [bh, i, j, c]
            att_t = torch.einsum("bic,bjc,bijc->bji", rq, kq, e)
            drs = drs + torch.einsum("bijc,bjc,bij->bic", e, kq, da_)
            dks = dks + torch.einsum("bijc,bic,bij->bjc", e, rq, da_)
        else:
            att_t = torch.zeros_like(da_)                # A^T: [bh, j, i]
            drs, dks = _rwkv6_subchunk_terms(rq, kq, cum, cp, da_, drs, dks,
                                             att_t, chunk, sub, op)
        bdot = (vq * dyq).sum(-1, keepdim=True)
        bonus = (rq * uf[:, None] * kq).sum(-1)
        att_t = att_t + torch.diag_embed(bonus)
        dv = op(att_t) @ dyq + op(kq * tail) @ op(g)
        # dlogw: the running sum from the chunk's end back to its start
        step = rq * drs - kq * dks
        after = torch.flip(torch.cumsum(torch.flip(step, [1]), 1), [1])
        dlogw = acc[:, None] + after - rq * drs
        acc = acc + after[:, 0]
        for grad, val in zip(grads, (drs + uf[:, None] * kq * bdot,
                                     dks + uf[:, None] * rq * bdot, dv,
                                     dlogw)):
            grad[:, sl] = val
        du += (rq * kq * bdot).sum(1)
        g = (torch.exp(cum[:, -1])[..., None] * op(g)
             + op((rq * torch.exp(cp)).transpose(1, 2)) @ dyq)
    dr, dk_, dv, dlogw = (t[:, :s] for t in grads)
    return dr, dk_, dv, dlogw, du


def _rwkv6_subchunk_terms(rq, kq, cum, cp, da_, drs, dks, att_t, chunk, sub,
                          op):
    """:func:`rwkv6_bwd_chunks`' chunk-local terms around the kernel's
    sub-chunk reference points: returns drs and dks with them added, and
    fills ``att_t`` (A^T) in place."""
    half = sub // 2
    ar = torch.arange(half, device=rq.device)
    tri = (ar[:, None] > ar[None, :])[
        None, :, :, None]
    drs, dks = drs.clone(), dks.clone()
    for a0 in range(0, chunk, sub):
        blk = slice(a0, a0 + sub)
        if a0:      # rows of this sub-chunk against the columns before it
            ref = cum[:, a0 - 1, None]
            kh = kq[:, :a0] * torch.exp(ref - cum[:, :a0])
            drs[:, blk] += torch.exp(cp[:, blk] - ref) * (
                op(da_[:, blk, :a0]) @ op(kh))
        if a0 + sub < chunk:    # its columns against the rows after it
            ref = cum[:, a0 + sub - 1, None]
            later = slice(a0 + sub, chunk)
            rh = rq[:, later] * torch.exp(cp[:, later] - ref)
            kh = kq[:, blk] * torch.exp(ref - cum[:, blk])
            dks[:, blk] += torch.exp(ref - cum[:, blk]) * (
                op(da_[:, later, blk].transpose(1, 2)) @ op(rh))
            att_t[:, blk, later] = op(kh) @ op(rh).transpose(1, 2)
        # the quadrant: the block's second half against its first half
        lo, hi = slice(a0, a0 + half), slice(a0 + half, a0 + sub)
        ref = cum[:, a0 + half - 1, None]
        rh = rq[:, hi] * torch.exp(cp[:, hi] - ref)
        kh = kq[:, lo] * torch.exp(ref - cum[:, lo])
        drs[:, hi] += torch.exp(cp[:, hi] - ref) * (
            op(da_[:, hi, lo]) @ op(kh))
        dks[:, lo] += torch.exp(ref - cum[:, lo]) * (
            op(da_[:, hi, lo].transpose(1, 2)) @ op(rh))
        att_t[:, lo, hi] = op(kh) @ op(rh).transpose(1, 2)
        for t0 in (a0, a0 + half):      # the two triangles, E per channel
            tr = slice(t0, t0 + half)
            e = torch.exp(torch.where(tri, cp[:, tr, None] - cum[:, None, tr],
                                      -torch.inf))
            d8 = da_[:, tr, tr]
            drs[:, tr] += torch.einsum("bijc,bjc,bij->bic", e, kq[:, tr], d8)
            dks[:, tr] += torch.einsum("bijc,bic,bij->bjc", e, rq[:, tr], d8)
            att_t[:, tr, tr] = torch.einsum("bijc,bic,bjc->bji", e,
                                            rq[:, tr], kq[:, tr])
    return drs, dks


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


def pack_bwd_ref(grad_out, src_idx, n):
    """The pack's backward: row n of the result sums the slots that hold
    source row n (``src_idx[d, c] == n``), over the destinations in
    ascending order, in fp32, rounded once to ``grad_out``'s dtype; zeros for
    a row no slot holds.  A row fills at most one slot per destination, so
    the map is inverted into ``slot_of`` [D, N] first (the kernel's
    algorithm, in its order of sums).  grad_out [D, C, H] -> [N, H]."""
    d, c, h = grad_out.shape
    dev = grad_out.device
    held = src_idx >= 0
    slot_of = torch.full((d, n + 1), -1, dtype=torch.int64, device=dev)
    slot_of.scatter_(1, torch.where(held, src_idx, n).long(),
                     torch.arange(c, device=dev).expand(d, c).clone())
    slot_of = slot_of[:, :n]
    acc = torch.zeros((n, h), dtype=torch.float32, device=dev)
    for dd in range(d):
        rows = grad_out[dd].float()[slot_of[dd].clamp(min=0)]
        acc = acc + torch.where((slot_of[dd] >= 0)[:, None], rows, 0.0)
    return acc.to(grad_out.dtype)
