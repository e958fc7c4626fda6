"""Shared neural layers: norms, RoPE/M-RoPE, MLPs, GQA attention, KV caches.

Port of ``src/repro/models/layers.py``.  Each layer is a plain function on
tensors whose first argument holds the parameters, plus an ``nn.Module``
that owns those parameters and draws them from an explicit
``torch.Generator`` (``reset_parameters``; ``init_*`` builds and draws).
Matrices are stored in the compute dtype (the reference stores fp32 and
casts at each use, which rounds to the same values); norm weights stay
fp32.

Tensor parallelism over the model axis of a ``pctx`` follows the
reference's layout (``src/repro/parallel/sharding.py::_rule_for``): wq, wk,
wv, w1, w3 column-parallel, wo, w2 row-parallel and followed by an
``all_reduce`` over the model axis; the kv heads are split only when they
divide over it, and replicated otherwise.  A module whose width does not
divide over the axis (query heads, FFN width; :func:`splits`) is
replicated: whole on every rank, run through :func:`model_ctx` without
*f* and without the row-parallel sum.  A module's ``shards`` maps each
split parameter to its cut of the whole tensor (:func:`cut_segments`):
``(dim, parts, index)``, its block, or ``(dim, whole, ((lo, hi), ...))``,
the column segments it keeps (Mamba2's ``in_proj``, whose output is
``[z | x | B | C | dt]``).  Random weights draw each tensor whole and keep
the cut, so a rank's weights equal the one-rank model's slices.

Gradients over the model axis (training): every model rank computes the
same loss, so a value whole on every model rank has the same cotangent on
every rank too.  The row-parallel sum is *g* (:func:`reduce_over_model`:
``all_reduce`` forward, identity backward); a column-parallel product
takes its input through *f* (:func:`to_model`: identity forward,
``all_reduce`` of the cotangent backward, since each rank's cotangent is
the part its own block of the weights produced); and so does a whole
weight that a rank uses only in part (the kv projections replicated over
the model axis, of which a rank reads the heads of its own query heads),
so that its gradient is again the same on every rank.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.parallel import mesh as mesh_ops


def cut_segments(shard, local: int) -> tuple:
    """``(dim, whole size, ((lo, hi), ...))`` of a ``shards`` entry whose
    kept part is ``local`` long along ``dim``: a block ``(dim, parts,
    index)`` is the one segment ``[index * local, (index + 1) * local)`` of
    ``parts * local``; segments ``(dim, whole, ((lo, hi), ...))`` are kept
    in their order."""
    dim, parts_or_whole, which = shard
    if isinstance(which, int):
        return dim, parts_or_whole * local, ((which * local,
                                              (which + 1) * local),)
    return dim, parts_or_whole, tuple(which)


def truncated_normal_(t: torch.Tensor, scale: float,
                      generator: torch.Generator, *,
                      shard=None) -> torch.Tensor:
    """Fill ``t`` with N(0, 1) truncated to [-2, 2], times ``scale``.
    Drawn in fp32 one slice of dim 0 at a time for stacked 3-d weights, so
    the fp32 temporary stays one expert's size.  ``shard``: a ``shards``
    entry (:func:`cut_segments`) whose cut of the tensor drawn ``t`` is;
    the tensor is drawn whole (the generator advances as for the whole
    tensor) and freed before the next."""
    with torch.no_grad():
        stacked = t.dim() == 3
        for part in (t if stacked else (t,)):
            shape = list(part.shape)
            if shard is not None:
                dim = shard[0] - stacked
                _, whole, segs = cut_segments(shard, part.shape[dim])
                shape[dim] = whole
            tmp = torch.empty(shape, dtype=torch.float32, device=part.device)
            nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            if shard is not None:
                pieces = [tmp.narrow(dim, lo, hi - lo) for lo, hi in segs]
                tmp = (pieces[0] if len(pieces) == 1
                       else torch.cat(pieces, dim=dim))
            part.copy_(tmp.mul_(scale))
    return t


def tp_of(pctx) -> tuple[int, int]:
    """(ranks of the model axis, this rank's index on it); (1, 0) without
    a context."""
    if pctx is None or pctx.model_size == 1:
        return 1, 0
    return pctx.model_size, pctx.mesh.axis_index(pctx.model_axis)


def splits(n: int, parts: int) -> bool:
    """Whether a module cuts a width of ``n`` over ``parts`` model ranks:
    where it divides, as the reference's ``_guard`` splits a dim only
    where the axis divides it.  Otherwise the module is replicated: it
    keeps the width whole on every model rank, has no ``shards`` entry
    for it, and its functions run with :func:`model_ctx`'s None, so that
    its input takes no *f* and its output no row-parallel sum."""
    return parts > 1 and n % parts == 0


def model_ctx(split: bool, pctx):
    """The context a module's products and sums over the model axis take:
    ``pctx`` where the module is split (its ``split``), None where it is
    replicated (every product whole, nothing summed)."""
    return pctx if split else None


def reduce_over_model(x: torch.Tensor, pctx) -> torch.Tensor:
    """The row-parallel sum: ``x`` summed over the model axis, in place
    (``lax.psum(x, model)``); ``x`` itself without one.  *g* of the
    Megatron pair: its backward is the identity."""
    if pctx is not None and pctx.model_size > 1:
        return mesh_ops.reduce_model(x, pctx.mesh.group(pctx.model_axis))
    return x


def sum_over_model(x: torch.Tensor, pctx) -> torch.Tensor:
    """A partial summed over the model axis whose backward sums the
    cotangents over it too (``parallel.mesh.sum_model``): for a sum that
    each model rank then applies to its own channels only.  ``x`` itself
    without a model axis."""
    if pctx is not None and pctx.model_size > 1:
        return mesh_ops.sum_model(x, pctx.mesh.group(pctx.model_axis))
    return x


def to_model(x: torch.Tensor, pctx) -> torch.Tensor:
    """*f*: ``x`` (whole on every model rank) as it is, entering a product
    with this rank's block of the weights; its backward sums the
    cotangents over the model axis.  ``x`` itself without one."""
    if pctx is not None and pctx.model_size > 1:
        return mesh_ops.copy_to_model(x, pctx.mesh.group(pctx.model_axis))
    return x


def parameter(shape, *, device, dtype) -> nn.Parameter:
    """An uninitialised parameter, made without ``requires_grad``: serving
    keeps it so, and training turns it on for the whole module
    (``runtime.trainer.trainable``)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """RMSNorm with a zero-initialised fp32 weight applied as ``1 + w``
    (made without ``requires_grad``, as :func:`parameter`)."""

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


def rmsnorm_over_model(w, x, width: int, pctx, eps=1e-5):
    """RMSNorm over a width of ``width`` channels split over the model
    axis: ``x`` [..., width / m] and ``w`` are this rank's channels; the
    sum of squares ([..., 1] fp32) is summed over the model axis before
    the rank's channels are scaled, so each is normed as on one rank (a
    norm of the rank's channels alone would be a group norm).  The sum
    goes through :func:`sum_over_model`: each rank scales only its own
    channels by it, so each rank's cotangent of the sum is different, and
    the gradient of a rank's partial is the sum of them all (*g*'s
    identity backward would keep the rank's own).  Plain :func:`rmsnorm`
    without a model axis."""
    if x.shape[-1] == width:
        return rmsnorm(w, x, eps)
    dt = x.dtype
    xf = x.float()
    sq = sum_over_model(xf.pow(2).sum(dim=-1, keepdim=True), pctx)
    xf = xf * torch.rsqrt(sq / width + eps)
    return (xf * (1.0 + w)).to(dt)


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


def apply_rope(x, positions, theta=1e4, mrope_sections=None):
    """Rotary embedding.  x: [B, S, H, D]; positions: [B, S] int, or
    [B, S, 3] with ``mrope_sections`` (Qwen2-VL's M-RoPE: the head-dim
    halves are cut into (t, h, w) sections, each rotated by its own
    position id)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                       # [d/2]
    if mrope_sections is None:
        ang = positions[..., None].float() * inv               # [B, S, d/2]
    else:
        if sum(mrope_sections) != d // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not sum "
                             f"to half of head_dim {d}")
        parts, off = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(positions[..., i, None].float() * inv[off:off + sec])
            off += sec
        ang = torch.cat(parts, dim=-1)                         # [B, S, d/2]
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
    [D, G*dh], wo [H*dh, D]; over ``tp = (m, r)`` model ranks, rank r's
    ``heads = H / m`` query heads and ``kv_heads`` = G / m kv heads (all G,
    replicated, when G does not divide over m).  When H does not divide
    over m (nor then G) the block is replicated (:func:`splits`): every
    rank holds all four matrices whole and runs every head."""

    def __init__(self, dims: AttnDims, *, device, dtype, tp=(1, 0)):
        super().__init__()
        d, h, g, dh = dims.d_model, dims.n_heads, dims.n_kv, dims.d_head
        m, r = tp
        self.dims, self.tp = dims, (m, r)
        self.split = splits(h, m)
        self.heads = h // m if self.split else h
        self.kv_split = self.split and g % m == 0
        self.kv_heads = g // m if self.kv_split else g
        self.wq = parameter((d, self.heads * dh), device=device, dtype=dtype)
        self.wk = parameter((d, self.kv_heads * dh), device=device,
                            dtype=dtype)
        self.wv = parameter((d, self.kv_heads * dh), device=device,
                            dtype=dtype)
        self.wo = parameter((self.heads * dh, d), device=device, dtype=dtype)
        self.shards = {}
        if self.split:
            self.shards = {"wq": (1, m, r), "wo": (0, m, r)}
            if self.kv_split:
                self.shards.update(wk=(1, m, r), wv=(1, m, r))

    def reset_parameters(self, generator: torch.Generator) -> "Attention":
        dims = self.dims
        for name in ("wq", "wk", "wv"):
            truncated_normal_(getattr(self, name),
                              1.0 / math.sqrt(dims.d_model), generator,
                              shard=self.shards.get(name))
        truncated_normal_(self.wo, 1.0 / math.sqrt(dims.n_heads * dims.d_head),
                          generator, shard=self.shards.get("wo"))
        return self

    def kv_of_heads(self):
        """The kv heads this rank's query heads read, as a slice of its own
        (``(first, count)``: whole GQA groups; all of them where the rank's
        kv heads are its own or the block is replicated) or, when its heads
        cut a group, one kv head index per query head (a list)."""
        m, r = self.tp
        if self.kv_split or not self.split:
            return 0, self.kv_heads
        rep = self.dims.n_heads // self.dims.n_kv
        wanted = [(r * self.heads + i) // rep for i in range(self.heads)]
        count = wanted[-1] - wanted[0] + 1
        if self.heads % count == 0 and all(
                w == wanted[0] + i // (self.heads // count)
                for i, w in enumerate(wanted)):
            return wanted[0], count
        return wanted


def init_attention(dims: AttnDims, *, generator, device, dtype,
                   tp=(1, 0)) -> Attention:
    return Attention(dims, device=device, dtype=dtype, tp=tp
                     ).reset_parameters(generator)


def _local_kv(p: Attention, k, v):
    """k, v [B, S, kv_heads, dh] cut to the kv heads of this rank's query
    heads (views where they are whole groups)."""
    sel = p.kv_of_heads()
    if isinstance(sel, list):
        idx = torch.tensor(sel, device=k.device)
        return k.index_select(2, idx), v.index_select(2, idx)
    first, count = sel
    return k[:, :, first:first + count], v[:, :, first:first + count]


def attention(p: Attention, x, positions, dims: AttnDims, *, causal=True,
              window=None, softcap=None, rope_theta=1e4, mrope=None,
              return_kv=False, pctx=None):
    """Prefill attention through the flash-attention kernel on grouped kv.
    x: [B, S, D] -> [B, S, D] (and the rotated k, v [B, S, kv_heads, dh]
    of this rank).  Over model ranks each runs its own heads, and the
    row-parallel ``wo`` products are summed over the model axis; a
    replicated block runs every head on every rank, its output whole."""
    b, s, _ = x.shape
    dh = dims.d_head
    pctx = model_ctx(p.split, pctx)
    x = to_model(x, pctx)
    wk, wv = p.wk, p.wv
    if not p.kv_split:        # whole on every rank, read in part
        wk, wv = to_model(wk, pctx), to_model(wv, pctx)
    q = (x @ p.wq).reshape(b, s, p.heads, dh)
    k = (x @ wk).reshape(b, s, p.kv_heads, dh)
    v = (x @ wv).reshape(b, s, p.kv_heads, dh)
    q = apply_rope(q, positions, rope_theta, mrope)
    k = apply_rope(k, positions, rope_theta, mrope)
    ka, va = _local_kv(p, k, v)
    # [B, S, heads, dh] viewed as [B, heads, S, dh]: the kernel reads
    # strides, so no transposed copies are made
    o = ops.flash_attention(q.transpose(1, 2), ka.transpose(1, 2),
                            va.transpose(1, 2), causal=causal, window=window,
                            softcap=softcap)
    out = reduce_over_model(o.transpose(1, 2).reshape(b, s, p.heads * dh)
                            @ p.wo, pctx)
    return (out, (k, v)) if return_kv else out


def position(device) -> torch.Tensor:
    """A decode cache's filled length on the device: an int64 scalar."""
    return torch.zeros((), dtype=torch.int64, device=device)


def kv_layout(n_kv: int, pctx, max_len: int) -> str:
    """How a decode KV cache of ``max_len`` positions lies over the model
    axis (the reference's cache rule, ``sharding.cache_specs``): "seq"
    (each rank a block of the length, every kv head: flash-decoding) under
    ``seq_shard_decode`` when the length divides; else "heads" (the whole
    length, this rank's kv heads) when the heads divide; else "replicated"
    (the whole length and all kv heads on every rank, as the reference's
    ``P(dp, None, None, None)``: each rank's query heads read theirs,
    :meth:`Attention.kv_of_heads`); "whole" without a model axis."""
    m = 1 if pctx is None else pctx.model_size
    if m == 1:
        return "whole"
    if pctx.seq_shard_decode and max_len % m == 0:
        return "seq"
    if n_kv % m == 0:
        return "heads"
    return "replicated"


def kv_cache_shape(n_kv: int, d_head: int, batch: int, max_len: int,
                   layout: str, parts: int) -> tuple:
    """A rank's [B, length, kv heads, dh] cache in ``layout``: a "seq"
    rank holds ``1/parts`` of the length, a "heads" rank ``1/parts`` of
    the kv heads, a "replicated" (or "whole") rank all of both."""
    if layout == "seq":
        return (batch, max_len // parts, n_kv, d_head)
    if layout == "heads":
        return (batch, max_len, n_kv // parts, d_head)
    return (batch, max_len, n_kv, d_head)


def write_prefill_kv(p: Attention, cache_k, cache_v, k, v, layout: str,
                     pctx) -> None:
    """Write a prefill's k, v [B, S, kv_heads, dh] into the caches in the
    decode layout: this rank's kv heads ("heads", "whole"; all of them,
    "replicated"), or its block of positions of every kv head ("seq";
    split kv heads are gathered over the model axis first)."""
    seq = k.shape[1]
    if layout != "seq":
        cache_k[:, :seq] = k.to(cache_k.dtype)
        cache_v[:, :seq] = v.to(cache_v.dtype)
        return
    if p.kv_split:
        kv = pctx.mesh.all_gather(torch.stack([k, v]), pctx.model_axis)
        k, v = kv.permute(1, 2, 3, 0, 4, 5).flatten(3, 4)   # [2, B, S, G, dh]
    part = cache_k.shape[1]
    lo = pctx.mesh.axis_index(pctx.model_axis) * part
    hi = min(seq, lo + part)
    if hi > lo:
        cache_k[:, :hi - lo] = k[:, lo:hi].to(cache_k.dtype)
        cache_v[:, :hi - lo] = v[:, lo:hi].to(cache_v.dtype)


def decode_attention_block(p: Attention, x, cache_k, cache_v,
                           pos: torch.Tensor, dims: AttnDims, *, window=None,
                           softcap=None, rope_theta=1e4, mrope=None,
                           pctx=None, layout: str = "whole"):
    """Single-token decode.  x: [B, 1, D]; cache_[kv]: this rank's cache in
    ``layout`` (:func:`kv_layout`; [B, Smax, G, dh] on one rank); pos:
    int64 scalar tensor on x's device, the tokens already in the cache.

    The position is read on the device only (RoPE, the cache write, the
    mask bound), so a captured step stays right when it is replayed at a
    later position.  The new k, v are written into the caches IN PLACE at
    ``pos`` (the reference returns updated caches from
    ``dynamic_update_slice``), and attention masks over the whole cache by
    comparison, so every shape is static.  A replicated block runs every
    head on every rank and sums nothing after ``wo``.  Returns out
    [B, 1, D]."""
    b = x.shape[0]
    dh = dims.d_head
    q = (x @ p.wq).reshape(b, 1, p.heads, dh)
    k = (x @ p.wk).reshape(b, 1, p.kv_heads, dh)
    v = (x @ p.wv).reshape(b, 1, p.kv_heads, dh)
    # M-RoPE: every section at the cache's position, as the reference's
    positions = pos.expand(b, 1) if mrope is None else pos.expand(b, 1, 3)
    q = apply_rope(q, positions, rope_theta, mrope)
    k = apply_rope(k, positions, rope_theta, mrope)
    if layout == "seq":
        o = _decode_seq_sharded(p, q[:, 0], k[:, 0], v[:, 0], cache_k,
                                cache_v, pos, pctx, window=window,
                                softcap=softcap)
    else:
        at = pos.view(1)
        cache_k.index_copy_(1, at, k.to(cache_k.dtype))
        cache_v.index_copy_(1, at, v.to(cache_v.dtype))
        # "replicated": this rank's query heads read their kv heads of all
        # G (a view where they are whole groups); else the rank's own
        ka, va = _local_kv(p, cache_k, cache_v)
        o = ops.decode_attention(q[:, 0], ka, va, kv_len=pos + 1,
                                 softcap=softcap, window=window)
    return reduce_over_model(o.reshape(b, 1, p.heads * dh).to(x.dtype)
                             @ p.wo, model_ctx(p.split, pctx))


def _decode_seq_sharded(p: Attention, q, k, v, cache_k, cache_v, pos,
                        pctx, *, window, softcap):
    """Flash-decoding over a KV length sharded over the model axis.  q
    [B, heads, dh], k/v [B, kv_heads, dh] of this rank; the caches hold
    positions [r * L, (r + 1) * L) of every kv head.

    The new token's q (and split k, v) are gathered over the model axis
    (a replicated block's are whole on every rank already);
    the rank that owns ``pos`` writes k, v there (every rank writes at its
    clamped index, the others their old values back: no host branch on
    the position); each rank attends over its block; the partial (max,
    sum, o) of the ranks are merged in rank order; and this rank's heads
    of the result (a replicated block's: all of them) go on to its rows
    of ``wo``.  Returns [B, heads, dh]."""
    mesh, axis = pctx.mesh, pctx.model_axis
    m, r = p.tp
    b, hl, dh = q.shape
    q_all = q
    if p.split:
        parts = [q] + ([k, v] if p.kv_split else [])
        got = mesh.all_gather(torch.cat(parts, dim=1), axis)  # [m, B, ., dh]
        q_all = got[:, :, :hl].transpose(0, 1).reshape(b, m * hl, dh)
    if p.kv_split:
        gl = p.kv_heads
        k = got[:, :, hl:hl + gl].transpose(0, 1).reshape(b, m * gl, dh)
        v = got[:, :, hl + gl:].transpose(0, 1).reshape(b, m * gl, dh)
    part = cache_k.shape[1]
    lo = r * part
    at = (pos - lo).clamp(0, part - 1).view(1)
    mine = (pos >= lo) & (pos < lo + part)
    for cache, new in ((cache_k, k), (cache_v, v)):
        old = cache.index_select(1, at)
        cache.index_copy_(1, at, torch.where(mine, new[:, None].to(
            cache.dtype), old))
    mx, total, acc = ref.decode_attention_partial(
        q_all, cache_k, cache_v, pos + 1 - lo, softcap=softcap, window=window)
    stats = mesh.all_gather(torch.cat([mx[..., None], total[..., None], acc],
                                      dim=-1), axis)       # [m, B, H, 2+dh]
    top = stats[0, ..., 0]
    for i in range(1, m):
        top = torch.maximum(top, stats[i, ..., 0])
    num = den = 0
    for i in range(m):                                    # rank order
        w = torch.exp(stats[i, ..., 0] - top)
        num = num + stats[i, ..., 2:] * w[..., None]
        den = den + stats[i, ..., 1] * w
    o = (num / den[..., None]).to(q.dtype)                # [B, H, dh]
    return o[:, r * hl:(r + 1) * hl] if p.split else o


# ---------------------------------------------------------------------------
# split-TP AllGather (§3.1): the tp_subgroups > 1 activation gather
# ---------------------------------------------------------------------------

def split_tp_allgather(x, pctx, *, axis_name=None):
    """AllGather a model-axis-sharded activation across its split-TP
    domain (paper §3.1: the model axis divided into ``pctx.tp_subgroups``
    TP domains, cross-domain links idle and available for relaying).

    Routing, as the reference's: a bound plan's site or ``plan_policy ==
    "auto"`` takes ``pctx.allgather_plan``'s decision; ``"fixed"`` without
    a bound site runs MultiWrite paired relaying at the §5.2 analytic
    split; ``tp_subgroups == 1`` gathers plainly over the whole axis, and
    more than 2 domains plainly within each domain.

    Returns ``[domain_size, *x.shape]``, bit-identical to
    ``collectives.allgather_reference`` over the same domains."""
    from repro_torch.core import collectives as cl
    from repro_torch.core.schedules import optimal_split

    axis = axis_name or pctx.model_axis
    nd = pctx.tp_subgroups
    if nd <= 1:
        return cl.allgather_reference(x, pctx.mesh, axis, num_domains=1)
    if nd != 2:
        return cl.allgather_reference(x, pctx.mesh, axis, num_domains=nd)
    frag_bytes = x.numel() * x.element_size()
    decision = pctx.allgather_plan(frag_bytes, num_domains=nd)
    if decision is not None:
        return cl.planned_allgather(x, pctx.mesh, axis, num_domains=nd,
                                    decision=decision)
    return cl.multiwrite_allgather(
        x, pctx.mesh, axis, num_domains=nd,
        split=optimal_split("multiwrite_paired"), mode="paired")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """w1/w3 [D, F], w2 [F, D]; over ``tp = (m, r)`` model ranks, rank r's
    block of F/m columns of w1/w3 and rows of w2, or all of them where F
    does not divide over m (replicated, :func:`splits`)."""

    def __init__(self, d: int, f: int, gated: bool, *, device, dtype,
                 tp=(1, 0)):
        super().__init__()
        m, r = tp
        self.d, self.f, self.gated = d, f, gated
        self.split = splits(f, m)
        fl = f // m if self.split else f
        self.w1 = parameter((d, fl), device=device, dtype=dtype)
        self.w2 = parameter((fl, d), device=device, dtype=dtype)
        self.w3 = (parameter((d, fl), device=device, dtype=dtype)
                   if gated else None)
        self.shards = ({"w1": (1, m, r), "w3": (1, m, r), "w2": (0, m, r)}
                       if self.split else {})

    def reset_parameters(self, generator: torch.Generator) -> "MLP":
        sh = self.shards.get
        truncated_normal_(self.w1, 1.0 / math.sqrt(self.d), generator,
                          shard=sh("w1"))
        truncated_normal_(self.w2, 1.0 / math.sqrt(self.f), generator,
                          shard=sh("w2"))
        if self.w3 is not None:
            truncated_normal_(self.w3, 1.0 / math.sqrt(self.d), generator,
                              shard=sh("w3"))
        return self


def init_mlp(d, f, gated: bool, *, generator, device, dtype,
             tp=(1, 0)) -> MLP:
    return MLP(d, f, gated, device=device, dtype=dtype, tp=tp
               ).reset_parameters(generator)


def mlp(p: MLP, x, act_name: str, pctx=None, *, reduce: bool = True):
    """The (gated) MLP; over a model axis summed over it, or with
    ``reduce=False`` this rank's partial sum (the caller reduces it).  A
    replicated MLP's output is whole either way (the caller asks it for
    no partial: ``transformer._ffn_partial``)."""
    pctx = model_ctx(p.split, pctx)
    x = to_model(x, pctx)
    hidden = activation(act_name)(x @ p.w1)
    if p.gated:                   # (reading w3 would gather an FSDP shard)
        hidden = hidden * (x @ p.w3)
    out = hidden @ p.w2
    return reduce_over_model(out, pctx) if reduce else out


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


def embed(w, tokens):
    """The rows of the table ``w`` [V, D] at ``tokens`` (the caller reads
    the table: under FSDP each read is a gather)."""
    return F.embedding(tokens.long(), w)


def unembed(p_emb: Embedding, x, out_proj=None, final_softcap=None):
    """Logits; tied (x @ emb.T) unless out_proj [D, V] is given."""
    w = p_emb.emb.T if out_proj is None else out_proj
    logits = x @ w
    if final_softcap is not None:
        logits = final_softcap * torch.tanh(
            logits.float() / final_softcap).to(x.dtype)
    return logits


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, ignore: int = -1):
    """Mean token CE in fp32; labels == ignore are masked."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = labels != ignore
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


def _chunk_loss(hh, emb, ll, tied: bool, final_softcap, ignore: int):
    """(summed nll, count) of one sequence chunk: the unembedding product
    in the activations' dtype, the softmax in fp32 (:class:`_ChunkNLL`)."""
    logits = hh @ (emb.T if tied else emb).to(hh.dtype)       # [B, C, V]
    mask = ll != ignore
    return _ChunkNLL.apply(logits, ll, mask, final_softcap), torch.sum(mask)


def _softcapped(logits, cap):
    """(the fp32 logits under the final softcap, tanh of them over the cap
    or None without one)."""
    lf = logits.float()
    if cap is None:
        return lf, None
    t = torch.tanh(lf / cap)
    return cap * t, t


class _ChunkNLL(torch.autograd.Function):
    """The summed token nll of a chunk's logits [B, C, V]: logsumexp less
    the gold logit, in fp32, masked.  Its backward is the one autograd
    derives, op for op (the softmax times the cotangent, the gold logit's
    cotangent added, the softcap's chain rule, the cast), but it runs in
    one fp32 buffer of the logits' size, where autograd's holds the fp32
    logits and each of its intermediates (five such buffers at once): the
    chunk's backward was the largest transient of a training step."""

    @staticmethod
    def forward(ctx, logits, ll, mask, cap):
        lf, _ = _softcapped(logits, cap)
        logz = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, ll.clamp(min=0).long()[..., None])[..., 0]
        del lf
        ctx.cap = cap
        ctx.save_for_backward(logits, logz, ll, mask)
        return torch.sum((logz - gold) * mask)

    @staticmethod
    def backward(ctx, g):
        logits, logz, ll, mask = ctx.saved_tensors
        dl = g.expand(logz.shape) * mask              # the sum's, the mask's
        lf, t = _softcapped(logits, ctx.cap)
        grad = lf.sub_(logz[..., None]).exp_().mul_(dl[..., None])
        grad.scatter_add_(-1, ll.clamp(min=0).long()[..., None],
                          (-dl)[..., None])           # the gold logit's
        if ctx.cap is not None:
            grad = torch.ops.aten.tanh_backward(grad.mul_(ctx.cap), t)
            grad = grad.div_(ctx.cap)
        return grad.to(logits.dtype), None, None, None


def chunked_nll(h, emb, labels, *, tied=True, chunk=512,
                final_softcap=None, ignore: int = -1):
    """(summed token nll fp32, labelled token count) of h: [B, S, D] with
    sequence-chunked logits: the unembedding product and softmax run per
    S-chunk under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), so the forward and the backward hold one chunk of
    logits at a time.  emb: [V, D] (tied=True) or [D, V]; labels: [B, S]."""
    from torch.utils.checkpoint import checkpoint
    s = h.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for lo in range(0, h.shape[1], chunk):
        dn, dc = checkpoint(_chunk_loss, h[:, lo:lo + chunk], emb,
                            labels[:, lo:lo + chunk], tied, final_softcap,
                            ignore, use_reentrant=False)
        nll = nll + dn
        cnt = cnt + dc
    return nll, cnt


def chunked_cross_entropy(h, emb, labels, *, tied=True, chunk=512,
                          final_softcap=None, ignore: int = -1):
    """Sequence-chunked CE that never holds [B, S, V] logits
    (:func:`chunked_nll`).  Returns the mean token CE (fp32 scalar)."""
    nll, cnt = chunked_nll(h, emb, labels, tied=tied, chunk=chunk,
                           final_softcap=final_softcap, ignore=ignore)
    return nll / torch.clamp(cnt, min=1)
