"""FlashAttention prefill attention on wgmma and TMA: the wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention`` / ``_attn_kernel``), the prefill attention of every
block (``models/layers.py::attention``).

What bounds it on an H100: at the DBRX prefill shape (q [4, 48, 512, 128],
kv [4, 8, 512, 128], bf16, causal) the bytes of q, k, v and o (about 59 MB,
17.5 us at 3.35 TB/s) and the causal half of the two products (12.9 GFLOP,
13 us at 989 TFLOP/s bf16) are close, so the kernel must keep the scores
and the repeated kv heads out of device memory, overlap its loads with its
products and run the products at the wgmma rate.

Design: one block per (batch, head, 128-row q tile); a producer warpgroup
(one thread issues) keeps TMA loads of the next kv tile in flight (a two-stage ring in swizzled
shared memory, on mbarriers) while two consumer warpgroups of 64 q rows
run S = Q K^T and O += P V as ``wgmma`` (P from registers, V through the
transpose bit) with the running max, sum and accumulator in fp32
registers.  The heaviest causal q tiles launch first; tiles wholly outside
a warpgroup's causal or window mask are skipped; grouped kv is read
directly, so the reference's ``jnp.repeat`` of the kv heads is never
materialised.

Layout: q [B, H, S, D] and grouped k/v [B, G, T, D] (H = G * rep, query head
h reads kv head h // rep), as ``layers.flash_attention_jnp`` of the
reference takes them.  The kernel describes each to TMA through its strides
(4-D tensor maps made on every call), so views of [B, S, H, D] buffers
need no copy; the output is such a view.

The gradient (training): when q, k or v needs one, :func:`flash_attention`
runs under a ``torch.autograd.Function`` whose forward also writes each
row's log-sum-exp, and whose backward is :func:`flash_attention_bwd`, the
FlashAttention backward of the same source (``flash_attention_bwd``), in
two passes shaped like the forward (TMA rings, wgmma): dQ, one persistent
block an SM walking the 128-row q tiles, whose prologue also writes each
row's delta = rowsum(do * o); then dK and dV with one block per pair of
64-row kv tiles (:func:`dkdv_blocks`), whose two consumer warpgroups
split the q heads' steps and sum their partials in a fixed order; no
atomics.

For tensors on the CPU each wrapper runs its plain version (dense fp32
attention, :func:`repro_torch.kernels.ref.attention_ref`, over repeated kv
heads; :func:`~repro_torch.kernels.ref.attention_bwd_ref` for the
gradient); for CUDA tensors it launches the kernel (bf16, head_dim 64, 112
or 128), or raises.  ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.ref import attention_ref

NAME = "flash_attention"
HEAD_DIMS = (64, 112, 128)
BWD_ROWS = 64   # rows of the backward's tiles and steps (kBwdRows)


def _lib() -> ctypes.CDLL:
    lib = _build.library(NAME)
    fn = lib.flash_attention
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        F = ctypes.c_float
        fn.argtypes = [P] * 4 + [L] * 12 + [I] * 6 + [F, F, I, I, P, P]
        fn.restype = ctypes.c_int
        bwd = lib.flash_attention_bwd
        bwd.argtypes = [P] * 11 + [I] * 6 + [F, F, I, I, P]
        bwd.restype = ctypes.c_int
        rec = lib.flash_attention_bwd_record
        rec.argtypes = bwd.argtypes + [P, L]
        rec.restype = ctypes.c_int
    return lib


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          softcap=None, scale=None):
    """Plain version: the kv heads repeated, then dense attention in fp32.
    q [B, H, S, D], k/v [B, G, T, D] -> [B, H, S, D] in q's dtype."""
    b, h, s, d = q.shape
    g, t = k.shape[1], k.shape[2]
    rep = h // g
    kx = k.repeat_interleave(rep, dim=1).reshape(b * h, t, d)
    vx = v.repeat_interleave(rep, dim=1).reshape(b * h, t, d)
    out = attention_ref(q.reshape(b * h, s, d), kx, vx, causal=causal,
                        window=window, softcap=softcap, scale=scale)
    return out.reshape(b, h, s, d)


def _check_operand(name: str, x: torch.Tensor) -> None:
    if x.stride(-1) != 1 or x.data_ptr() % 16 != 0 or any(
            st % 8 for st in x.stride()[:-1]):
        raise ValueError(f"flash_attention: {name} needs a contiguous head "
                         f"dimension and 16-byte aligned rows, got strides "
                         f"{x.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Fused attention.  q [B, H, S, D]; k/v [B, G, T, D] with H % G == 0.
    Returns [B, H, S, D] in q's dtype.  Differentiable in q, k and v."""
    mask = (causal, window, softcap, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, mask)
    return _forward(q, k, v, mask, with_lse=False)[0]


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        out, lse = _forward(q, k, v, mask, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, grad_out, lse,
                                         causal=causal, window=window,
                                         softcap=softcap, scale=scale)
        return dq, dk, dv, None


def _forward(q, k, v, mask, *, with_lse: bool):
    """The forward: (out, the rows' log-sum-exp [B, H, S] fp32 when
    ``with_lse``, else None)."""
    causal, window, softcap, scale = mask
    b, h, s, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not match")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    if q.device.type == "cpu":
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        out = flash_attention_plain(q, k, v, **kw)
        return out, ref.attention_lse(q, k, **kw) if with_lse else None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"flash_attention: the kernel takes bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x)
    g, t = k.shape[1], k.shape[2]
    # [B, S, H, D] storage seen as [B, H, S, D]: callers merge heads freely
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    code = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        b, h, g, s, t, d,
        d ** -0.5 if scale is None else scale,
        0.0 if softcap is None else softcap,
        int(causal), 0 if window is None else int(window),
        None if lse is None else lse.data_ptr(), _build.stream(q.device))
    _build.check(lib, NAME, code)
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, grad_out, lse, *, causal=True,
                        window=None, softcap=None, scale=None, record=None):
    """The backward of :func:`flash_attention`: from its inputs, its output
    ``out``, the output's gradient and the forward's log-sum-exp ``lse``
    [B, H, S], returns (dq, dk, dv) in the shapes and dtypes of q, k, v.

    ``record``, on the card only: an int64 tensor of
    :func:`dkdv_blocks` x 2 x 2 into which each dK/dV block's two consumer
    warpgroups write the q steps they walked and the SM clock cycles they
    took, blocks in (batch, kv head, pair) order."""
    b, h, s, d = q.shape
    g, t = k.shape[1], k.shape[2]
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if grad_out.shape != q.shape or out.shape != q.shape \
            or lse.shape != (b, h, s):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, out "
                         f"{tuple(out.shape)}, grad {tuple(grad_out.shape)}, "
                         f"lse {tuple(lse.shape)}")
    if q.device.type == "cpu" and record is None:
        return ref.attention_bwd_ref(q, k, v, out, grad_out, lse, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    blocks = dkdv_blocks(b, g, t, causal=causal)
    if record is not None and (record.shape != (blocks, 2, 2)
                               or record.dtype != torch.int64
                               or record.device != q.device
                               or not record.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: record needs a contiguous "
                         f"int64 tensor of ({blocks}, 2, 2) on {q.device}")
    if grad_out.dtype != torch.bfloat16 or grad_out.stride(-1) != 1:
        grad_out = grad_out.to(torch.bfloat16).contiguous()
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("grad", grad_out)):
        _check_operand(name, x)
    # gradients in the [B, S, heads, D] layout the forward's inputs have
    dq = torch.empty((b, s, h, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((b, t, g, d), dtype=k.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty((b, t, g, d), dtype=v.dtype,
                     device=q.device).transpose(1, 2)
    stats = torch.empty(bwd_stats_shape(b, h, s), dtype=torch.float32,
                        device=q.device)
    strides = (ctypes.c_longlong * 24)(*[
        st for x in (q, k, v, out, grad_out, dq, dk, dv)
        for st in x.stride()[:3]])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            grad_out.data_ptr(), lse.contiguous().data_ptr(), stats.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides,
            b, h, g, s, t, d, d ** -0.5 if scale is None else scale,
            0.0 if softcap is None else softcap, int(causal),
            0 if window is None else int(window), _build.stream(q.device))
    lib = _lib()
    code = (lib.flash_attention_bwd(*args) if record is None else
            lib.flash_attention_bwd_record(*args, record.data_ptr(), blocks))
    _build.check(lib, "flash_attention_bwd", code)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def bwd_stats_shape(batch: int, heads: int, q_len: int) -> tuple:
    """The backward's fp32 scratch: each q row's log-sum-exp times log2(e)
    and its delta = rowsum(do * o), which the dQ pass writes and the dK/dV
    pass loads a 64-row step at a time; rows padded to whole steps."""
    return (2, batch, heads, -(-q_len // BWD_ROWS) * BWD_ROWS)


def dkdv_blocks(batch: int, kv_heads: int, kv_len: int, *,
                causal: bool = True) -> int:
    """The backward's dK/dV blocks: one per (batch, kv head, pair of 64-row
    kv tiles i and n - 1 - i) under a causal mask, else per kv tile."""
    tiles = -(-kv_len // BWD_ROWS)
    return batch * kv_heads * (-(-tiles // 2) if causal else tiles)
