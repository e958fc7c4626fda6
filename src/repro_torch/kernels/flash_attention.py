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

For tensors on the CPU the wrapper runs the plain version (dense fp32
attention, :func:`repro_torch.kernels.ref.attention_ref`, over repeated kv
heads); for CUDA tensors it launches the kernel (bf16, head_dim 64, 112 or
128), or raises.  ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

NAME = "flash_attention"
HEAD_DIMS = (64, 112, 128)


def _lib() -> ctypes.CDLL:
    lib = _build.library(NAME)
    fn = lib.flash_attention
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 4 + [L] * 12 + [I] * 6
                       + [ctypes.c_float, ctypes.c_float, I, I, P])
        fn.restype = ctypes.c_int
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
    Returns [B, H, S, D] in q's dtype."""
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
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
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
        _build.stream(q.device))
    _build.check(lib, NAME, code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
