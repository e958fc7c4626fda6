"""RWKV-6 chunked WKV scan: the wrapper of ``csrc/rwkv6_scan.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/rwkv6_scan.py``
(``rwkv6_scan`` / ``_rwkv6_kernel``), the time-mix of every RWKV6 block at
prefill (``models/rwkv.py::time_mix``).  Unlike the TPU kernel it also
returns the final state, which the prefill hands to decode (the
reference's serving path runs its chunked jnp twin for that).

What bounds it on an H100: bytes.  At the RWKV6-7B prefill shape (r/k/v
[256, 512, 64] bf16, logw fp32) it reads r, k, v and logw once and writes y
and the final state, about 105 MB (0.031 ms at 3.35 TB/s), against about
3 GFLOP.

Design: one warpgroup per (batch, head) row walks 64-step chunks with the
[dk, dv] state in shared memory.  Each warp owns a 16-step sub-chunk: its
scores against earlier sub-chunks factorise around a reference point at
the sub-chunk's start (``mma.sync``), and its 16 x 16 diagonal block once
more around its middle, so only 8-step triangles take one exp per (i, j,
channel), and no exponent is ever positive (the TPU kernel's
k * exp(-cum) factor would overflow at full width).  The chunk
products A v, r~ S_prev and the state update are ``wgmma`` m64n64k16, with
fp32-made operands split into hi + lo bf16 pairs; r, k, v, logw arrive by
``cp.async`` into a double buffer (see the ``.cu``).

The gradient (training): when an input needs one, :func:`rwkv6_scan` runs
under a ``torch.autograd.Function`` whose backward is
:func:`rwkv6_scan_bwd`, the ``rwkv6_scan_bwd`` kernel of the same source:
one warpgroup a row walks the chunks forward, writing each chunk's
dy S0^T to a scratch, then in reverse with the state's gradient as hi + lo
bf16 tiles in shared memory, on the tensor cores (``wgmma`` for the chunk
products, ``mma.sync`` for the sub-chunk ones around the forward's
reference points, fp32-made operands as hi + lo bf16 pairs).  The
log-decays' gradient is a reverse running sum of r * dr and k * dk terms,
so no exponent is ever positive and it stays finite where a chunk's
decays sum below -88 (see the ``.cu``).

For tensors on the CPU each wrapper runs its plain version (the chunked
scan of :func:`repro_torch.kernels.ref.rwkv6_chunked` at the reference's
chunk of 32, whatever tile the kernel takes, and its gradient
:func:`~repro_torch.kernels.ref.rwkv6_chunked_bwd`); for CUDA tensors it
launches the kernel (bf16 r/k/v, fp32 logw/u, dk and dv multiples of 8 up
to 64, contiguous and 16-byte aligned), or raises.
``rwkv6_scan.launches`` and ``rwkv6_scan_bwd.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.ref import rwkv6_chunked, rwkv6_chunked_bwd

NAME = "rwkv6_scan"
PLAIN_CHUNK = 32    # the plain version's chunk: the reference's default
MAX_DIM = 64        # dk, dv: multiples of 8 up to 64


def _lib() -> ctypes.CDLL:
    lib = _build.library(NAME)
    fn = lib.rwkv6_scan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 4 + [P]
        fn.restype = ctypes.c_int
        bwd = lib.rwkv6_scan_bwd
        bwd.argtypes = [P] * 13 + [I] * 4 + [P]
        bwd.restype = ctypes.c_int
    return lib


def rwkv6_scan_plain(r, k, v, logw, u):
    """Plain version: the chunked scan in fp32.  Returns (y in v's dtype,
    final state fp32)."""
    return rwkv6_chunked(r, k, v, logw, u, chunk=PLAIN_CHUNK,
                         return_final=True)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor):
    """Chunked RWKV-6 time-mix with its final state.

    r, k, logw [BH, S, dk] (logw <= 0); v [BH, S, dv]; u [BH, dk].
    Returns (y [BH, S, dv] in v's dtype, state [BH, dk, dv] fp32).
    Differentiable in every input.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u)):
        return _RWKV6Scan.apply(r, k, v, logw, u)
    return _scan(r, k, v, logw, u)


class _RWKV6Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        y, state = _scan(r, k, v, logw, u)
        ctx.save_for_backward(r, k, v, logw, u)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, logw, u = ctx.saved_tensors
        dy = torch.zeros_like(v) if dy is None else dy.contiguous()
        return rwkv6_scan_bwd(r, k, v, logw, u, dy,
                              None if dstate is None else dstate.contiguous())


def _check(name, r, k, v, logw, u):
    """Raise on inputs that do not match or that the kernel does not take
    (for CUDA tensors)."""
    rows, s, dk = r.shape
    dv = v.shape[-1]
    if (k.shape != r.shape or logw.shape != r.shape
            or v.shape != (rows, s, dv) or u.shape != (rows, dk)):
        raise ValueError(f"{name}: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)} do not "
                         f"match")
    devices = {t.device for t in (r, k, v, logw, u)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    if r.device.type == "cpu":
        return
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {r.device}")
    if not r.dtype == k.dtype == v.dtype == torch.bfloat16 or not (
            logw.dtype == u.dtype == torch.float32):
        raise TypeError(f"{name}: the kernel takes bf16 r/k/v and fp32 "
                        f"logw/u, got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{logw.dtype}, {u.dtype}")
    if not (dk <= MAX_DIM and dv <= MAX_DIM and dk % 8 == dv % 8 == 0):
        raise ValueError(f"{name}: dk {dk} and dv {dv} must be "
                         f"multiples of 8 up to {MAX_DIM}")
    if not all(t.is_contiguous() and (t.is_meta or t.data_ptr() % 16 == 0)
               for t in (r, k, v, logw, u)):
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                         f"aligned")


def _scan(r, k, v, logw, u):
    _check("rwkv6_scan", r, k, v, logw, u)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, logw, u)
    rows, s, dk = r.shape
    dv = v.shape[-1]
    y = torch.empty_like(v)
    state = torch.empty((rows, dk, dv), dtype=torch.float32, device=r.device)
    if r.device.type == "meta":
        # the work of the chunked form at the reference's chunk of 32
        q = PLAIN_CHUNK
        low = q * (q - 1) // 2          # strictly-lower pairs of a chunk
        cost.record(NAME, 2 * rows * -(-s // q) * (
            low * dk + q * dk + (low + q) * dv + 2 * q * dk * dv),
            (r.numel() + k.numel() + 2 * v.numel()) * r.element_size()
            + 4 * logw.numel() + 4 * u.numel() + 4 * rows * dk * dv)
        return y, state
    lib = _lib()
    code = lib.rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), rows, s, dk, dv,
        _build.stream(r.device))
    _build.check(lib, NAME, code)
    rwkv6_scan.launches += 1
    return y, state


rwkv6_scan.launches = 0

BWD_CHUNK = 64      # the backward kernel's chunk
BWD_SCRATCH = 64 * 64   # fp32 a chunk and row: its dy S0^T


def rwkv6_scan_bwd(r, k, v, logw, u, dy, dstate=None):
    """The backward of :func:`rwkv6_scan`: from its inputs, the gradient
    ``dy`` [BH, S, dv] of y (v's dtype) and that of the final state
    ``dstate`` [BH, dk, dv] fp32 (None: zero), returns (dr, dk, dv, dlogw,
    du) in the shapes and dtypes of r, k, v, logw, u."""
    _check("rwkv6_scan_bwd", r, k, v, logw, u)
    rows, s, dk = r.shape
    dv = v.shape[-1]
    if dy.shape != v.shape or (dstate is not None and dstate.shape != (
            rows, dk, dv)):
        raise ValueError(f"rwkv6_scan_bwd: dy {tuple(dy.shape)} and dstate "
                         f"{None if dstate is None else tuple(dstate.shape)} "
                         f"do not match v {tuple(v.shape)}")
    if r.device.type == "cpu":
        grads = rwkv6_chunked_bwd(r, k, v, logw, u, dy, dstate,
                                  chunk=PLAIN_CHUNK)
        return tuple(gr.to(t.dtype) for gr, t in
                     zip(grads, (r, k, v, logw, u)))
    if r.device.type == "meta":
        # r, k, v, dy, dr, dk, dv; logw, dlogw fp32; u, du; a chunk and
        # row: 8 chunk products and the sub-chunk ones (chip_smoke.py)
        c = BWD_CHUNK
        cost.record("rwkv6_scan_bwd", 2 * rows * -(-s // c) * (
            8 * c * dk * dv + 3 * 6 * 16 * 16 * dk + 12 * 8 * 8 * dk),
            7 * r.numel() * r.element_size() + 8 * logw.numel()
            + 8 * rows * dk)
        return tuple(torch.empty_like(t) for t in (r, k, v, logw, u))
    if dy.device != r.device or dy.dtype != v.dtype or not dy.is_contiguous() \
            or dy.data_ptr() % 16 or (dstate is not None and (
                dstate.device != r.device or dstate.dtype != torch.float32
                or not dstate.is_contiguous())):
        raise ValueError("rwkv6_scan_bwd: the kernel takes a contiguous, "
                         "16-byte aligned dy in v's dtype and a contiguous "
                         "fp32 dstate on r's device")
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk_, dv_ = (torch.empty_like(t) for t in (r, k, v))
    dlogw = torch.empty_like(logw)
    du = torch.empty((rows, dk), **f32)
    scratch = torch.empty((rows, -(-s // BWD_CHUNK), BWD_SCRATCH), **f32)
    lib = _lib()
    code = lib.rwkv6_scan_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dr.data_ptr(),
        dk_.data_ptr(), dv_.data_ptr(), dlogw.data_ptr(), du.data_ptr(),
        scratch.data_ptr(), rows, s, dk, dv, _build.stream(r.device))
    _build.check(lib, "rwkv6_scan_bwd", code)
    rwkv6_scan_bwd.launches += 1
    return dr, dk_, dv_, dlogw, du


rwkv6_scan_bwd.launches = 0
