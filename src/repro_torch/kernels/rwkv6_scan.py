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

For tensors on the CPU the wrapper runs the plain version (the chunked scan
of :func:`repro_torch.kernels.ref.rwkv6_chunked` at the reference's chunk
of 32, whatever tile the kernel takes); for CUDA tensors it launches the
kernel (bf16 r/k/v, fp32 logw/u, dk and dv multiples of 8 up to 64,
contiguous and 16-byte aligned), or raises.  ``rwkv6_scan.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_chunked

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
    """
    rows, s, dk = r.shape
    dv = v.shape[-1]
    if (k.shape != r.shape or logw.shape != r.shape
            or v.shape != (rows, s, dv) or u.shape != (rows, dk)):
        raise ValueError(f"rwkv6_scan: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)} do not "
                         f"match")
    devices = {t.device for t in (r, k, v, logw, u)}
    if len(devices) != 1:
        raise ValueError(f"rwkv6_scan: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, logw, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: no kernel for device {r.device}")
    if not r.dtype == k.dtype == v.dtype == torch.bfloat16 or not (
            logw.dtype == u.dtype == torch.float32):
        raise TypeError(f"rwkv6_scan: the kernel takes bf16 r/k/v and fp32 "
                        f"logw/u, got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{logw.dtype}, {u.dtype}")
    if not (dk <= MAX_DIM and dv <= MAX_DIM and dk % 8 == dv % 8 == 0):
        raise ValueError(f"rwkv6_scan: dk {dk} and dv {dv} must be "
                         f"multiples of 8 up to {MAX_DIM}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (r, k, v, logw, u)):
        raise ValueError("rwkv6_scan: inputs must be contiguous and 16-byte "
                         "aligned")
    y = torch.empty_like(v)
    state = torch.empty((rows, dk, dv), dtype=torch.float32, device=r.device)
    lib = _lib()
    code = lib.rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), rows, s, dk, dv,
        _build.stream(r.device))
    _build.check(lib, NAME, code)
    rwkv6_scan.launches += 1
    return y, state


rwkv6_scan.launches = 0
