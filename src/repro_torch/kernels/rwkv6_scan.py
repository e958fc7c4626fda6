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

Design: one block per (batch, head) row loops over 32-step chunks and keeps
the [dk, dv] state in shared memory.  The intra-chunk weights take
exp(cum_prev_i - cum_j) per channel only for j < i, so no exponent is
positive: the TPU kernel's k * exp(-cum) factor would reach about e^72 at
full width (see the ``.cu``).

For tensors on the CPU the wrapper runs the plain version (the chunked scan
of :func:`repro_torch.kernels.ref.rwkv6_chunked`); for CUDA tensors it
launches the kernel (bf16 r/k/v, fp32 logw/u, dk and dv up to 64), or
raises.  ``rwkv6_scan.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_chunked

NAME = "rwkv6_scan"
CHUNK = 32          # the kernel's chunk length, and the plain version's
MAX_DIM = 64        # dk, dv


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
    return rwkv6_chunked(r, k, v, logw, u, chunk=CHUNK, return_final=True)


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
    if dk > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"rwkv6_scan: dk {dk} and dv {dv} must be <= "
                         f"{MAX_DIM}")
    if not all(t.is_contiguous() for t in (r, k, v, logw, u)):
        raise ValueError("rwkv6_scan: inputs must be contiguous")
    y = torch.empty_like(v)
    state = torch.empty((rows, dk, dv), dtype=torch.float32, device=r.device)
    lib = _lib()
    code = lib.rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), rows, s, dk, dv,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, NAME, code)
    rwkv6_scan.launches += 1
    return y, state


rwkv6_scan.launches = 0
