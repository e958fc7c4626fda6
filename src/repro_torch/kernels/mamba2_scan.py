"""Mamba2 (SSD) chunked scan: the wrapper of ``csrc/mamba2_scan.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/mamba2_scan.py``
(``mamba2_scan`` / ``_mamba2_kernel``), the sequence mixer of every Zamba2
Mamba2 block at prefill (``models/ssm.py::mamba2_block_prefill``).  Unlike
the TPU kernel it also returns the final state, which the prefill hands to
decode (the reference's serving path runs its chunked jnp twin for that).

What bounds it on an H100: bytes.  At the Zamba2-7B prefill shape (x
[448, 512, 64] bf16, dt fp32, B/C one group of [4, 512, 64]) it reads x, dt
and B/C once and writes y and the final state, about 68 MB (0.020 ms at
3.35 TB/s), against 7.5 GFLOP of chunk products.

Design: one block per (batch, head) row loops over 64-step chunks and keeps
the [ds, dh] state in shared memory; the chunk products run in fp32 on the
CUDA cores with 4 x 4 register tiles; B and C are read per group, so the
group shared by all heads is never repeated in memory (see the ``.cu``).

For tensors on the CPU the wrapper runs the plain version (the chunked scan
of :func:`repro_torch.kernels.ref.mamba2_chunked`); for CUDA tensors it
launches the kernel (bf16 x/B/C, dh and ds up to 64), or raises.
``mamba2_scan.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba2_chunked

NAME = "mamba2_scan"
CHUNK = 64          # the kernel's chunk length, and the plain version's
MAX_DIM = 64        # dh, ds


def _lib() -> ctypes.CDLL:
    lib = _build.library(NAME)
    fn = lib.mamba2_scan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 5 + [P]
        fn.restype = ctypes.c_int
    return lib


def expand_groups(t: torch.Tensor, rows: int) -> torch.Tensor:
    """[G, S, ds] -> [rows, S, ds]: row r reads group r // (rows // G)."""
    return t.repeat_interleave(rows // t.shape[0], dim=0)


def mamba2_scan_plain(x, dt, a, b, c, d):
    """Plain version: groups repeated per head, then the chunked scan in
    fp32.  Returns (y in x's dtype, final state fp32)."""
    rows = x.shape[0]
    return mamba2_chunked(x, dt, a, expand_groups(b, rows),
                          expand_groups(c, rows), d, chunk=CHUNK,
                          return_final=True)


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d: torch.Tensor):
    """Chunked SSD scan with its final state.

    x [BH, S, dh]; dt [BH, S] (post-softplus); a, d [BH] fp32; b, c
    [G, S, ds] with BH % G == 0, row bh reading group bh // (BH // G)
    (G = BH: one group per head; G = batch: Mamba2's single group shared
    by every head).  Returns (y [BH, S, dh] in x's dtype, h [BH, ds, dh]
    fp32).
    """
    rows, s, dh = x.shape
    g, ds = b.shape[0], b.shape[-1]
    if (dt.shape != (rows, s) or a.shape != (rows,) or d.shape != (rows,)
            or b.shape != (g, s, ds) or c.shape != b.shape or rows % g):
        raise ValueError(f"mamba2_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, d "
                         f"{tuple(d.shape)} do not match")
    devices = {t.device for t in (x, dt, a, b, c, d)}
    if len(devices) != 1:
        raise ValueError(f"mamba2_scan: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    if x.device.type == "cpu":
        return mamba2_scan_plain(x, dt, a, b, c, d)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_scan: no kernel for device {x.device}")
    if not x.dtype == b.dtype == c.dtype == torch.bfloat16 or not (
            dt.dtype == a.dtype == d.dtype == torch.float32):
        raise TypeError(f"mamba2_scan: the kernel takes bf16 x/b/c and fp32 "
                        f"dt/a/d, got {x.dtype}, {b.dtype}, {c.dtype}, "
                        f"{dt.dtype}, {a.dtype}, {d.dtype}")
    if dh > MAX_DIM or ds > MAX_DIM:
        raise ValueError(f"mamba2_scan: dh {dh} and ds {ds} must be <= "
                         f"{MAX_DIM}")
    if not all(t.is_contiguous() for t in (x, dt, a, b, c, d)):
        raise ValueError("mamba2_scan: inputs must be contiguous")
    y = torch.empty_like(x)
    h = torch.empty((rows, ds, dh), dtype=torch.float32, device=x.device)
    lib = _lib()
    code = lib.mamba2_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), y.data_ptr(), h.data_ptr(), rows, s, dh,
        ds, rows // g, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, NAME, code)
    mamba2_scan.launches += 1
    return y, h


mamba2_scan.launches = 0
