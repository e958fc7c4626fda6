"""Bitmap-driven dispatch packing: the wrapper of ``csrc/dispatch_pack.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/dispatch_pack.py``
(``dispatch_pack`` / ``_pack_kernel``): the cs_send / cs_relay packing step
that every MoE layer runs three times per forward
(``core/collectives.py::hierarchical_dispatch``).

What bounds it on an H100: bytes.  It reads the N input rows once and writes
the [D, C, H] packed buffer once, and computes nothing.  At the DBRX prefill
shapes (N = 2048 tokens, H = 6144, bf16) the three stages move about 57, 63
and 165 MB: 17, 19 and 49 us at 3.35 TB/s.

Design: the TPU kernel's sequential grid with an SMEM slot counter cannot
carry over, since Hopper runs blocks in no order.  Pass 1 runs one block per
destination that scans the bitmap column and writes the slot map; pass 2
runs one warp per slot that copies its row with 16-byte loads and stores.
The copy moves raw bytes, so the kernel is bit-exact against the plain
version for every element type.

For tensors on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.pack_ref`); for CUDA tensors it launches the
kernel, or raises.  ``dispatch_pack.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pack_ref

NAME = "dispatch_pack"
DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.library(NAME)
    fn = lib.dispatch_pack
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, ctypes.c_longlong, I, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def dispatch_pack(tokens: torch.Tensor, bitmap: torch.Tensor,
                  valid: torch.Tensor, *, num_dests: int, capacity: int):
    """Pack rows into per-destination buffers.

    tokens [N, H]; bitmap [N] int32 (bit d: destination d); valid [N] bool;
    num_dests D <= 31; capacity C slots per destination.
    Returns (out [D, C, H] in tokens' dtype, src_idx [D, C] int32 with -1
    for empty slots).
    """
    devices = {tokens.device, bitmap.device, valid.device}
    if len(devices) != 1:
        raise ValueError(f"dispatch_pack: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    if not 1 <= num_dests <= 31 or capacity < 1:
        raise ValueError(f"dispatch_pack: need 1 <= num_dests <= 31 and "
                         f"capacity >= 1, got {num_dests}, {capacity}")
    if tokens.device.type == "cpu":
        return pack_ref(tokens, bitmap, valid, num_dests, capacity)
    if tokens.device.type != "cuda":
        raise ValueError(f"dispatch_pack: no kernel for device "
                         f"{tokens.device}")
    n, h = tokens.shape
    if tokens.dtype not in DTYPES:
        raise TypeError(f"dispatch_pack: tokens dtype {tokens.dtype}")
    if bitmap.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"dispatch_pack: bitmap must be int32 and valid "
                        f"bool, got {bitmap.dtype}, {valid.dtype}")
    if bitmap.shape != (n,) or valid.shape != (n,):
        raise ValueError(f"dispatch_pack: bitmap {tuple(bitmap.shape)} and "
                         f"valid {tuple(valid.shape)} must be ({n},)")
    if not (tokens.is_contiguous() and bitmap.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("dispatch_pack: inputs must be contiguous")
    out = torch.empty((num_dests, capacity, h), dtype=tokens.dtype,
                      device=tokens.device)
    src_idx = torch.empty((num_dests, capacity), dtype=torch.int32,
                          device=tokens.device)
    row_bytes = h * tokens.element_size()
    vec16 = int(row_bytes % 16 == 0 and tokens.data_ptr() % 16 == 0
                and out.data_ptr() % 16 == 0)
    lib = _lib()
    code = lib.dispatch_pack(
        tokens.data_ptr(), bitmap.data_ptr(), valid.data_ptr(),
        out.data_ptr(), src_idx.data_ptr(), n, row_bytes, num_dests,
        capacity, vec16, torch.cuda.current_stream(tokens.device).cuda_stream)
    _build.check(lib, NAME, code)
    dispatch_pack.launches += 1
    return out, src_idx


dispatch_pack.launches = 0
