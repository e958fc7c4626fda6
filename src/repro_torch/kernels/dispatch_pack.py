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
carry over, since Hopper runs blocks in no order.  One launch per call: a
grid of (slot tile, destination) blocks, 1 to 16 slots a tile, each of
which ranks its destination's rows itself (warp ballots over the bitmap,
read from L2), writes its part of the slot map and copies its slots' rows
as one flat run of 16-byte words, eight loads in flight a thread.  The
copy moves raw bytes, so the kernel is bit-exact against the plain version
for every element type.

The gradient (training): the pack is a gather by the slot map, so its
backward sums each source row's slots, :func:`dispatch_pack_bwd` (the
kernel ``dispatch_pack_bwd`` of the same source: the slot map inverted, then
one block a row adding its at most D slots in ascending destination order,
in fp32; no atomics, so the sums are the same bits from run to run).
:func:`dispatch_pack` runs under a ``torch.autograd.Function`` when its
tokens need a gradient.

For tensors on the CPU each wrapper runs its plain version
(:func:`repro_torch.kernels.ref.pack_ref`, :func:`~repro_torch.kernels.ref.
pack_bwd_ref`); for CUDA tensors it launches the kernel, or raises.
``dispatch_pack.launches`` and ``dispatch_pack_bwd.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pack_bwd_ref, pack_ref

NAME = "dispatch_pack"
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    """The C entry point, looked up and typed once per process."""
    fn = _build.library(NAME).dispatch_pack
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, ctypes.c_longlong, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    fn = _build.library(NAME).dispatch_pack_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


class _Pack(torch.autograd.Function):
    """The pack with its gradient: the tokens' gradient sums each row's
    slots of the output's gradient (:func:`dispatch_pack_bwd`)."""

    @staticmethod
    def forward(ctx, tokens, bitmap, valid, num_dests, capacity):
        out, src_idx = _pack(tokens, bitmap, valid, num_dests, capacity)
        ctx.mark_non_differentiable(src_idx)
        ctx.save_for_backward(src_idx)
        ctx.rows = tokens.shape[0]
        return out, src_idx

    @staticmethod
    def backward(ctx, grad_out, _grad_idx):
        (src_idx,) = ctx.saved_tensors
        return (dispatch_pack_bwd(grad_out, src_idx, ctx.rows),
                None, None, None, None)


def dispatch_pack(tokens: torch.Tensor, bitmap: torch.Tensor,
                  valid: torch.Tensor, *, num_dests: int, capacity: int):
    """Pack rows into per-destination buffers.

    tokens [N, H]; bitmap [N] int32 (bit d: destination d); valid [N] bool;
    num_dests D <= 31; capacity C slots per destination.
    Returns (out [D, C, H] in tokens' dtype, src_idx [D, C] int32 with -1
    for empty slots).  Differentiable in ``tokens``.
    """
    if tokens.requires_grad and torch.is_grad_enabled():
        return _Pack.apply(tokens, bitmap, valid, num_dests, capacity)
    return _pack(tokens, bitmap, valid, num_dests, capacity)


def _pack(tokens, bitmap, valid, num_dests, capacity):
    device = tokens.device
    if bitmap.device != device or valid.device != device:
        names = sorted({str(t.device) for t in (tokens, bitmap, valid)})
        raise ValueError(f"dispatch_pack: tensors on several devices {names}")
    if not 1 <= num_dests <= 31 or capacity < 1:
        raise ValueError(f"dispatch_pack: need 1 <= num_dests <= 31 and "
                         f"capacity >= 1, got {num_dests}, {capacity}")
    if device.type == "cpu":
        return pack_ref(tokens, bitmap, valid, num_dests, capacity)
    if device.type != "cuda":
        raise ValueError(f"dispatch_pack: no kernel for device {device}")
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
    # new_empty takes dtype and device from its tensor; on the card it costs
    # less than torch.empty, and one buffer cut by views costs more
    out = tokens.new_empty((num_dests, capacity, h))
    src_idx = bitmap.new_empty((num_dests, capacity))
    row_bytes = h * tokens.element_size()
    tok = tokens.data_ptr()
    # a fresh allocation is 16-byte aligned: only the tokens can break vec16
    vec16 = int(row_bytes % 16 == 0 and tok % 16 == 0)
    code = _entry()(tok, bitmap.data_ptr(), valid.data_ptr(), out.data_ptr(),
                    src_idx.data_ptr(), n, row_bytes, num_dests, capacity,
                    vec16, _build.sm_count(device.index),
                    _build.stream(device))
    if code:
        _build.check(_build.library(NAME), NAME, code)
    dispatch_pack.launches += 1
    return out, src_idx


dispatch_pack.launches = 0


def dispatch_pack_bwd(grad_out: torch.Tensor, src_idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """The pack's backward: grad_out [D, C, H] and the forward's slot map
    src_idx [D, C] -> the tokens' gradient [N, H] in grad_out's dtype, each
    row the sum of its slots (zeros for a row in no slot)."""
    device = grad_out.device
    if src_idx.device != device:
        raise ValueError(f"dispatch_pack_bwd: tensors on several devices "
                         f"{sorted({str(device), str(src_idx.device)})}")
    d, c, h = grad_out.shape
    if src_idx.shape != (d, c) or not 1 <= d <= 31 or n < 1:
        raise ValueError(f"dispatch_pack_bwd: grad {tuple(grad_out.shape)}, "
                         f"slot map {tuple(src_idx.shape)}, {n} rows")
    if device.type == "cpu":
        return pack_bwd_ref(grad_out, src_idx, n)
    if device.type != "cuda":
        raise ValueError(f"dispatch_pack_bwd: no kernel for device {device}")
    if grad_out.dtype not in DTYPES or src_idx.dtype != torch.int32:
        raise TypeError(f"dispatch_pack_bwd: grad {grad_out.dtype}, slot "
                        f"map {src_idx.dtype}")
    grad_out = grad_out.contiguous()
    src_idx = src_idx.contiguous()
    grad_tokens = grad_out.new_empty((n, h))
    slot_of = src_idx.new_empty((d, n))
    code = _bwd_entry()(grad_out.data_ptr(), src_idx.data_ptr(),
                        slot_of.data_ptr(), grad_tokens.data_ptr(), n, h, d,
                        c, int(grad_out.dtype == torch.float32),
                        _build.stream(device))
    if code:
        _build.check(_build.library(NAME), "dispatch_pack_bwd", code)
    dispatch_pack_bwd.launches += 1
    return grad_tokens


dispatch_pack_bwd.launches = 0
