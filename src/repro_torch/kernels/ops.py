"""The kernels the models call.

Each op goes by the device of its tensors alone: the hand-written CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors.  There
is no switch and no fallback.  Decode attention is a plain op on every
device, as in the reference (``src/repro/kernels/ops.py::decode_attention``):
one query token per sequence is a memory-bound matrix-vector product.  So
are the one-token Mamba2 and RWKV-6 state updates of decode
(``ref.mamba2_decode_step``, ``ref.rwkv6_decode_step``), plain in both
packages.

The pack and attention are differentiable: their gradients run the
backward kernels of the same sources (``dispatch_pack_bwd``,
``flash_attention_bwd``; plain versions for CPU tensors).  The two scans
have no backward kernel yet, so the hybrid and rwkv families do not train
on the card (``models.api.Model.loss`` raises there).

Launch counts: ``<op>.launches`` for each op of ``KERNEL_OPS``.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.dispatch_pack import dispatch_pack, dispatch_pack_bwd
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.mamba2_scan import mamba2_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan

__all__ = ["dispatch_pack", "dispatch_pack_bwd", "flash_attention",
           "flash_attention_bwd", "mamba2_scan", "rwkv6_scan",
           "decode_attention", "reset_launches", "launches"]

KERNEL_OPS = (dispatch_pack, flash_attention, mamba2_scan, rwkv6_scan,
              dispatch_pack_bwd, flash_attention_bwd)


def decode_attention(q, k, v, kv_len=None, *, scale=None, softcap=None,
                     window=None):
    """Decode-step attention over a grouped KV cache (plain op)."""
    return ref.decode_attention_ref(q, k, v, kv_len, scale=scale,
                                    softcap=softcap, window=window)


def reset_launches() -> None:
    for op in KERNEL_OPS:
        op.launches = 0


def launches() -> dict[str, int]:
    return {op.__name__: op.launches for op in KERNEL_OPS}
