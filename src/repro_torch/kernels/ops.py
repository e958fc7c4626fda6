"""The kernels the models call.

Each op goes by the device of its tensors alone: the hand-written CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors.  There
is no switch and no fallback.  Decode attention is a plain op on every
device, as in the reference (``src/repro/kernels/ops.py::decode_attention``):
one query token per sequence is a memory-bound matrix-vector product.

Launch counts: ``dispatch_pack.launches`` and ``flash_attention.launches``.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.dispatch_pack import dispatch_pack
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["dispatch_pack", "flash_attention", "decode_attention",
           "reset_launches", "launches"]

KERNEL_OPS = (dispatch_pack, flash_attention)


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
