"""The kernels the models call.

Each op goes by the device of its tensors alone: the hand-written CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors, and
for meta tensors (the dry run, ``launch/dryrun.py``) outputs of the right
shapes, with the launch's FLOPs and bytes recorded (``kernels/cost.py``).
There is no switch and no fallback.  Decode attention is a plain op on every
device, as in the reference (``src/repro/kernels/ops.py::decode_attention``):
one query token per sequence is a memory-bound matrix-vector product.  So
are the one-token Mamba2 and RWKV-6 state updates of decode
(``ref.mamba2_decode_step``, ``ref.rwkv6_decode_step``), plain in both
packages.

Every kernel op is differentiable: the pack, attention (at each head_dim
it takes, 256 included) and the two scans run their gradients through the
backward kernels of the same sources (``dispatch_pack_bwd``,
``flash_attention_bwd``, ``mamba2_scan_bwd``, ``rwkv6_scan_bwd``; plain
versions for CPU tensors), so every family trains on the card.

Launch counts: ``<op>.launches`` for each op of ``KERNEL_OPS``, real launches
only.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.dispatch_pack import dispatch_pack, dispatch_pack_bwd
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.mamba2_scan import mamba2_scan, mamba2_scan_bwd
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd

__all__ = ["dispatch_pack", "dispatch_pack_bwd", "flash_attention",
           "flash_attention_bwd", "mamba2_scan", "mamba2_scan_bwd",
           "rwkv6_scan", "rwkv6_scan_bwd", "decode_attention",
           "reset_launches", "launches"]

KERNEL_OPS = (dispatch_pack, flash_attention, mamba2_scan, rwkv6_scan,
              dispatch_pack_bwd, flash_attention_bwd, mamba2_scan_bwd,
              rwkv6_scan_bwd)


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
