"""Fixed-width rank-bitmap destination encoding (paper §4.1).

Own copy of ``src/repro/core/bitmap.py``.  The paper replaces multicast
group IDs with a fixed-size bitmap carried in each packet: bit ``i`` set
means rank ``i`` is a destination.  A 64-bit field covers domains up to 64
ranks; larger domains spill extra words into the payload (paper §6.4: 1024
ranks cost 128 bytes, about 3.13% of a 4 KiB payload).

- plain-Python helpers (arbitrary width, int-backed), copied;
- tensor helpers on little-endian 32-bit word arrays.  PyTorch has no
  arithmetic on ``uint32``, so a word is an ``int64`` tensor holding the
  unsigned 32-bit value (the reference's ``uint32`` words, widened).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

WORD_BITS = 32


# ---------------------------------------------------------------------------
# Python side
# ---------------------------------------------------------------------------

def encode(dests: Iterable[int], num_ranks: int) -> int:
    """Encode a destination set as an int bitmap (bit i == rank i)."""
    bm = 0
    for d in dests:
        if not 0 <= d < num_ranks:
            raise ValueError(f"rank {d} out of range [0,{num_ranks})")
        bm |= 1 << d
    return bm


def decode(bitmap: int, num_ranks: int) -> list[int]:
    """Decode an int bitmap into a sorted destination list."""
    if bitmap < 0 or bitmap >> num_ranks:
        raise ValueError(f"bitmap {bitmap:#x} has bits >= {num_ranks}")
    return [i for i in range(num_ranks) if (bitmap >> i) & 1]


def popcount(bitmap: int) -> int:
    return bin(bitmap).count("1")


def subset_mask(dests: Sequence[int]) -> int:
    return encode(dests, max(dests) + 1 if dests else 1)


def metadata_bytes(num_ranks: int) -> int:
    """Header/payload overhead of the bitmap in bytes (§6.4): domains of at
    most 64 ranks ride in the write_with_immediate field (0 extra bytes);
    larger domains embed ceil(num_ranks/8) bytes in the payload."""
    if num_ranks <= 64:
        return 0
    return (num_ranks + 7) // 8


# ---------------------------------------------------------------------------
# tensor side: bitmaps as little-endian 32-bit word arrays
# ---------------------------------------------------------------------------

def num_words(num_ranks: int) -> int:
    return (num_ranks + WORD_BITS - 1) // WORD_BITS


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int64, device=device)


def encode_onehot(onehot: torch.Tensor, num_ranks: int) -> torch.Tensor:
    """Pack a destination matrix ``[..., num_ranks]`` (nonzero means
    destination) into words ``[..., num_words(num_ranks)]`` (int64 holding
    unsigned 32-bit values)."""
    w = num_words(num_ranks)
    oh = (onehot != 0).to(torch.int64)
    pad = w * WORD_BITS - num_ranks
    if pad:
        oh = torch.nn.functional.pad(oh, (0, pad))
    oh = oh.reshape(*oh.shape[:-1], w, WORD_BITS)
    return (oh << _shifts(oh.device)).sum(dim=-1)


def decode_onehot(words: torch.Tensor, num_ranks: int) -> torch.Tensor:
    """Unpack words into a bool matrix ``[..., num_ranks]``."""
    bits = (words.to(torch.int64)[..., :, None] >> _shifts(words.device)) & 1
    return bits.flatten(-2)[..., :num_ranks].bool()


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Number of set bits per bitmap (sum over words), int32."""
    bits = (words.to(torch.int64)[..., :, None] >> _shifts(words.device)) & 1
    return bits.sum(dim=(-1, -2)).to(torch.int32)


def mask_range(words: torch.Tensor, lo: int, hi: int,
               num_ranks: int) -> torch.Tensor:
    """Zero all bits outside [lo, hi): the relay's metadata rewrite (§4.1).
    After forwarding to a next hop responsible for ranks [lo, hi), the
    remaining metadata keeps only that slice so downstream nodes do not
    re-replicate (no duplicate delivery, no routing loops)."""
    oh = decode_onehot(words, num_ranks)
    ranks = torch.arange(num_ranks, device=words.device)
    return encode_onehot(oh & (ranks >= lo) & (ranks < hi), num_ranks)


def np_encode_rows(onehot: np.ndarray, num_ranks: int) -> np.ndarray:
    """NumPy twin of :func:`encode_onehot` for test oracles (uint32)."""
    w = num_words(num_ranks)
    out = np.zeros(onehot.shape[:-1] + (w,), dtype=np.uint32)
    for r in range(num_ranks):
        word, bit = divmod(r, WORD_BITS)
        out[..., word] |= (onehot[..., r].astype(np.uint32) << np.uint32(bit))
    return out
