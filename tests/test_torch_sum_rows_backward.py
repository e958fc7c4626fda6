"""The backward of the combine's row sum (``collectives._sum_rows_into``):
one gather of the cotangent by each row's slot, against autograd through
the blocked gathers of ``_sum_rows_plain``, bit for bit up to the sign of
zero (``torch.equal`` holds -0.0 equal to 0.0), at one row a slot and at
several, with rows that land in no slot (index -1), over one block of
slots and over many (``SUM_BLOCK_BYTES`` cut down), in fp32 and bf16."""

import numpy as np
import pytest
import torch

from repro_torch.core import collectives as cl

H, C, SLOTS = 8, 6, 20


def _index(width: int, rng) -> torch.Tensor:
    """[R, C] slots: each group holds a slot at most once and a slot is
    held by at most ``width`` groups; about a quarter of the rows -1."""
    if width == 1:
        perm = rng.permutation(SLOTS)[:3 * C].reshape(3, C)
    else:
        perm = np.stack([rng.permutation(SLOTS)[:C] for _ in range(width)])
    perm = np.where(rng.random(perm.shape) < 0.25, -1, perm)
    return torch.from_numpy(perm.astype(np.int32))


def _grads(fn, index, rows, weight):
    leaf = rows.clone().requires_grad_(True)
    out = fn(index, leaf, SLOTS, max(1, index.shape[0]))
    (out * weight).sum().backward()
    return out.detach(), leaf.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", ["one", "many"])
@pytest.mark.parametrize("width", [1, 3])
def test_backward_equals_autograd_of_the_plain_sum(width, blocks, dtype,
                                                   monkeypatch):
    if blocks == "many":        # 3 slots a block
        monkeypatch.setattr(cl, "SUM_BLOCK_BYTES",
                            3 * H * torch.finfo(dtype).bits // 8)
    rng = np.random.default_rng(width)
    index = _index(width, rng)
    rows = torch.from_numpy(rng.normal(size=(index.numel(), H)).astype(
        np.float32)).to(dtype).reshape(*index.shape, H)
    weight = torch.from_numpy(rng.normal(size=(SLOTS, H)).astype(np.float32))

    def plain(index, rows, num_slots, w):
        return cl._sum_rows_plain(index, rows, num_slots, w if width > 1
                                  else 1)

    def new(index, rows, num_slots, w):
        return cl._sum_rows_into(index, rows, num_slots, w if width > 1
                                 else 1)
    want_out, want = _grads(plain, index, rows, weight)
    got_out, got = _grads(new, index, rows, weight)
    assert torch.equal(got_out, want_out)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    # a row that lands in no slot gets no gradient
    assert not got[index < 0].any()


def test_backward_is_one_gather(monkeypatch):
    """The plain sum gathers once per block and column; the backward
    gathers once in all."""
    monkeypatch.setattr(cl, "SUM_BLOCK_BYTES", 3 * H * 4)
    rng = np.random.default_rng(0)
    index = _index(3, rng)
    rows = torch.randn(*index.shape, H, requires_grad=True)
    out = cl._sum_rows_into(index, rows, SLOTS, 3)
    calls = []
    gather = cl.gather_rows
    monkeypatch.setattr(cl, "gather_rows",
                        lambda *a: calls.append(1) or gather(*a))
    out.sum().backward()
    assert len(calls) == 1
    assert rows.grad.shape == rows.shape
