"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips when there is no CUDA device (there is no
CPU mode for a CUDA kernel).  This file imports neither JAX nor the
reference package, so it runs where only the port is installed:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_plain


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_kernel_matches_plain_on_card(dtype):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, d, c = 1000, 256, 31, 40
    tokens = torch.randn((n, h), generator=gen, device="cuda").to(dtype)
    bitmap = torch.randint(0, 1 << d, (n,), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
    valid = torch.rand(n, generator=gen, device="cuda") > 0.25
    got_t, got_i = ops.dispatch_pack(tokens, bitmap, valid, num_dests=d,
                                     capacity=c)
    exp_t, exp_i = tref.pack_ref(tokens, bitmap, valid, d, c)
    assert torch.equal(got_i, exp_i)
    assert torch.equal(got_t, exp_t)


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 32, None), (False, None, 30.0)])
def test_attention_kernel_matches_plain_on_card(causal, window, softcap):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((2, 8, 200, 128), generator=gen, device="cuda")
    k = torch.randn((2, 2, 200, 128), generator=gen, device="cuda")
    v = torch.randn((2, 2, 200, 128), generator=gen, device="cuda")
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(q, k, v, **kw).float()
    exp = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got, exp, atol=2e-2, rtol=2e-2)
