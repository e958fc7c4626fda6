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


@pytest.mark.gpu
def test_attention_kernel_at_head_dim_112_on_card():
    """Zamba2's shared block: 32 heads of 112."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((2, 4, 150, 112), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    got = ops.flash_attention(q, k, v).float()
    exp = flash_attention_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(got, exp, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("groups", ["per-head", "shared"])
def test_mamba2_kernel_matches_plain_on_card(groups):
    _need_cuda()
    from repro_torch.kernels.mamba2_scan import expand_groups
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch, heads, s = 2, 3, 100                    # 2 chunks, ragged
    rows = batch * heads
    g = rows if groups == "per-head" else batch

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = rn(rows, s, 64).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(rn(rows, s) - 1.0)
    a = -torch.exp(rn(rows) * 0.5)
    d = rn(rows)
    b, c = (rn(g, s, 64).to(torch.bfloat16) for _ in range(2))
    y, h = ops.mamba2_scan(x, dt, a, b, c, d)
    ey, eh = tref.mamba2_ref(x.float(), dt, a,
                             expand_groups(b, rows).float(),
                             expand_groups(c, rows).float(), d,
                             return_final=True)
    torch.testing.assert_close(y.float(), ey, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(h, eh, atol=5e-2, rtol=5e-2)


@pytest.mark.gpu
def test_rwkv6_kernel_matches_plain_on_card():
    """Decays fast enough that one chunk's log-decays sum far below fp32's
    exp range (the factorised form would overflow)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    rows, s = 6, 100
    r, k, v = (rn(rows, s, 64).to(torch.bfloat16) for _ in range(3))
    logw = -torch.exp(rn(rows, s, 64) * 1.5)
    u = rn(rows, 64) * 0.3
    y, state = ops.rwkv6_scan(r, k, v, logw, u)
    ey, es = tref.rwkv6_ref(r.float(), k.float(), v.float(), logw, u,
                            return_final=True)
    assert logw[:, :32].sum(1).min() < -89.0
    torch.testing.assert_close(y.float(), ey, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(state, es, atol=5e-2, rtol=5e-2)
