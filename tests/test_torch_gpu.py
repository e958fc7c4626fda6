"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips when there is no CUDA device (there is no
CPU mode for a CUDA kernel).  This file imports neither JAX nor the
reference package, so it runs where only the port is installed:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
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
@pytest.mark.parametrize("n,h,d,c", [
    (1, 64, 3, 4),          # one row
    (50, 128, 2, 200),      # more slots than kept rows: an empty tail
    (3000, 64, 7, 1),       # one slot, many candidates
    (2049, 64, 1, 2049),    # N past the 2,048-row rank step
    (1500, 256, 9, 700),    # N not a multiple of it
])
def test_pack_kernel_at_edges_on_card(n, h, d, c):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randn((n, h), generator=gen, device="cuda").to(
        torch.bfloat16)
    bitmap = torch.randint(0, 1 << d, (n,), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
    valid = torch.rand(n, generator=gen, device="cuda") > 0.25
    got_t, got_i = ops.dispatch_pack(tokens, bitmap, valid, num_dests=d,
                                     capacity=c)
    exp_t, exp_i = tref.pack_ref(tokens, bitmap, valid, d, c)
    assert torch.equal(got_i, exp_i)
    assert torch.equal(got_t.view(torch.int16), exp_t.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,c,blocks,filled", [
    (512, 2, 640, 1, 512),      # stage 1: 512 tokens a rank to 2 pods
    (1280, 2, 1600, 2, 490),    # stage 2: rows from 2 pods, with holes
    (3200, 4, 640, 2, 720),     # stage 3: rows from 2 relays, 4 experts
])
def test_pack_kernel_at_two_by_two_rank_stages_on_card(n, d, c, blocks,
                                                       filled):
    """The packs of one DBRX prefill MoE layer at 2 pods x 2 ep ranks
    (capacity factor 1.25): the stage-2 and stage-3 inputs come off a
    transport, each received block filled to its sender's count."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(n)
    tokens = torch.randn((n, 6144), generator=gen, device="cuda").to(
        torch.bfloat16)
    bitmap = torch.randint(1, 1 << d, (n,), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
    valid = torch.arange(n, device="cuda") % (n // blocks) < filled
    got_t, got_i = ops.dispatch_pack(tokens, bitmap, valid, num_dests=d,
                                     capacity=c)
    exp_t, exp_i = tref.pack_ref(tokens, bitmap, valid, d, c)
    assert torch.equal(got_i, exp_i)
    assert torch.equal(got_t.view(torch.int16), exp_t.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,c,blocks,filled", [
    (512, 2, 1024, 1, 512),       # stage 1: 512 tokens a rank to 2 pods
    (2048, 8, 2048, 2, 510),      # stage 2: rows from 2 pods to 8 ep ranks
    (16384, 24, 341, 8, 410),     # stage 3: rows from 8 relays, 24 experts
    (6400, 24, 213, 8, 410),      # stage 3 at capacity factor 1.25
])
def test_pack_kernel_at_kimi_rank_stages_on_card(n, d, c, blocks, filled):
    """The packs of one Kimi-K2 prefill MoE layer at 2 pods x 8 ep ranks
    (d_model 7168, capacity factor 2, and stage 3 at 1.25): rows off a
    transport, each received block filled to its sender's count."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(n)
    tokens = torch.randn((n, 7168), generator=gen, device="cuda").to(
        torch.bfloat16)
    bitmap = torch.randint(1, 1 << d, (n,), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
    valid = torch.arange(n, device="cuda") % (n // blocks) < filled
    got_t, got_i = ops.dispatch_pack(tokens, bitmap, valid, num_dests=d,
                                     capacity=c)
    exp_t, exp_i = tref.pack_ref(tokens, bitmap, valid, d, c)
    assert torch.equal(got_i, exp_i)
    assert torch.equal(got_t.view(torch.int16), exp_t.view(torch.int16))


@pytest.mark.gpu
def test_attention_kernel_at_kimi_rank_shape_on_card():
    """A Kimi-K2 rank's prefill: 64 q heads over 8 kv heads of 112, 512
    tokens, in the main path's [B, S, heads, D] layout."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((1, 512, 64, 112), generator=gen, device="cuda")
    k = torch.randn((1, 512, 8, 112), generator=gen, device="cuda")
    v = torch.randn((1, 512, 8, 112), generator=gen, device="cuda")
    q, k, v = (x.to(torch.bfloat16).transpose(1, 2) for x in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=True).float()
    exp = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    torch.testing.assert_close(got, exp, atol=2e-2, rtol=2e-2)


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
@pytest.mark.parametrize("sq,sk,causal,window", [
    (300, 300, True, 32),        # Gemma2's local layers, reduced window
    (300, 300, True, None),      # its global layers
    (1, 1, True, None),          # one q row
    (200, 200, True, None),      # q length off the 128-row and 64-row tiles
    (150, 150, True, 20),        # a window smaller than one kv tile
    (77, 333, False, None),      # cross lengths
])
def test_attention_kernel_at_head_dim_256_on_card(sq, sk, causal, window):
    """Gemma2's head_dim 256 (64-row kv tiles): 16 q heads over 8 kv
    heads, softcap 50, in the main path's [B, S, heads, D] layout."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((2, sq, 16, 256), generator=gen, device="cuda")
    k = torch.randn((2, sk, 8, 256), generator=gen, device="cuda")
    v = torch.randn((2, sk, 8, 256), generator=gen, device="cuda")
    q, k, v = (x.to(torch.bfloat16).transpose(1, 2) for x in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=50.0)
    got = ops.flash_attention(q, k, v, **kw).float()
    exp = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got, exp, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 112, 128, 256])
@pytest.mark.parametrize("window,softcap,q_scale", [
    (None, 50.0, 10.0),          # scores several times Gemma2's cap
    (20, 3.0, 1.0),              # a cap near the scores' own size, windowed
])
def test_attention_kernel_where_the_softcap_bites_on_card(d, window, softcap,
                                                          q_scale):
    """The softcap where it changes the output: the plain version without
    it lies outside the tolerance, so a kernel that dropped or misplaced
    the cap would fail; the kernel lies within it."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((2, 200, 8, d), generator=gen, device="cuda") * q_scale
    k = torch.randn((2, 200, 2, d), generator=gen, device="cuda")
    v = torch.randn((2, 200, 2, d), generator=gen, device="cuda")
    q, k, v = (x.to(torch.bfloat16).transpose(1, 2) for x in (q, k, v))
    kw = dict(causal=True, window=window, softcap=softcap)
    exp = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    uncapped = flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=True, window=window)
    assert not torch.allclose(uncapped, exp, atol=2e-2, rtol=2e-2)
    got = ops.flash_attention(q, k, v, **kw).float()
    torch.testing.assert_close(got, exp, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window,q_scale", [
    (True, 64, 10.0),       # Gemma2's windowed layer, the softcap biting
    (True, None, 1.0),      # its global layer
    (False, None, 1.0),     # no mask
])
def test_attention_gradient_at_head_dim_256_on_card(causal, window,
                                                    q_scale):
    """A gradient at head_dim 256 (softcap 50) through the wrapper: one
    forward and one backward kernel launch, nothing plain in their place,
    and dq, dk, dv within atol = rtol = 2e-2 of autograd of the plain
    forward in fp32; with q x 10, where the cap bites and dK grows with q
    (to about 30), of the plain backward with P and dS rounded to bf16
    where the kernel rounds them (bf16's rounding of dS alone moves dK by
    more than 2e-2 there); and a second call bit-identical, the windowed
    shape included."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = (torch.randn((2, 200, 4, 256), generator=gen, device="cuda")
         * q_scale).to(torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((2, 200, 2, 256), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    do = torch.randn((2, 4, 200, 256), generator=gen, device="cuda").to(
        torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=50.0)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ops.reset_launches()
    got = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves, do)
    counts = ops.launches()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    # a second call gives the same bits (no atomics, fixed sum orders)
    again = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves,
                                do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if q_scale > 1.0:
        from repro_torch.kernels.flash_attention import _forward
        out, _ = _forward(q, k, v, (causal, window, 50.0, None),
                          with_lse=False)
        exp = [x.float() for x in tref.attention_bwd_ref(
            q, k, v, out, do, tref.attention_lse(q, k, **kw), **kw,
            operands=torch.bfloat16)]
    else:
        ref_leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
        exp = torch.autograd.grad(flash_attention_plain(*ref_leaves, **kw),
                                  ref_leaves, do.float())
    for a, e in zip(got, exp):
        torch.testing.assert_close(a.float(), e, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,g,sq,sk,d,causal", [
    (8, 2, 300, 300, 112, True),     # ragged last q and kv tiles
    (4, 1, 77, 333, 112, False),     # one kv head for every q head
    (4, 4, 129, 257, 64, False),     # one row / one key past a tile
    (4, 2, 1, 1, 128, True),         # a single query and key
    (16, 16, 512, 512, 64, False),   # SeamlessM4T's encoder, its cross
    (16, 16, 512, 512, 64, True),    # SeamlessM4T's decoder prefill
    (16, 16, 1, 544, 64, False),     # a SeamlessM4T decode step's cross
    (4, 2, 1, 77, 64, False),        # one q row under a 128-row tile
])
def test_attention_kernel_at_tile_edges_on_card(hq, g, sq, sk, d, causal):
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((2, sq, hq, d), generator=gen, device="cuda")
    k = torch.randn((2, sk, g, d), generator=gen, device="cuda")
    v = torch.randn((2, sk, g, d), generator=gen, device="cuda")
    q, k, v = (x.to(torch.bfloat16).transpose(1, 2) for x in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=causal).float()
    exp = flash_attention_plain(q.float(), k.float(), v.float(),
                                causal=causal)
    torch.testing.assert_close(got, exp, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_attention_kernel_replayed_from_a_cuda_graph_on_card():
    """One query row against 544 keys (a SeamlessM4T decode step's
    cross-attention) captured in a CUDA graph: the tensor maps are encoded
    at capture, so a replay on new values in the same buffers must give
    the plain version's output on those values.  (The capture's count is
    taken back, as ``runtime/graphs.py`` does.)"""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(9)

    def fill(*xs):
        for x in xs:
            x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
    q = torch.empty((4, 1, 16, 64), dtype=torch.bfloat16,
                    device="cuda").transpose(1, 2)
    k = torch.empty((4, 544, 16, 64), dtype=torch.bfloat16,
                    device="cuda").transpose(1, 2)
    v = torch.empty_like(k)
    fill(q, k, v)
    ops.flash_attention(q, k, v, causal=False)          # warm-up
    launches = ops.flash_attention.launches
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.current_stream().wait_stream(side)
    ops.flash_attention.launches = launches
    for _ in range(2):
        fill(q, k, v)
        graph.replay()
        exp = flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=False)
        torch.testing.assert_close(out.float(), exp, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("groups,heads,s", [
    ("per-head", 3, 100), ("shared", 3, 100),   # 2 chunks, ragged
    ("shared", 4, 1), ("shared", 4, 63), ("per-head", 3, 65),
])
def test_mamba2_kernel_matches_plain_on_card(groups, heads, s):
    _need_cuda()
    from repro_torch.kernels.mamba2_scan import expand_groups
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = 2
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


@pytest.mark.gpu
@pytest.mark.parametrize("s,decay", [
    (1, True), (15, True), (17, True), (63, True), (65, True),
    (130, False),           # logw = 0: no decay
])
def test_rwkv6_kernel_at_chunk_edges_on_card(s, decay):
    """Edges of the kernel's 64-step chunk and 16-step sub-chunks."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    rows = 8
    r, k, v = (rn(rows, s, 64).to(torch.bfloat16) for _ in range(3))
    logw = -torch.exp(rn(rows, s, 64) - 0.5) if decay else torch.zeros(
        (rows, s, 64), device="cuda")
    u = rn(rows, 64) * 0.3
    y, state = ops.rwkv6_scan(r, k, v, logw, u)
    ey, es = tref.rwkv6_ref(r.float(), k.float(), v.float(), logw, u,
                            return_final=True)
    torch.testing.assert_close(y.float(), ey, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(state, es, atol=5e-2, rtol=5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [2, 4])
def test_moe_pipeline_on_its_own_stream_matches_serial_on_card(g):
    """``moe_ffn`` at G chunks on the card (one rank; each chunk's dispatch
    on the layer's own stream) against G = 1 and the CPU plain version, in
    fp32 without TF32: the same rows, in the same order.  The aux is the
    mean of the chunks' auxes, so it is held to the CPU's at the same G.
    The layer's stream is made once and reused."""
    _need_cuda()
    import types

    from repro_torch.models import moe as M
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.parallel.mesh import RankMesh
    cfg = types.SimpleNamespace(num_experts=8, top_k=2, act="silu",
                                moe_capacity=4.0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    layer = M.init_moe(64, 128, 8, generator=gen, device="cuda",
                       dtype=torch.float32)
    x = torch.randn((2, 256, 64), generator=gen, device="cuda")
    mesh = RankMesh((1, 1, 1))
    outs = {}
    for chunks in (1, g):
        pctx = ParallelContext(mesh, moe_microbatch=chunks)
        assert M.pipeline_config(pctx, cfg, 512, 64, 128, 4)[
            "microbatch"] == chunks
        y, aux = M.moe_ffn(layer, x, cfg, pctx)
        outs[chunks] = (y, aux)
    stream = layer.dispatch_stream()
    assert stream is layer.dispatch_stream()
    assert stream != torch.cuda.current_stream()
    torch.cuda.synchronize()
    (y1, a1), (yg, ag) = outs[1], outs[g]
    assert torch.isfinite(yg).all()
    torch.testing.assert_close(yg, y1, atol=1e-5, rtol=1e-5)
    cpu = M.MoE(64, 128, 8, device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    yc, ac = M.moe_ffn(cpu, x.cpu(), cfg, ParallelContext(
        mesh, moe_microbatch=g))
    torch.testing.assert_close(yg.cpu(), yc, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ag.cpu(), ac, atol=1e-5, rtol=1e-5)
    assert torch.isfinite(a1)


# ---------------------------------------------------------------------------
# decode as a CUDA graph (runtime/graphs.py)
# ---------------------------------------------------------------------------

GRAPH_NEW = 6           # new tokens: one eager round, a capture, 3 more


# small configs at the kernels' widths (head_dim 128 / 112, scan heads of
# 64), as chip_smoke.py's phase 4 sizes them
SMALL = {
    "dbrx_132b": dict(d_model=512, n_heads=4, n_kv_heads=2, d_ff=256,
                      vocab=1024, num_experts=8, top_k=2),
    "zamba2_7b": dict(n_layers=4, d_model=448, n_heads=4, n_kv_heads=4,
                      d_ff=512, vocab=1024, ssm_state=64, ssm_head_dim=64,
                      shared_attn_every=2),
    "rwkv6_7b": dict(n_layers=2, d_model=512, d_ff=1024, vocab=1024,
                     rwkv_head_dim=64, rwkv_decay_lora=64),
    "gemma2_9b": dict(d_model=512, n_heads=2, d_head=256, d_ff=256,
                      vocab=1024),
    "qwen2_vl_2b": dict(d_model=512, n_heads=4, n_kv_heads=2, d_ff=256,
                        vocab=1024),
    "seamless_m4t_medium": dict(d_model=512, n_heads=8, n_kv_heads=8,
                                d_ff=256, vocab=1024),
}


def _graph_engine(arch):
    """A small model of ``arch`` in bf16 on the card, in an engine."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import build_engine
    cfg = get_config(arch).reduced(**SMALL[arch])
    return build_engine(cfg, device="cuda", dtype=torch.bfloat16, seed=0,
                        max_new=GRAPH_NEW)


def _eager_tokens(engine, prompts):
    """Greedy tokens and logits of the model's own prefill and decode on a
    fresh cache (no engine, no graph)."""
    from repro_torch.data.pipeline import batch_for_model
    model, params = engine.model, engine.params
    logits_kept, toks = [], []
    batch = batch_for_model(model.cfg, {"tokens": prompts}, device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(len(prompts), prompts.shape[1] + GRAPH_NEW)
        logits, _ = model.prefill(params, batch, cache)
        for step in range(GRAPH_NEW):
            if step:
                logits, _ = model.decode(params, model.decode_batch(tok),
                                         cache)
            tok = torch.argmax(logits, dim=-1)
            logits_kept.append(logits.float().cpu())
            toks.append(tok.cpu())
    return torch.stack(toks, dim=1).numpy(), logits_kept


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dbrx_132b", "zamba2_7b", "rwkv6_7b",
                                  "gemma2_9b", "qwen2_vl_2b",
                                  "seamless_m4t_medium"])
def test_decode_graph_equals_eager_on_card(arch):
    """Graph decode gives the eager loop's greedy tokens; the logits' gap
    is printed (a replay runs the captured kernels on the same inputs).
    Qwen2-VL's decode input is the stub embedding of each sampled token,
    copied into the graph's static buffer every round; SeamlessM4T's
    graph holds the cross-attention kernel at one query row over the
    cache's ``enc_out``."""
    _need_cuda()
    import numpy as np

    from repro_torch.launch.serve import make_prompts
    engine = _graph_engine(arch)
    prompts = make_prompts(engine.model.cfg, 4, 16, seed=1)
    kept = []
    sample = engine._sample
    engine._sample = lambda state: (kept.append(state.logits.float().cpu()),
                                    sample(state))[1]
    out = engine.generate(prompts)
    g = engine.stats["decode_graph"]
    assert (g["mode"], g["captures"], g["replays"], g["eager_rounds"]) == \
        ("graph", 1, GRAPH_NEW - 2, 1)
    tokens, logits = _eager_tokens(engine, prompts)
    gap = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(kept, logits))
    print(f"{arch}: graph vs eager logits gap {gap:.3e} of max |logit|")
    np.testing.assert_array_equal(out, tokens)
    assert gap <= 1e-2


@pytest.mark.gpu
def test_second_cohort_of_a_shape_replays_on_card():
    _need_cuda()
    import numpy as np

    from repro_torch.launch.serve import make_prompts
    engine = _graph_engine("zamba2_7b")
    prompts = make_prompts(engine.model.cfg, 4, 16, seed=2)
    first = engine.generate(prompts)
    g = engine.stats["decode_graph"]
    before = dict(g)
    np.testing.assert_array_equal(engine.generate(prompts), first)
    assert g["captures"] == before["captures"] == 1
    assert g["replays"] - before["replays"] == GRAPH_NEW - 1
    assert g["eager_rounds"] == before["eager_rounds"]
    # another shape is a slot, and a capture, of its own
    engine.generate(prompts[:2])
    assert g["captures"] == 2


@pytest.mark.gpu
def test_graph_launch_counts_are_exact_on_card():
    """The dispatch pack's launches of a graphed generate: three a MoE
    layer in every forward, replays included, the capture not."""
    _need_cuda()
    from repro_torch.launch.serve import make_prompts
    engine = _graph_engine("dbrx_132b")
    cfg = engine.model.cfg
    prompts = make_prompts(cfg, 4, 16, seed=3)
    for _ in range(2):                  # a capture, then replays only
        ops.reset_launches()
        engine.generate(prompts)
        assert ops.launches() == {
            "dispatch_pack": 3 * cfg.n_layers * GRAPH_NEW,
            "flash_attention": cfg.n_layers, "mamba2_scan": 0,
            "rwkv6_scan": 0, "dispatch_pack_bwd": 0,
            "flash_attention_bwd": 0, "mamba2_scan_bwd": 0,
            "rwkv6_scan_bwd": 0}
    assert engine.stats["decode_graph"]["captures"] == 1


@pytest.mark.gpu
def test_failed_capture_raises_on_card():
    """A step that cannot be captured (here: it reads a device value on
    the host) fails the round that captures it; nothing decodes on
    eagerly in its place."""
    _need_cuda()
    from repro_torch.launch.serve import make_prompts
    engine = _graph_engine("dbrx_132b")
    step = engine.model.decode_step

    def syncing_step(params, batch, cache):
        int(cache["pos"])                   # a host read of the device
        return step(params, batch, cache)
    engine.model.decode_step = syncing_step
    prompts = make_prompts(engine.model.cfg, 2, 16, seed=4)
    with pytest.raises(RuntimeError):
        engine.generate(prompts)
    g = engine.stats["decode_graph"]
    assert (g["eager_rounds"], g["captures"], g["replays"]) == (1, 0, 0)


# ---------------------------------------------------------------------------
# the backward kernels (training)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n,h,d,c,dtype", [
    (2048, 6144, 1, 2560, torch.bfloat16),    # DBRX prefill, stage 1
    (3200, 6144, 16, 640, torch.bfloat16),    # stage 3: rows in 4 slots
    (1024, 256, 31, 40, torch.float32),       # 31 destinations, overflow
    (300, 6, 5, 70, torch.bfloat16),          # rows not 16-byte wide
    (1, 64, 3, 4, torch.bfloat16),            # one row
    (50, 128, 2, 200, torch.bfloat16),        # empty slots
])
def test_pack_backward_kernel_on_card(n, h, d, c, dtype):
    """The pack's backward kernel: bit-exact against its plain version
    (the same fp32 sums in the same order), and within 2e-2 of autograd of
    the plain pack in fp32; invalid rows get zeros."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(n + d)
    tokens = torch.randn((n, h), generator=gen, device="cuda").to(dtype)
    bitmap = torch.randint(0, 1 << d, (n,), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
    valid = torch.rand(n, generator=gen, device="cuda") > 0.25
    _, idx = ops.dispatch_pack(tokens, bitmap, valid, num_dests=d,
                               capacity=c)
    grad = torch.randn((d, c, h), generator=gen, device="cuda").to(dtype)
    got = ops.dispatch_pack_bwd(grad, idx, n)
    exp = tref.pack_bwd_ref(grad, idx, n)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(ints), exp.view(ints))
    leaf = tokens.float().requires_grad_(True)
    auto, = torch.autograd.grad(tref.pack_ref(leaf, bitmap, valid, d, c)[0],
                                leaf, grad.float())
    torch.testing.assert_close(got.float(), auto, atol=2e-2, rtol=2e-2)
    assert not got[~valid].any()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,window,softcap", [
    ((4, 48, 8, 512, 512, 128), True, None, None),     # DBRX prefill
    ((2, 4, 2, 100, 100, 128), True, 32, None),         # a window
    ((2, 4, 2, 64, 64, 64), True, None, 30.0),          # softcap, dh 64
    ((2, 8, 2, 300, 300, 112), True, None, None),       # dh 112, ragged
    ((1, 4, 2, 96, 160, 128), True, 48, 20.0),          # every mask
    ((2, 4, 1, 77, 133, 112), False, None, None),       # cross, one kv head
    ((1, 2, 2, 64, 64, 64), True, None, None),          # one q tile
    ((4, 16, 16, 512, 512, 64), False, None, None),     # Seamless encoder
    ((4, 16, 16, 512, 512, 64), True, None, None),      # Seamless decoder
    ((2, 16, 16, 300, 200, 64), False, None, None),     # cross lengths, MHA
    ((1, 48, 8, 4096, 4096, 128), True, None, None),    # DBRX at train_4k
    ((1, 4, 2, 200, 200, 256), True, 64, 50.0),         # Gemma2, windowed
    ((2, 16, 8, 300, 300, 256), True, None, 50.0),      # Gemma2, global
    ((1, 2, 1, 77, 130, 256), False, None, None),       # dh 256, no mask
])
def test_attention_backward_kernel_on_card(shape, causal, window, softcap):
    """The attention backward kernel from the forward's own log-sum-exp:
    dq, dk, dv within atol = rtol = 2e-2 of autograd of the plain forward
    in fp32, and of the plain backward; the forward's log-sum-exp within
    1e-3 of the plain one; a second call gives the same bits."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import _forward
    b, hq, g, sq, t, d = shape
    gen = torch.Generator(device="cuda").manual_seed(sq + t)

    def rand(*size):
        return torch.randn(size, generator=gen, device="cuda").to(
            torch.bfloat16)
    q = rand(b, sq, hq, d).transpose(1, 2)
    k = rand(b, t, g, d).transpose(1, 2)
    v = rand(b, t, g, d).transpose(1, 2)
    do = rand(b, sq, hq, d).transpose(1, 2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = _forward(q, k, v, (causal, window, softcap, None),
                        with_lse=True)
    lse_ref = tref.attention_lse(q, k, **kw)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-4)
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
    auto = torch.autograd.grad(flash_attention_plain(*leaves, **kw), leaves,
                               do.float())
    plain = tref.attention_bwd_ref(q, k, v, out, do, lse_ref, **kw)
    for a, e, p in zip(got, auto, plain):
        assert a.shape == e.shape and a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), e, atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(a.float(), p.float(), atol=2e-2,
                                   rtol=2e-2)


def _live_blocks(heads, kv_heads, q_len, kv_len, causal, window):
    """(q head, q step, kv tile) of every 64 x 64 block of one batch row's
    scores with at least one element inside the mask."""
    r = np.arange(q_len)[:, None]
    c = np.arange(kv_len)[None, :]
    ok = np.ones((q_len, kv_len), bool)
    if causal:
        ok &= c <= r
    if window:
        ok &= r - c < window
    return {(hq, st, ti) for hq in range(heads)
            for st in range(-(-q_len // 64)) for ti in range(-(-kv_len // 64))
            if ok[64 * st:64 * st + 64, 64 * ti:64 * ti + 64].any()}


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,window", [
    ((4, 48, 8, 512, 512), True, None),     # DBRX's prefill
    ((1, 48, 8, 4096, 4096), True, None),   # DBRX's heads at train_4k
    ((2, 4, 2, 100, 100), True, 32),
    ((2, 8, 2, 300, 300), True, None),      # an odd number of kv tiles
    ((1, 4, 2, 96, 160), True, 48),
    ((2, 4, 1, 77, 133), False, None),      # cross, one kv head
    ((1, 6, 2, 200, 130), True, None),      # causal, kv shorter than q
    ((1, 3, 3, 70, 300), True, None),       # kv tiles no q row attends
])
def test_attention_backward_dkdv_record_on_card(shape, causal, window):
    """The dK/dV blocks as they ran: their warpgroups walked as many q
    steps as there are 64 x 64 blocks of scores inside the mask, each
    recorded the cycles it took, the gradients are those of a call without
    the record, and at DBRX's heads the heaviest warpgroup walked at most
    1.25 x the mean q steps."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import _forward, dkdv_blocks
    b, hq, g, sq, t = shape
    gen = torch.Generator(device="cuda").manual_seed(sq + t)

    def rand(*size):
        return torch.randn(size, generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
    q, k, v, do = (rand(b, n, h, 128) for n, h in
                   ((sq, hq), (t, g), (t, g), (sq, hq)))
    kw = dict(causal=causal, window=window)
    out, lse = _forward(q, k, v, (causal, window, None, None), with_lse=True)
    record = torch.zeros((dkdv_blocks(b, g, t, causal=causal), 2, 2),
                         dtype=torch.int64, device="cuda")
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, record=record, **kw)
    plain = ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, plain))
    steps, cycles = record[..., 0].cpu(), record[..., 1].cpu()
    assert steps.sum().item() == b * len(_live_blocks(hq, g, sq, t, causal,
                                                      window))
    assert (cycles > 0).all()
    if (hq, g) == (48, 8):
        assert steps.max().item() <= 1.25 * steps.float().mean().item()


@pytest.mark.gpu
def test_attention_gradient_through_the_wrapper_on_card():
    """``ops.flash_attention`` under autograd runs the forward kernel with
    its log-sum-exp and the backward kernel, once each."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
        for s in ((2, 8, 128, 64), (2, 2, 128, 64), (2, 2, 128, 64)))
    ops.reset_launches()
    ops.flash_attention(q, k, v).sum().backward()
    counts = ops.launches()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in (q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("scan,s,final", [
    ("mamba2", 512, False),     # Zamba2's sequences, one B/C group each
    ("mamba2", 130, True),      # a ragged chunk, a final-state gradient
    ("mamba2-odd", 200, True),  # 3 heads a group: a block a head
    ("rwkv6", 512, False),
    ("rwkv6", 100, True),
    ("rwkv6-wide", 100, True),  # 265 rows: past one wave of 2 blocks an SM
])
def test_scan_backward_kernels_match_plain_on_card(scan, s, final):
    """The scans' backward kernels against autograd of the fp32 per-step
    recurrences: every gradient within 5e-2 of its max |value|; two calls
    give the same bits.  Mamba2 with 8 heads a B/C group (the kernel's
    blocks of two heads) and with 3 (``mamba2-odd``: blocks of one);
    RWKV-6 at 8 rows and at 265 (``rwkv6-wide``: an odd count past the
    264 blocks two an SM hold at once on an H100)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(s)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    bf16 = torch.bfloat16
    kind = scan.split("-")[0]
    if kind == "mamba2":
        from repro_torch.kernels.mamba2_scan import expand_groups, sum_groups
        batch, heads = 2, 3 if scan == "mamba2-odd" else 8
        rows = batch * heads
        x = rn(rows, s, 64).to(bf16)
        dt = torch.nn.functional.softplus(rn(rows, s) - 1.0)
        a, d = -torch.exp(rn(rows) * 0.5), rn(rows)
        b, c = (rn(batch, s, 64).to(bf16) for _ in range(2))
        args = (x, dt, a, b, c, d)
        dy = rn(rows, s, 64).to(bf16)
        dfinal = rn(rows, 64, 64) if final else None
        call = ops.mamba2_scan_bwd
        exp = list(tref.grads_of(
            lambda *t: tref.mamba2_ref(*t, return_final=True),
            (x, dt, a, expand_groups(b, rows), expand_groups(c, rows), d),
            dy, dfinal))
        exp[3], exp[4] = sum_groups(exp[3], batch), sum_groups(exp[4], batch)
    else:
        rows = 265 if scan == "rwkv6-wide" else 8
        r, k, v = (rn(rows, s, 64).to(bf16) for _ in range(3))
        logw = -torch.exp(rn(rows, s, 64) - 1.0)
        u = rn(rows, 64) * 0.3
        args = (r, k, v, logw, u)
        dy = rn(rows, s, 64).to(bf16)
        dfinal = rn(rows, 64, 64) if final else None
        call = ops.rwkv6_scan_bwd
        exp = tref.grads_of(lambda *t: tref.rwkv6_ref(*t, return_final=True),
                            args, dy, dfinal)
    ops.reset_launches()
    got = call(*args, dy, dfinal)
    again = call(*args, dy, dfinal)
    assert ops.launches()[f"{kind}_scan_bwd"] == 2
    assert all(torch.equal(g_, a_) for g_, a_ in zip(got, again))
    for g_, e, t in zip(got, exp, args):
        assert g_.shape == t.shape and g_.dtype == t.dtype
        assert torch.isfinite(g_).all()
        err = (g_.float() - e).abs().max().item()
        assert err <= 5e-2 * e.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_7b"])
def test_recurrent_training_on_card(arch, monkeypatch):
    """The hybrid and rwkv families' loss and backward on the card: each
    layer's scan forward and backward kernel once (and the shared block's
    attention kernels), nothing plain in their place; and every
    parameter's gradient at a cosine above 0.999 of the same step whose
    scan backward is autograd of the fp32 per-step recurrence instead (the
    same forward, bit for bit, so the comparison sees the backward kernel
    and not the model's bf16 rounding, which moves a random-weight
    Zamba2's gradients far more)."""
    _need_cuda()
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import mamba2_scan as m2, rwkv6_scan as r6
    from repro_torch.models.api import build_model
    from repro_torch.models.ssm import n_shared_calls
    from repro_torch.runtime.trainer import trainable
    cfg = get_config(arch).reduced(
        n_layers=2, d_model=256, vocab=512,
        **({"ssm_state": 64, "ssm_head_dim": 64, "n_heads": 2,
            "n_kv_heads": 2, "shared_attn_every": 1}
           if arch == "zamba2_7b" else {"rwkv_head_dim": 64}))
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    trainable(params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 70)).astype(np.int32)).cuda()

    def grads():
        for p in params.parameters():
            p.grad = None
        loss, _ = model.loss(params, {"tokens": toks, "labels": toks})
        loss.backward()
        return {n: p.grad.double() for n, p in params.named_parameters()}

    ops.reset_launches()
    got = grads()
    counts = {k: v for k, v in ops.launches().items() if v}
    if arch == "zamba2_7b":
        calls = n_shared_calls(cfg)
        want = {"mamba2_scan": cfg.n_layers,
                "mamba2_scan_bwd": cfg.n_layers,
                "flash_attention": calls, "flash_attention_bwd": calls}
    else:
        want = {"rwkv6_scan": cfg.n_layers, "rwkv6_scan_bwd": cfg.n_layers}
    assert counts == want

    def plain_mamba2(x, dt, a, b, c, d, dy, dh=None):
        rows, g = x.shape[0], b.shape[0]
        out = list(tref.grads_of(
            lambda *t: tref.mamba2_ref(*t, return_final=True),
            (x, dt, a, m2.expand_groups(b, rows), m2.expand_groups(c, rows),
             d), dy, dh))
        out[3], out[4] = m2.sum_groups(out[3], g), m2.sum_groups(out[4], g)
        return tuple(o.to(t.dtype) for o, t in zip(out, (x, dt, a, b, c, d)))

    def plain_rwkv6(r, k, v, logw, u, dy, dstate=None):
        out = tref.grads_of(lambda *t: tref.rwkv6_ref(*t, return_final=True),
                            (r, k, v, logw, u), dy, dstate)
        return tuple(o.to(t.dtype) for o, t in zip(out, (r, k, v, logw, u)))
    if arch == "zamba2_7b":
        monkeypatch.setattr(m2, "mamba2_scan_bwd", plain_mamba2)
    else:
        monkeypatch.setattr(r6, "rwkv6_scan_bwd", plain_rwkv6)
    exp = grads()
    for name, a in got.items():
        e = exp[name]
        assert torch.isfinite(a).all(), name
        cos = (a.flatten() @ e.flatten() / (a.norm() * e.norm())).item()
        assert cos > 0.999, (name, cos)


@pytest.mark.gpu
def test_card_transport_against_gloo_on_card(tmp_path):
    """The card transport's CUDA flavour (staging buffers on the card,
    opened by the peers from CUDA IPC handles) against gloo on 4 ranks of
    one card: the byte movers bit for bit, the sums the same bits on every
    member and in group-rank order, large inputs in pieces of 4 KB."""
    _need_cuda()
    from repro_torch.launch import ranks
    cases = [
        dict(name="a2a", kind="all_to_all", mesh=(2, 2, 1),
             axis=("pod", "data"), shape=(4, 700, 3), dtype="bfloat16"),
        dict(name="gather", kind="all_gather", mesh=(1, 1, 4),
             axis="model", members=((0, 1), (2, 3)), shape=(3000,),
             dtype="bfloat16"),
        dict(name="permute", kind="ppermute", mesh=(1, 1, 4), axis="model",
             shape=(2100,), dtype="float32"),
        dict(name="reduce-scatter", kind="reduce_scatter", mesh=(2, 2, 1),
             axis="data", shape=(2, 3000), dtype="float32"),
        dict(name="all-reduce", kind="all_reduce", mesh=(2, 2, 1),
             axis=("pod", "data"), shape=(5000,), dtype="float32")]
    spec = dict(world=4, pods=1, ep=1, tp=4, backend="gloo",
                device="cuda:0", init_method=f"file://{tmp_path}/store",
                timeout_s=120, out_dir=str(tmp_path / "out"), threads=1,
                piece_bytes=4096, cases=cases, barriers=100)
    got = ranks.run_ranks(ranks.card_transport_worker, spec, timeout_s=300)
    for r in got:
        for name, c in r["check"]["cases"].items():
            if c["kind"] in ("all_reduce", "reduce_scatter"):
                assert c["rank_order"] and c["over_bound"] == 0, (name, c)
            else:
                assert c["same_bits"], (name, c)
        assert all(s["card"] > 0 for s in r["check"]["staging"].values())
    digests = {r["check"]["cases"]["all-reduce"]["digest"] for r in got}
    assert len(digests) == 1


class _Forged:
    """Pickles as the reduction it is given."""

    def __init__(self, reduced):
        self.reduced = reduced

    def __reduce__(self):
        return self.reduced


@pytest.mark.gpu
def test_card_transport_handle_that_does_not_open_raises():
    """A slot whose pickled CUDA IPC handle is zeroed does not open: the
    card transport raises, naming the member and its group."""
    _need_cuda()
    import pickle

    from torch.multiprocessing import reductions

    from repro_torch.parallel import mesh
    slot = mesh._allocate_shareable(1 << 20, torch.device("cuda"))
    rebuild, args = reductions.reduce_tensor(slot)
    args = list(args)
    args[7] = bytes(len(args[7]))           # the storage's IPC handle
    raw = pickle.dumps(_Forged((rebuild, tuple(args))))
    with pytest.raises(RuntimeError, match="member 1 of group"):
        mesh._open_slot(raw, 1, (0, 1))


@pytest.mark.gpu
def test_checkpoint_of_device_leaves_has_the_host_writers_bytes(tmp_path):
    """A tree of CUDA tensors (leaves above and below the writer's 64 MB
    piece, bf16 among them) streamed through the pinned buffers gives the
    bytes of the same tree written from host copies, and restores into
    CUDA tensors bit for bit."""
    _need_cuda()
    import hashlib
    import os
    import time
    from unittest import mock

    from repro_torch.checkpoint import store
    gen = torch.Generator(device="cuda").manual_seed(4)
    tree = {"big": torch.randn((9, 1 << 22), generator=gen, device="cuda"
                               ).to(torch.bfloat16),
            "f": torch.randn((33, 7), generator=gen, device="cuda"),
            "n": torch.tensor(3, device="cuda"),
            "empty": torch.empty((0, 4), device="cuda")}
    clock = time.struct_time((2026, 1, 2, 3, 4, 5, 4, 2, 0))

    def digest(tr, where):
        with mock.patch("time.time", return_value=1.7e9), \
                mock.patch("time.localtime", return_value=clock):
            path = store.CheckpointManager(str(where)).save(1, tr)
        with open(os.path.join(path, store.SHARD), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    host = {k: v.cpu() for k, v in tree.items()}
    assert digest(tree, tmp_path / "card") == digest(host, tmp_path / "host")
    into = {k: torch.zeros_like(v) for k, v in tree.items()}
    store.CheckpointManager(str(tmp_path / "card")).restore_into(1, into)
    for k, v in tree.items():
        assert torch.equal(into[k], v), k
