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
@pytest.mark.parametrize("hq,g,sq,sk,d,causal", [
    (8, 2, 300, 300, 112, True),     # ragged last q and kv tiles
    (4, 1, 77, 333, 112, False),     # one kv head for every q head
    (4, 4, 129, 257, 64, False),     # one row / one key past a tile
    (4, 2, 1, 1, 128, True),         # a single query and key
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
    model, params = engine.model, engine.params
    logits_kept, toks = [], []
    with torch.inference_mode():
        cache = model.init_cache(len(prompts), prompts.shape[1] + GRAPH_NEW)
        logits, _ = model.prefill(
            params, {"tokens": torch.from_numpy(prompts).cuda()}, cache)
        for step in range(GRAPH_NEW):
            if step:
                logits, _ = model.decode(
                    params, {"tokens": tok.to(torch.int32)[:, None]}, cache)
            tok = torch.argmax(logits, dim=-1)
            logits_kept.append(logits.float().cpu())
            toks.append(tok.cpu())
    return torch.stack(toks, dim=1).numpy(), logits_kept


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dbrx_132b", "zamba2_7b", "rwkv6_7b"])
def test_decode_graph_equals_eager_on_card(arch):
    """Graph decode gives the eager loop's greedy tokens; the logits' gap
    is printed (a replay runs the captured kernels on the same inputs)."""
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
            "flash_attention_bwd": 0}
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
    ((1, 48, 8, 4096, 4096, 128), True, None, None),    # DBRX at train_4k
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
@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_7b"])
def test_recurrent_training_raises_on_card(arch):
    """The scans have no backward kernel yet: the hybrid and rwkv families'
    loss raises on the card instead of running anything plain there."""
    _need_cuda()
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    ops.reset_launches()
    with pytest.raises(NotImplementedError, match="backward kernel"):
        model.loss(params, {"tokens": toks, "labels": toks})
    assert not any(ops.launches().values())
