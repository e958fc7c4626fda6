#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (no CUDA device is an error);
2. build: compile every kernel under ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it plus edge cases, with its time, the
   plain version's time, the least time the card could take (bound) and a
   library yardstick where one PyTorch call computes the same function;
   and the DBRX prefill combine run twice on the same inputs, which must be
   bit-identical;
4. reference: small models in bf16 on the card (kernels) against the same
   weights in fp32 on the CPU (plain versions): DBRX-shaped with every
   expert active and routed top-2 of 8 with overflow, then Zamba2-shaped
   (attention at head_dim 112) and RWKV6-shaped;
5. serve: through ``ServeEngine.generate``, random seeded weights, 4
   prompts x 512 tokens, 32 new tokens greedy, one model at a time, each
   freed before the next: DBRX-132B at full width with its depth cut to 4
   layers, then Zamba2-7B and RWKV6-7B at full width and full depth; each
   with the kernels' launch counts over its own run.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# (arch, depth cut or None for the published depth), served in this order
SERVES = (("dbrx_132b", 4), ("zamba2_7b", None), ("rwkv6_7b", None))
PROMPTS, PROMPT_LEN, MAX_NEW = 4, 512, 32
ATTN_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 kernel vs fp32 plain
# bf16 scans vs the fp32 per-step recurrence: the reference kernel tests'
# bf16 tolerance (tests/test_kernels.py)
SCAN_TOL = dict(atol=5e-2, rtol=5e-2)
REF_TOL = 5e-2                          # of max |logit|, bf16 vs fp32 model


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def pack_inputs(n, h, d, dtype, *, valid_rows=None, k=None, seed=0):
    """Rows, destination bitmaps (all d bits random, or k distinct of d,
    or bit 0 only when d == 1) and valid flags on the card."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randn((n, h), generator=gen, device="cuda").to(dtype)
    if d == 1:
        bitmap = torch.ones(n, dtype=torch.int32, device="cuda")
    elif k is not None:
        picks = torch.rand((n, d), generator=gen, device="cuda"
                           ).argsort(dim=-1)[:, :k]
        bitmap = (1 << picks.to(torch.int32)).sum(-1, dtype=torch.int32)
    else:
        bitmap = torch.randint(0, 1 << d, (n,), generator=gen, device="cuda",
                               dtype=torch.int64).to(torch.int32)
    if valid_rows is None:
        valid = torch.rand(n, generator=gen, device="cuda") > 0.25
    else:
        valid = torch.arange(n, device="cuda") < valid_rows
    return tokens, bitmap, valid


def check_pack(failures: list, label: str, args, d: int, c: int) -> None:
    import torch

    from repro_torch.kernels import ops, ref
    out, idx = ops.dispatch_pack(*args, num_dests=d, capacity=c)
    exp_out, exp_idx = ref.pack_ref(*args, d, c)
    torch.cuda.synchronize()
    ints = torch.int16 if out.element_size() == 2 else torch.int32
    same = (torch.equal(idx, exp_idx)
            and torch.equal(out.view(ints), exp_out.view(ints)))
    print(f"  dispatch_pack {label}: N={args[0].shape[0]} H={args[0].shape[1]}"
          f" D={d} C={c} {args[0].dtype}: "
          f"{'bit-exact' if same else 'MISMATCH'}")
    if not same:
        failures.append(f"dispatch_pack {label}")


def kernel_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_plain

    failures: list = []
    h = 6144
    bf16 = torch.bfloat16
    # the three stages of one DBRX prefill MoE layer: N = 4 x 512 tokens,
    # top-4 of 16 experts, capacity factor 1.25 (models/moe.py)
    stages = [
        ("stage1", pack_inputs(2048, h, 1, bf16, valid_rows=2048), 1, 2560),
        ("stage2", pack_inputs(2560, h, 1, bf16, valid_rows=2048, seed=1),
         1, 3200),
        ("stage3", pack_inputs(3200, h, 16, bf16, valid_rows=2048, k=4,
                               seed=2), 16, 640),
    ]
    # the three of one decode round, which make up all but 12 of the main
    # path's launches: N = 4 tokens, one slot per expert, so stage 3 drops
    # rows and its scan stops at capacity on every step
    decode = [
        ("decode1", pack_inputs(4, h, 1, bf16, valid_rows=4, seed=7), 1, 5),
        ("decode2", pack_inputs(5, h, 1, bf16, valid_rows=4, seed=8), 1, 6),
        ("decode3", pack_inputs(6, h, 16, bf16, valid_rows=4, k=4, seed=9),
         16, 1),
    ]
    edge = [
        ("d31-bf16", pack_inputs(1024, 256, 31, bf16, seed=3), 31, 40),
        ("d31-f32", pack_inputs(1024, 256, 31, torch.float32, seed=4),
         31, 40),
        ("overflow", pack_inputs(4096, 128, 4, torch.float32, seed=5), 4, 100),
        ("odd-rows", pack_inputs(300, 6, 5, bf16, seed=6), 5, 70),
    ]
    for label, args, d, c in stages + decode + edge:
        check_pack(failures, label, args, d, c)
    pk = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for label, args, d, c in stages + decode:
        tokens = args[0]
        n, esize = tokens.shape[0], tokens.element_size()
        # bytes this data needs: the bitmap and valid flags, the rows that
        # land in some slot (read once), the packed buffer and slot map
        _, idx = ref.pack_ref(*args, d, c)
        rows_read = torch.unique(idx[idx >= 0]).numel()
        nbytes = n * 5 + rows_read * h * esize + d * c * (h * esize + 4)
        ms = time_ms(lambda: ops.dispatch_pack(*args, num_dests=d,
                                               capacity=c))
        plain = time_ms(lambda: ref.pack_ref(*args, d, c))
        bnd, _ = bound_ms(nbytes)
        print(f"  dispatch_pack {label} time: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bnd:.4f} ms ({rows_read} rows read, "
              f"{nbytes / 1e6:.3f} MB)")
        if label.startswith("stage"):    # the kernels line: one prefill layer
            pk["ms"] += ms
            pk["plain_ms"] += plain
            pk["bound_ms"] += bnd

    # attention: the DBRX prefill shape in the main path's layout (views of
    # [B, S, heads, D] buffers), then small shapes over the mask set
    def attn_inputs(b, hq, g, s, t, d, seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(bf16)
        k = torch.randn((b, t, g, d), generator=gen, device="cuda").to(bf16)
        v = torch.randn((b, t, g, d), generator=gen, device="cuda").to(bf16)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    attn_cases = [  # b, heads, kv heads, Sq, Sk, D, causal, window, softcap
        ("dbrx", (4, 48, 8, 512, 512, 128), True, None, None),
        ("zamba2", (4, 32, 32, 512, 512, 112), True, None, None),
        ("window", (2, 4, 2, 100, 100, 128), True, 32, None),
        ("softcap", (2, 4, 2, 64, 64, 64), True, None, 30.0),
        ("cross", (2, 4, 1, 40, 72, 128), False, None, None),
        ("noncausal", (1, 2, 2, 130, 130, 64), False, None, None),
        ("causal-ragged", (2, 4, 2, 200, 200, 128), True, None, None),
        ("all-masks", (1, 4, 2, 96, 160, 128), True, 48, 20.0),
    ]
    attn_err = 0.0
    for i, (label, shape, causal, window, softcap) in enumerate(attn_cases):
        q, k, v = attn_inputs(*shape, seed=10 + i)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = ops.flash_attention(q, k, v, **kw).float()
        exp = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        err = (out - exp).abs().max().item()
        ok = torch.allclose(out, exp, **ATTN_TOL)
        print(f"  flash_attention {label} {shape} causal={causal} "
              f"window={window} softcap={softcap}: max|err| {err:.3e} "
              f"{'within' if ok else 'OUTSIDE'} atol=rtol=2e-2")
        if not ok:
            failures.append(f"flash_attention {label}")
        if label in ("dbrx", "zamba2"):
            b, hq, g, sq, t, d = shape
            ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
            plain = time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                            iters=5)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            nbytes = 2 * (2 * b * hq * sq * d + 2 * b * g * t * d)
            flops = 4 * b * hq * d * (sq * (sq + 1) // 2)   # causal pairs
            bnd, by = bound_ms(nbytes, flops)
            print(f"  flash_attention {label} time: kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, scaled_dot_product_attention "
                  f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}; "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
            if label == "dbrx":       # the kernels line: DBRX's shape
                attn_err = err
                fa_ms, fa_plain, fa_lib, fa_bound, fa_by = \
                    ms, plain, lib, bnd, by
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    rows = {
        "dispatch_pack": dict(
            name="dispatch_pack", route="cuda",
            source="src/repro_torch/kernels/csrc/dispatch_pack.cu",
            replaces="src/repro/kernels/dispatch_pack.py:97",
            max_abs_err=0.0, ms=pk["ms"], plain_ms=pk["plain_ms"],
            bound_ms=pk["bound_ms"], bound_by="bytes", library_ms=None),
        "flash_attention": dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:112",
            max_abs_err=attn_err, ms=fa_ms, plain_ms=fa_plain,
            bound_ms=fa_bound, bound_by=fa_by, library_ms=fa_lib),
    }
    return rows


def scan_inputs_mamba2(batch, heads, s, groups, seed):
    """Zamba2-like scan inputs on the card: conv-output-sized x, dt from a
    softplus, A = -exp(A_log), B/C per group (``shared``: one group per
    sequence, read by all of its heads through a head stride of 0)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    rows = batch * heads
    g = batch if groups == "shared" else rows
    x = rn(rows, s, 64).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(rn(rows, s) - 1.0)
    a = -torch.exp(rn(rows) * 0.5)
    d = rn(rows)
    b, c = (rn(g, s, 64).to(torch.bfloat16) for _ in range(2))
    return x, dt, a, b, c, d


def scan_inputs_rwkv6(batch, heads, s, seed):
    """RWKV6-7B-like scan inputs on the card.  logw is made as
    ``models/rwkv.py::_decay_logw`` makes it at full width (d 4096, LoRA
    64, the reference's init scales, w0 = 0) from unit-variance inputs, so
    one 32-step chunk's log-decays sum to about -70 at the extreme."""
    import torch
    from repro_torch.models.layers import truncated_normal_
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dmodel, lora, dk = heads * 64, 64, 64

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def to_heads(t):
        return t.reshape(batch, s, heads, dk).transpose(1, 2).reshape(
            batch * heads, s, dk).contiguous()

    wa = truncated_normal_(torch.empty((dmodel, lora), device="cuda"),
                           dmodel ** -0.5, gen)
    wb = truncated_normal_(torch.empty((lora, dmodel), device="cuda"),
                           lora ** -0.5, gen)
    xw = rn(batch, s, dmodel)
    logw = to_heads(-torch.exp(torch.tanh(xw @ wa) @ wb))
    r, k, v = (to_heads(rn(batch, s, dmodel)).to(torch.bfloat16)
               for _ in range(3))
    u = truncated_normal_(torch.empty((heads, dk), device="cuda"), 0.3,
                          gen).repeat(batch, 1)
    return r, k, v, logw, u


def _check_scan(failures, name, label, got, exp) -> float:
    import torch
    (y, st), (ey, est) = got, exp
    torch.cuda.synchronize()
    y_err = (y.float() - ey).abs().max().item()
    st_err = (st - est).abs().max().item()
    ok = (torch.isfinite(y).all().item()
          and torch.allclose(y.float(), ey, **SCAN_TOL)
          and torch.allclose(st, est, **SCAN_TOL))
    print(f"  {name} {label}: y max|err| {y_err:.3e} (max|y| "
          f"{ey.abs().max().item():.3e}), final state max|err| {st_err:.3e} "
          f"(max|state| {est.abs().max().item():.3e}): "
          f"{'within' if ok else 'OUTSIDE'} atol=rtol=5e-2 of the fp32 "
          f"per-step recurrence")
    if not ok:
        failures.append(f"{name} {label}")
    return y_err


def scan_phase() -> dict:
    """The two scan kernels against the per-step recurrence (fp32, which
    cannot overflow), y and final state, at the serving shapes, a ragged
    S = 500 and, for mamba2, B/C per head as well as shared; times at the
    serving shapes against the chunked plain versions."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mamba2_scan import (CHUNK as MQ,
                                                 expand_groups,
                                                 mamba2_scan_plain)
    from repro_torch.kernels.rwkv6_scan import CHUNK as RQ, rwkv6_scan_plain

    failures: list = []
    rows = {}
    # Zamba2-7B prefill: 4 sequences x 112 heads of 64, ds 64, one B/C
    # group per sequence
    for label, (batch, heads, s, groups) in (
            ("zamba2", (4, 112, 512, "shared")),
            ("ragged", (4, 112, 500, "shared")),
            ("per-head", (2, 16, 300, "per-head"))):
        args = scan_inputs_mamba2(batch, heads, s, groups, seed=20)
        x, dt, a, b, c, d = args
        n = x.shape[0]
        exp = ref.mamba2_ref(x.float(), dt, a, expand_groups(b, n).float(),
                             expand_groups(c, n).float(), d,
                             return_final=True)
        err = _check_scan(failures, "mamba2_scan", label,
                          ops.mamba2_scan(*args), exp)
        if label != "zamba2":
            continue
        ms = time_ms(lambda: ops.mamba2_scan(*args))
        plain = time_ms(lambda: mamba2_scan_plain(*args), iters=5)
        dh, ds = x.shape[-1], b.shape[-1]
        nbytes = (x.numel() * 2 * 2 + dt.numel() * 4 + (a.numel() + d.numel())
                  * 4 + (b.numel() + c.numel()) * 2 + n * ds * dh * 4)
        chunks = -(-s // MQ)
        tri = MQ * (MQ + 1) // 2        # causal pairs of a chunk
        flops = 2 * n * chunks * (tri * ds + tri * dh + 2 * MQ * ds * dh)
        bnd, by = bound_ms(nbytes, flops)
        print(f"  mamba2_scan zamba2 time: kernel {ms:.4f} ms, plain "
              f"(chunked) {plain:.4f} ms, bound {bnd:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        rows["mamba2_scan"] = dict(
            name="mamba2_scan", route="cuda",
            source="src/repro_torch/kernels/csrc/mamba2_scan.cu",
            replaces="src/repro/kernels/mamba2_scan.py:100",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=None)
    # RWKV6-7B prefill: 4 sequences x 64 heads of 64
    for label, (batch, s) in (("rwkv6", (4, 512)), ("ragged", (4, 500))):
        args = scan_inputs_rwkv6(batch, 64, s, seed=21)
        r, k, v, logw, u = args
        chunk_sum = logw[:, :RQ].sum(dim=1).min().item()
        print(f"  rwkv6_scan {label}: most negative first-chunk sum of "
              f"logw {chunk_sum:.2f}")
        exp = ref.rwkv6_ref(r.float(), k.float(), v.float(), logw, u,
                            return_final=True)
        err = _check_scan(failures, "rwkv6_scan", label,
                          ops.rwkv6_scan(*args), exp)
        if label != "rwkv6":
            continue
        ms = time_ms(lambda: ops.rwkv6_scan(*args))
        plain = time_ms(lambda: rwkv6_scan_plain(*args), iters=5)
        n, _, dk = r.shape
        dv = v.shape[-1]
        nbytes = ((r.numel() + k.numel() + v.numel()) * 2 + logw.numel() * 4
                  + u.numel() * 4 + v.numel() * 2 + n * dk * dv * 4)
        chunks = -(-s // RQ)
        low = RQ * (RQ - 1) // 2        # strictly-lower pairs of a chunk
        flops = 2 * n * chunks * (low * dk + RQ * dk + (low + RQ) * dv
                                  + 2 * RQ * dk * dv)
        bnd, by = bound_ms(nbytes, flops)
        print(f"  rwkv6_scan rwkv6 time: kernel {ms:.4f} ms, plain "
              f"(chunked) {plain:.4f} ms, bound {bnd:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        rows["rwkv6_scan"] = dict(
            name="rwkv6_scan", route="cuda",
            source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
            replaces="src/repro/kernels/rwkv6_scan.py:97",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=None)
    if failures:
        raise AssertionError(f"scan kernels disagree with the per-step "
                             f"recurrence: {failures}")
    return rows


def combine_phase() -> None:
    """The DBRX prefill combine (4 x 512 tokens, top-4 of 16, capacity
    factor 1.25) twice on the same inputs: the outputs must be
    bit-identical."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core import collectives as cl
    from repro_torch.models.moe import balanced_capacities

    cfg = get_config("dbrx_132b")
    n, h = PROMPTS * PROMPT_LEN, cfg.d_model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    tokens = torch.randn((n, h), generator=gen, device="cuda").to(
        torch.bfloat16)
    logits = torch.randn((n, cfg.num_experts), generator=gen, device="cuda")
    gates, ids = cl.route_topk(logits, cfg.top_k)
    mesh = cl.EPMesh(pod_axis=None, ep_axis="_none", num_pods=1,
                     ep_per_pod=1)
    dcfg = balanced_capacities(n, cfg.top_k, 1, 1, cfg.num_experts,
                               cfg.moe_capacity)
    exp_tok, exp_gate, state = cl.hierarchical_dispatch(tokens, ids, gates,
                                                        dcfg, mesh)
    expert_out = torch.randn(exp_tok.shape, generator=gen,
                             device="cuda").to(torch.bfloat16)
    first = cl.hierarchical_combine(expert_out, exp_gate, state)
    second = cl.hierarchical_combine(expert_out, exp_gate, state)
    torch.cuda.synchronize()
    same = torch.equal(first.view(torch.int32), second.view(torch.int32))
    kept = int((state.map_exp >= 0).sum())
    print(f"  DBRX prefill combine [{n}, {h}] from {kept} expert slots, "
          f"twice on the same inputs: "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the combine is not deterministic")


# ---------------------------------------------------------------------------
# phase 4: small model, card (bf16 kernels) vs CPU (fp32 plain versions)
# ---------------------------------------------------------------------------

def reference_phase() -> None:
    from repro_torch.configs.base import get_config

    # head_dim 128 as at full width
    dbrx = get_config("dbrx_132b")
    small = dict(d_model=512, n_heads=4, n_kv_heads=2, d_ff=256, vocab=1024)
    # every expert active: no routing choice, no drops
    compare_small_model("all experts", dbrx.reduced(
        **small, num_experts=4, top_k=4), seed=7)
    # top-2 of 8 at DBRX's capacity factor: partial bitmaps, and experts
    # that overflow their slots (one slot each at decode)
    compare_small_model("routed", dbrx.reduced(
        **small, num_experts=8, top_k=2, moe_capacity=dbrx.moe_capacity),
        seed=8)
    # Zamba2-shaped: mamba heads of 64 with ds 64 as at full width, and the
    # shared block at head_dim 112 (4 heads over d_model 448), shared after
    # every 2 of 4 mamba layers
    compare_small_recurrent("Zamba2-shaped", get_config("zamba2_7b").reduced(
        n_layers=4, d_model=448, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab=1024, ssm_state=64, ssm_head_dim=64, shared_attn_every=2),
        seed=9)
    # RWKV6-shaped: wkv heads of 64 and a LoRA of 64 as at full width
    compare_small_recurrent("RWKV6-shaped", get_config("rwkv6_7b").reduced(
        n_layers=2, d_model=512, d_ff=1024, vocab=1024, rwkv_head_dim=64,
        rwkv_decay_lora=64), seed=10)


def _call(fn, *args):
    return fn(*args)


def logits_gap(label: str, card, host, toks) -> float:
    """Prefill ``toks`` and take 3 greedy decode steps (the CPU's choices)
    on both sides; ``card`` and ``host`` are (model, params, call), where
    ``call(fn, *args)`` runs one model call.  Raises when the card's logits
    are off by ``REF_TOL`` of max |logit| at any step; returns the worst."""
    import torch
    (gpu, params, on_card), (cpu, cpu_params, on_cpu) = card, host
    b, s = toks.shape
    worst = 0.0
    with torch.inference_mode():
        cache_g = gpu.init_cache(b, s + 16)
        cache_c = cpu.init_cache(b, s + 16)
        lg, cache_g = on_card(gpu.prefill, params, {"tokens": toks.cuda()},
                              cache_g)
        lc, cache_c = on_cpu(cpu.prefill, cpu_params, {"tokens": toks},
                             cache_c)
        for step in range(4):
            rel = ((lg.float().cpu() - lc).abs().max()
                   / lc.abs().max()).item()
            worst = max(worst, rel)
            if not rel < REF_TOL:
                raise AssertionError(f"reference {label} step {step}: card "
                                     f"logits off by {rel:.3e} of max "
                                     f"|logit|")
            if step == 3:
                return worst
            nxt = lc.argmax(-1).to(torch.int32)[:, None]
            lg, cache_g = on_card(gpu.decode, params,
                                  {"tokens": nxt.cuda()}, cache_g)
            lc, cache_c = on_cpu(cpu.decode, cpu_params, {"tokens": nxt},
                                 cache_c)


def compare_small_recurrent(label: str, cfg, *, seed: int) -> None:
    """Prefill (100 tokens: ragged chunks for both scans) and 3 decode
    steps of a hybrid or rwkv ``cfg`` in bf16 on the card (kernels) and in
    fp32 on the CPU (plain versions), same weights and tokens."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model, param_module

    gpu = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = gpu.init(gen)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu_params = param_module(cfg, device="cpu", dtype=torch.float32)
    cpu_params.load_state_dict({k: v.float().cpu()
                                for k, v in params.state_dict().items()})
    b, s = 4, 100
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32))
    ops.reset_launches()
    worst = logits_gap(label, (gpu, params, _call), (cpu, cpu_params, _call),
                       toks)
    counts = {k: v for k, v in ops.launches().items() if v}
    heads = (f"attention head_dim {cfg.head_dim}" if cfg.family == "hybrid"
             else f"wkv head_dim {cfg.rwkv_head_dim}")
    print(f"  small {label} model ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {heads}): card bf16 vs "
          f"CPU fp32 logits over prefill + 3 decode steps, worst "
          f"{worst:.3e} of max |logit| (limit {REF_TOL}); kernel launches "
          f"{counts}")
    scan = "mamba2_scan" if cfg.family == "hybrid" else "rwkv6_scan"
    if counts.get(scan) != cfg.n_layers:
        raise AssertionError(f"reference {label}: {scan} launched "
                             f"{counts.get(scan)} times, not "
                             f"{cfg.n_layers}")


def compare_small_model(label: str, cfg, *, seed: int) -> None:
    """Prefill and 3 decode steps of ``cfg`` in bf16 on the card (kernels)
    and in fp32 on the CPU (plain versions), same weights and tokens.

    bf16 rounding can flip an expert choice where two router logits nearly
    tie, and one flip changes which rows overflow.  So the CPU run takes the
    card's expert choices (its gates come from its own logits), and every
    choice it would have made otherwise must be a near tie in its logits.
    """
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.core import collectives as cl
    from repro_torch.models import transformer as T
    from repro_torch.models.api import build_model

    route, dispatch = cl.route_topk, cl.hierarchical_dispatch
    card_ids: list = []          # the card's choices, one entry per MoE call
    tally = {"pairs": 0, "kept": 0, "flips": 0, "gap": 0.0}

    def card_route(logits, k):
        gates, ids = route(logits, k)
        card_ids.append(ids.cpu())
        return gates, ids

    def card_dispatch(tokens, ids, gates, dcfg, mesh):
        out = dispatch(tokens, ids, gates, dcfg, mesh)
        tally["pairs"] += ids.numel()
        tally["kept"] += int((out[2].map_exp >= 0).sum())
        return out

    def cpu_route(logits, k):
        ids = card_ids.pop(0).long()
        own = route(logits, k)[1].long()
        flips = (own.sort(-1).values != ids.sort(-1).values).any(-1)
        kth = logits.topk(k, dim=-1).values[..., -1:]
        gap = ((kth - logits.gather(-1, ids)).max().clamp(min=0)
               / logits.abs().max()).item()
        tally["flips"] += int(flips.sum())
        tally["gap"] = max(tally["gap"], gap)
        probs = torch.softmax(logits.float(), dim=-1).gather(-1, ids)
        return probs / probs.sum(-1, keepdim=True), ids.to(torch.int32)

    gpu = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = gpu.init(gen)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu_params = T.Transformer(cfg, device="cpu", dtype=torch.float32)
    cpu_params.load_state_dict({k: v.float().cpu()
                                for k, v in params.state_dict().items()})
    b, s = 4, 64
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32))

    def on_card(fn, *args):
        with mock.patch.object(cl, "route_topk", card_route), \
                mock.patch.object(cl, "hierarchical_dispatch", card_dispatch):
            return fn(*args)

    def on_cpu(fn, *args):
        with mock.patch.object(cl, "route_topk", cpu_route):
            return fn(*args)

    worst = logits_gap(label, (gpu, params, on_card),
                       (cpu, cpu_params, on_cpu), toks)
    dropped = tally["pairs"] - tally["kept"]
    print(f"  small DBRX-shaped model, {label} ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, top-{cfg.top_k} of {cfg.num_experts}, "
          f"capacity factor {cfg.moe_capacity}): card bf16 vs CPU fp32 "
          f"logits over prefill + 3 decode steps, worst {worst:.3e} of max "
          f"|logit| (limit {REF_TOL}); {tally['pairs']} token-expert pairs, "
          f"{dropped} dropped; {tally['flips']} rows where the CPU would "
          f"have routed otherwise, widest gap {tally['gap']:.3e} of max "
          f"|router logit| (limit {REF_TOL})")
    if card_ids:
        raise AssertionError(f"reference {label}: {len(card_ids)} MoE calls "
                             f"on the card had no CPU counterpart")
    if tally["gap"] > REF_TOL:
        raise AssertionError(f"reference {label}: the card chose an expert "
                             f"{tally['gap']:.3e} of max |router logit| "
                             f"below the CPU's k-th choice")
    if cfg.top_k < cfg.num_experts and dropped == 0:
        raise AssertionError(f"reference {label}: no expert overflowed")


# ---------------------------------------------------------------------------
# phase 5: serve each model at full width
# ---------------------------------------------------------------------------

def expected_launches(cfg, forwards: int) -> dict:
    """Kernel launches of one ``generate``: ``forwards`` = 1 prefill plus
    the decode rounds.  Attention and the scans run at prefill only; the
    dispatch pack runs three times per MoE layer in every forward."""
    from repro_torch.kernels import ops
    from repro_torch.models.ssm import n_shared_calls
    want = dict.fromkeys(ops.launches(), 0)
    if cfg.family == "moe":
        want["dispatch_pack"] = 3 * cfg.n_layers * forwards
        want["flash_attention"] = cfg.n_layers
    elif cfg.family == "hybrid":
        want["mamba2_scan"] = cfg.n_layers
        want["flash_attention"] = n_shared_calls(cfg)
    elif cfg.family == "rwkv":
        want["rwkv6_scan"] = cfg.n_layers
    return want


def serve_phase(arch: str, layers) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, make_prompts, \
        serve_config

    cfg = serve_config(arch, layers=layers, smoke=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = build_engine(cfg, device="cuda", dtype=torch.bfloat16, seed=0,
                          max_new=MAX_NEW)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in engine.params.parameters())
    nbytes = sum(p.numel() * p.element_size()
                 for p in engine.params.parameters())
    shape = (f"{cfg.num_experts} experts top-{cfg.top_k}, d_ff "
             f"{cfg.expert_d_ff}" if cfg.family == "moe" else
             f"ssm state {cfg.ssm_state}, head_dim {cfg.ssm_head_dim}, "
             f"shared block every {cfg.shared_attn_every}, d_ff {cfg.d_ff}"
             if cfg.family == "hybrid" else
             f"wkv head_dim {cfg.rwkv_head_dim}, decay LoRA "
             f"{cfg.rwkv_decay_lora}, d_ff {cfg.d_ff}")
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv (head_dim "
          f"{cfg.head_dim}), {shape}, vocab {cfg.vocab}: "
          f"{nparams / 1e9:.2f} B parameters, {nbytes / 1e9:.2f} GB, random "
          f"init {time.monotonic() - t0:.1f} s")
    prompts = make_prompts(cfg, PROMPTS, PROMPT_LEN, seed=0)
    engine.generate(prompts, max_new=2)          # warm-up, not counted
    engine.stats.update(prefill_s=0.0, decode_s=0.0, tokens=0)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    out = engine.generate(prompts)
    counts = ops.launches()

    st = engine.stats
    if out.shape != (PROMPTS, MAX_NEW):
        raise AssertionError(f"generate returned {out.shape}")
    if not ((out >= 0) & (out < cfg.vocab)).all():
        raise AssertionError("token ids out of vocab range")
    if st["nonfinite_logits"]:
        raise AssertionError(f"{st['nonfinite_logits']} steps with "
                             f"non-finite logits")
    want = expected_launches(cfg, forwards=MAX_NEW)
    print(f"  launches during generate: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    decode_ms = st["decode_s"] * 1e3 / (MAX_NEW - 1)
    total_s = st["prefill_s"] + st["decode_s"]
    print(f"  generate [{PROMPTS} x {PROMPT_LEN}] -> {list(out.shape)}: "
          f"prefill {st['prefill_s'] * 1e3:.3f} ms, decode "
          f"{decode_ms:.3f} ms/token, {PROMPTS * MAX_NEW / total_s:.1f} "
          f"tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"  first tokens: {out[:, :8].tolist()}")
    del engine
    torch.cuda.empty_cache()
    return counts


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from repro_torch.kernels import _build

    print("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {kind}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip())

    print("phase 2: build")
    t0 = time.monotonic()
    built = _build.build()
    print(f"  built {built or 'nothing (cached)'} in "
          f"{time.monotonic() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("phase 3: kernels vs plain versions")
    rows = kernel_phase()
    rows.update(scan_phase())
    combine_phase()
    print("phase 4: small-model reference")
    reference_phase()
    print("phase 5: serve")
    by_path = {}
    for arch, layers in SERVES:
        by_path[arch] = serve_phase(arch, layers)

    for name, row in rows.items():
        row["launches"] = sum(c[name] for c in by_path.values())
        row["launches_by_path"] = {arch: c[name]
                                   for arch, c in by_path.items()}
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
