#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (no CUDA device is an error);
2. build: compile every kernel under ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it plus edge cases, with its time, the
   plain version's time, the least time the card could take (bound) and a
   library yardstick where one PyTorch call computes the same function;
4. reference: a small DBRX-shaped model in bf16 on the card (kernels)
   against the same weights in fp32 on the CPU (plain versions), once
   with every expert active and once routed top-2 of 8 with overflow;
5. serve: DBRX-132B at full width, depth cut to 4 layers, random seeded
   weights, 4 prompts x 512 tokens, 32 new tokens greedy, through
   ``ServeEngine.generate``, with the kernels' launch counts.

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

ARCH = "dbrx_132b"
LAYERS = 4
PROMPTS, PROMPT_LEN, MAX_NEW = 4, 512, 32
ATTN_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 kernel vs fp32 plain
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
        if label == "dbrx":
            attn_err = err
            b, hq, g, s, t, d = shape
            fa_ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
            fa_plain = time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                               iters=5)
            fa_lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            nbytes = 2 * (2 * b * hq * s * d + 2 * b * g * t * d)
            flops = 4 * b * hq * d * (s * (s + 1) // 2)   # causal pairs
            fa_bound, fa_by = bound_ms(nbytes, flops)
            print(f"  flash_attention dbrx time: kernel {fa_ms:.4f} ms, "
                  f"plain {fa_plain:.4f} ms, scaled_dot_product_attention "
                  f"{fa_lib:.4f} ms, bound {fa_bound:.4f} ms ({fa_by}; "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
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


# ---------------------------------------------------------------------------
# phase 4: small model, card (bf16 kernels) vs CPU (fp32 plain versions)
# ---------------------------------------------------------------------------

def reference_phase() -> None:
    from repro_torch.configs.base import get_config

    # head_dim 128 as at full width
    dbrx = get_config(ARCH)
    small = dict(d_model=512, n_heads=4, n_kv_heads=2, d_ff=256, vocab=1024)
    # every expert active: no routing choice, no drops
    compare_small_model("all experts", dbrx.reduced(
        **small, num_experts=4, top_k=4), seed=7)
    # top-2 of 8 at DBRX's capacity factor: partial bitmaps, and experts
    # that overflow their slots (one slot each at decode)
    compare_small_model("routed", dbrx.reduced(
        **small, num_experts=8, top_k=2, moe_capacity=dbrx.moe_capacity),
        seed=8)


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

    with torch.inference_mode():
        cache_g = gpu.init_cache(b, s + 16)
        cache_c = cpu.init_cache(b, s + 16)
        lg, cache_g = on_card(gpu.prefill, params, {"tokens": toks.cuda()},
                              cache_g)
        lc, cache_c = on_cpu(cpu.prefill, cpu_params, {"tokens": toks},
                             cache_c)
        worst = 0.0
        for step in range(4):
            rel = ((lg.float().cpu() - lc).abs().max()
                   / lc.abs().max()).item()
            worst = max(worst, rel)
            if not rel < REF_TOL:
                raise AssertionError(f"reference {label} step {step}: card "
                                     f"logits off by {rel:.3e} of max "
                                     f"|logit|")
            if step == 3:
                break
            nxt = lc.argmax(-1).to(torch.int32)[:, None]
            lg, cache_g = on_card(gpu.decode, params,
                                  {"tokens": nxt.cuda()}, cache_g)
            lc, cache_c = on_cpu(cpu.decode, cpu_params, {"tokens": nxt},
                                 cache_c)
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
# phase 5: serve DBRX at full width
# ---------------------------------------------------------------------------

def serve_phase() -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, make_prompts, \
        serve_config

    cfg = serve_config(ARCH, layers=LAYERS, smoke=False)
    t0 = time.monotonic()
    engine = build_engine(cfg, device="cuda", dtype=torch.bfloat16, seed=0,
                          max_new=MAX_NEW)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in engine.params.parameters())
    nbytes = sum(p.numel() * p.element_size()
                 for p in engine.params.parameters())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, {cfg.num_experts} "
          f"experts top-{cfg.top_k}, d_ff {cfg.expert_d_ff}, vocab "
          f"{cfg.vocab}: {nparams / 1e9:.2f} B parameters, "
          f"{nbytes / 1e9:.2f} GB, random init {time.monotonic() - t0:.1f} s")
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
    forwards = MAX_NEW          # 1 prefill + MAX_NEW - 1 decode rounds
    want = {"dispatch_pack": 3 * cfg.n_layers * forwards,
            "flash_attention": cfg.n_layers}
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
    print("phase 4: small-model reference")
    reference_phase()
    print("phase 5: serve")
    counts = serve_phase()

    for name, row in rows.items():
        row["launches"] = counts[name]
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
