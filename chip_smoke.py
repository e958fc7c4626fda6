#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (no CUDA device is an error);
2. build: compile every kernel under ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, all started together; print ptxas's registers and
   spills for each kernel function, and count the wgmma/TMA (flash
   attention) and tensor-core (both scans) instructions in the SASS where
   the toolkit has ``cuobjdump``, and wgmma/TMA in each of the attention
   backward's own kernel functions;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it plus edge cases (tile and chunk
   edges, no decay and fast decay, one row, empty and full slots), with its
   device time (20 calls captured in one CUDA graph), its host issue time
   per call, the plain version's time, the least time the card could take
   (bound) and a library yardstick timed the same way where one PyTorch
   call computes the same function; and the DBRX prefill combine run twice
   on the same inputs, which must be bit-identical;
4. reference: small models in bf16 on the card (kernels) against the same
   weights in fp32 on the CPU (plain versions): DBRX-shaped with every
   expert active and routed top-2 of 8 with overflow, Kimi-shaped (head_dim
   112 over one kv head, a dense first layer, 24 experts top-8, a shared
   expert), then Zamba2-shaped (attention at head_dim 112) and
   RWKV6-shaped;
5. serve: through ``ServeEngine.generate``, random seeded weights, 4
   prompts x 512 tokens, 32 new tokens greedy, one model at a time, each
   freed before the next: DBRX-132B at full width with its depth cut to 4
   layers, then Zamba2-7B and RWKV6-7B at full width and full depth; each
   with the kernels' launch counts over its own run, decode replayed from
   a CUDA graph (captures and replays counted), a second call of the same
   shape that replays without a capture, and an eager loop of the model's
   own prefill and decode on the same prompts: greedy tokens equal, the
   logits' gap and both decode times printed; then DBRX serves a seeded
   Poisson stream through the continuous-batching scheduler under planner
   admission on ``2x8`` (12 requests, capacity 4, cohorts of unequal
   size);
6. ranks: DBRX-132B (4 layers) over 4 spawned ranks, 2 pods x 2 ep ranks
   of 4 experts, one prompt a rank (nccl with a card a rank where there are
   4 cards, else gloo with all ranks on card 0): the three MoE scheme pairs
   at one chunk, the hierarchical pair at G = 4 chunks, and a run under the
   planner's plan for the fabric the ranks measured, with the planner's
   decisions on that fabric and on a slow pod link; every rank's tokens
   equal, equal across the pairs and to a one-rank run up to near ties,
   exact launch counts, every pack of each warm-up bit-exact, and the
   pod-group bytes of one prefill dispatch below the baseline's; decode
   eager over gloo (its exchanges are host-staged) and graphed over nccl;
   and a continuous run under planner admission whose batch crosses a
   bucket: every request completed, a plan swap and no cold retrace;
7. Kimi-K2-1T at full width (depth 2 on one card, 4 on four) over 16
   spawned gloo ranks, 2 pods x 8 ep ranks of 24 experts, laid over the
   cards present, the non-expert weights made once a card and shared with
   its ranks as CUDA IPC handles: the three scheme pairs, a planned run
   and its fixed twin, one prompt of 512 tokens a rank, capacity factor 2;
   gates as phase 6's where they apply, plus the pairs each run drops and
   each rank's memory;
8. tensor parallelism over 4 spawned ranks (nccl with a card a rank where
   there are 4 cards, else gloo on card 0): Mistral-NeMo-12B at full width
   over (1, 1, 4) at ``tp_subgroups`` 1, 2 fixed and 2 planned, against a
   one-rank run of the same weights, and the split-TP MultiWrite gather
   alone at the served fragment; then DBRX (4 layers) over (1, 2, 2) with
   the experts' TP reduction per expert and deferred.  Within a run every
   rank's tokens equal, the three Mistral runs bit-identical, near ties
   against one rank, the gather bit-exact, every pack bit-exact;
9. the telemetry loop over 4 spawned ranks (as phase 6 and 8 lay them
   out): DBRX (4 layers) over 2 x 2 calibrates with a ``LiveProbe`` (the
   dispatch and combine plans, the directed rail probes), plans its serve
   program on the datasheet and on the fitted model and serves under the
   calibrated plan beside its fixed twin and the fixed hierarchical and
   baseline pairs; Mistral-NeMo's model axis over (1, 1, 4) sweeps the
   AllGather plans and sets the planner's split-TP pick, datasheet
   against calibrated, beside the gather's measured walls.  Every rank's
   walls the same bits, no probe failed, the calibrated model differs
   from the datasheet, every rank binds the same plan, every pack
   bit-exact, the calibrated run's tokens its twin's up to near ties;
10. training: the two backward kernels (the pack's, attention's with the
   forward's log-sum-exp) against their plain versions and against
   autograd of the plain forwards, at the shapes of one DBRX prefill
   layer of 4 x 512 tokens and at edge cases, timed beside
   ``index_add_`` and the backward of ``scaled_dot_product_attention``
   (attention's also each pass's device time, its host issue, two calls
   bit-identical, the dK/dV blocks' balance as they ran, and DBRX's heads
   at 4,096 tokens, held against the plain backward); a
   small DBRX-shaped model's loss and gradients in bf16 on the card
   against fp32 on the CPU; then DBRX-132B at full width, depth cut to 2,
   trained through ``Trainer`` for 8 steps of 4 x 512 tokens (AdamW with
   bf16 state, cosine schedule), with a checkpoint after step 4 restored
   into a fresh trainer that must reach the same losses.  Gates: finite
   losses and gradient norms, a falling loss, exact launch counts.

Phase 3 also holds the pack at the shapes of one DBRX prefill layer at
2 x 2 ranks and of one Kimi-K2 prefill layer at 2 x 8 (capacity factors
2 and 1.25), and attention at Kimi's rank shape (GQA groups of 8) and at
the tensor-parallel rank shapes of phase 8.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.

  python3 chip_smoke.py --ranks-only 4 1.25 --trace chiprun_out/t.json

runs phase 6 alone, once at each capacity factor (on four cards: nccl),
after the device and build phases;

  python3 chip_smoke.py --kimi-only

runs phase 7 alone after them (on four cards at depth 4 with 32 new
tokens);

  python3 chip_smoke.py --tp-only

runs phase 8 alone after them (on four cards over nccl, decode graphed);

  python3 chip_smoke.py --calibrate-only

runs phase 9 alone after them (on four cards over nccl);

  python3 chip_smoke.py --train-only

runs phase 10 alone after them.
"""

from __future__ import annotations

import gc
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
KIMI_H = 7168                           # Kimi-K2's d_model
RANKS = (2, 2)                          # phase 6: pods x ep ranks
KIMI_RANKS = (2, 8)                     # phase 7: pods x ep ranks
KIMI_CF = 2.0                           # phase 7: capacity factor
KIMI_PROMPT_LEN = 512                   # phase 7: one prompt a rank
# phase 7's (depth, new tokens) on one card and on four
KIMI_DEPTH = {1: (2, 8), 4: (4, 32)}
RANKS_CF = 4.0                          # phases 6, 8: num_experts / top_k
TP_MESH = (1, 1, 4)                     # phase 8: pods x data x model
DBRX_TP_MESH = (1, 2, 2)
# phase 8's Mistral-NeMo depth on one card and on four
TP_DEPTH = {1: 40, 4: 40}
PIPE_G = 4                              # phase 6: chunks of the G > 1 run
PROMPTS, PROMPT_LEN, MAX_NEW = 4, 512, 32
# phase 5's continuous DBRX stream: 12 requests of 512 tokens, 8 new each,
# Poisson at 500 a second of the virtual clock (cohorts of 1 to 3)
CONTINUOUS = dict(requests=12, prompt_len=512, max_new=8, arrival_rate=500.0)
# phase 6's: groups of one request a rank, a batch bucket crossed
# phase 9: the dispatch/combine probes' tokens a rank, the AllGather probes'
# bytes a rank (the reference's sweep below 64 MB), new tokens a served run
CAL_TOKENS = (32, 128, 512)
CAL_GATHER = (256 << 10, 1 << 20, 4 << 20, 16 << 20)
CAL_NEW = 8
RANKS_CONTINUOUS = dict(requests=12, prompt_len=512, max_new=8, rate=1e5,
                        capacity=8)
ATTN_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 kernel vs fp32 plain
# bf16 scans vs the fp32 per-step recurrence: the reference kernel tests'
# bf16 tolerance (tests/test_kernels.py)
SCAN_TOL = dict(atol=5e-2, rtol=5e-2)
REF_TOL = 5e-2                          # of max |logit|, bf16 vs fp32 model


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean wall of ``iters`` calls issued back to back, between CUDA
    events: device time while the device is the slower side, host issue
    time once the calls are shorter than their issue."""
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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph
    and replayed, so no host work sits between the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn) -> tuple[float, float]:
    """Host issue time per call: the host clock over a run of calls without
    waiting for the device (launches queue up behind each other).  Returns
    the median of 7 runs of 40 calls (the host is shared and noisy), and
    one run of 20 calls right after a warm call: the single figure this
    script printed before it took medians, kept so that readings on both
    footings can be compared."""
    import statistics

    from repro_torch.launch.host_issue import runs
    single = runs(fn, 1, calls=20)[0]
    return statistics.median(runs(fn, 7, calls=40)), single


def issue_text(issue: tuple[float, float]) -> str:
    return (f"{issue[0]:.4f} ms (median of 7 runs of 40 calls; one run of "
            f"20 calls: {issue[1]:.4f} ms)")


# instructions each redesigned kernel's SASS must hold: (all of, any of)
SASS_WANTS = {
    "flash_attention": (("HGMMA", "UTMALDG"), ()),
    "mamba2_scan": ((), ("HMMA", "HGMMA")),
    "rwkv6_scan": ((), ("HMMA", "HGMMA")),
}
# kernel functions that must hold instructions in their own SASS: library
# -> {a part of the function's name: all of}
SASS_FUNCTION_WANTS = {
    "flash_attention": {"attn_bwd_dq_kernel": ("HGMMA", "UTMALDG"),
                        "attn_bwd_dkdv_kernel": ("HGMMA", "UTMALDG")},
}


def kernel_name(mangled: str) -> str:
    """``attn_bwd_dq_kernel<128>`` from a mangled template instance's name,
    ``dispatch_pack_kernel`` from a plain function's."""
    import re
    m = re.search(r"ILi(\d+)E", mangled)
    if not m:
        m = re.match(r"_Z(\d+)", mangled)
        return mangled[m.end():m.end() + int(m.group(1))] if m else mangled
    end = m.start()
    # the name before the template arguments is preceded by its length
    for start in range(end - 1, 0, -1):
        length = str(end - start)
        if mangled[start - len(length):start] == length:
            return f"{mangled[start:end]}<{m.group(1)}>"
    return mangled


def sass_functions(sass: str) -> dict:
    """A ``cuobjdump -sass`` listing cut at its ``Function :`` headers:
    mangled function name -> that function's SASS."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
    return out


def sass_phase() -> None:
    """Count the tensor-core and TMA instructions in the built libraries
    with ``cuobjdump -sass``, and in each function of
    ``SASS_FUNCTION_WANTS`` on its own; says "not checked" where the
    toolkit has no ``cuobjdump``, and fails where an instruction is
    missing."""
    import shutil

    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, (every, some) in SASS_WANTS.items():
        if not Path(tool).exists():
            print(f"  {name} SASS: not checked (no cuobjdump)")
            continue
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        counts = {op: sass.count(op) for op in every + some}
        print(f"  {name} SASS: {counts}")
        if not all(counts[op] for op in every) or (
                some and not any(counts[op] for op in some)):
            raise AssertionError(f"{name}: SASS lacks {every or some}")
        functions = sass_functions(sass)
        for part, ops in SASS_FUNCTION_WANTS.get(name, {}).items():
            found = {f: b for f, b in functions.items() if part in f}
            if not found:
                raise AssertionError(f"{name}: no function {part} in SASS")
            for fname, body in sorted(found.items()):
                counts = {op: body.count(op) for op in ops}
                print(f"  {name} {kernel_name(fname)} SASS: {counts}")
                if not all(counts.values()):
                    raise AssertionError(f"{kernel_name(fname)}: SASS lacks "
                                         f"{ops}")


def bound_ms(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def pack_inputs(n, h, d, dtype, *, valid_rows=None, k=None, holes=None,
                seed=0):
    """Rows, destination bitmaps (all d bits random, or k distinct of d,
    or bit 0 only when d == 1) and valid flags on the card: random, the
    first ``valid_rows``, or ``holes`` = (blocks, filled): rows off a
    transport, each of ``blocks`` received blocks filled to ``filled`` rows
    with holes behind."""
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
    if holes is not None:
        blocks, filled = holes
        valid = torch.arange(n, device="cuda") % (n // blocks) < filled
    elif valid_rows is None:
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
    # the three of one DBRX prefill MoE layer at 2 pods x 2 ep ranks (512
    # tokens a rank, capacity factor 1.25): stage 2 and stage 3 pack rows
    # received from 2 senders (about 490 of 640 and 720 of 1,600 filled);
    # phase 6 checks its own packs (factor 4) on the path
    ranked = [
        ("rank-stage1", pack_inputs(512, h, 2, bf16, valid_rows=512,
                                    seed=16), 2, 640),
        ("rank-stage2", pack_inputs(1280, h, 2, bf16, holes=(2, 490),
                                    seed=17), 2, 1600),
        ("rank-stage3", pack_inputs(3200, h, 4, bf16, holes=(2, 720),
                                    seed=18), 4, 640),
    ]
    # the three of one Kimi-K2 prefill MoE layer at 2 pods x 8 ep ranks
    # (512 tokens a rank, top-8 of 384, 24 experts a rank) at capacity
    # factors 2 (phase 7's) and 1.25 (the config's): stage 2 packs rows
    # from 2 senders (about 510 of each block filled), stage 3 rows from 8
    # relays (about 410 each, most hitting one local expert)
    kimi = []
    for cf, cp, cd, ce in ((2, 1024, 2048, 341), (1.25, 640, 800, 213)):
        kimi += [
            (f"kimi-cf{cf}-stage1", pack_inputs(512, KIMI_H, 2, bf16,
                                                valid_rows=512, seed=40),
             2, cp),
            (f"kimi-cf{cf}-stage2", pack_inputs(2 * cp, KIMI_H, 8, bf16,
                                                holes=(2, 510), seed=41),
             8, cd),
            (f"kimi-cf{cf}-stage3", pack_inputs(8 * cd, KIMI_H, 24, bf16,
                                                holes=(8, 410), k=1, seed=42),
             24, ce)]
    edge = [
        ("d31-bf16", pack_inputs(1024, 256, 31, bf16, seed=3), 31, 40),
        ("d31-f32", pack_inputs(1024, 256, 31, torch.float32, seed=4),
         31, 40),
        ("overflow", pack_inputs(4096, 128, 4, torch.float32, seed=5), 4, 100),
        ("odd-rows", pack_inputs(300, 6, 5, bf16, seed=6), 5, 70),
        # one row; more slots than kept rows (an empty tail); one slot
        # with many candidates; N not a multiple of the 2,048-row rank step
        ("n1", pack_inputs(1, 64, 3, bf16, seed=11), 3, 4),
        ("empty-tail", pack_inputs(50, 128, 2, bf16, seed=12), 2, 200),
        ("capacity1", pack_inputs(3000, 64, 7, bf16, seed=13), 7, 1),
        ("n2049", pack_inputs(2049, 64, 1, bf16, seed=15), 1, 2049),
        ("n1500", pack_inputs(1500, 256, 9, torch.float32, seed=14), 9, 700),
    ]
    for label, args, d, c in stages + decode + ranked + kimi + edge:
        check_pack(failures, label, args, d, c)
    pk = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "decode_ms": [],
          "decode_bound_ms": [], "decode_host_ms": [], "rank_ms": 0.0,
          "rank_bound_ms": 0.0, "kimi": {}}
    for label, args, d, c in stages + decode + ranked + kimi:
        tokens = args[0]
        n, width = tokens.shape
        esize = tokens.element_size()
        # bytes this data needs: the bitmap and valid flags, the rows that
        # land in some slot (read once), the packed buffer and slot map
        _, idx = ref.pack_ref(*args, d, c)
        rows_read = torch.unique(idx[idx >= 0]).numel()
        nbytes = (n * 5 + rows_read * width * esize
                  + d * c * (width * esize + 4))
        def call():
            return ops.dispatch_pack(*args, num_dests=d, capacity=c)
        ms = device_ms(call)
        issue = host_ms(call)
        plain = time_ms(lambda: ref.pack_ref(*args, d, c))
        bnd, _ = bound_ms(nbytes)
        print(f"  dispatch_pack {label} time (device): kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bnd:.4f} ms ({rows_read} rows "
              f"read, {nbytes / 1e6:.3f} MB)")
        print(f"  dispatch_pack {label} host issue per call: "
              f"{issue_text(issue)}")
        if label.startswith("kimi-"):
            cf = label.split("-")[1]
            sums = pk["kimi"].setdefault(cf, {"ms": 0.0, "plain_ms": 0.0,
                                              "bound_ms": 0.0})
            sums["ms"] += ms
            sums["plain_ms"] += plain
            sums["bound_ms"] += bnd
        elif label.startswith("rank-"):
            pk["rank_ms"] += ms
            pk["rank_bound_ms"] += bnd
        elif label.startswith("stage"):  # the kernels line: one prefill layer
            pk["ms"] += ms
            pk["plain_ms"] += plain
            pk["bound_ms"] += bnd
            # yardstick, not a port path: a device copy of the same bytes
            src = torch.empty(nbytes // 4, dtype=torch.int16, device="cuda")
            dst = torch.empty_like(src)
            print(f"  dispatch_pack {label}: a device copy_ of the same "
                  f"{nbytes / 1e6:.3f} MB moved takes "
                  f"{device_ms(lambda: dst.copy_(src)):.4f} ms")
        else:
            pk["decode_ms"].append(ms)
            pk["decode_bound_ms"].append(bnd)
            pk["decode_host_ms"].append(issue[0])

    print(f"  dispatch_pack one DBRX prefill layer at 2 pods x 2 ep ranks "
          f"(3 packs a rank): {pk['rank_ms']:.4f} ms, bound "
          f"{pk['rank_bound_ms']:.4f} ms")
    for cf, sums in pk["kimi"].items():
        print(f"  dispatch_pack one Kimi-K2 prefill layer at 2 pods x 8 ep "
              f"ranks, capacity factor {cf[2:]} (3 packs a rank): "
              f"{sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, bound "
              f"{sums['bound_ms']:.4f} ms")

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
        # a Kimi-K2 rank's prefill: one prompt, GQA groups of 8
        ("kimi", (1, 64, 8, 512, 512, 112), True, None, None),
        # a tensor-parallel rank's prefill: Mistral-NeMo over 4 model ranks
        # (8 of 32 heads, 2 of 8 kv heads), DBRX over 2 (24 of 48, 4 of 8)
        # at 2 prompts a data-parallel rank
        ("mistral-tp4", (4, 8, 2, 512, 512, 128), True, None, None),
        ("dbrx-tp2", (2, 24, 4, 512, 512, 128), True, None, None),
        ("window", (2, 4, 2, 100, 100, 128), True, 32, None),
        ("softcap", (2, 4, 2, 64, 64, 64), True, None, 30.0),
        ("cross", (2, 4, 1, 40, 72, 128), False, None, None),
        ("noncausal", (1, 2, 2, 130, 130, 64), False, None, None),
        ("causal-ragged", (2, 4, 2, 200, 200, 128), True, None, None),
        ("all-masks", (1, 4, 2, 96, 160, 128), True, 48, 20.0),
        # edges of the 128-row q and kv tiles
        ("ragged-112", (2, 8, 2, 300, 300, 112), True, None, None),
        ("cross-112-g1", (2, 4, 1, 77, 333, 112), False, None, None),
        ("q-short", (1, 4, 4, 129, 257, 64), False, None, None),
        ("window-long", (1, 4, 2, 700, 700, 128), True, 150, None),
    ]
    attn_err = 0.0
    rank_shapes = {}
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
        if label in ("dbrx", "zamba2", "kimi", "mistral-tp4", "dbrx-tp2"):
            b, hq, g, sq, t, d = shape
            ms = device_ms(lambda: ops.flash_attention(q, k, v, **kw))
            plain = time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                            iters=5)
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            issue = host_ms(lambda: ops.flash_attention(q, k, v, **kw))
            nbytes = 2 * (2 * b * hq * sq * d + 2 * b * g * t * d)
            flops = 4 * b * hq * d * (sq * (sq + 1) // 2)   # causal pairs
            bnd, by = bound_ms(nbytes, flops)
            print(f"  flash_attention {label} time (device, CUDA graph of "
                  f"20 calls): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"scaled_dot_product_attention {lib:.4f} ms, bound "
                  f"{bnd:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP); kernel/sdpa {ms / lib:.2f}")
            print(f"  flash_attention {label} host issue per call: "
                  f"{issue_text(issue)}")
            if label == "dbrx":       # the kernels line: DBRX's shape
                attn_err = err
                fa_ms, fa_plain, fa_lib, fa_bound, fa_by = \
                    ms, plain, lib, bnd, by
            elif label != "zamba2":
                rank_shapes[label] = dict(
                    shape=list(shape), ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=lib, max_abs_err=err)
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")
    rows = {
        "dispatch_pack": dict(
            name="dispatch_pack", route="cuda",
            source="src/repro_torch/kernels/csrc/dispatch_pack.cu",
            replaces="src/repro/kernels/dispatch_pack.py:97",
            max_abs_err=0.0, ms=pk["ms"], plain_ms=pk["plain_ms"],
            bound_ms=pk["bound_ms"], bound_by="bytes", library_ms=None,
            decode_ms=max(pk["decode_ms"]),
            decode_bound_ms=max(pk["decode_bound_ms"]),
            decode_host_ms=max(pk["decode_host_ms"]),
            rank_stages_ms=pk["rank_ms"],
            rank_stages_bound_ms=pk["rank_bound_ms"],
            kimi_rank_stages=pk["kimi"]),
        "flash_attention": dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:112",
            max_abs_err=attn_err, ms=fa_ms, plain_ms=fa_plain,
            bound_ms=fa_bound, bound_by=fa_by, library_ms=fa_lib,
            rank_shapes=rank_shapes),
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


def rwkv6_fast_decay_inputs(rows, s, seed):
    """The card test's fast decays: logw = -exp(1.5 N(0, 1)), so a 32-step
    chunk of logw sums far below fp32's exp range."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = (rn(rows, s, 64).to(torch.bfloat16) for _ in range(3))
    logw = -torch.exp(rn(rows, s, 64) * 1.5)
    return r, k, v, logw, rn(rows, 64) * 0.3


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
    from repro_torch.kernels.rwkv6_scan import PLAIN_CHUNK, rwkv6_scan_plain

    failures: list = []
    rows = {}
    # Zamba2-7B prefill: 4 sequences x 112 heads of 64, ds 64, one B/C
    # group per sequence
    for label, (batch, heads, s, groups) in (
            ("zamba2", (4, 112, 512, "shared")),
            ("ragged", (4, 112, 500, "shared")),
            ("per-head", (2, 16, 300, "per-head")),
            # edges of the 64-step chunk, and heads that do not pair up
            ("s1", (2, 4, 1, "shared")),
            ("s63", (2, 4, 63, "shared")),
            ("s65", (2, 3, 65, "per-head")),
            ("odd-heads", (2, 3, 130, "shared"))):
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
        ms = device_ms(lambda: ops.mamba2_scan(*args))
        issue = host_ms(lambda: ops.mamba2_scan(*args))
        plain = time_ms(lambda: mamba2_scan_plain(*args), iters=5)
        dh, ds = x.shape[-1], b.shape[-1]
        nbytes = (x.numel() * 2 * 2 + dt.numel() * 4 + (a.numel() + d.numel())
                  * 4 + (b.numel() + c.numel()) * 2 + n * ds * dh * 4)
        chunks = -(-s // MQ)
        tri = MQ * (MQ + 1) // 2        # causal pairs of a chunk
        flops = 2 * n * chunks * (tri * ds + tri * dh + 2 * MQ * ds * dh)
        bnd, by = bound_ms(nbytes, flops)
        print(f"  mamba2_scan zamba2 time (device): kernel {ms:.4f} ms, "
              f"plain (chunked) {plain:.4f} ms, bound {bnd:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        print(f"  mamba2_scan zamba2 host issue per call: {issue_text(issue)}")
        rows["mamba2_scan"] = dict(
            name="mamba2_scan", route="cuda",
            source="src/repro_torch/kernels/csrc/mamba2_scan.cu",
            replaces="src/repro/kernels/mamba2_scan.py:100",
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
            bound_by=by, library_ms=None)
    # RWKV6-7B prefill: 4 sequences x 64 heads of 64; then the edges of the
    # kernel's 64-step chunk and 16-step sub-chunks, no decay (logw = 0),
    # and decays fast enough that one 32-step chunk of logw sums below -89
    # (the reference's factorised chunked form overflows there)
    for label, (batch, heads, s) in (
            ("rwkv6", (4, 64, 512)), ("ragged", (4, 64, 500)),
            ("s1", (2, 4, 1)), ("s15", (2, 4, 15)), ("s17", (2, 4, 17)),
            ("s63", (2, 4, 63)), ("s65", (2, 4, 65)),
            ("no-decay", (2, 4, 130)), ("fast-decay", (6, 1, 100))):
        if label == "fast-decay":
            args = rwkv6_fast_decay_inputs(batch, s, seed=4)
        else:
            args = scan_inputs_rwkv6(batch, heads, s, seed=21)
        if label == "no-decay":
            args[3].zero_()
        r, k, v, logw, u = args
        chunk_sum = logw[:, :PLAIN_CHUNK].sum(dim=1).min().item()
        print(f"  rwkv6_scan {label}: most negative first-chunk sum of "
              f"logw {chunk_sum:.2f}")
        if label == "fast-decay" and not chunk_sum < -89.0:
            raise AssertionError("rwkv6_scan fast-decay: decays too slow")
        exp = ref.rwkv6_ref(r.float(), k.float(), v.float(), logw, u,
                            return_final=True)
        err = _check_scan(failures, "rwkv6_scan", label,
                          ops.rwkv6_scan(*args), exp)
        if label != "rwkv6":
            continue
        ms = device_ms(lambda: ops.rwkv6_scan(*args))
        issue = host_ms(lambda: ops.rwkv6_scan(*args))
        plain = time_ms(lambda: rwkv6_scan_plain(*args), iters=5)
        n, _, dk = r.shape
        dv = v.shape[-1]
        nbytes = ((r.numel() + k.numel() + v.numel()) * 2 + logw.numel() * 4
                  + u.numel() * 4 + v.numel() * 2 + n * dk * dv * 4)
        # the work of the chunked form at the reference's chunk of 32,
        # whatever tile the kernel takes
        q = PLAIN_CHUNK
        chunks = -(-s // q)
        low = q * (q - 1) // 2          # strictly-lower pairs of a chunk
        flops = 2 * n * chunks * (low * dk + q * dk + (low + q) * dv
                                  + 2 * q * dk * dv)
        bnd, by = bound_ms(nbytes, flops)
        print(f"  rwkv6_scan rwkv6 time (device): kernel {ms:.4f} ms, "
              f"plain (chunked) {plain:.4f} ms, bound {bnd:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        print(f"  rwkv6_scan rwkv6 host issue per call: {issue_text(issue)}")
        # one block (one row) an SM, then two, as the serving shape's 256
        # rows run: twice the time means the second block found no idle
        # issue slots, so more warps an SM would not help
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        occ = [device_ms(lambda a=scan_inputs_rwkv6(1, m * sms, 512, seed=22):
                         ops.rwkv6_scan(*a)) for m in (1, 2)]
        print(f"  rwkv6_scan occupancy: {sms} rows (one block an SM) "
              f"{occ[0]:.4f} ms, {2 * sms} rows (two an SM) {occ[1]:.4f} ms,"
              f" ratio {occ[1] / occ[0]:.3f}")
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
    # Kimi-shaped: head_dim 112 with 8 q heads over 1 kv head, a dense first
    # layer, 24 experts (a rank's share at 2 x 8) top-8 at the config's
    # capacity factor, and one shared expert
    kimi = get_config("kimi_k2_1t")
    compare_small_model("Kimi-shaped", kimi.reduced(
        d_model=896, n_heads=8, n_kv_heads=1, d_ff=512, vocab=1024,
        num_experts=24, top_k=8, moe_d_ff=256,
        moe_capacity=kimi.moe_capacity), seed=12)
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

    def card_dispatch(tokens, ids, gates, dcfg, mesh, **kw):
        out = dispatch(tokens, ids, gates, dcfg, mesh, **kw)
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
    print(f"  small {cfg.name} model, {label} ({cfg.n_layers} layers, "
          f"{cfg.first_k_dense} dense, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads / {cfg.n_kv_heads} kv of {cfg.head_dim}, top-"
          f"{cfg.top_k} of {cfg.num_experts}, {cfg.n_shared_experts} shared "
          f"expert(s), capacity factor {cfg.moe_capacity}): card bf16 vs "
          f"CPU fp32 "
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

def launch_counts(**counts) -> dict:
    """A launch count for every kernel op of ``ops.KERNEL_OPS`` (the
    backward kernels' included): ``counts``, zero for the rest.  The ranks'
    counts are ``ops.launches()`` of their own processes."""
    from repro_torch.kernels import ops
    want = dict.fromkeys(ops.launches(), 0)
    want.update(counts)
    return want


def expected_launches(cfg, forwards: int) -> dict:
    """Kernel launches of one ``generate``: ``forwards`` = 1 prefill plus
    the decode rounds.  Attention and the scans run at prefill only; the
    dispatch pack runs three times per MoE layer in every forward."""
    from repro_torch.models.ssm import n_shared_calls
    want = launch_counts()
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
    """One model served at full width through ``ServeEngine.generate``,
    decode replayed from a CUDA graph: a warm-up call, the measured call
    (its first decode round eager, the second captured, the rest
    replayed), a second call of the same shape (every round a replay of
    the same graph, the logits kept), and an eager loop of
    ``model.prefill`` / ``model.decode`` with argmax on the same prompts
    and a fresh cache.  Gates: exact launch counts in all three, greedy
    tokens equal, ``captures >= 1`` and ``replays == rounds -
    eager_rounds`` in the measured call, no capture in the second.  DBRX
    also serves a continuous stream (:func:`continuous_phase`).  Returns
    the kernel launches of the measured call."""
    import numpy as np
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
    graph = engine.stats["decode_graph"]
    print(f"  decode mode: {graph['mode']} ({graph['reason']})")
    if graph["mode"] != "graph":
        raise AssertionError(f"one rank on CUDA decodes {graph['mode']}")
    torch.cuda.reset_peak_memory_stats()
    want = expected_launches(cfg, forwards=MAX_NEW)
    rounds = MAX_NEW - 1

    before = dict(graph)
    ops.reset_launches()
    out = engine.generate(prompts)
    counts = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = engine.stats
    captured = {key: graph[key] - before[key]
                for key in ("captures", "replays", "eager_rounds",
                            "capture_s")}
    if out.shape != (PROMPTS, MAX_NEW):
        raise AssertionError(f"generate returned {out.shape}")
    if not ((out >= 0) & (out < cfg.vocab)).all():
        raise AssertionError("token ids out of vocab range")
    if st["nonfinite_logits"]:
        raise AssertionError(f"{st['nonfinite_logits']} steps with "
                             f"non-finite logits")
    print(f"  launches during generate: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    print(f"  decode graph, measured call: {captured['captures']} "
          f"capture(s) in {captured['capture_s'] * 1e3:.3f} ms (host), "
          f"{captured['replays']} replays, {captured['eager_rounds']} eager "
          f"round(s) of {rounds}")
    if captured["captures"] < 1 or \
            captured["replays"] != rounds - captured["eager_rounds"]:
        raise AssertionError(f"decode graph counts {captured} over {rounds} "
                             f"rounds")
    decode_ms = st["decode_s"] * 1e3 / rounds
    total_s = st["prefill_s"] + st["decode_s"]
    print(f"  generate [{PROMPTS} x {PROMPT_LEN}] -> {list(out.shape)}: "
          f"prefill {st['prefill_s'] * 1e3:.3f} ms, decode "
          f"{decode_ms:.3f} ms/token (one eager round and the capture "
          f"included), {PROMPTS * MAX_NEW / total_s:.1f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB")
    print(f"  first tokens: {out[:, :8].tolist()}")

    # the same shape again: its slot's graph replays every round; the
    # logits are kept (a host copy a round, as the eager loop keeps them)
    engine.stats.update(prefill_s=0.0, decode_s=0.0)
    before = dict(graph)
    ops.reset_launches()
    again, kept = generate_keeping_logits(engine, prompts)
    counts2 = ops.launches()
    replayed = graph["replays"] - before["replays"]
    graph_ms = engine.stats["decode_s"] * 1e3 / rounds
    if counts2 != want or graph["captures"] != before["captures"] or \
            replayed != rounds or not np.array_equal(again, out):
        raise AssertionError(f"second call: launches {counts2}, "
                             f"{graph['captures'] - before['captures']} "
                             f"captures, {replayed} replays, tokens equal "
                             f"{np.array_equal(again, out)}")

    # the eager loop: the model's own prefill and decode, argmax
    eager, eager_ms, eager_counts = eager_loop(engine, prompts)
    gap = max(((g - e).abs().max() / e.abs().max()).item()
              for g, e in zip(kept, eager["logits"]))
    same = np.array_equal(eager["tokens"], out)
    print(f"  graph vs eager loop: tokens {'equal' if same else 'DIFFER'} "
          f"over {MAX_NEW}; logits max gap {gap:.3e} of max |logit| over "
          f"{MAX_NEW} steps; decode {graph_ms:.3f} ms/token replayed "
          f"against {eager_ms:.3f} eager (both keep the logits on the "
          f"host); launches of the loop {eager_counts}")
    if not same:
        raise AssertionError("graph decode tokens differ from the eager "
                             "loop's")
    if eager_counts != want:
        raise AssertionError(f"eager loop launches {eager_counts} != {want}")
    if arch == "dbrx_132b":
        continuous_phase(engine, cfg)
    # the engine's plan binder calls back into the engine: a cycle, which
    # only the collector frees (with the weights it holds)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def generate_keeping_logits(engine, prompts):
    """``engine.generate(prompts)`` with each sampling step's logits kept
    on the host.  Returns (tokens, logits by step)."""
    kept = []
    sample = engine._sample

    def keep(state):
        kept.append(state.logits.float().cpu())
        return sample(state)
    engine._sample = keep
    try:
        return engine.generate(prompts), kept
    finally:
        del engine._sample


def eager_loop(engine, prompts):
    """Greedy decoding by the engine's model directly: ``prefill`` on a
    fresh cache, then ``MAX_NEW - 1`` calls of ``decode``, argmax after
    each, every step's logits kept on the host.  Returns ({"tokens",
    "logits"}, decode ms a token, the kernel launches)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    model, params = engine.model, engine.params
    ops.reset_launches()
    logits_kept = []
    with torch.inference_mode():
        cache = model.init_cache(len(prompts), PROMPT_LEN + MAX_NEW)
        logits, _ = model.prefill(
            params, {"tokens": torch.from_numpy(prompts).cuda()}, cache)
        tok = torch.argmax(logits, dim=-1)
        logits_kept.append(logits.float().cpu())
        toks = [tok.cpu()]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(MAX_NEW - 1):
            logits, _ = model.decode(
                params, {"tokens": tok.to(torch.int32)[:, None]}, cache)
            tok = torch.argmax(logits, dim=-1)
            logits_kept.append(logits.float().cpu())
            toks.append(tok.cpu())
        ms = (time.monotonic() - t0) * 1e3 / (MAX_NEW - 1)
    tokens = torch.stack(toks, dim=1).numpy().astype(np.int32)
    return {"tokens": tokens, "logits": logits_kept}, ms, ops.launches()


def continuous_phase(engine, cfg) -> None:
    """DBRX on one rank through ``launch.serve.serve_continuous``: seeded
    Poisson arrivals (``CONTINUOUS``) under planner admission on ``2x8``
    at capacity 4, which forms cohorts of unequal size; every request must
    complete.  Prints the report (times on the scheduler's virtual clock:
    the planner's predicted collective times), the measured walls and the
    graph slots captured."""
    import argparse

    from repro_torch.launch.serve import serve_continuous
    graph = engine.stats["decode_graph"]
    before = dict(graph)
    args = argparse.Namespace(smoke=False, fabric="2x8", prompts=4,
                              tpot_slo_us=None, ttft_slo_us=None, seed=0,
                              **CONTINUOUS)
    rep = serve_continuous(args, cfg, engine, None)
    print(f"  continuous: {rep['completed']}/{args.requests} completed in "
          f"{rep['iterations']} iterations, max in flight "
          f"{rep['max_in_flight']}, admission holds "
          f"{rep['admission_holds']}; virtual TTFT p50/p99 "
          f"{rep['ttft_p50_s'] * 1e3:.3f}/{rep['ttft_p99_s'] * 1e3:.3f} ms, "
          f"TPOT p50/p99 {rep['tpot_p50_s'] * 1e6:.1f}/"
          f"{rep['tpot_p99_s'] * 1e6:.1f} us; measured walls prefill "
          f"{rep['wall']['prefill_s'] * 1e3:.3f} ms, decode "
          f"{rep['wall']['decode_s'] * 1e3:.3f} ms; graph slots captured "
          f"{graph['captures'] - before['captures']}, replays "
          f"{graph['replays'] - before['replays']}, eager rounds "
          f"{graph['eager_rounds'] - before['eager_rounds']}")
    if rep["completed"] != args.requests or rep["pending"]:
        raise AssertionError(f"continuous run: {rep}")


# ---------------------------------------------------------------------------
# phase 6: DBRX over 4 ranks, 2 pods x 2 ep ranks
# ---------------------------------------------------------------------------

def ranks_phase(cf: float = RANKS_CF, trace: str | None = None) -> dict:
    """DBRX-132B (4 layers) served over 4 spawned ranks, 2 pods x 2 ep
    ranks with 4 experts each, at capacity factor ``cf``.

    Runs, in order: the three fixed scheme pairs at one chunk; the
    hierarchical pair at G = 4 chunks; one run under the plan of
    ``build_collective_program`` for prefill and decode, bound on the
    fabric the ranks measured (over nccl: the per-pair rate of one
    ``all_to_all_single`` at the stage-1 prefill size, ``2x2@R:R``; over
    gloo nothing is measured and the planner scores on the reference's
    mesh-derived default); and its twin, the fixed run at the (scheme,
    combine, G) the plan resolved for prefill.  The ranks also report the planner's decisions
    on that fabric and on the same fabric with its pod link slowed to 12.5
    GB/s, and the host time of one ``moe_pipeline_kwargs`` call.

    Gates: every rank's tokens, launch counts (from each run's resolved
    G), finite logits, every pack of each run's warm-up (a prefill and a
    decode step at the measured shapes, chunked ones included) bit-exact
    against its plain version, the same plan on every rank, and MultiWrite's
    pod-group bytes below the baseline's.  At ``cf`` = num_experts / top_k
    = 4 no stage of either path drops a (token, expert) pair, so also: the
    three pairs give the same tokens, the 4-rank logits are within
    ``REF_TOL`` of a one-rank run of the same weights, the G = 4 run parts
    from the first run only at near ties, and the planned run from its
    twin.  Below that the paths drop different pairs (drop priority
    follows the order of arrival, and a chunk's capacity is its own), so
    the one-rank run and the other configurations are no reference (a
    planned run and its twin still agree), and only the ranks are held
    to each other.  ``trace`` names a file for a ``torch.profiler`` trace of
    one G = 4 prefill layer (on the card, every rank traced, rank 0's
    written).  Returns the kernel launches of the measured runs, summed
    over ranks and runs."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.launch import ranks
    from repro_torch.launch.serve import make_prompts, serve_config
    from repro_torch.models.api import build_model
    from repro_torch.runtime.server import ServeConfig

    cfg = dataclasses.replace(serve_config("dbrx_132b", layers=4,
                                           smoke=False), moe_capacity=cf)
    exact = cf >= cfg.num_experts / cfg.top_k
    world = RANKS[0] * RANKS[1]
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= world else "gloo"
    where = ("nccl, one card a rank over NVLink: no pod link is slower"
             if backend == "nccl" else
             f"gloo, {world} processes on one card, host-staged transport: "
             f"no fabric measured")
    print(f"  {cards} card(s): {world} ranks over {where}; capacity factor "
          f"{cf}")
    prompts = make_prompts(cfg, PROMPTS, PROMPT_LEN, seed=0)

    if exact:
        # the one-rank reference: the same weights, capacity factor, prompts
        model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        one = ranks.RecordingEngine(model, model.init(gen),
                                    ServeConfig(max_new_tokens=MAX_NEW),
                                    device="cuda")
        expected = one.generate(prompts)
        one_logits = one.step_logits      # [B, V] at each of MAX_NEW steps
        # the same model one prompt at a time: how far the bf16 products at
        # a rank's shapes (512 rows, not 2,048) move the logits on their own
        with torch.inference_mode():
            alone = torch.cat([model.prefill(
                one.params,
                {"tokens": torch.from_numpy(prompts[i:i + 1]).cuda()},
                model.init_cache(1, PROMPT_LEN))[0].float().cpu()
                for i in range(PROMPTS)])
        shape_rel = ((alone - one_logits[0]).abs().max()
                     / one_logits[0].abs().max()).item()
        del one, model
        gc.collect()                    # the engine's binder cycle
        torch.cuda.empty_cache()
    else:
        print(f"  capacity factor {cf} < {cfg.num_experts // cfg.top_k}: the "
              f"paths drop different pairs, so no one-rank run is a "
              f"reference; only the ranks are held to each other")

    # the stage-1 send buffer of one prefill dispatch a rank: P x Cp rows
    stage1 = ranks.link_probe_bytes(cfg, PROMPTS * PROMPT_LEN // world,
                                    *RANKS)
    nccl = backend == "nccl"
    runs = ranks.fixed_runs() + [
        dict(scheme="hierarchical", combine="hierarchical",
             microbatch=PIPE_G),
        dict(label="planned", policy="auto",
             fabric="measured" if nccl else None, bind=True),
        dict(label="planned-fixed", twin="planned")]
    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(world=world, pods=RANKS[0], ep=RANKS[1], backend=backend,
                    device="cuda:0", init_method=f"file://{tmp}/store",
                    timeout_s=120, out_dir=f"{tmp}/out", threads=2, cfg=cfg,
                    dtype=torch.bfloat16, cache_dtype=torch.bfloat16, seed=0,
                    prompts=prompts, max_new=MAX_NEW, runs=runs, warmup=True,
                    measure_link=stage1 if nccl else None,
                    continuous=RANKS_CONTINUOUS,
                    decide=(["measured", "measured-pod:12.5"] if nccl
                            else [None]),
                    trace=(dict(run=ranks.run_label(runs[3]), path=trace)
                           if trace else None))
        t0 = time.monotonic()
        results = ranks.run_ranks(ranks.serve_worker, spec, timeout_s=900)
    print(f"  {world} ranks spawned, served and joined in "
          f"{time.monotonic() - t0:.1f} s; peak memory a rank "
          f"{max(r['peak_gb'] for r in results):.2f} GB")

    failures = report_planner(results, world)
    found, total, walls = check_served(results, runs, cfg, MAX_NEW, where,
                                       exact)
    failures += found
    failures += check_decode_mode(results, backend)
    failures += check_continuous(results)
    r0 = results[0]
    labels = [ranks.run_label(run) for run in runs]
    pairs = labels[:3]
    first = r0["runs"][labels[0]]["tokens"]
    g4 = labels[3]
    print(f"  {g4} against {labels[0]}: prefill {walls[g4][0]:.3f} against "
          f"{walls[labels[0]][0]:.3f} ms, decode {walls[g4][1]:.3f} against "
          f"{walls[labels[0]][1]:.3f} ms/token")
    if trace:
        for label, w in r0["layer_walls"].items():
            print(f"  one MoE layer at the prefill rows, {label}, rank 0: "
                  f"host issue {w['issue_ms']:.3f} ms, wall "
                  f"{w['wall_ms']:.3f} ms (medians of 5)")
        tr = r0["trace"]
        print(f"  trace of one {g4} prefill layer, rank 0 ({trace}): "
              f"{tr['kernels']} kernels, {tr['launch_calls']} "
              f"cudaLaunchKernel calls; exchange kernels "
              f"{tr['exchange_us']:.1f} us on streams "
              f"{tr['exchange_streams']}, GEMMs {tr['gemm_us']:.1f} us on "
              f"streams {tr['gemm_streams']}; exchange time overlapped by "
              f"GEMMs {tr['overlap_us']:.1f} us")

    if exact:
        # (b) against the one-rank run: prefill logits, then greedy tokens
        # up to each row's first difference, which must be a near tie
        ranked_logits = torch.cat([r["runs"][pairs[0]]["prefill_logits"]
                                   for r in results])
        ref = one_logits[0]
        rel = ((ranked_logits - ref).abs().max() / ref.abs().max()).item()
        print(f"  last-position prefill logits, 4 ranks vs one: {rel:.3e} "
              f"of max |logit| (limit {REF_TOL}); one rank, a prompt at a "
              f"time vs four at once: {shape_rel:.3e}")
        if not rel < REF_TOL:
            failures.append(f"prefill logits off by {rel:.3e}")
        equal, worst_gap = ranks.near_ties(range(PROMPTS), first, expected,
                                           one_logits)
        print(f"  tokens vs one rank: {equal} of {PROMPTS} "
              f"rows equal over {MAX_NEW} tokens; rows that part do so at a "
              f"near tie of the one-rank logits, widest gap "
              f"{worst_gap:.3e} of max |logit| (limit {REF_TOL})")
        if worst_gap > REF_TOL:
            failures.append(f"a token parts from the one-rank run "
                            f"{worst_gap:.3e} below its best logit")
    if failures:
        raise AssertionError(f"phase 6: {failures}")
    return total


# ---------------------------------------------------------------------------
# phase 7: Kimi-K2-1T over 16 ranks, 2 pods x 8 ep ranks
# ---------------------------------------------------------------------------

def kimi_phase(layers: int, max_new: int) -> dict:
    """Kimi-K2-1T at full width with its depth cut to ``layers`` (the dense
    first layer, then MoE layers of 384 experts top-8 and one shared
    expert) served over 16 spawned gloo ranks, 2 pods x 8 ep ranks of 24
    experts, laid over the cards present in blocks.  This process makes the
    non-expert weights once a card and hands them to that card's ranks as
    CUDA IPC handles; each rank draws only its own experts.  One prompt of
    512 tokens a rank, ``max_new`` greedy tokens, capacity factor 2 (the
    least at which neither pair's stage 1 or 2 can drop a pair).

    Runs, in order: the three fixed scheme pairs at one chunk; a run under
    the planner's plan for prefill and decode on gloo's mesh-derived
    default fabric; and its twin, fixed at the plan's prefill triple.
    Each run's warm-up (a prefill and a decode step) holds every pack
    against its plain version.  Gates: those of :func:`check_served` (every
    rank's tokens and plan equal, finite logits, exact launch counts,
    every pack bit-exact, MultiWrite's pod-group bytes below the
    baseline's in whole buffers and occupied rows), no rank holding a copy
    of the shared weights, the twin's prefill logits within ``REF_TOL``
    of the planned run's, and, where no run drops a (token, expert) pair
    at prefill, the pairs' prefill logits within ``REF_TOL`` of each
    other.  Prints the planner's decisions, the pairs each run drops, the
    most loaded expert, each rank's memory and the card's free memory.
    Returns the kernel launches of the measured runs, summed over ranks and
    runs."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.launch import ranks
    from repro_torch.launch.serve import make_prompts, serve_config

    cfg = dataclasses.replace(serve_config("kimi_k2_1t", layers=layers,
                                           smoke=False),
                              moe_capacity=KIMI_CF)
    world = KIMI_RANKS[0] * KIMI_RANKS[1]
    cards = torch.cuda.device_count()
    where = (f"gloo, {world} processes over {cards} card(s), host-staged "
             f"transport: no fabric measured")
    print(f"  {cfg.name}: {cfg.n_layers} layers ({cfg.first_k_dense} "
          f"dense), d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv (head_dim {cfg.head_dim}), {cfg.num_experts}"
          f" experts top-{cfg.top_k}, d_ff {cfg.expert_d_ff}, "
          f"{cfg.n_shared_experts} shared expert, vocab {cfg.vocab}; {where};"
          f" capacity factor {cfg.moe_capacity}, {max_new} new tokens")
    prompts = make_prompts(cfg, world, KIMI_PROMPT_LEN, seed=0)
    runs = ranks.fixed_runs() + [
        dict(label="planned", policy="auto", bind=True),
        dict(label="planned-fixed", twin="planned")]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(world=world, pods=KIMI_RANKS[0], ep=KIMI_RANKS[1],
                    backend="gloo", device="cuda",
                    init_method=f"file://{tmp}/store", timeout_s=300,
                    out_dir=f"{tmp}/out", threads=1, cfg=cfg,
                    dtype=torch.bfloat16, cache_dtype=torch.bfloat16, seed=0,
                    prompts=prompts, max_new=max_new, runs=runs, warmup=True,
                    decide=[None])
        t0 = time.monotonic()
        shared = ranks.shared_weights(spec)
        shared_gb = {str(dev): sum(t.numel() * t.element_size()
                                   for t in weights.values()) / 1e9
                     for dev, weights in shared.items()}
        free = [torch.cuda.mem_get_info(c)[0] / 1e9 for c in range(cards)]
        print(f"  non-expert weights made once a card: {shared_gb} GB in "
              f"{time.monotonic() - t0:.1f} s; free on the card(s) before "
              f"the ranks start: {[round(f, 3) for f in free]} GB")
        results = ranks.run_ranks(ranks.serve_worker, spec, timeout_s=900,
                                  shared=shared)
        del shared
        torch.cuda.empty_cache()
    print(f"  {world} ranks spawned, served and joined in "
          f"{time.monotonic() - t0:.1f} s; this process holds "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB after them")
    failures = report_planner(results, world)
    failures += check_kimi(results, runs, cfg, max_new)
    found, total, _ = check_served(results, runs, cfg, max_new, where,
                                   exact=False)
    failures += found
    if failures:
        raise AssertionError(f"phase 7: {failures}")
    return total


def check_kimi(results: list, runs: list, cfg, max_new: int) -> list:
    """Phase 7's own gates and prints (memory, drops, expert load, prefill
    logits across the pairs and against the twin).  Returns the
    failures."""
    import numpy as np

    from repro_torch.launch import ranks
    failures = []
    for r in results:
        mem = r["memory"]
        print(f"  rank {r['rank']} on {r['device']}: weights "
              f"{mem['all_gb']:.2f} GB, its experts {mem['experts_gb']:.2f} "
              f"GB, allocated by the rank after building them "
              f"{mem['own_gb']:.2f} GB (reserved {mem['reserved_gb']:.2f}); "
              f"card free once all ranks built {mem['card_free_gb']:.2f} GB;"
              f" peak {r['peak_gb']:.2f} GB")
        # the shared weights were opened, not copied: the rank allocated
        # little beyond its experts
        if mem["own_gb"] > mem["experts_gb"] + 1.0:
            failures.append(f"rank {r['rank']} allocated {mem['own_gb']:.2f}"
                            f" GB for {mem['experts_gb']:.2f} GB of experts")
    labels = [ranks.run_label(run) for run in runs]
    moe_layers = cfg.n_layers - cfg.first_k_dense
    dropped = {}
    for label in labels:
        res = results[0]["runs"][label]["resolved"]
        per_call = np.array([r["runs"][label]["pairs"] for r in results]
                            ).sum(axis=0)            # [calls, (given, kept)]
        pre = moe_layers * res["prefill"][2]
        given, kept = per_call[:pre, 0].sum(), per_call[:pre, 1].sum()
        dgiven, dkept = per_call[pre:, 0].sum(), per_call[pre:, 1].sum()
        dropped[label] = (int(given - kept), int(dgiven - dkept))
        print(f"  {label}: (token, expert) pairs dropped over all ranks: "
              f"prefill {given - kept} of {given}, decode {dgiven - dkept} "
              f"of {dgiven} over {max_new - 1} steps")
    load = sum(r["runs"][labels[0]]["expert_load"] for r in results)
    mean = load.sum() / cfg.num_experts
    # an expert's slots at prefill, as moe.balanced_capacities sizes them
    slots = round(KIMI_PROMPT_LEN * cfg.top_k * len(results)
                  / cfg.num_experts * cfg.moe_capacity)
    print(f"  expert load of the first prefill MoE layer ({labels[0]}): max "
          f"{load.max()} against a mean of {mean:.1f} (ratio "
          f"{load.max() / mean:.3f}), min {load.min()}; {slots} slots an "
          f"expert")

    def logits(label):
        return np.concatenate([r["runs"][label]["prefill_logits"].numpy()
                               for r in results])

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    # the pairs drop as many pairs at each expert, but not the same ones
    # (drops follow the order of arrival), so they are held to each other
    # only where no run drops a pair at prefill
    exact = not any(pre for pre, _ in dropped.values())
    first = logits(labels[0])
    for label in labels[1:3]:
        gap = rel(logits(label), first)
        mine = results[0]["runs"][label]["tokens"]
        equal = sum(np.array_equal(a, b) for a, b in zip(
            mine, results[0]["runs"][labels[0]]["tokens"]))
        print(f"  {label} vs {labels[0]}: prefill logits {gap:.3e} of max "
              f"|logit|, {equal} of {len(mine)} rows' tokens equal (limit "
              f"{REF_TOL}{'' if exact else ', not gated: prefill drops'})")
        if exact and not gap < REF_TOL:
            failures.append(f"{label}: prefill logits off by {gap:.3e}")
    gap = rel(logits("planned-fixed"), logits("planned"))
    print(f"  prefill logits, planned-fixed vs planned: {gap:.3e} of max "
          f"|logit| (limit {REF_TOL})")
    if not gap < REF_TOL:
        failures.append(f"planned-fixed: prefill logits off by {gap:.3e}")
    return failures

# ---------------------------------------------------------------------------
# phase 8: tensor parallelism over the model axis
# ---------------------------------------------------------------------------

def tp_spec(tmp: str, mesh: tuple, backend: str, cfg, runs: list,
            **kw) -> dict:
    """A phase 8 spec for :func:`ranks.serve_worker` over ``mesh``."""
    import torch
    pods, ep, tp = mesh
    return dict(world=pods * ep * tp, pods=pods, ep=ep, tp=tp,
                backend=backend, device="cuda:0",
                init_method=f"file://{tmp}/store", timeout_s=300,
                out_dir=f"{tmp}/out", threads=2, cfg=cfg,
                dtype=torch.bfloat16, cache_dtype=torch.bfloat16, seed=0,
                max_new=MAX_NEW, runs=runs, warmup=True, **kw)


def tp_phase() -> dict:
    """Tensor parallelism over 4 spawned ranks: nccl with a card a rank
    where there are 4 cards, else gloo with all ranks on card 0.

    Mistral-NeMo-12B at full width over (1, 1, 4), 4 prompts x 512 tokens,
    32 new, greedy, seed 0 (``TP_DEPTH``: 40 layers on four cards, cut on
    one card): ``tp_subgroups`` 1 (a plain gather of the sequence at each
    block), 2 fixed (MultiWrite paired relaying at the analytic split) and
    2 under ``plan_policy="auto"`` with the serve program's plan bound (the
    planner's decision for the gather site printed), against a one-rank
    run of the same weights; and the split-TP gather alone at the served
    fragment ([4, 128, 5120] bf16 a rank).  Then DBRX-132B (4 layers) over
    (1, 2, 2), 8 experts a data rank, half of each expert's hidden width a
    model rank, capacity factor 4, with ``moe_deferred_tp_reduce`` off and
    on.

    Gates: within a run every rank's tokens equal; the three Mistral runs
    give the same bits (logits at every step, tokens); their tokens match
    the one-rank run's up to near ties (phase 6's gate: prefill logits
    within ``REF_TOL`` of max |logit|, a row parts only at a gap below it);
    the gather alone bit-exact against the plain ``all_gather`` under every
    scheme; DBRX's deferred run equals its per-expert run up to near ties,
    and every pack of the warm-ups is bit-exact; exact launch counts;
    decode eager over gloo, graphed over nccl (captures and replays
    counted).  Returns the kernel launches of the measured runs, summed
    over ranks and runs."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch import ranks
    from repro_torch.launch.serve import make_prompts, serve_config
    from repro_torch.models.api import build_model
    from repro_torch.runtime.server import ServeConfig

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 4 else "gloo"
    depth = TP_DEPTH[4 if cards >= 4 else 1]
    cfg = serve_config("mistral_nemo_12b", layers=depth, smoke=False)
    where = ("nccl, one card a rank" if backend == "nccl" else
             "gloo, 4 processes on one card, host-staged transport: the "
             "walls time the host's copies")
    print(f"  {cards} card(s): 4 ranks over {where}; Mistral-NeMo-12B at "
          f"full width, depth {depth} of 40"
          + ("" if depth == 40 else " (cut on one card to stay within the "
             "script's time)"))
    prompts = make_prompts(cfg, PROMPTS, PROMPT_LEN, seed=0)

    # the one-rank reference: the same weights (each rank draws every
    # tensor whole from the same seed and keeps its block)
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    one = ranks.RecordingEngine(model, model.init(gen),
                                ServeConfig(max_new_tokens=MAX_NEW),
                                device="cuda")
    torch.cuda.empty_cache()
    one.generate(prompts, max_new=2)    # the first call's one-time costs
    one.step_logits.clear()
    one.stats.update(prefill_s=0.0, decode_s=0.0)
    torch.cuda.reset_peak_memory_stats()
    expected = one.generate(prompts)
    one_logits = list(one.step_logits)
    walls = (one.stats["prefill_s"], one.stats["decode_s"])
    one.stats.update(prefill_s=0.0, decode_s=0.0)
    one.generate(prompts)               # the same shape: every round replayed
    print(f"  one rank, after a warm-up call: prefill {walls[0] * 1e3:.3f} "
          f"ms, decode {walls[1] * 1e3 / (MAX_NEW - 1):.3f} ms/token (a "
          f"second call, every round replayed: "
          f"{one.stats['decode_s'] * 1e3 / (MAX_NEW - 1):.3f}); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    one.close()
    del one, model
    gc.collect()                        # the engine's binder cycle
    torch.cuda.empty_cache()

    runs = [dict(label="tp_subgroups=1", tp_subgroups=1),
            dict(label="tp_subgroups=2 fixed", tp_subgroups=2),
            dict(label="tp_subgroups=2 auto", tp_subgroups=2, policy="auto",
                 bind=True)]
    frag = (PROMPTS, PROMPT_LEN // 4, cfg.d_model)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        results = ranks.run_ranks(ranks.serve_worker, tp_spec(
            tmp, TP_MESH, backend, cfg, runs, prompts=prompts,
            gather=dict(shape=frag, reps=5)), timeout_s=900)
    print(f"  4 ranks spawned, served and joined in "
          f"{time.monotonic() - t0:.1f} s")
    failures = check_decode_mode(results, backend)
    total: dict = {}
    labels = [run["label"] for run in runs]
    r0 = results[0]
    for r in results:
        mem = r["memory"]
        print(f"  rank {r['rank']} on {r['device']}: weights "
              f"{mem['all_gb']:.2f} GB, peak {r['peak_gb']:.2f} GB")
    g = r0["gather"]
    print(f"  split-TP gather alone, {g['shape']} bf16 a rank "
          f"({g['bytes'] / 1e6:.2f} MB), 2 domains of 2: walls ({backend}"
          f"{', host-staged' if backend == 'gloo' else ''}; median of 5, "
          f"the slowest rank's) " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in g["wall_ms"].items())
          + f"; the planner picks {g['plan']} (mode {g['mode']}, split "
          f"{g['split']})")
    for r in results:
        if not all(r["gather"]["exact"].values()):
            failures.append(f"rank {r['rank']}: gather not bit-exact "
                            f"{r['gather']['exact']}")
    want = launch_counts(dispatch_pack=0, flash_attention=cfg.n_layers)
    for label in labels:
        runs_ = [r["runs"][label] for r in results]
        run0 = runs_[0]
        if not all(np.array_equal(run["tokens"], run0["tokens"])
                   for run in runs_):
            failures.append(f"{label}: ranks returned different tokens")
        for r, run in zip(results, runs_):
            if run["launches"] != want:
                failures.append(f"{label} rank {r['rank']}: launches "
                                f"{run['launches']} != {want}")
            if run["nonfinite_logits"]:
                failures.append(f"{label} rank {r['rank']}: non-finite")
            for name, n in run["launches"].items():
                total[name] = total.get(name, 0) + n
        if label != labels[0]:
            same = all(run["same_logits"] for run in runs_) and \
                np.array_equal(run0["tokens"], r0["runs"][labels[0]]["tokens"])
            print(f"    {label} vs {labels[0]}: logits at every step and "
                  f"tokens {'bit-identical' if same else 'DIFFER'}")
            if not same:
                failures.append(f"{label}: not the bits of {labels[0]}")
        st = max(runs_, key=lambda run: run["prefill_s"])
        line = (f"  {label}: prefill {st['prefill_s'] * 1e3:.3f} ms, decode "
                f"{st['decode_s'] * 1e3 / (MAX_NEW - 1):.3f} ms/token (the "
                f"slowest rank's)")
        if st["replay_decode_s"] is not None:
            line += (f"; a second call, every round replayed: "
                     f"{st['replay_decode_s'] * 1e3 / (MAX_NEW - 1):.3f} "
                     f"ms/token")
        g = run0["decode_graph"]
        line += (f"; decode {g['mode']}: {g['captures']} captures, "
                 f"{g['replays']} replays, {g['eager_rounds']} eager rounds")
        decision = run0["split_tp"]
        if decision:
            line += (f"; gather site planned: {decision['plan']} predicted "
                     f"{decision['predicted_us']:.1f} us vs baseline "
                     f"{decision['baseline_us']:.1f} us")
        print(line)
        if label.endswith("auto") and decision is None:
            failures.append(f"{label}: no split-TP gather decision")
    ranked = r0["runs"][labels[0]]
    ref = one_logits[0]
    rel = ((ranked["prefill_logits"] - ref).abs().max()
           / ref.abs().max()).item()
    equal, gap = ranks.near_ties(range(PROMPTS), ranked["tokens"], expected,
                                 one_logits)
    print(f"  4 ranks vs one: last-position prefill logits {rel:.3e} of max "
          f"|logit| (limit {REF_TOL}); {equal} of {PROMPTS} rows' tokens "
          f"equal over {MAX_NEW}; a row parts at a gap of {gap:.3e} at most "
          f"(limit {REF_TOL})")
    if not rel < REF_TOL or gap > REF_TOL:
        failures.append(f"4 ranks vs one: logits {rel:.3e}, gap {gap:.3e}")
    del results
    gc.collect()

    # DBRX, 4 layers, over (1, 2, 2): TP inside the experts
    dbrx = dataclasses.replace(serve_config("dbrx_132b", layers=4,
                                            smoke=False), moe_capacity=RANKS_CF)
    runs = [dict(label="per-expert all_reduce", deferred=False),
            dict(label="deferred all_reduce", deferred=True)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        results = ranks.run_ranks(ranks.serve_worker, tp_spec(
            tmp, DBRX_TP_MESH, backend, dbrx, runs,
            prompts=make_prompts(dbrx, PROMPTS, PROMPT_LEN, seed=0)),
            timeout_s=900)
    print(f"  DBRX-132B, 4 layers, over (1, 2, 2), capacity factor "
          f"{RANKS_CF}: 4 ranks spawned, served and joined in "
          f"{time.monotonic() - t0:.1f} s")
    failures += check_decode_mode(results, backend)
    moe_layers = dbrx.n_layers - dbrx.first_k_dense
    want = launch_counts(dispatch_pack=moe_layers * 3 * MAX_NEW,
                            flash_attention=dbrx.n_layers)
    for run in runs:
        label = run["label"]
        runs_ = [r["runs"][label] for r in results]
        run0 = runs_[0]
        if not all(np.array_equal(x["tokens"], run0["tokens"])
                   for x in runs_):
            failures.append(f"{label}: ranks returned different tokens")
        packs = [p for x in runs_ for p in x["packs"]]
        exact = all(p[-1] for p in packs)
        if not packs or not exact:
            failures.append(f"{label}: packs {len(packs)}, bit-exact {exact}")
        for r, x in zip(results, runs_):
            if x["launches"] != want or x["resolved"]["prefill"] != (
                    "hierarchical", "hierarchical", 1):
                failures.append(f"{label} rank {r['rank']}: launches "
                                f"{x['launches']} != {want}, resolved "
                                f"{x['resolved']}")
            for name, n in x["launches"].items():
                total[name] = total.get(name, 0) + n
        st = max(runs_, key=lambda x: x["prefill_s"])
        line = (f"  {label}: prefill {st['prefill_s'] * 1e3:.3f} ms, decode "
                f"{st['decode_s'] * 1e3 / (MAX_NEW - 1):.3f} ms/token; "
                f"{len(packs)} packs of the warm-ups, "
                f"{'all bit-exact' if exact else 'NOT bit-exact'}; peak "
                f"{max(r['peak_gb'] for r in results):.2f} GB a rank")
        if label != runs[0]["label"]:
            equal = sum(x["vs"]["rows_equal"] for x in runs_) // 2
            gap = max(x["vs"]["widest_gap"] for x in runs_)
            line += (f"; tokens vs {runs[0]['label']}: {equal} of {PROMPTS} "
                     f"rows equal, widest near-tie gap {gap:.3e} (limit "
                     f"{REF_TOL})")
            if gap > REF_TOL:
                failures.append(f"{label}: a token parts {gap:.3e} below")
        print(line)
    if failures:
        raise AssertionError(f"phase 8: {failures}")
    return total


def report_planner(results: list, world: int) -> list:
    """Print the link the ranks timed (if any) and the planner's decisions
    with the host time of one ``moe_pipeline_kwargs`` call; every rank must
    have reached the same decisions.  Returns the failures."""
    failures = []
    r0 = results[0]
    if "link" in r0:
        link = r0["link"]
        print(f"  link: all_to_all_single of {link['bytes']} bytes a rank "
              f"over the {world} ranks: {link['pair_rate'] / 1e9:.3f} GB/s "
              f"a pair (10 exchanges back to back, the median of 3 rounds, "
              f"the slowest rank's) -> fabric "
              f"{link['fabric']}")
    else:
        print("  link: no fabric measured (gloo stages every exchange "
              "through the host); the planner scores on the reference's "
              "default, the mesh-derived topology")
    for dec in r0["decisions"]:
        host = dec["host_us"]
        print(f"  planner on {dec['fabric']} [{dec['fingerprint']}] (model "
              f"decision): " + "; ".join(
                  f"{ph} {d['scheme']}+{d['combine']} G={d['microbatch']}, "
                  f"modelled serial {d['serial_s'] * 1e6:.1f} us, pipelined "
                  f"{d['pipelined_s'] * 1e6:.1f} us"
                  for ph, d in dec["phases"].items()))
        print(f"    one moe_pipeline_kwargs call, host: bound plan "
              f"{host['bound'][0]:.1f} us first, {host['bound'][1]:.1f} us "
              f"repeated; ad-hoc auto {host['auto'][0]:.1f} us first, "
              f"{host['auto'][1]:.1f} us repeated")
    for r in results:
        if [d["fingerprint"] for d in r["decisions"]] != \
                [d["fingerprint"] for d in r0["decisions"]]:
            failures.append(f"rank {r['rank']}: other planner decisions")
    return failures


def check_served(results: list, runs: list, cfg, max_new: int, where: str,
                 exact: bool, pairs: list | None = None
                 ) -> tuple[list, dict, dict]:
    """The gates of a served ranks phase, over every rank's results of each
    run: (a) every rank returns the same global tokens and resolves the
    same plan; (c) where ``exact`` (no stage of any run drops a pair) the
    three fixed scheme pairs give the same tokens, and a further run parts
    from the one it is held against only at near ties; (d) exact launch
    counts from each run's resolved G, finite logits, and every pack of the
    warm-up run bit-exact against its plain version; a twin runs its
    plan's prefill triple; (e) the occupied pod-group bytes of the first
    prefill dispatch equal ``dispatch_pod_bytes``, and MultiWrite's are
    below the baseline's in whole buffers and occupied rows.  ``pairs``:
    the labels of the fixed scheme pairs (default: the first three runs'),
    MultiWrite's first and the baseline's last.  Prints each run's plan,
    packs, walls and bytes.  Returns (failures, the kernel
    launches summed over ranks and runs, the walls by run label)."""
    import numpy as np

    from repro_torch.launch import ranks
    failures: list = []
    total: dict = {}
    r0 = results[0]
    moe_layers = cfg.n_layers - cfg.first_k_dense
    rows = len(r0["runs"][ranks.run_label(runs[0])]["tokens"])
    labels = [ranks.run_label(run) for run in runs]
    pairs = pairs or labels[:3]
    first = r0["runs"][labels[0]]["tokens"]
    packs = {"hierarchical": 3, "baseline": 2}   # packs a dispatch chunk
    walls = {}
    for label in labels:
        runs_ = [r["runs"][label] for r in results]
        res = runs_[0]["resolved"]
        if any(run["resolved"] != res or run["plan"] != runs_[0]["plan"]
               for run in runs_):
            failures.append(f"{label}: ranks resolved different plans")
        (ps, pc, pg), (ds, dc, dg) = res["prefill"], res["decode"]
        print(f"  {label}: prefill {ps}+{pc} G={pg}, decode {ds}+{dc} "
              f"G={dg}" + (f" (plan {runs_[0]['plan']})"
                           if runs_[0]["plan"] else ""))
        # (a) every rank returns the same global tokens
        if not all(np.array_equal(run["tokens"], runs_[0]["tokens"])
                   for run in runs_):
            failures.append(f"{label}: ranks returned different tokens")
        # (c) the three scheme pairs give the same tokens
        if exact and label in pairs and \
                not np.array_equal(runs_[0]["tokens"], first):
            failures.append(f"{label}: tokens differ from {labels[0]}")
        # (d) exact launch counts on each rank
        want = launch_counts(
            dispatch_pack=moe_layers * (packs[ps] * pg
                                        + packs[ds] * dg * (max_new - 1)),
            flash_attention=cfg.n_layers)
        warm = moe_layers * (packs[ps] * pg + packs[ds] * dg)
        for r, run in zip(results, runs_):
            if run["launches"] != want:
                failures.append(f"{label} rank {r['rank']}: launches "
                                f"{run['launches']} != {want}")
            if run["nonfinite_logits"]:
                failures.append(f"{label} rank {r['rank']}: non-finite "
                                f"logits")
            if len(run["packs"]) != warm:
                failures.append(f"{label} rank {r['rank']}: "
                                f"{len(run['packs'])} packs checked, not "
                                f"{warm}")
            for name, n in run["launches"].items():
                total[name] = total.get(name, 0) + n
        # every pack of the warm-up run (a prefill and a decode step, the
        # shapes of the measured run) against pack_ref on the same inputs
        shapes: dict = {}
        for run in runs_:
            for n, valid, d, c, ok in run["packs"]:
                lo, hi, same = shapes.get((n, d, c), (valid, valid, True))
                shapes[(n, d, c)] = (min(lo, valid), max(hi, valid),
                                     same and ok)
        for (n, d, c), (lo, hi, ok) in shapes.items():
            print(f"    dispatch_pack N={n} ({lo}-{hi} rows valid) D={d} "
                  f"C={c} on the path, all ranks: "
                  f"{'bit-exact' if ok else 'MISMATCH'} against pack_ref")
            if not ok:
                failures.append(f"{label}: dispatch_pack N={n} D={d} C={c}")
        st = max(runs_, key=lambda run: run["prefill_s"])
        walls[label] = (st["prefill_s"] * 1e3,
                        st["decode_s"] * 1e3 / (max_new - 1))
        print(f"    prefill {walls[label][0]:.3f} ms, decode "
              f"{walls[label][1]:.3f} ms/token (the slowest rank's walls; "
              f"{where}); launches a rank {runs_[0]['launches']}")
        if runs_[0]["replay_decode_s"] is not None:
            replay = max(run["replay_decode_s"] for run in runs_)
            print(f"    decode of a second call of the same shape, every "
                  f"round a graph replay: {replay * 1e3 / (max_new - 1):.3f} "
                  f"ms/token (the slowest rank's)")
        # the G = 4 run against the first and the plan's twin against the
        # planned run: rows equal, and a row that parts does so at a near
        # tie of the other run's logits
        if label not in pairs and not runs[labels.index(label)].get("bind"):
            against = runs_[0]["vs"]["run"]
            equal = sum(run["vs"]["rows_equal"] for run in runs_)
            gap = max(run["vs"]["widest_gap"] for run in runs_)
            print(f"    tokens vs {against}: {equal} of {rows} rows "
                  f"equal over {max_new} tokens; widest near-tie gap "
                  f"{gap:.3e} of max |logit| (limit {REF_TOL}"
                  f"{'' if exact else ', not gated where pairs drop'})")
            if exact and gap > REF_TOL:
                failures.append(f"{label}: a token parts from "
                                f"{against} {gap:.3e} below its best logit")
        twin = runs[labels.index(label)].get("twin")
        if twin is not None:
            # the twin runs the plan's prefill triple; its decode (one row
            # a rank, so G = 1) may take another scheme pair, and at G = 1
            # the pairs give the same bits (gate c)
            plan = r0["runs"][twin]["resolved"]
            print(f"    fixed at the plan's prefill {plan['prefill']}; "
                  f"decode {res['decode']} for the plan's {plan['decode']}")
            if res["prefill"] != plan["prefill"] or \
                    res["decode"][2] != 1 or plan["decode"][2] != 1:
                failures.append(f"{label}: resolved {res}, the plan {plan}")
        # (e) pod-group bytes of the first prefill dispatch (chunk 0 at G > 1)
        for r, run in zip(results, runs_):
            b = run["pod_bytes"]
            kind = "multiwrite" if ps == "hierarchical" else "baseline"
            analytic = (f"; dispatch_pod_bytes {run['analytic_pod_bytes']}"
                        if run["pod"] == 0 else "")
            print(f"    rank {r['rank']} (pod {run['pod']}): pod-group "
                  f"bytes of the first prefill dispatch: {b['whole']} whole "
                  f"buffers, {b['occupied']} occupied rows{analytic}")
            if run["pod"] == 0 and b["occupied"] != \
                    run["analytic_pod_bytes"][kind]:
                failures.append(f"{label} rank {r['rank']}: occupied pod "
                                f"bytes {b['occupied']} != dispatch_pod_bytes")
    for r in results:
        mw = r["runs"][pairs[0]]["pod_bytes"]
        base = r["runs"][pairs[-1]]["pod_bytes"]
        ok = all(mw[key] < base[key] for key in ("whole", "occupied"))
        print(f"  rank {r['rank']}: multiwrite {mw} vs baseline {base} pod-"
              f"group bytes: {'multiwrite < baseline' if ok else 'NOT LESS'}")
        if not ok:
            failures.append(f"rank {r['rank']}: multiwrite pod bytes not "
                            f"below the baseline's")
    return failures, total, walls


def check_decode_mode(results: list, backend: str) -> list:
    """Every rank's engines decode by the rule: eager over gloo (its
    exchanges are staged through the host), a CUDA graph over nccl.
    Returns the failures."""
    want = "graph" if backend == "nccl" else "eager"
    failures = []
    modes = {(run["decode_graph"]["mode"], run["decode_graph"]["reason"])
             for r in results for run in r["runs"].values()}
    for mode, reason in sorted(modes):
        print(f"  decode over {backend}: {mode} ({reason})")
        if mode != want:
            failures.append(f"decode {mode} over {backend}, not {want}")
    if want == "graph":
        for r in results:
            for label, run in r["runs"].items():
                g = run["decode_graph"]
                if g["captures"] < 1:
                    failures.append(f"{label} rank {r['rank']}: no capture")
    return failures


def check_continuous(results: list) -> list:
    """The ranks' continuous run (``RANKS_CONTINUOUS``, planner admission
    with the plan bound for one row a rank): every request completed, the
    same report and tokens on every rank, at least one plan swap when the
    batch crossed a bucket, and no cold retrace.  Returns the failures."""
    failures = []
    c0 = results[0]["continuous"]
    rep = c0["report"]
    g = c0["decode_graph"]
    print(f"  continuous over the ranks: {rep['completed']}/"
          f"{RANKS_CONTINUOUS['requests']} completed in {rep['iterations']} "
          f"iterations, max in flight {rep['max_in_flight']}, bucket "
          f"{c0['bound_bucket']} bound at the end; plan prefetches "
          f"{rep['prefetch_rebinds']}, swaps {rep['plan_swaps']}, cold "
          f"retraces {rep['cold_retraces']}; virtual TTFT p50/p99 "
          f"{rep['ttft_p50_s'] * 1e3:.3f}/{rep['ttft_p99_s'] * 1e3:.3f} ms, "
          f"TPOT p50/p99 {rep['tpot_p50_s'] * 1e6:.1f}/"
          f"{rep['tpot_p99_s'] * 1e6:.1f} us; measured walls (rank 0) "
          f"prefill {c0['wall']['prefill_s'] * 1e3:.3f} ms, decode "
          f"{c0['wall']['decode_s'] * 1e3:.3f} ms; decode {g['mode']}: "
          f"{g['captures']} captures, {g['replays']} replays, "
          f"{g['eager_rounds']} eager rounds")
    if rep["completed"] != RANKS_CONTINUOUS["requests"] or rep["pending"]:
        failures.append(f"continuous: {rep['completed']} completed")
    if rep["plan_swaps"] < 1 or rep["cold_retraces"] != 0:
        failures.append(f"continuous: {rep['plan_swaps']} swaps, "
                        f"{rep['cold_retraces']} cold retraces")
    for r in results[1:]:
        c = r["continuous"]
        same = {key: c["report"][key] for key in ("completed", "plan_swaps",
                                                  "iterations")} == \
            {key: rep[key] for key in ("completed", "plan_swaps",
                                       "iterations")}
        if not same or c["tokens"] != c0["tokens"]:
            failures.append(f"continuous: rank {r['rank']} differs")
    return failures


# ---------------------------------------------------------------------------
# phase 9: the telemetry loop on the card
# ---------------------------------------------------------------------------

def report_calibration(results: list, title: str) -> list:
    """Print one live calibration of the ranks (``ranks.live_calibration``
    reports): each record's predicted and measured us, the fits, the drift
    at fit and the calibrated model against the datasheet.  Gates: every
    rank's walls the same bits, no probe failed (after its retries, the
    checking pass included), every checked pack bit-exact.  Returns the
    failures."""
    import numpy as np
    failures = []
    cal = results[0]["calibration"]
    print(f"  {title}: {len(cal['records'])} records on {cal['fabric']}, "
          f"the monitor's cycle {cal['wall_s']:.1f} s (rank 0)")
    for rec in cal["records"]:
        print(f"    {rec['op']}/{rec['plan']} {rec['payload_bytes']:.0f} B: "
              f"predicted {rec['predicted_s'] * 1e6:.1f} us, measured "
              f"{rec['measured_s'] * 1e6:.1f} us ({rec['bottleneck_role']})")
    for name, f in cal["fits"].items():
        print(f"    fit {name}: {f['bw_gbps']:.3f} GB/s, alpha "
              f"{f['alpha_us']:.1f} us, r2 {f['r2']}, {f['n_used']} points"
              f" ({f['n_rejected']} rejected), "
              + ("trusted" if f["trusted"] else f"untrusted: {f['reason']}"))
    rates = {k: round(v / 1e9, 3) for k, v in cal["link_bw"].items()}
    print(f"    drift at fit {100 * cal['drift']:.1f}% (by op "
          + ", ".join(f"{op} {100 * v:.1f}%"
                      for op, v in cal["drift_by_op"].items())
          + f"); {cal['measured_links']} link rates fitted, GB/s {rates}; "
          f"alpha_base {cal['alpha_base'] * 1e6:.2f} us; the calibrated "
          f"model {'differs from' if cal['hw'] != cal['default'] else 'is'} "
          f"the datasheet")

    def bits(r):
        return [np.float64(rec["measured_s"]).tobytes()
                for rec in r["calibration"]["records"]]
    for r in results:
        if bits(r) != bits(results[0]):
            failures.append(f"{title}: rank {r['rank']} measured other "
                            f"walls")
        if r["calibration"]["failures"]:
            failures.append(f"{title}: rank {r['rank']}: "
                            f"{r['calibration']['failures']} probes failed")
        if not all(ok for *_, ok in r["calibration"]["packs"]):
            failures.append(f"{title}: rank {r['rank']}: a probe's pack "
                            f"differs from pack_ref")
    packs = [p for r in results for p in r["calibration"]["packs"]]
    if packs:
        print(f"    probe packs (an unrecorded checking pass of the MoE "
              f"sweeps): {len(packs)} over the ranks, "
              f"{sum(ok for *_, ok in packs)} bit-exact against pack_ref")
    return failures


def calibrate_phase() -> dict:
    """The telemetry loop on the card, over 4 spawned ranks (nccl with a
    card a rank where there are 4 cards, else gloo on card 0).

    DBRX-132B (4 layers, full width) over 2 pods x 2 ep ranks, capacity
    factor 4, a prompt of 512 tokens a rank: every rank runs one startup
    calibration (``ranks.live_calibration``, the steps of
    ``telemetry.startup_calibration`` with a ``LiveProbe`` over the rank
    mesh) on the topology the context's planner scores on: the dispatch
    and the combine, both plans each, at ``CAL_TOKENS`` tokens a rank of
    the model's own token bytes, and the directed rail probes; then the
    serve program planned on the datasheet and on the store's fitted model
    (``calibration=``), and DBRX served under the calibrated plan, its
    fixed twin and the fixed hierarchical and baseline pairs at G = 1.
    Then Mistral-NeMo-12B's model axis over (1, 1, 4): a ``LiveProbe``
    sweep of the AllGather plans on the split-TP topology, the planner's
    split-TP pick at the served fragment on the datasheet and on the
    fitted model, the serve program planned with and without the store,
    and the gather alone at that fragment (plain, paired, full and the
    datasheet's pick).

    Gates: every rank's walls the same bits; no probe failed; every pack of
    the probes and of the served warm-ups bit-exact; DBRX's calibrated
    model differs from the datasheet (the store reached the planner's
    topology key); every rank plans and binds the same plans; the served
    runs' gates of phase 6 (the calibrated run held to its twin up to near
    ties, exact launch counts); the gather bit-exact.  Returns the kernel
    launches of the measured served runs, summed over ranks and runs."""
    import dataclasses
    import math
    import tempfile

    import torch

    from repro_torch.core.topology import split_tp_full_mesh
    from repro_torch.launch import ranks
    from repro_torch.launch.serve import make_prompts, serve_config

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 4 else "gloo"
    where = ("nccl, one card a rank" if backend == "nccl" else
             "gloo, 4 processes on one card, host-staged transport: the "
             "probes time the host's copies")
    cfg = dataclasses.replace(
        serve_config("dbrx_132b", layers=4, smoke=False),
        moe_capacity=RANKS_CF)
    token_bytes = cfg.d_model * 2
    world = RANKS[0] * RANKS[1]
    print(f"  {cards} card(s): {world} ranks over {where}")
    prompts = make_prompts(cfg, PROMPTS, PROMPT_LEN, seed=0)
    runs = ranks.fixed_runs(pairs=(ranks.SCHEME_PAIRS[0],
                                   ranks.SCHEME_PAIRS[2])) + [
        dict(label="calibrated", policy="auto", calibrated=True, bind=True),
        dict(label="calibrated-fixed", twin="calibrated")]
    labels = [ranks.run_label(run) for run in runs]
    sweep = tuple(n * token_bytes for n in CAL_TOKENS)
    calibrate = dict(ops=("dispatch", "combine"), repeats=3,
                     payloads={"dispatch": sweep, "combine": sweep},
                     check_packs=True,
                     scenario=dict(num_experts=cfg.num_experts,
                                   top_k=cfg.top_k, token_bytes=token_bytes))
    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(world=world, pods=RANKS[0], ep=RANKS[1], backend=backend,
                    device="cuda:0", init_method=f"file://{tmp}/store",
                    timeout_s=120, out_dir=f"{tmp}/out", threads=2, cfg=cfg,
                    dtype=torch.bfloat16, cache_dtype=torch.bfloat16, seed=0,
                    prompts=prompts, max_new=CAL_NEW, runs=runs, warmup=True,
                    calibrate=calibrate)
        t0 = time.monotonic()
        results = ranks.run_ranks(ranks.serve_worker, spec, timeout_s=900)
    print(f"  {world} ranks spawned, calibrated, served and joined in "
          f"{time.monotonic() - t0:.1f} s")
    failures = report_calibration(results, "DBRX over 2 x 2")
    cal = results[0]["calibration"]
    if cal["hw"] == cal["default"]:
        failures.append("DBRX: the calibrated model is the datasheet's")
    for dec in results[0]["decisions"]:
        kind = "calibrated" if dec["calibrated"] else "datasheet"
        print(f"  planner, {kind} [{dec['fingerprint']}]: " + "; ".join(
                  f"{ph} {d['scheme']}+{d['combine']} G={d['microbatch']}, "
                  f"predicted serial {d['serial_s'] * 1e6:.1f} us, pipelined "
                  f"{d['pipelined_s'] * 1e6:.1f} us"
                  for ph, d in dec["phases"].items()))
    for r in results:
        if [d["fingerprint"] for d in r["decisions"]] != \
                [d["fingerprint"] for d in results[0]["decisions"]]:
            failures.append(f"DBRX rank {r['rank']}: other plans")
    found, total, walls = check_served(results, runs, cfg, CAL_NEW, where,
                                       True, pairs=labels[:2])
    failures += found
    failures += check_decode_mode(results, backend)
    print("  walls, prefill ms / decode ms a token: " + "; ".join(
        f"{label} {walls[label][0]:.3f} / {walls[label][1]:.3f}"
        for label in labels))

    mcfg = serve_config("mistral_nemo_12b", layers=None, smoke=False)
    topo, _ = split_tp_full_mesh(TP_MESH[2], tp=TP_MESH[2] // 2)
    frag = (PROMPTS, PROMPT_LEN // TP_MESH[2], mcfg.d_model)
    with tempfile.TemporaryDirectory() as tmp:
        pods, ep, tp = TP_MESH
        spec = dict(world=pods * ep * tp, pods=pods, ep=ep, tp=tp,
                    backend=backend, device="cuda:0",
                    init_method=f"file://{tmp}/store", timeout_s=120,
                    out_dir=f"{tmp}/out", threads=2, topo=topo,
                    calibrate=dict(ops=("allgather",), repeats=3,
                                   payloads={"allgather": CAL_GATHER}),
                    gather=dict(shape=frag, reps=5),
                    split_tp=math.prod(frag) * 2,
                    program=dict(cfg=mcfg, itemsize=2, tp_subgroups=2,
                                 phases={"prefill": (PROMPTS, PROMPT_LEN),
                                         "decode": (PROMPTS, 1)}))
        t0 = time.monotonic()
        mres = ranks.run_ranks(ranks.probe_worker, spec, timeout_s=600)
    print(f"  Mistral-NeMo's model axis, {TP_MESH}: 4 ranks spawned, "
          f"probed and joined in {time.monotonic() - t0:.1f} s")
    failures += report_calibration(mres, "split-TP AllGather over (1, 1, 4)")
    m0 = mres[0]
    for name, d in m0["split_tp"].items():
        print(f"  split-TP pick at {math.prod(frag) * 2} bytes a rank, "
              f"{name}: {d['plan']} (split {d['split']}), predicted "
              f"{d['predicted_s'] * 1e6:.1f} us")
    for name, d in m0["program"].items():
        print(f"  Mistral serve program, context {name} [{d['fingerprint']}]"
              f": prefill/split_tp_gather {d['plan']} (split {d['split']}), "
              f"predicted {d['predicted_s'] * 1e6:.1f} us; the context plans "
              f"on {'a fitted' if d['hw_fitted'] else 'the datasheet'} "
              f"model")
    g = m0["gather"]
    print(f"  the gather alone, {g['shape']} bf16 a rank: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in g["wall_ms"].items())
        + f" (median of 5, the slowest rank's; planned = the datasheet's "
        f"pick {g['plan']})")
    for r in mres:
        if not all(r["gather"]["exact"].values()):
            failures.append(f"rank {r['rank']}: gather not bit-exact")
        if r["program"] != m0["program"] or r["split_tp"] != m0["split_tp"]:
            failures.append(f"Mistral rank {r['rank']}: other plans")
    if failures:
        raise AssertionError(f"phase 9: {failures}")
    return total


# ---------------------------------------------------------------------------
# phase 10: training, the backward kernels and DBRX at full width
# ---------------------------------------------------------------------------

# DBRX trained at full width with its depth cut to 2: batch 4 x 512 from
# SyntheticLM seed 0, AdamW (bf16 state) on a cosine schedule, 8 steps, a
# checkpoint after step 4 restored into a fresh trainer
TRAIN_DEPTH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 4, 512, 8, 1e-3
TRAIN_SAVE_AT = 4
GRAD_COSINE = 0.99                      # small model, bf16 card vs fp32 CPU
LOSS_GAP = 5e-2
RESTORE_RTOL = 1e-3


def _same_bits(a, b) -> bool:
    import torch
    ints = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(ints), b.view(ints))


def pack_bwd_checks(failures: list) -> dict:
    """The pack's backward kernel against its plain version (bit-exact) and
    against autograd of the plain pack (fp32 sums, 2e-2), at the three
    packs of one DBRX prefill layer of 4 x 512 tokens and at edge cases;
    the layer's three timed (kernel, plain, and ``index_add_`` of the same
    rows as the library yardstick)."""
    import torch

    from repro_torch.kernels import ops, ref
    h = 6144
    bf16 = torch.bfloat16
    layer = [
        ("stage1", pack_inputs(2048, h, 1, bf16, valid_rows=2048), 1, 2560),
        ("stage2", pack_inputs(2560, h, 1, bf16, valid_rows=2048, seed=1),
         1, 3200),
        ("stage3", pack_inputs(3200, h, 16, bf16, valid_rows=2048, k=4,
                               seed=2), 16, 640),
    ]
    edge = [   # rows in several slots, empty slots, invalid rows, one row
        ("d31-bf16", pack_inputs(1024, 256, 31, bf16, seed=3), 31, 40),
        ("d31-f32", pack_inputs(1024, 256, 31, torch.float32, seed=4),
         31, 40),
        ("overflow", pack_inputs(4096, 128, 4, torch.float32, seed=5), 4, 100),
        ("odd-rows", pack_inputs(300, 6, 5, bf16, seed=6), 5, 70),
        ("n1", pack_inputs(1, 64, 3, bf16, seed=11), 3, 4),
        ("empty-tail", pack_inputs(50, 128, 2, bf16, seed=12), 2, 200),
    ]
    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "max_abs_err": 0.0}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    for label, args, d, c in layer + edge:
        tokens, bitmap, valid = args
        n, width = tokens.shape
        _, idx = ops.dispatch_pack(tokens, bitmap, valid, num_dests=d,
                                   capacity=c)
        grad = torch.randn((d, c, width), generator=gen,
                           device="cuda").to(tokens.dtype)
        got = ops.dispatch_pack_bwd(grad, idx, n)
        exp = ref.pack_bwd_ref(grad, idx, n)
        leaf = tokens.float().requires_grad_(True)
        auto, = torch.autograd.grad(
            ref.pack_ref(leaf, bitmap, valid, d, c)[0], leaf, grad.float())
        torch.cuda.synchronize()
        exact = _same_bits(got, exp)
        err = (got.float() - auto).abs().max().item()
        near = torch.allclose(got.float(), auto, **ATTN_TOL)
        print(f"  dispatch_pack_bwd {label}: N={n} H={width} D={d} C={c} "
              f"{tokens.dtype}: {'bit-exact' if exact else 'MISMATCH'} "
              f"against the plain backward; max|err| {err:.3e} against "
              f"autograd of the plain pack ({'within' if near else 'OUTSIDE'}"
              f" atol=rtol=2e-2)")
        if not (exact and near):
            failures.append(f"dispatch_pack_bwd {label}")
        if not label.startswith("stage"):
            continue
        row["max_abs_err"] = max(row["max_abs_err"], err)
        held = idx >= 0
        slots = int(held.sum())
        esize = tokens.element_size()
        # bytes: the occupied slots' rows and the slot map read, the rows'
        # gradient written
        nbytes = slots * width * esize + d * c * 4 + n * width * esize
        ms = device_ms(lambda: ops.dispatch_pack_bwd(grad, idx, n))
        plain = time_ms(lambda: ref.pack_bwd_ref(grad, idx, n), iters=5)
        rows_in = grad.reshape(d * c, width)[held.reshape(-1)]
        index = idx[held].long()
        acc = torch.zeros((n, width), dtype=tokens.dtype, device="cuda")
        lib = device_ms(lambda: acc.index_add_(0, index, rows_in))
        bnd, _ = bound_ms(nbytes)
        print(f"  dispatch_pack_bwd {label} time (device, CUDA graph of 20 "
              f"calls): kernel {ms:.4f} ms, plain {plain:.4f} ms, index_add_ "
              f"{lib:.4f} ms, bound {bnd:.4f} ms ({nbytes / 1e6:.3f} MB)")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bnd)):
            row[key] += val
    print(f"  dispatch_pack_bwd one DBRX prefill layer (3 packs): "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, index_add_ "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    return dict(name="dispatch_pack_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/dispatch_pack.cu",
                replaces="src/repro/kernels/dispatch_pack.py:97",
                bound_by="bytes", **row)


def kernel_ms_by_name(fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, by name,
    from a ``torch.profiler`` trace of ``calls`` calls after a warm one."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.name] += evt.time_range.elapsed_us() / 1e3 / calls
    return dict(out)


# the attention backward's two passes, by a part of their kernels' names
BWD_PASSES = (("dQ", "attn_bwd_dq_kernel"), ("dK/dV", "attn_bwd_dkdv_kernel"))
# DBRX's attention heads at train_4k's sequence length: b, heads, kv heads,
# Sq, Sk, D
ATTN_BWD_LONG = (1, 48, 8, 4096, 4096, 128)


def time_attention_bwd(label: str, args: tuple, lse_ref, kw: dict) -> dict:
    """The backward kernel's device time at one causal shape, each pass's
    from a profiler trace, its host issue, the plain backward's time, the
    backward of ``scaled_dot_product_attention`` on the same q, k, v, do
    and the bound; printed and returned as a kernels-line row's numbers."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    q, k, v, out, do, lse = args
    b, hq, sq, d = q.shape
    g, t = k.shape[1], k.shape[2]

    def call():
        return ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    ms = device_ms(call)
    by_name = kernel_ms_by_name(call)
    passes = {p: sum(v for n, v in by_name.items() if part in n)
              for p, part in BWD_PASSES}
    issue = host_ms(call)
    plain_ms = time_ms(lambda: ref.attention_bwd_ref(
        q, k, v, out, do, lse_ref, **kw), iters=5, warmup=1)
    qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              enable_gqa=True)
    # the backward alone: forward and backward captured together (so the
    # backward runs on the capturing stream), less the forward
    lib = device_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), do)) \
        - device_ms(sdpa)
    # q, o, do read and dq written; k, v read and dk, dv written; the lse
    # read; the five products of the causal pairs
    nbytes = 2 * (4 * b * hq * sq * d + 4 * b * g * t * d) + 4 * b * hq * sq
    flops = 10 * b * hq * d * (sq * (sq + 1) // 2)
    bnd, by = bound_ms(nbytes, flops)
    shares = ", ".join(
        f"{p} {v:.4f} ms ({v / sum(passes.values()):.0%})" if v else
        f"{p} not measured (no device events)" for p, v in passes.items())
    print(f"  flash_attention_bwd {label} time (device, CUDA graph of 20 "
          f"calls): kernel {ms:.4f} ms (profiler: {shares}), plain "
          f"{plain_ms:.4f} ms, the backward of scaled_dot_product_attention "
          f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP); kernel/sdpa {ms / lib:.2f}, "
          f"{flops / ms / 1e9:.1f} TFLOP/s; host issue {issue_text(issue)}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib, host_ms=issue[0],
                pass_ms={p: v for p, v in passes.items()})


def dkdv_balance(shape: tuple, args: tuple, kw: dict, failures: list) -> None:
    """The dK/dV pass's balance as it ran: one call that has each block's
    two consumer warpgroups record the q steps they walked and the SM clock
    cycles they took; prints the heaviest over the mean of each (the aim
    for the steps: 1.25).  Fails if a warpgroup recorded nothing or the
    gradients differ from a call without the record."""
    import torch

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import dkdv_blocks
    b, _, g, _, t, _ = shape
    record = torch.zeros((dkdv_blocks(b, g, t, causal=kw["causal"]), 2, 2),
                         dtype=torch.int64, device="cuda")
    got = ops.flash_attention_bwd(*args, record=record, **kw)
    same = all(torch.equal(a, c) for a, c in
               zip(got, ops.flash_attention_bwd(*args, **kw)))
    steps, cycles = record[..., 0].float(), record[..., 1].float()
    print(f"  dK/dV blocks at {shape} as they ran: {record.shape[0]} blocks "
          f"of 2 consumer warpgroups on {_build.sm_count(0)} SMs; q steps a "
          f"warpgroup {int(steps.min())}-{int(steps.max())}, heaviest/mean "
          f"{(steps.max() / steps.mean()).item():.3f} (aim 1.25); cycles a "
          f"warpgroup {int(cycles.min())}-{int(cycles.max())}, heaviest/mean "
          f"{(cycles.max() / cycles.mean()).item():.3f}")
    if not same or not (cycles > 0).all():
        failures.append(f"flash_attention_bwd record at {shape}")


def attention_bwd_checks(failures: list) -> dict:
    """The attention backward kernel (and the forward's log-sum-exp)
    against the plain backward and against autograd of the plain forward,
    atol = rtol = 2e-2 of fp32, at DBRX's prefill shape and at edge cases;
    at DBRX's shape also two calls bit-identical; DBRX's shape and
    ``ATTN_BWD_LONG`` (held against the plain backward alone) timed beside
    the backward of ``scaled_dot_product_attention``, with the dK/dV
    blocks' balance as they ran."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_plain)
    bf16 = torch.bfloat16
    cases = [  # b, heads, kv heads, Sq, Sk, D, causal, window, softcap
        ("dbrx", (4, 48, 8, 512, 512, 128), True, None, None),
        ("window", (2, 4, 2, 100, 100, 128), True, 32, None),
        ("softcap-64", (2, 4, 2, 64, 64, 64), True, None, 30.0),
        ("ragged-112", (2, 8, 2, 300, 300, 112), True, None, None),
        ("all-masks", (1, 4, 2, 96, 160, 128), True, 48, 20.0),
        ("cross-112-g1", (2, 4, 1, 77, 133, 112), False, None, None),
        ("one-q-tile", (1, 2, 2, 64, 64, 64), True, None, None),
        ("long", ATTN_BWD_LONG, True, None, None),
    ]
    row = {}
    for i, (label, shape, causal, window, softcap) in enumerate(cases):
        b, hq, g, sq, t, d = shape
        gen = torch.Generator(device="cuda")
        gen.manual_seed(30 + i)

        def rand(*size):
            return torch.randn(size, generator=gen, device="cuda").to(bf16)
        q = rand(b, sq, hq, d).transpose(1, 2)
        k = rand(b, t, g, d).transpose(1, 2)
        v = rand(b, t, g, d).transpose(1, 2)
        do = rand(b, sq, hq, d).transpose(1, 2)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = _forward(q, k, v, (causal, window, softcap, None),
                            with_lse=True)
        lse_ref = ref.attention_lse(q, k, **kw)
        got = ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        plain = ref.attention_bwd_ref(q, k, v, out, do, lse_ref, **kw)
        held = [plain]
        if label != "long":   # autograd of the plain forward: 2 x the memory
            leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
            held.append(torch.autograd.grad(
                flash_attention_plain(*leaves, **kw), leaves, do.float()))
        torch.cuda.synchronize()
        lse_err = (lse - lse_ref).abs().max().item()
        errs = [(a.float() - e.float()).abs().max().item()
                for a, e in zip(got, held[-1])]
        ok = all(torch.allclose(a.float(), e.float(), **ATTN_TOL)
                 for exp in held for a, e in zip(got, exp)) and lse_err < 1e-3
        against = ("the plain backward" if label == "long" else
                   "autograd of the plain forward")
        print(f"  flash_attention_bwd {label} {shape} causal={causal} "
              f"window={window} softcap={softcap}: dq/dk/dv max|err| "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} against {against}, "
              f"forward lse {lse_err:.3e}: {'within' if ok else 'OUTSIDE'} "
              f"atol=rtol=2e-2")
        if not ok:
            failures.append(f"flash_attention_bwd {label}")
        del held, plain
        if label == "dbrx":
            again = ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            print(f"  flash_attention_bwd dbrx called twice: dq, dk, dv "
                  f"{'bit-identical' if same else 'DIFFER'}")
            if not same:
                failures.append("flash_attention_bwd: two calls differ")
            dkdv_balance(shape, (q, k, v, out, do, lse), kw, failures)
            row = dict(max_abs_err=max(errs),
                       **time_attention_bwd(label, (q, k, v, out, do, lse),
                                            lse_ref, kw))
        elif label == "long":
            dkdv_balance(shape, (q, k, v, out, do, lse), kw, failures)
            row["long"] = dict(shape=list(shape), max_abs_err=max(errs),
                               **time_attention_bwd(
                                   label, (q, k, v, out, do, lse), lse_ref,
                                   kw))
        # the long shape's plain backward holds about 20 GB of fp32 scores
        del q, k, v, do, out, lse, lse_ref, got
        torch.cuda.empty_cache()
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:112", **row)


def grad_reference_check() -> None:
    """A reduced DBRX-shaped model (head_dim 128, 4 experts all active) in
    bf16 on the card (kernels) against the same weights in fp32 on the CPU
    (plain versions): one loss and backward each; the loss within
    ``LOSS_GAP`` and every parameter's gradient at a cosine above
    ``GRAD_COSINE``."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.api import build_model
    from repro_torch.runtime.trainer import trainable

    cfg = get_config("dbrx_132b").reduced(
        d_model=512, n_heads=4, n_kv_heads=2, d_ff=256, vocab=1024,
        num_experts=4, top_k=4)
    gpu = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    params = gpu.init(gen)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu_params = T.Transformer(cfg, device="cpu", dtype=torch.float32)
    cpu_params.load_state_dict({k: v.float().cpu()
                                for k, v in params.state_dict().items()})
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                 global_batch=4, seed=0)).batch(0)
    losses = []
    ops.reset_launches()
    for model, p, dev in ((gpu, params, "cuda"), (cpu, cpu_params, "cpu")):
        trainable(p)
        loss, _ = model.loss(p, batch_for_model(cfg, raw, device=dev))
        loss.backward()
        losses.append(loss.item())
    counts = {k: v for k, v in ops.launches().items() if v}
    gap = abs(losses[0] - losses[1])
    cosines = {}
    for (name, a), (_, e) in zip(params.named_parameters(),
                                 cpu_params.named_parameters()):
        a, e = a.grad.double().cpu().flatten(), e.grad.double().flatten()
        cosines[name] = (a @ e / (a.norm() * e.norm())).item()
    worst = min(cosines, key=cosines.get)
    print(f"  small DBRX-shaped model ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, head_dim {cfg.head_dim}, {cfg.num_experts} "
          f"experts top-{cfg.top_k}), loss and backward of 4 x 64 tokens: "
          f"card bf16 {losses[0]:.5f} vs CPU fp32 {losses[1]:.5f}, gap "
          f"{gap:.3e} (limit {LOSS_GAP}); gradient cosines of "
          f"{len(cosines)} parameters, lowest {cosines[worst]:.6f} "
          f"({worst}; limit {GRAD_COSINE}); kernel launches {counts}")
    low = {k: v for k, v in cosines.items() if not v > GRAD_COSINE}
    if not gap < LOSS_GAP or low:
        raise AssertionError(f"small-model gradients: loss gap {gap:.3e}, "
                             f"cosines below {GRAD_COSINE}: {low}")
    want = {"dispatch_pack": 3 * cfg.n_layers,
            "dispatch_pack_bwd": 3 * cfg.n_layers,
            "flash_attention": cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}
    if counts != want:
        raise AssertionError(f"small model: launches {counts} != {want}")


def train_full_width() -> dict:
    """DBRX-132B at full width, depth ``TRAIN_DEPTH``, through ``Trainer``:
    ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, a
    checkpoint after step ``TRAIN_SAVE_AT``, which a fresh trainer restores
    and continues from.  Gates: finite losses and gradient norms, the mean
    loss of the last 3 steps below that of the first 3, exact launch
    counts, the restored run's losses within ``RESTORE_RTOL``.  Returns the
    kernel launches of the 8 steps."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model, param_count
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("dbrx_132b"), n_layers=TRAIN_DEPTH)
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))

    def make_batch(step):
        return batch_for_model(cfg, data.batch(step), device="cuda")

    def optimizer():
        return adamw(lr=cosine_schedule(TRAIN_LR, warmup=1,
                                        total=TRAIN_STEPS),
                     weight_decay=0.01)

    ckpt_dir = ROOT / "build" / "train_checkpoint"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def trainer(total, ckpt):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        return Trainer(model, optimizer(), make_batch, TrainerConfig(
            total_steps=total, checkpoint_every=TRAIN_SAVE_AT,
            checkpoint_dir=str(ckpt_dir) if ckpt else None, log_every=1),
            generator=gen)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.monotonic()
    tr = trainer(TRAIN_SAVE_AT, ckpt=True)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9 - before_gb
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, {cfg.num_experts} "
          f"experts top-{cfg.top_k} of d_ff {cfg.expert_d_ff}, vocab "
          f"{cfg.vocab}: {param_count(tr.state.params) / 1e9:.3f} B "
          f"parameters; bf16 parameters and AdamW state {state_gb:.2f} GB, "
          f"set up in {time.monotonic() - t0:.1f} s ({before_gb:.2f} GB "
          f"allocated before)")
    timed = {}
    save = tr.ckpt.save

    def timed_save(*args, **kw):
        t = time.monotonic()
        out = save(*args, **kw)
        timed["save_s"] = time.monotonic() - t
        return out
    tr.ckpt.save = timed_save
    ops.reset_launches()
    tr.run()                                   # steps 0-3, then the save
    save_s = timed["save_s"]
    tr.ckpt = None                             # no more saves
    tr.cfg = dataclasses.replace(tr.cfg, total_steps=TRAIN_STEPS,
                                 checkpoint_dir=None)
    tr.run()                                   # steps 4-7
    torch.cuda.synchronize()
    counts = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = tr.metrics_history
    for h in hist:
        print(f"  step {h['step']}: loss {h['loss']:.5f} (ce {h['ce']:.5f}, "
              f"aux {h['aux']:.5f}), grad norm {h['grad_norm']:.4f}, wall "
              f"{h['wall'] * 1e3:.1f} ms")
    walls = [h["wall"] for h in hist]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tps = tokens * (len(walls) - 1) / sum(walls[1:])
    print(f"  first step {walls[0] * 1e3:.1f} ms; steps 2-{len(walls)} "
          f"{sum(walls[1:]) / (len(walls) - 1) * 1e3:.1f} ms a step, "
          f"{tps:.1f} tokens/s; peak memory {peak_gb:.2f} GB "
          f"(max_memory_allocated); checkpoint of step {TRAIN_SAVE_AT} "
          f"written in {save_s:.1f} s")
    want = launch_counts(dispatch_pack=3 * cfg.n_layers * TRAIN_STEPS,
                         dispatch_pack_bwd=3 * cfg.n_layers * TRAIN_STEPS,
                         flash_attention=cfg.n_layers * TRAIN_STEPS,
                         flash_attention_bwd=cfg.n_layers * TRAIN_STEPS)
    print(f"  launches over {TRAIN_STEPS} steps: {counts} (expected {want}: "
          f"per step and layer 3 packs and 3 pack backwards, 1 attention "
          f"forward and 1 backward; nothing recomputed)")
    failures = []
    if counts != want:
        failures.append(f"launches {counts} != {want}")
    import math
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist):
        failures.append("a non-finite loss or gradient norm")
    first = sum(h["loss"] for h in hist[:3]) / 3
    last = sum(h["loss"] for h in hist[-3:]) / 3
    print(f"  mean loss of the first 3 steps {first:.5f}, of the last 3 "
          f"{last:.5f}")
    if not last < first:
        failures.append(f"the loss did not fall: {first:.5f} -> {last:.5f}")
    losses = [h["loss"] for h in hist]
    update_ms, clip_ms = time_update(tr)
    rest = sum(walls[1:]) / (len(walls) - 1) * 1e3 - update_ms - clip_ms
    print(f"  where a step's time goes: the AdamW update {update_ms:.1f} ms "
          f"and the clip {clip_ms:.1f} ms (each timed alone on the live "
          f"state, with zero gradients), the forward, backward and "
          f"cross-entropy {rest:.1f} ms (the rest of the step wall)")

    # a fresh trainer (new random weights, then the checkpoint over them)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    tr = trainer(TRAIN_STEPS, ckpt=True)
    restore_s = time.monotonic() - t0
    tr.ckpt = None                             # continue without saving
    if tr.state.step != TRAIN_SAVE_AT:
        failures.append(f"the fresh trainer resumed at step {tr.state.step}")
    tr.run()
    again = [h["loss"] for h in tr.metrics_history]
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(again, losses[TRAIN_SAVE_AT:]))
    print(f"  restored at step {TRAIN_SAVE_AT} into a fresh trainer "
          f"(set-up and restore {restore_s:.1f} s): losses "
          f"{[round(x, 5) for x in again]} against "
          f"{[round(x, 5) for x in losses[TRAIN_SAVE_AT:]]}, largest "
          f"relative gap {rel:.3e} (limit {RESTORE_RTOL})")
    if len(again) != TRAIN_STEPS - TRAIN_SAVE_AT or not rel <= RESTORE_RTOL:
        failures.append(f"restored run: {again} against "
                        f"{losses[TRAIN_SAVE_AT:]}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if failures:
        raise AssertionError(f"phase 10: {failures}")
    return counts


def time_update(tr) -> tuple[float, float]:
    """Device ms of one optimizer update and one global-norm clip of the
    trainer's live state (CUDA events around each, after a warm call),
    with zero gradients of the parameters' shapes: the same arithmetic
    as a step's."""
    import torch

    from repro_torch.optim.optimizers import clip_by_global_norm_
    named = tr.state.named()
    grads = {n: torch.zeros_like(p) for n, p in named.items()}

    def timed(fn) -> float:
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)
    with torch.no_grad():
        update = timed(lambda: tr.optimizer.apply(grads, tr.state.opt_state,
                                                  named, tr.state.step))
        clip = timed(lambda: clip_by_global_norm_(grads, 1.0))
    return update, clip


def train_phase() -> tuple[dict, dict]:
    """Phase 10.  Returns (the kernels JSON rows of the two backward
    kernels, the launches of the full-width training run)."""
    failures: list = []
    rows = {"dispatch_pack_bwd": pack_bwd_checks(failures),
            "flash_attention_bwd": attention_bwd_checks(failures)}
    if failures:
        raise AssertionError(f"backward kernels disagree: {failures}")
    grad_reference_check()
    return rows, train_full_width()


def ptxas_report(log: str) -> list:
    """(function, registers, spill stores, spill loads) of each kernel
    function in an ``nvcc -Xptxas -v`` log."""
    import re
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *spills))
            name = None
    return rows


def build_phase() -> None:
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    built = _build.build()
    print(f"  built {built or 'nothing (cached)'} in "
          f"{time.monotonic() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for fname, regs, stores, loads in ptxas_report(log):
            print(f"  {name}: {kernel_name(fname)}: {regs} registers, spill "
                  f"stores {stores} bytes, spill loads {loads} bytes")
        for line in log.splitlines():
            if "wgmma" in line and "serialized" in line:
                print(f"  {name}: {line.strip()}")


def main(argv=None) -> None:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks-only", type=float, nargs="+", metavar="CF",
                    help="phases 1, 2 and 6 only, phase 6 once at each "
                         "capacity factor given (four cards: nccl)")
    ap.add_argument("--trace", default=None,
                    help="with --ranks-only: write a torch.profiler trace "
                         "of one G = 4 prefill layer (rank 0) here")
    ap.add_argument("--kimi-only", action="store_true",
                    help="phases 1, 2 and 7 only (on four cards: depth 4 "
                         "and 32 new tokens)")
    ap.add_argument("--tp-only", action="store_true",
                    help="phases 1, 2 and 8 only (on four cards: nccl)")
    ap.add_argument("--calibrate-only", action="store_true",
                    help="phases 1, 2 and 9 only (on four cards: nccl)")
    ap.add_argument("--train-only", action="store_true",
                    help="phases 1, 2 and 10 only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")

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
    build_phase()
    depth, kimi_new = KIMI_DEPTH[4 if torch.cuda.device_count() >= 4 else 1]
    kimi_title = (f"phase 7: Kimi-K2-1T over 2 pods x 8 ep ranks, depth "
                  f"{depth}")
    tp_title = "phase 8: tensor parallelism, Mistral-NeMo-12B over (1, 1, 4)"
    cal_title = ("phase 9: the telemetry loop, DBRX over 2 x 2 and "
                 "Mistral-NeMo over (1, 1, 4) calibrated on the card")
    train_title = (f"phase 10: training, the backward kernels and "
                   f"DBRX-132B at full width, depth {TRAIN_DEPTH}")
    if args.kimi_only:
        print(kimi_title)
        kimi_phase(depth, kimi_new)
    elif args.tp_only:
        print(tp_title)
        tp_phase()
    elif args.calibrate_only:
        print(cal_title)
        calibrate_phase()
    elif args.train_only:
        print(train_title)
        rows, counts = train_phase()
        for name, row in rows.items():
            row["launches"] = counts[name]
            row["launches_by_path"] = {"dbrx_132b_train": counts[name]}
        print(json.dumps({"kernels": list(rows.values())}))
    elif args.ranks_only:
        for i, cf in enumerate(args.ranks_only):
            print(f"phase 6: DBRX over 2 pods x 2 ep ranks, capacity factor "
                  f"{cf}")
            ranks_phase(cf, trace=args.trace if i == 0 else None)
    else:
        sass_phase()
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
        print("phase 6: DBRX over 2 pods x 2 ep ranks")
        by_path["dbrx_132b_2x2_ranks"] = ranks_phase()
        print(kimi_title)
        by_path["kimi_k2_1t_2x8_ranks"] = kimi_phase(depth, kimi_new)
        print(tp_title)
        by_path["tp_ranks"] = tp_phase()
        print(cal_title)
        by_path["dbrx_132b_2x2_calibrated"] = calibrate_phase()
        print(train_title)
        bwd_rows, by_path["dbrx_132b_train"] = train_phase()
        rows.update(bwd_rows)

        for name, row in rows.items():
            row["launches"] = sum(c.get(name, 0) for c in by_path.values())
            row["launches_by_path"] = {arch: c.get(name, 0)
                                       for arch, c in by_path.items()}
        print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
