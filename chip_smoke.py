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
   backward's own kernel functions (head_dim 256's too) and wgmma in the
   Mamba2 backward's;
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
   expert), Gemma2-shaped (head_dim 256, post-norms, both softcaps, the
   32-token window on alternate layers, an 80-token prompt) and
   Qwen2-VL-shaped (M-RoPE, the embeddings input), then Zamba2-shaped
   (attention at head_dim 112) and RWKV6-shaped;
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
   4 cards, else all ranks on card 0 over the card transport: the
   exchanges through the card's memory, gloo for control; there the spawn
   first holds each of the five exchanges against gloo's on the same
   ranks at the served and trained shapes, the byte movers bit-exact, the
   sums the same bits on every member in group-rank order within the
   summation bound of the fp64 sum): the three MoE scheme pairs
   at one chunk, the hierarchical pair at G = 4 chunks, and a run under the
   planner's plan for the fabric the ranks measured, with the planner's
   decisions on that fabric and on a slow pod link; every rank's tokens
   equal, equal across the pairs and to a one-rank run up to near ties,
   exact launch counts, every pack of each warm-up bit-exact, and the
   pod-group bytes of one prefill dispatch below the baseline's; decode
   eager over the card transport (its exchanges meet at host barriers)
   and graphed over nccl;
   and a continuous run under planner admission whose batch crosses a
   bucket: every request completed, a plan swap and no cold retrace;
7. Kimi-K2-1T at full width (depth 2 on one card, 4 on four) over 16
   spawned ranks (the card transport on one card, gloo over four), 2 pods
   x 8 ep ranks of 24 experts, laid over the
   cards present, the non-expert weights made once a card and shared with
   its ranks as CUDA IPC handles: the three scheme pairs, a planned run
   and its fixed twin, one prompt of 512 tokens a rank, capacity factor 2;
   gates as phase 6's where they apply, plus the pairs each run drops and
   each rank's memory;
8. tensor parallelism over 4 spawned ranks (nccl with a card a rank where
   there are 4 cards, else the card transport on card 0): Mistral-NeMo-12B
   at full width
   over (1, 1, 4) at ``tp_subgroups`` 1, 2 fixed and 2 planned, against a
   one-rank run of the same weights, and the split-TP MultiWrite gather
   alone at the served fragment; then, on the same spawn over a mesh of
   its own, DBRX (4 layers) over (1, 2, 2) with the experts' TP
   reduction per expert and deferred.  Within a run every
   rank's tokens equal, the three Mistral runs bit-identical, near ties
   against one rank, the gather bit-exact, every pack bit-exact;
9. the telemetry loop over 4 spawned ranks (as phase 6 and 8 lay them
   out): DBRX (4 layers) over 2 x 2 calibrates with a ``LiveProbe`` (the
   dispatch and combine plans, the directed rail probes at 32 to 512 MB,
   where the card transport's rate shows beside its fixed cost), plans its serve
   program on the datasheet and on the fitted model and serves under the
   calibrated plan beside its fixed twin (their walls beside phase 6's
   fixed pairs on the same spawn and weights); Mistral-NeMo's model axis
   over (1, 1, 4) sweeps the AllGather plans and sets the planner's
   split-TP pick, datasheet against calibrated, beside the gather's
   measured walls.  Every rank's
   walls the same bits, no probe failed, the calibrated model differs
   from the datasheet, every rank binds the same plan, every pack
   bit-exact, the calibrated run's tokens its twin's up to near ties;
10. training: the four backward kernels (the pack's, attention's with the
   forward's log-sum-exp, the two scans') against their plain versions and
   against autograd of the plain forwards, at the shapes of one DBRX
   prefill layer of 4 x 512 tokens and at edge cases, timed beside
   ``index_add_`` and the backward of ``scaled_dot_product_attention``
   (attention's also each pass's device time, its host issue, two calls
   bit-identical, the dK/dV blocks' balance as they ran, and DBRX's heads
   at 4,096 tokens, held against the plain backward); attention's at
   head_dim 256, Gemma2's served shape (window 4,096 and global, softcap
   50) held slice by slice against the plain backward, at both masks
   twice bit-identical, timed (each pass from a profiler trace) beside the
   backward of ``flex_attention`` under ``torch.compile`` and beside the
   first version's time, and its edges (one row, ragged, a window under a
   tile, no mask, the cap biting); the scans' at Zamba2's and RWKV6's
   served shapes and edges (S off the chunks, one row, G = BH, three heads
   a group, a final-state gradient, fast RWKV-6 decays) against autograd
   of the fp32 per-step recurrences within 5e-2 of each gradient's max
   |value|, twice bit-identical, timed (Mamba2's beside its first
   version's time); small DBRX-, Zamba2-, RWKV6- and Gemma2-shaped
   models' loss and gradients in bf16 on the card against fp32 on the
   CPU; then DBRX-132B at full width, depth cut to 2,
   trained through ``Trainer`` for 8 steps of 4 x 512 tokens (AdamW with
   bf16 state, cosine schedule), with a checkpoint after step 4 restored
   into a fresh trainer that must reach the same losses.  Gates: finite
   losses and gradient norms, a falling loss, exact launch counts;
11. training over ranks (nccl with a card a rank where there are 4 cards,
   else 4 processes on card 0 over the card transport): a reduced DBRX
   over 2 x 2 against one rank on the card (step-0 ce and every synced
   gradient's cosine);
   DBRX-132B at full width over 2 pods x 2 ep ranks, 4 x 512 tokens
   (depth 1 and 6 steps on one card, depth 2 and 8 steps on four), FSDP
   over the data axis (the reference's default; each rank's weight,
   gradient and AdamW-state bytes and the steps' peak printed), under
   the plan bound for its train program, the ``grad_sync`` verdict
   running through ``planned_psum``, with every pack backward and
   attention backward of its first step held against their plain
   versions at the ranks' shapes and that step's gradients reduced once
   by each scheme; then
   Mistral-NeMo-12B over (1, 1, 4) at full width, depth 2, through the
   split-TP MultiWrite gather, against one rank.  Each step's wall of the
   slowest rank split by CUDA events into forward and backward, the
   gradient mean, the clip and the update.  Gates: finite losses, a
   falling DBRX loss, every replicated leaf bit-identical on every rank
   and every FSDP shard on its pod replicas, the same grad norm on every
   rank, exact launch counts, the kernels against their plain versions;
12. the decoder-only secondary families at full width and full depth,
   through ``ServeEngine.generate`` as in phase 5, random seeded weights,
   one at a time: Gemma2-9B (2 prompts x 8,160 tokens, so its 4,096-token
   windows bite and the served length reaches 8,192), StarCoder2-15B,
   Minitron-8B and Qwen2-VL-2B's backbone (4 x 512 tokens, Qwen2-VL's
   through the stub frontend), 32 new tokens each: decode graphed and an
   eager loop with equal greedy tokens, exact launch counts (42 attention
   launches a Gemma2 prefill), walls and peak memory; then Gemma2's loss
   and backward at full width and depth on the card, through the
   attention backward at head_dim 256: finite, one forward and one
   backward launch a layer;
13. the encoder-decoder, SeamlessM4T-medium at full width and depth (12
   encoder and 12 decoder layers, 0.62 B parameters): served as in phase
   12 (4 prompts x 512 tokens, 32 new; the encoder over the stub
   frontend's embeddings of the prompt, the decoder over its tokens),
   with exactly ``n_enc_layers + 2 * n_layers`` attention launches a
   prefill and ``n_layers`` a decode round (the cross-attention, one q
   row against the cache's 544 ``enc_out`` rows, replayed from the
   graph): 408 a ``generate``; then trained through ``Trainer`` for 8
   steps of 4 x 512 ``SyntheticLM`` tokens, with finite, falling losses
   and 36 attention forwards and 36 backwards a step;
14. the hybrid, rwkv and encoder-decoder families and a decoder whose kv
   heads are replicated over the model axis, served over 4 spawned
   tensor-parallel ranks (1, 1, 4) (nccl with a card a rank where there
   are 4 cards, decode graphed; else 4 processes on card 0 over the card
   transport, decode eager), one spawn serving the four one after another
   at full width, 4 prompts x 512 tokens, seed-0 random weights, greedy:
   Zamba2-7B (28 of 112 SSM heads a rank, the SSD and conv states split,
   out_norm's sum of squares summed over the ranks), RWKV6-7B (16 of 64
   heads a rank), SeamlessM4T-medium (4 of 16 heads a rank, cross-attention over the
   whole encoder output) and Qwen2-VL-2B's backbone with the KV length
   unsharded (its 2 kv heads over 4 ranks replicated); on four cards at
   full depth with 32 new tokens, on one card Zamba2 at 24 of 81 blocks
   and RWKV6 at 8 of 32 with 8 new tokens each.  Each model is held
   against a one-rank run of the same weights on the card: every rank's
   tokens equal, the prefill logits within 5e-2 of max |logit| and rows
   parting only at near ties, exact scan and attention launches on each
   rank; each rank's decode-state bytes beside one rank's.  Then the
   same ranks train Zamba2-7B at 7 blocks, RWKV6-7B at 2 and
   SeamlessM4T-medium at full width over (1, 1, 4), 4 ``Trainer`` steps
   of 4 x 512 tokens each, every step's wall printed.  Gates: finite
   losses; step 0's loss within 2e-2 of one rank's (on rank 0 of the
   spawn, the same weights); every gradient, gathered to its global
   shape, at a cosine above 0.99 to one rank's in fp32 (each rank's
   fp32 copy of its weights through the plain versions) and, where one
   rank's bf16 gradient of that leaf is conditioned, in bf16; every
   replicated leaf
   bit-identical over the ranks and one gradient norm on every rank; the
   scans' and attention's backward kernels held against their plain
   versions at the ranks' shapes; exact launches;
15. the hybrid, rwkv and Gemma2 families trained at full width, 8 steps
   of ``SyntheticLM`` tokens each from seed-0 random weights (AdamW with
   bf16 state, cosine schedule): Zamba2-7B at 24 of 81 blocks and
   RWKV6-7B at 8 of 32 through ``Trainer`` (4 x 512 tokens), Gemma2-9B at
   4 of 42 layers through ``launch.train.main`` (1 x 8,192 tokens, past
   its 4,096 window); the memory arithmetic printed beside the measured
   peak.  Gates: finite losses and gradient norms, a falling loss, exact
   launches (each scan's forward and backward kernel once a layer and
   step, attention's once a call).  The last step of each runs under
   ``torch.profiler``, which gives the device ms of the family's backward
   kernel in a step (``mamba2_scan_bwd``, ``rwkv6_scan_bwd``, attention's
   at head_dim 256), printed beside the step wall;
16. the dry run (``launch/dryrun.py``, meta tensors on the host) against
   the card: (a) DBRX at full width on a ``ShapeMesh`` of (2, 2, 1),
   4 x 512 prefill, the MultiWrite and the baseline pair: each rank's
   pod-crossing bytes of the first prefill dispatch's token exchange
   equal to phase 6's measured ``pod_bytes["whole"]`` of that rank (hard);
   (b) DBRX at depth 2 on one rank, training on 4 x 512: the weight,
   gradient and AdamW-state bytes equal to what phase 10's trainer holds
   (hard), the predicted peak (each storage counted once, split by
   category) within 10% of phase 10's ``max_memory_allocated`` (hard);
   (c) one (16, 16) ``mw`` cell of each family, its roofline line (H100
   data sheet) printed; (d) phase 11's DBRX training under FSDP on a
   ``ShapeMesh`` of (2, 2, 1), each rank: its weight, gradient and
   AdamW-state bytes equal to phase 11's rank's (hard), the predicted
   peak beside its ``max_memory_allocated`` (recorded: four processes
   share the card).  ``--train-only`` and ``--train-ranks-only`` run (b)
   and (d) after their phase.

Every phase prints its wall (``phase N took X s``) and the script ends
with all of them; each spawn of ranks prints where its wall went: spawn
and import up to the first collective, the weights, each run, and the
join, the slowest rank's; and each one-rank reference on the card its
own.

Phase 3 also holds the pack at the shapes of one DBRX prefill layer at
2 x 2 ranks and of one Kimi-K2 prefill layer at 2 x 8 (capacity factors
2 and 1.25), and attention at Kimi's rank shape (GQA groups of 8), at
the tensor-parallel rank shapes of phase 8, and at head_dim 256: Gemma2's
served prefill (q [2, 16, 8160, 256] over 8 kv heads, softcap 50, window
4,096 and global, with ``flex_attention`` under ``torch.compile`` as the
library call, the same cap and mask, and ``scaled_dot_product_attention``
without a softcap as a yardstick) and its edges (one q row, a ragged q
length, a window under one kv tile).  At every head dim it holds the
softcap where it bites (q x 10 under a cap of 50, or a cap of 3), each
case first showing that the plain version without the cap lies outside
the tolerance.  Phase 13's attention shapes are held and timed there too:
SeamlessM4T's encoder, decoder and cross-attention at 4 x 512 (head_dim
64, MHA, non-causal but the decoder's self-attention) and a decode step's
cross-attention (one q row over 544 keys), and one q row over a ragged kv
tile; phase 4 runs a small Seamless-shaped model, and phase 10 the
attention backward non-causal at head_dim 64 with MHA, at equal lengths
(timed) and with the q and kv lengths apart, and at the decoder's causal
shape beside the errors of SDPA's bf16 backward and of the plain
backward on the same inputs.  Phase 14's rank shapes are held and timed
in phase 3 as well: attention at Seamless's [4, 4, 512, 64] (non-causal,
causal, cross, and a decode step's cross), Zamba2's shared block [4, 8,
512, 112] and Qwen2-VL's [4, 3, 512, 128] over one kv head, and both
scans at the ranks' rows (4 x 28 heads of Zamba2, 4 x 16 of RWKV6).

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

runs phase 10 alone after them;

  python3 chip_smoke.py --train-ranks-only

runs phase 11 alone after them (on four cards over nccl);

  python3 chip_smoke.py --families-only

runs phase 12 alone after them;

  python3 chip_smoke.py --encdec-only

runs phase 13 alone after them;

  python3 chip_smoke.py --tp-families-only

runs phase 14 alone after them (on four cards over nccl, full depth);

  python3 chip_smoke.py --train-families-only

runs phase 15 alone after them.
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
# phase 12: (arch, prompts, prompt tokens, new tokens) at full width and
# depth; Gemma2's 2 x 8,160 prompts reach its 8,192 positions with the new
# tokens, so its 4,096-token windows bite
FAMILIES = (("gemma2_9b", 2, 8160, 32), ("starcoder2_15b", 4, 512, 32),
            ("minitron_8b", 4, 512, 32), ("qwen2_vl_2b", 4, 512, 32))
# phase 13: SeamlessM4T-medium at full width and depth, served (arch,
# prompts, prompt tokens, new tokens: the decode cache's enc_out of 544
# rows), then trained through Trainer on SyntheticLM batches of 4 x 512
# (AdamW, bf16 state, cosine schedule)
ENCDEC = ("seamless_m4t_medium", 4, 512, 32)
ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_LR = 8, 1e-4
KIMI_H = 7168                           # Kimi-K2's d_model
RANKS = (2, 2)                          # phase 6: pods x ep ranks
KIMI_RANKS = (2, 8)                     # phase 7: pods x ep ranks
KIMI_CF = 2.0                           # phase 7: capacity factor
KIMI_PROMPT_LEN = 512                   # phase 7: one prompt a rank
# phase 7's (depth, new tokens) on one card and on four
KIMI_DEPTH = {1: (2, 8), 4: (4, 32)}
RANKS_CF = 4.0                          # phases 6, 8: num_experts / top_k
# over ranks: nccl with a card a rank where there are as many cards as
# ranks, else every rank on card 0 over the card transport
# (``RankMesh(transport="card")``: the exchanges through the card's memory
# beside a gloo group for control traffic)
CARD_WHERE = ("the card transport, {world} processes on one card: "
              "exchanges through the card's memory, gloo for control")
TP_MESH = (1, 1, 4)                     # phase 8: pods x data x model
DBRX_TP_MESH = (1, 2, 2)
# phase 8's Mistral-NeMo depth and new tokens on one card and on four:
# over gloo a decode round of the 4 ranks takes about 1.1 s (80
# host-staged all-reduces), so one card decodes 8 of the 32 tokens (each
# run prints what that gives up); the one-rank reference keeps 32
TP_DEPTH = {1: 40, 4: 40}
TP_NEW = {1: 8, 4: 32}
PIPE_G = 4                              # phase 6: chunks of the G > 1 run
PROMPTS, PROMPT_LEN, MAX_NEW = 4, 512, 32
# phase 5's continuous DBRX stream: 12 requests of 512 tokens, 8 new each,
# Poisson at 500 a second of the virtual clock (cohorts of 1 to 3)
CONTINUOUS = dict(requests=12, prompt_len=512, max_new=8, arrival_rate=500.0)
# phase 6's: groups of one request a rank, a batch bucket crossed
# phase 9: the dispatch/combine probes' tokens a rank, the directed rail
# probes' bytes (above the card transport's 64 MB piece, where its rate
# shows beside the fixed cost of an exchange, about 0.8 ms with four
# processes on one card), the AllGather probes' bytes a rank (the
# reference's sweep below 64 MB), new tokens a served run
CAL_TOKENS = (32, 128, 512)
CAL_DIRECTIONS = (32 << 20, 128 << 20, 256 << 20, 512 << 20)
CAL_GATHER = (256 << 10, 1 << 20, 4 << 20, 16 << 20)
CAL_NEW = 8
RANKS_CONTINUOUS = dict(requests=12, prompt_len=512, max_new=8, rate=1e5,
                        capacity=8)
ATTN_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 kernel vs fp32 plain
# Gemma2's served prefill attention (phases 3 and 12): 2 prompts of 8,160
# tokens, 16 q heads over 8 kv heads of 256; its softcap and local window
GEMMA_ATTN = (2, 16, 8, 8160, 256)
GEMMA_SOFTCAP, GEMMA_WINDOW = 50.0, 4096
# bf16 scans vs the fp32 per-step recurrence: the reference kernel tests'
# bf16 tolerance (tests/test_kernels.py)
SCAN_TOL = dict(atol=5e-2, rtol=5e-2)
REF_TOL = 5e-2                          # of max |logit|, bf16 vs fp32 model


def ranks_backend(cards: int, world: int = 4) -> str:
    """How ``world`` ranks run on ``cards`` cards: ``"nccl"`` (a card a
    rank) or ``"card"`` (every rank on card 0 over the card transport)."""
    return "nccl" if cards >= world else "card"


def backend_keys(backend: str) -> dict:
    """A rank spec's ``backend`` (and ``transport``) for
    :func:`ranks_backend`'s answer."""
    if backend == "nccl":
        return dict(backend="nccl")
    return dict(backend="gloo", transport="card")


def spawn_split(results: list, what: str) -> None:
    """Print where the wall of one ``ranks.run_ranks`` spawn went: spawn
    and import up to the first collective (the last rank's mark "ready"),
    each stretch between the ranks' later marks (the slowest rank's), and
    the join (the last mark to every process joined)."""
    started, joined = results[0]["spawn"]
    parts, prev = [], started
    for i, (label, _) in enumerate(results[0]["marks"]):
        at = max(r["marks"][i][1] for r in results)
        name = {"ready": "spawn and import to the first collective",
                "done": "the last barrier"}.get(label, label)
        parts.append(f"{name} {at - prev:.1f}")
        prev = at
    parts.append(f"join {joined - prev:.1f}")
    print(f"  {what}: {joined - started:.1f} s = " + ", ".join(parts)
          + " s")


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
                        "attn_bwd_dkdv_kernel": ("HGMMA", "UTMALDG"),
                        # head_dim 256's passes
                        "bwd2569dq_kernel": ("HGMMA", "UTMALDG"),
                        "bwd25611dkdv_kernel": ("HGMMA", "UTMALDG")},
    "mamba2_scan": {"mamba2_bwd_kernel": ("HGMMA",)},
    "rwkv6_scan": {"rwkv6_bwd_kernel": ("HGMMA",)},
}
# the redesigned backward kernels' first versions' device ms (mma.sync at
# head_dim 256, plain fp32 FMA for Mamba2 and RWKV-6; a whole-script run on
# an H100 80GB HBM3 at 700 W), printed beside this run's
EARLIER_MS = {"flash_attention_bwd 256 global": 46.2700,
              "flash_attention_bwd 256 window 4096": 34.6647,
              "mamba2_scan_bwd": 1.5333, "rwkv6_scan_bwd": 1.8701}


def kernel_name(mangled: str) -> str:
    """``attn_bwd_dq_kernel<128>`` from a mangled template instance's name
    (``dq_kernel<1>`` for a bool argument), ``dispatch_pack_kernel`` from a
    plain function's."""
    import re
    m = re.search(r"IL[ib](\d+)E", mangled)
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
    def attn_inputs(b, hq, g, s, t, d, seed, q_scale=1.0):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        q = (torch.randn((b, s, hq, d), generator=gen, device="cuda")
             * q_scale).to(bf16)
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
        # phase 12's prefills at head_dim 128 (4 prompts of 512 tokens):
        # StarCoder2 (48 heads over 4 kv), Minitron (32 over 8), Qwen2-VL
        # (12 over 2)
        ("starcoder2", (4, 48, 4, 512, 512, 128), True, None, None),
        ("minitron", (4, 32, 8, 512, 512, 128), True, None, None),
        ("qwen2-vl", (4, 12, 2, 512, 512, 128), True, None, None),
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
        # phase 13's SeamlessM4T prefill (4 prompts of 512 tokens, 16 heads
        # of 64, MHA): the encoder's self-attention and the decoder's
        # cross-attention non-causal, the decoder's self-attention causal;
        # a decode step's cross-attention, one q row against the cache's
        # 544 enc_out rows (the graph holds it); one q row over a ragged
        # kv tile
        ("seamless-enc", (4, 16, 16, 512, 512, 64), False, None, None),
        ("seamless-dec", (4, 16, 16, 512, 512, 64), True, None, None),
        ("seamless-cross", (4, 16, 16, 512, 512, 64), False, None, None),
        ("decode-cross", (4, 16, 16, 1, 544, 64), False, None, None),
        ("q1-ragged", (1, 4, 2, 1, 77, 64), False, None, None),
        # phase 14's ranks over 4 model ranks, 4 prompts of 512 tokens:
        # SeamlessM4T's 4 of 16 heads (the encoder, the decoder's self-
        # and cross-attention at prefill, and a decode step's cross over
        # eager gloo decode), Zamba2's shared block (8 of 32 heads of 112)
        # and Qwen2-VL's 3 of 12 q heads over the one kv head they read
        ("seamless-enc-tp4", (4, 4, 4, 512, 512, 64), False, None, None),
        ("seamless-dec-tp4", (4, 4, 4, 512, 512, 64), True, None, None),
        ("seamless-cross-tp4", (4, 4, 4, 512, 512, 64), False, None,
         None),
        ("decode-cross-tp4", (4, 4, 4, 1, 544, 64), False, None, None),
        ("zamba2-tp4", (4, 8, 8, 512, 512, 112), True, None, None),
        ("qwen2-vl-tp4", (4, 3, 1, 512, 512, 128), True, None, None),
    ]
    attn_err = 0.0
    rank_shapes, family_shapes, encdec_shapes, tp4_shapes = {}, {}, {}, {}
    families = ("zamba2", "starcoder2", "minitron", "qwen2-vl")
    encdec = ("seamless-enc", "seamless-dec", "seamless-cross",
              "decode-cross")
    tp4 = ("seamless-enc-tp4", "seamless-dec-tp4", "seamless-cross-tp4",
           "decode-cross-tp4", "zamba2-tp4", "qwen2-vl-tp4")
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
        if label in ("dbrx", "kimi", "mistral-tp4",
                     "dbrx-tp2") + families + encdec + tp4:
            b, hq, g, sq, t, d = shape
            ms = device_ms(lambda: ops.flash_attention(q, k, v, **kw))
            plain = time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                            iters=5)
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))
            issue = host_ms(lambda: ops.flash_attention(q, k, v, **kw))
            nbytes = 2 * (2 * b * hq * sq * d + 2 * b * g * t * d)
            # the (q, k) pairs that attend: causal (sq == t here) or all
            pairs = causal_pairs(sq, None) if causal else sq * t
            flops = 4 * b * hq * d * pairs
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
            else:
                kept = (family_shapes if label in families else
                        encdec_shapes if label in encdec else
                        tp4_shapes if label in tp4 else rank_shapes)
                kept[label] = dict(
                    shape=list(shape), ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=lib, max_abs_err=err)
    # the softcap where it bites, at every head dim: scores several times
    # the cap (q x 10 under Gemma2's 50) or a cap near the scores' own size
    cap_cases = [  # b, heads, kv heads, Sq, Sk, D, window, softcap, q scale
        ("cap-bites-64", (2, 4, 2, 200, 200, 64), None, 3.0, 1.0),
        ("cap-bites-112", (2, 8, 2, 300, 300, 112), None, 50.0, 10.0),
        ("cap-bites-128", (4, 48, 8, 512, 512, 128), None, 50.0, 10.0),
        ("cap-bites-128-window", (2, 8, 2, 300, 300, 128), 32, 3.0, 1.0),
    ]
    for i, (label, shape, window, softcap, q_scale) in enumerate(cap_cases):
        q, k, v = attn_inputs(*shape, seed=40 + i, q_scale=q_scale)
        check_softcap_bites(label, q, k, v, dict(
            causal=True, window=window, softcap=softcap), failures)
    head256 = attention_256(attn_inputs, failures)
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
            rank_shapes=rank_shapes, family_shapes=family_shapes,
            encdec_shapes=encdec_shapes, tp4_family_shapes=tp4_shapes,
            head_dim_256=head256),
    }
    return rows


def causal_pairs(sq: int, window) -> int:
    """(q, k) pairs a causal mask with an optional window lets attend, for
    equal q and kv lengths: what the products of such attention need."""
    if window is None or window >= sq:
        return sq * (sq + 1) // 2
    return window * (window + 1) // 2 + (sq - window) * window


def check_softcap_bites(label: str, q, k, v, kw: dict,
                        failures: list) -> float:
    """The kernel against its plain version where the softcap bites: the
    plain version without the cap must lie outside the tolerance of the
    capped one (else the case could not tell a kernel that drops or
    misplaces the cap), then the kernel must lie within it.  Returns the
    kernel's max |err|."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    qf, kf, vf = q.float(), k.float(), v.float()
    exp = flash_attention_plain(qf, kf, vf, **kw)
    uncapped = flash_attention_plain(qf, kf, vf, **{**kw, "softcap": None})
    bites = not torch.allclose(uncapped, exp, **ATTN_TOL)
    cap_moves = (uncapped - exp).abs().max().item()
    del uncapped, qf, kf, vf
    got = ops.flash_attention(q, k, v, **kw).float()
    torch.cuda.synchronize()
    err = (got - exp).abs().max().item()
    ok = torch.allclose(got, exp, **ATTN_TOL)
    print(f"  flash_attention {label} {tuple(q.shape)} over {k.shape[1]} kv "
          f"heads, max|q| {q.abs().max().item():.1f}, {kw}: the cap moves "
          f"the plain output by {cap_moves:.3e} "
          f"({'outside' if bites else 'WITHIN'} atol=rtol=2e-2); kernel "
          f"max|err| {err:.3e} {'within' if ok else 'OUTSIDE'}")
    if not bites:
        failures.append(f"flash_attention {label}: the softcap does not bite")
    if not ok:
        failures.append(f"flash_attention {label}")
    return err


def flex_softcap(window, softcap: float, s: int):
    """The library call that computes attention with a logit softcap:
    ``flex_attention`` under ``torch.compile``, its score_mod the cap and
    its block mask causal (within ``window``), for equal q and kv lengths
    ``s``.  Timed as the library column only; the port never calls it.
    Inductor's and Triton's caches go under the checkout's ``build/``."""
    import os

    import torch
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def cap(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def causal(b, h, qi, ki):
        return qi >= ki

    def windowed(b, h, qi, ki):
        return (qi >= ki) & (qi - ki < window)

    mask = create_block_mask(causal if window is None else windowed,
                             None, None, s, s, device="cuda")
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda q, k, v: flex(q, k, v, score_mod=cap, block_mask=mask,
                                enable_gqa=True)


def attention_256(attn_inputs, failures: list) -> dict:
    """Attention at head_dim 256 (Gemma2): its served prefill shape, q
    [2, 16, 8160, 256] over 8 kv heads, softcap 50, with the local layers'
    window of 4,096 and global, against the plain version, timed (device,
    host issue, plain, bound, and ``flex_attention`` with the same cap and
    mask as the library call); ``scaled_dot_product_attention`` without a
    softcap, causal and global, is printed as a yardstick, not as the same
    function.  The same shape with q x 10, where the cap bites.  Then edge
    cases at 256: one q row, a q length off the tiles, a window smaller
    than one kv tile, and the cap biting on a small shape.  Returns the
    kernels line's ``head_dim_256`` entry."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    b, hq, g, s, d = GEMMA_ATTN
    q, k, v = attn_inputs(b, hq, g, s, s, d, seed=60)
    out = {"shape": [b, hq, g, s, s, d], "softcap": GEMMA_SOFTCAP,
           "library": "flex_attention (torch.compile), score_mod "
                      "c * tanh(s / c), causal block mask"}
    for window in (GEMMA_WINDOW, None):
        kw = dict(causal=True, window=window, softcap=GEMMA_SOFTCAP)
        got = ops.flash_attention(q, k, v, **kw).float()
        exp = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        err = (got - exp).abs().max().item()
        ok = torch.allclose(got, exp, **ATTN_TOL)
        del got
        flex = flex_softcap(window, GEMMA_SOFTCAP, s)
        lib_out = flex(q, k, v).float()
        lib_err = (lib_out - exp).abs().max().item()
        lib_ok = torch.allclose(lib_out, exp, **ATTN_TOL)
        del lib_out, exp
        ms = device_ms(lambda: ops.flash_attention(q, k, v, **kw))
        lib = device_ms(lambda: flex(q, k, v))
        plain = time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                        iters=2, warmup=1)
        issue = host_ms(lambda: ops.flash_attention(q, k, v, **kw))
        nbytes = 2 * (2 * b * hq * s * d + 2 * b * g * s * d)
        flops = 4 * b * hq * d * causal_pairs(s, window)
        bnd, by = bound_ms(nbytes, flops)
        tag = "global" if window is None else f"window {window}"
        print(f"  flash_attention gemma2 {tag} [{b}, {hq}, {s}, {d}] over "
              f"{g} kv heads, softcap {GEMMA_SOFTCAP}: max|err| {err:.3e} "
              f"{'within' if ok else 'OUTSIDE'} atol=rtol=2e-2; time "
              f"(device, CUDA graph of 20 calls): kernel {ms:.4f} ms, "
              f"flex_attention {lib:.4f} ms (max|err| {lib_err:.3e} "
              f"{'within' if lib_ok else 'OUTSIDE'}), plain {plain:.4f} ms, "
              f"bound {bnd:.4f} ms ({by}; {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), {flops / ms / 1e9:.1f} TFLOP/s; "
              f"kernel/flex {ms / lib:.2f}; host issue {issue_text(issue)}")
        if not ok:
            failures.append(f"flash_attention gemma2 {tag}")
        if not lib_ok:
            failures.append(f"flex_attention gemma2 {tag}: not the plain "
                            f"version's function")
        key = "global" if window is None else "window"
        out[key] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                        library_ms=lib, max_abs_err=err, host_ms=issue[0])
    sdpa = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    out["sdpa_yardstick_ms"] = sdpa
    print(f"  yardstick, not the same function: scaled_dot_product_attention "
          f"at the same shape, causal, global, no softcap: {sdpa:.4f} ms "
          f"(the kernel, global with softcap: {out['global']['ms']:.4f})")
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = attn_inputs(b, hq, g, s, s, d, seed=61, q_scale=10.0)
    out["cap_bites_max_abs_err"] = max(
        check_softcap_bites(f"gemma2 q x 10 {tag}", q, k, v, dict(
            causal=True, window=window, softcap=GEMMA_SOFTCAP), failures)
        for window, tag in ((GEMMA_WINDOW, "window 4096"), (None, "global")))
    del q, k, v
    torch.cuda.empty_cache()
    edges = [  # b, heads, kv heads, Sq, Sk, causal, window
        ("256-one-row", (1, 16, 8, 1, 1), True, None),
        ("256-ragged", (2, 16, 8, 200, 200), True, GEMMA_WINDOW),
        ("256-window-under-tile", (2, 16, 8, 300, 300), True, 20),
        ("256-cross", (1, 4, 2, 77, 333), False, None),
    ]
    worst = 0.0
    for i, (label, (bb, h, gg, sq, sk), causal, window) in enumerate(edges):
        q, k, v = attn_inputs(bb, h, gg, sq, sk, d, seed=70 + i)
        kw = dict(causal=causal, window=window, softcap=GEMMA_SOFTCAP)
        got = ops.flash_attention(q, k, v, **kw).float()
        exp = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        err = (got - exp).abs().max().item()
        ok = torch.allclose(got, exp, **ATTN_TOL)
        worst = max(worst, err)
        print(f"  flash_attention {label} {(bb, h, gg, sq, sk, d)} "
              f"causal={causal} window={window} softcap={GEMMA_SOFTCAP}: "
              f"max|err| {err:.3e} {'within' if ok else 'OUTSIDE'} "
              f"atol=rtol=2e-2")
        if not ok:
            failures.append(f"flash_attention {label}")
    # the cap biting on tile edges: a cap of 3 near the scores' own size,
    # and q x 10 under 50 with a window under one kv tile
    for i, (label, shape, window, softcap, q_scale) in enumerate([
            ("256-cap-bites", (2, 16, 8, 200, 200, d), None, 3.0, 1.0),
            ("256-cap-bites-window", (2, 16, 8, 300, 300, d), 20,
             GEMMA_SOFTCAP, 10.0)]):
        q, k, v = attn_inputs(*shape, seed=80 + i, q_scale=q_scale)
        worst = max(worst, check_softcap_bites(label, q, k, v, dict(
            causal=True, window=window, softcap=softcap), failures))
    out["edges_max_abs_err"] = worst
    torch.cuda.empty_cache()
    return out


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
            # a rank of Zamba2 over 4 model ranks (phase 14): 28 heads
            ("zamba2-tp4", (4, 28, 512, "shared")),
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
        if label not in ("zamba2", "zamba2-tp4"):
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
        print(f"  mamba2_scan {label} time (device): kernel {ms:.4f} ms, "
              f"plain (chunked) {plain:.4f} ms, bound {bnd:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        print(f"  mamba2_scan {label} host issue per call: "
              f"{issue_text(issue)}")
        if label == "zamba2-tp4":
            rows["mamba2_scan"]["tp4"] = dict(
                shape=[batch, heads, s], max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bnd, bound_by=by)
            continue
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
            ("rwkv6", (4, 64, 512)),
            # a rank of RWKV6 over 4 model ranks (phase 14): 16 heads
            ("rwkv6-tp4", (4, 16, 512)), ("ragged", (4, 64, 500)),
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
        if label not in ("rwkv6", "rwkv6-tp4"):
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
        print(f"  rwkv6_scan {label} time (device): kernel {ms:.4f} ms, "
              f"plain (chunked) {plain:.4f} ms, bound {bnd:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        print(f"  rwkv6_scan {label} host issue per call: "
              f"{issue_text(issue)}")
        if label == "rwkv6-tp4":
            rows["rwkv6_scan"]["tp4"] = dict(
                shape=[batch, heads, s], max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bnd, bound_by=by)
            continue
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
    # Gemma2-shaped: head_dim 256 as at full width, post-norms, both
    # softcaps, the reduced 32-token window on alternate layers, a prompt
    # of 80 tokens so the window bites
    compare_small_model("Gemma2-shaped", get_config("gemma2_9b").reduced(
        d_model=512, n_heads=2, d_head=256, d_ff=512, vocab=1024), seed=13,
        seq=80)
    # Qwen2-VL-shaped: M-RoPE sections over head_dim 128, the embeddings
    # input (the stub frontend of the prompt and of each sampled token)
    compare_small_model("Qwen2-VL-shaped", get_config("qwen2_vl_2b").reduced(
        **small), seed=14)
    # Seamless-shaped: head_dim 64 with MHA as at full width, 2 encoder and
    # 2 decoder layers, the stub frontend's source embeddings; decode's
    # cross-attention one q row over the cache's 80 enc_out rows
    compare_small_model("Seamless-shaped", get_config(
        "seamless_m4t_medium").reduced(d_model=512, n_heads=8, n_kv_heads=8,
                                       d_ff=512, vocab=1024), seed=15)
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

    from repro_torch.data.pipeline import batch_for_model
    (gpu, params, on_card), (cpu, cpu_params, on_cpu) = card, host
    b, s = toks.shape
    worst = 0.0
    batch = batch_for_model(cpu.cfg, {"tokens": toks.numpy()}, device="cpu")
    with torch.inference_mode():
        cache_g = gpu.init_cache(b, s + 16)
        cache_c = cpu.init_cache(b, s + 16)
        lg, cache_g = on_card(gpu.prefill, params,
                              {k: v.cuda() for k, v in batch.items()},
                              cache_g)
        lc, cache_c = on_cpu(cpu.prefill, cpu_params, batch, cache_c)
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
            nxt = lc.argmax(-1).to(torch.int32)
            lg, cache_g = on_card(gpu.decode, params,
                                  gpu.decode_batch(nxt.cuda()), cache_g)
            lc, cache_c = on_cpu(cpu.decode, cpu_params,
                                 cpu.decode_batch(nxt), cache_c)


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


def compare_small_model(label: str, cfg, *, seed: int, seq: int = 64,
                        ) -> None:
    """Prefill (``seq`` tokens, or their stub embeddings for the
    embeddings input) and 3 decode steps of ``cfg`` in bf16 on the card
    (kernels) and in fp32 on the CPU (plain versions), same weights and
    tokens.

    bf16 rounding can flip an expert choice where two router logits nearly
    tie, and one flip changes which rows overflow.  So the CPU run takes the
    card's expert choices (its gates come from its own logits), and every
    choice it would have made otherwise must be a near tie in its logits.
    """
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.core import collectives as cl
    from repro_torch.kernels import ops
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
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(4, seq)).astype(np.int32))

    def on_card(fn, *args):
        with mock.patch.object(cl, "route_topk", card_route), \
                mock.patch.object(cl, "hierarchical_dispatch", card_dispatch):
            return fn(*args)

    def on_cpu(fn, *args):
        with mock.patch.object(cl, "route_topk", cpu_route):
            return fn(*args)

    ops.reset_launches()
    worst = logits_gap(label, (gpu, params, on_card),
                       (cpu, cpu_params, on_cpu), toks)
    attn = ops.launches()["flash_attention"]
    want_attn = attention_launches(cfg, forwards=4)
    dropped = tally["pairs"] - tally["kept"]
    shape = (f"top-{cfg.top_k} of {cfg.num_experts}, {cfg.n_shared_experts} "
             f"shared expert(s), capacity factor {cfg.moe_capacity}"
             if cfg.is_moe else
             f"{cfg.n_enc_layers} encoder layers, cross-attention"
             if cfg.family == "encdec" else
             f"dense, window {cfg.window}, softcaps {cfg.attn_softcap}/"
             f"{cfg.final_softcap}, post_norm {cfg.post_norm}, M-RoPE "
             f"{cfg.mrope_sections}, input {cfg.input_mode}")
    print(f"  small {cfg.name} model, {label} ({cfg.n_layers} layers, "
          f"{cfg.first_k_dense} dense, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads / {cfg.n_kv_heads} kv of {cfg.head_dim}, {shape}; "
          f"prompt {toks.shape[1]}): card bf16 vs CPU fp32 "
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
    if attn != want_attn:
        raise AssertionError(f"reference {label}: flash_attention launched "
                             f"{attn} times, not {want_attn}")


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


def attention_launches(cfg, forwards: int) -> int:
    """``flash_attention`` launches of 1 prefill and ``forwards - 1``
    decode steps of a dense, moe or encdec ``cfg``: one a layer at
    prefill; the encoder-decoder's ``n_enc_layers + 2 * n_layers`` at
    prefill (the encoder, the decoder's self- and cross-attention) and
    ``n_layers`` a decode step (its cross-attention, one q row)."""
    if cfg.family == "encdec":
        return (cfg.n_enc_layers + 2 * cfg.n_layers
                + cfg.n_layers * (forwards - 1))
    return cfg.n_layers


def expected_launches(cfg, forwards: int) -> dict:
    """Kernel launches of one ``generate``: ``forwards`` = 1 prefill plus
    the decode rounds.  Attention runs at prefill only (but the
    encoder-decoder's cross-attention, every forward), the scans at
    prefill only; the dispatch pack runs three times per MoE layer in
    every forward."""
    from repro_torch.models.ssm import n_shared_calls
    want = launch_counts()
    if cfg.family in ("dense", "encdec"):
        want["flash_attention"] = attention_launches(cfg, forwards)
    elif cfg.family == "moe":
        want["dispatch_pack"] = 3 * cfg.n_layers * forwards
        want["flash_attention"] = cfg.n_layers
    elif cfg.family == "hybrid":
        want["mamba2_scan"] = cfg.n_layers
        want["flash_attention"] = n_shared_calls(cfg)
    elif cfg.family == "rwkv":
        want["rwkv6_scan"] = cfg.n_layers
    return want


def serve_phase(arch: str, layers, *, prompts_n: int = PROMPTS,
                prompt_len: int = PROMPT_LEN, max_new: int = MAX_NEW,
                after=None) -> dict:
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
    the kernel launches of the measured call.  ``prompts_n`` prompts of
    ``prompt_len`` tokens, ``max_new`` new tokens (phase 12 gives each
    family its own); ``after(engine, cfg)`` runs last, before the engine
    is freed."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, make_prompts, \
        serve_config

    cfg = serve_config(arch, layers=layers, smoke=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = build_engine(cfg, device="cuda", dtype=torch.bfloat16, seed=0,
                          max_new=max_new)
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
             f"{cfg.rwkv_decay_lora}, d_ff {cfg.d_ff}"
             if cfg.family == "rwkv" else
             f"{cfg.n_enc_layers} encoder layers, cross-attention, d_ff "
             f"{cfg.d_ff} ({cfg.act}), source input {cfg.input_mode}"
             if cfg.family == "encdec" else
             f"d_ff {cfg.d_ff} ({'gated ' if cfg.mlp_gated else ''}"
             f"{cfg.act}), window {cfg.window}, softcaps {cfg.attn_softcap}/"
             f"{cfg.final_softcap}, post_norm {cfg.post_norm}, M-RoPE "
             f"{cfg.mrope_sections}, input {cfg.input_mode}")
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv (head_dim "
          f"{cfg.head_dim}), {shape}, vocab {cfg.vocab}: "
          f"{nparams / 1e9:.2f} B parameters, {nbytes / 1e9:.2f} GB, random "
          f"init {time.monotonic() - t0:.1f} s")
    prompts = make_prompts(cfg, prompts_n, prompt_len, seed=0)
    engine.generate(prompts, max_new=2)          # warm-up, not counted
    engine.stats.update(prefill_s=0.0, decode_s=0.0, tokens=0)
    graph = engine.stats["decode_graph"]
    print(f"  decode mode: {graph['mode']} ({graph['reason']})")
    if graph["mode"] != "graph":
        raise AssertionError(f"one rank on CUDA decodes {graph['mode']}")
    torch.cuda.reset_peak_memory_stats()
    want = expected_launches(cfg, forwards=max_new)
    rounds = max_new - 1

    before = dict(graph)
    ops.reset_launches()
    out = engine.generate(prompts)
    counts = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = engine.stats
    captured = {key: graph[key] - before[key]
                for key in ("captures", "replays", "eager_rounds",
                            "capture_s")}
    if out.shape != (prompts_n, max_new):
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
    print(f"  generate [{prompts_n} x {prompt_len}] -> {list(out.shape)}: "
          f"prefill {st['prefill_s'] * 1e3:.3f} ms, decode "
          f"{decode_ms:.3f} ms/token (one eager round and the capture "
          f"included), {prompts_n * max_new / total_s:.1f} tokens/s, peak "
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
    eager, eager_ms, eager_counts = eager_loop(engine, prompts, max_new)
    gap = max(((g - e).abs().max() / e.abs().max()).item()
              for g, e in zip(kept, eager["logits"]))
    same = np.array_equal(eager["tokens"], out)
    print(f"  graph vs eager loop: tokens {'equal' if same else 'DIFFER'} "
          f"over {max_new}; logits max gap {gap:.3e} of max |logit| over "
          f"{max_new} steps; decode {graph_ms:.3f} ms/token replayed "
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
    if after is not None:
        after(engine, cfg)
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


def eager_loop(engine, prompts, max_new: int = MAX_NEW):
    """Greedy decoding by the engine's model directly: ``prefill`` on a
    fresh cache, then ``max_new - 1`` calls of ``decode``, argmax after
    each, every step's logits kept on the host.  Returns ({"tokens",
    "logits"}, decode ms a token, the kernel launches)."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.kernels import ops
    model, params = engine.model, engine.params
    batch = batch_for_model(model.cfg, {"tokens": prompts}, device="cuda")
    ops.reset_launches()
    logits_kept = []
    with torch.inference_mode():
        cache = model.init_cache(len(prompts), prompts.shape[1] + max_new)
        logits, _ = model.prefill(params, batch, cache)
        tok = torch.argmax(logits, dim=-1)
        logits_kept.append(logits.float().cpu())
        toks = [tok.cpu()]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(max_new - 1):
            logits, _ = model.decode(params, model.decode_batch(tok), cache)
            tok = torch.argmax(logits, dim=-1)
            logits_kept.append(logits.float().cpu())
            toks.append(tok.cpu())
        ms = (time.monotonic() - t0) * 1e3 / (max_new - 1)
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

# what a phase's spawn ran for a later phase over the same mesh and backend
# (phase 6's spawn: phase 9's DBRX and phase 11's DBRX training; phase 8's:
# phase 9's Mistral-NeMo probes, phase 14's four models and their
# training and phase 11's Mistral-NeMo training), by the later phase's key
CARRIED: dict = {}
# what an earlier phase measured that phase 16 holds the dry run to: phase
# 6's pod-group bytes of the first prefill dispatch by scheme pair and
# rank, phase 10's trainer's state bytes and peak
MEASURED: dict = {}


def ranks_phase(cf: float = RANKS_CF, trace: str | None = None,
                carry: bool = False) -> dict:
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
    written).  With ``carry`` the same spawn then serves phase 9's DBRX
    calibration and runs on the same weights (``CARRIED["dbrx"]``) and,
    the served state freed, trains phase 11's DBRX (``CARRIED["train
    dbrx"]``).  Returns the kernel launches of the measured runs, summed
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
    backend = ranks_backend(cards, world)
    where = ("nccl, one card a rank over NVLink: no pod link is slower"
             if backend == "nccl" else
             CARD_WHERE.format(world=world) + ": no fabric measured")
    print(f"  {cards} card(s): {world} ranks over {where}; capacity factor "
          f"{cf}")
    prompts = make_prompts(cfg, PROMPTS, PROMPT_LEN, seed=0)

    if exact:
        # the one-rank reference: the same weights, capacity factor, prompts
        t_one = time.monotonic()
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
        print(f"  the one-rank reference on the card: "
              f"{time.monotonic() - t_one:.1f} s")
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
    mine = dict(name="phase 6", max_new=MAX_NEW, runs=runs,
                measure_link=stage1 if nccl else None,
                continuous=RANKS_CONTINUOUS,
                decide=(["measured", "measured-pod:12.5"] if nccl
                        else [None]),
                trace=(dict(run=ranks.run_label(runs[3]), path=trace)
                       if trace else None))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        spec = dict(world=world, pods=RANKS[0], ep=RANKS[1],
                    **backend_keys(backend), device="cuda:0",
                    init_method=f"file://{tmp}/store",
                    timeout_s=600 if carry else 120, out_dir=f"{tmp}/out",
                    threads=2, cfg=cfg, dtype=torch.bfloat16,
                    cache_dtype=torch.bfloat16, seed=0, prompts=prompts,
                    warmup=True, dp_servers=(RANKS[0],) if carry else (),
                    models=([transport_entry(cfg, serve_config(
                        "mistral_nemo_12b", layers=None, smoke=False))]
                        if backend == "card" else []) + [mine]
                    + ([calibration_entry(cfg),
                        train_entry("dbrx", backend)]
                       if carry else []))
        t0 = time.monotonic()
        spawned = ranks.run_ranks(ranks.serve_worker, spec,
                                  timeout_s=1800 if carry else 900)
    results = [r["models"]["phase 6"] for r in spawned]
    if carry:
        CARRIED["dbrx"] = [r["models"]["phase 9"] for r in spawned]
        CARRIED["train dbrx"] = [r["models"]["phase 11 dbrx"]
                                 for r in spawned]
    print(f"  {world} ranks spawned, served and joined in "
          f"{time.monotonic() - t0:.1f} s"
          + (" (phase 9's DBRX calibration and runs and phase 11's DBRX "
             "training included)" if carry else "") + f"; peak memory a rank "
          f"{max(r['peak_gb'] for r in results):.2f} GB")
    spawn_split(spawned, "the spawn")

    failures = []
    if backend == "card":
        print("  the card transport against gloo on the same 4 ranks, "
              "before the served runs:")
        failures += report_transport([r["models"]["transport"]
                                      for r in spawned])
    staged = max(sum(r["staging"].values()) for r in results)
    print(f"  staging a rank after the served runs: {staged / 1e6:.1f} MB")
    failures += report_planner(results, world)
    found, total, walls = check_served(results, runs, cfg, MAX_NEW, where,
                                       exact)
    failures += found
    failures += check_decode_mode(results, backend)
    failures += check_continuous(results)
    MEASURED["phase 6 walls"] = walls
    r0 = results[0]
    labels = [ranks.run_label(run) for run in runs]
    pairs = labels[:3]
    MEASURED["pod bytes"] = {
        pair: {r["rank"]: r["runs"][pair]["pod_bytes"]["whole"]
               for r in results} for pair in (pairs[0], pairs[-1])}
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
# phase 6's check of the card transport against gloo
# ---------------------------------------------------------------------------

# the GradSync slice (32 M fp32 elements) and the barriers timed
GRAD_SLICE = 32 << 20
TRANSPORT_BARRIERS = 2000


def transport_entry(cfg, mistral) -> dict:
    """The exchanges phase 6's spawn holds on the card transport against
    gloo, as a ``ranks.serve_worker`` entry, at the shapes the served and
    trained runs give them: the three token exchanges of a DBRX prefill
    dispatch over 2 x 2 (4 x 512 tokens, capacity factor ``RANKS_CF``:
    MultiWrite's stage 1 over the pod axis and stage 2 over the data axis,
    the baseline's over the data-parallel pair) and its expert ids and
    slot flags; FSDP's gather and reduce-scatter of DBRX's unembedding
    shard over the data axis (phase 11) and a ``GradSync`` slice's
    all-reduce over the pods; over a (1, 1, 4) mesh of the same processes
    Mistral-NeMo's row-parallel all-reduce at 4 x 512 tokens, a split-TP
    domain's gather of the served fragment ([4, 128, 5120] a rank, phase
    8) and a ppermute of it."""
    from repro_torch.models import moe as M
    p, d = RANKS
    rows = PROMPTS * PROMPT_LEN // (p * d)
    k, h = cfg.top_k, cfg.d_model
    dcfg = M.balanced_capacities(rows, k, p, d, cfg.num_experts // (p * d),
                                 cfg.moe_capacity)
    cp = max(1, int(round(rows * dcfg.pod_capacity)))
    cd = max(1, int(round(p * cp * dcfg.ep_capacity)))
    cr = max(1, int(round(rows * min(1.0, k / (p * d))
                          * cfg.moe_capacity)))
    shard = (cfg.vocab // d, h)
    tp = (1, 1, 4)
    frag = (PROMPTS, PROMPT_LEN // 4, mistral.d_model)
    cases = [
        ("stage 1 tokens", "all_to_all", "pod", None, (p, cp, h),
         "bfloat16"),
        ("stage 1 expert ids", "all_to_all", "pod", None, (p, cp, k),
         "int32"),
        ("stage 2 tokens", "all_to_all", "data", None, (d, cd, h),
         "bfloat16"),
        ("stage 2 slot flags", "all_to_all", "data", None, (d, cd), "bool"),
        ("baseline tokens", "all_to_all", ("pod", "data"), None,
         (p * d, cr, h), "bfloat16"),
        ("FSDP unembedding gather", "all_gather", "data", None, shard,
         "bfloat16"),
        ("FSDP unembedding reduce-scatter", "reduce_scatter", "data", None,
         (d, *shard), "bfloat16"),
        ("GradSync slice all-reduce", "all_reduce", "pod", None,
         (GRAD_SLICE,), "float32"),
    ]
    out = [dict(name=n, kind=kd, axis=a, members=m, shape=sh, dtype=dt)
           for n, kd, a, m, sh, dt in cases]
    out += [dict(name="TP row-parallel all-reduce", kind="all_reduce",
                 mesh=tp, axis="model", shape=(PROMPTS, PROMPT_LEN,
                                               mistral.d_model),
                 dtype="bfloat16"),
            dict(name="split-TP domain gather", kind="all_gather", mesh=tp,
                 axis="model", members=((0, 1), (2, 3)), shape=frag,
                 dtype="bfloat16"),
            dict(name="model-axis ppermute", kind="ppermute", mesh=tp,
                 axis="model", shape=frag, dtype="bfloat16")]
    return dict(name="transport", transport_check=dict(
        cases=out, barriers=TRANSPORT_BARRIERS))


def report_transport(results: list) -> list:
    """Print phase 6's transport check (:func:`transport_entry`) and gate
    it: each byte mover's output the bits of gloo's on every rank; each
    sum the same bits on every member (an all-reduce's digest; every
    member's reduce-scatter block), in group-rank order, and within the
    recursive summation bound ``(n - 1) u sum|x|`` of the fp64 sum in the
    tensor's dtype.  Returns the failures."""
    failures = []
    r0 = results[0]
    for name, c in r0["cases"].items():
        per = [r["cases"][name] for r in results]
        line = (f"    {name}: {c['kind']} over {len(c['group'])}, "
                f"{list(c['shape'])} {c['dtype']} a rank "
                f"({c['bytes'] / 1e6:.2f} MB): card {c['card_ms']:.3f} ms, "
                f"gloo {c['gloo_ms']:.3f} ms (x"
                f"{c['gloo_ms'] / max(c['card_ms'], 1e-9):.1f}); ")
        if c["kind"] in ("all_reduce", "reduce_scatter"):
            err = max(x["fp64_err"] for x in per)
            gerr = max(x["gloo_fp64_err"] for x in per)
            order = all(x["rank_order"] for x in per)
            over = sum(x["over_bound"] for x in per)
            digests: dict = {}
            for x in per:
                digests.setdefault(tuple(x["group"]), set()).add(x["digest"])
            same = (c["kind"] == "reduce_scatter"
                    or all(len(v) == 1 for v in digests.values()))
            agree = ("the same bits on every member" if same
                     else "members DIFFER")
            line += (f"group-rank order {'yes' if order else 'NO'}, {agree}"
                     f", |err| vs fp64 {err:.3e} (gloo's {gerr:.3e}), "
                     f"{over} elements past the summation bound")
            if not (order and same and over == 0):
                failures.append(f"transport {name}: order {order}, same "
                                f"{same}, past the bound {over}")
        else:
            exact = all(x["same_bits"] for x in per)
            line += f"{'bit-exact' if exact else 'NOT bit-exact'} vs gloo"
            if not exact:
                failures.append(f"transport {name}: not gloo's bits")
        print(line)
    b = r0["barrier_us"]
    print(f"    one barrier of the 4 ranks: the card transport's flags "
          f"{b['card']:.1f} us (mean of {b['card_n']}), gloo's "
          f"{b['gloo']:.1f} us (mean of {b['gloo_n']}); the slowest rank's")
    for rank, r in enumerate(results):
        st = r["staging"]
        print(f"    rank {rank} staging after the check: " + ", ".join(
            f"mesh {k}: card {v['card'] / 1e6:.1f} MB, host "
            f"{v['host'] / 1e6:.1f} MB" for k, v in st.items()))
    return failures


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
    # every rank on one card: the card transport; over several cards
    # gloo, which stages each exchange through the host
    backend = "card" if cards == 1 else "gloo"
    where = (CARD_WHERE.format(world=world) if backend == "card" else
             f"gloo, {world} processes over {cards} cards, host-staged "
             f"transport") + ": no fabric measured"
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
                    **(backend_keys("card") if backend == "card" else
                       dict(backend="gloo")), device="cuda",
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
    spawn_split(results, "the spawn")
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
              f" peak {r['peak_gb']:.2f} GB; its card-transport staging "
              f"{r['staging']['card'] / 1e9:.3f} GB (within the peak)")
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
                **backend_keys(backend), device="cuda:0",
                init_method=f"file://{tmp}/store", timeout_s=300,
                out_dir=f"{tmp}/out", threads=2, cfg=cfg,
                dtype=torch.bfloat16, cache_dtype=torch.bfloat16, seed=0,
                max_new=MAX_NEW, runs=runs, warmup=True, **kw)


def tp_phase(carry: bool = False) -> dict:
    """Tensor parallelism over 4 spawned ranks: nccl with a card a rank
    where there are 4 cards, else all ranks on card 0 over the card
    transport.

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
    counted).  With ``carry`` the Mistral spawn then runs phase 9's probes
    of the same mesh (``CARRIED["mistral"]``), serves phase 14's models
    (``CARRIED["tp families"]``), trains phase 11's Mistral-NeMo
    (``CARRIED["train mistral"]``) and phase 14's models
    (``CARRIED["train tp families"]``).  Returns the kernel launches of the
    measured runs, summed over ranks and runs."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch import ranks
    from repro_torch.launch.serve import make_prompts, serve_config
    from repro_torch.models.api import build_model
    from repro_torch.runtime.server import ServeConfig

    cards = torch.cuda.device_count()
    backend = ranks_backend(cards)
    depth = TP_DEPTH[4 if cards >= 4 else 1]
    new = TP_NEW[4 if cards >= 4 else 1]
    cfg = serve_config("mistral_nemo_12b", layers=depth, smoke=False)
    where = ("nccl, one card a rank" if backend == "nccl" else
             CARD_WHERE.format(world=4))
    print(f"  {cards} card(s): 4 ranks over {where}; Mistral-NeMo-12B at "
          f"full width, depth {depth} of 40"
          + ("" if depth == 40 else " (cut on one card to stay within the "
             "script's time)"))
    prompts = make_prompts(cfg, PROMPTS, PROMPT_LEN, seed=0)

    # the one-rank reference: the same weights (each rank draws every
    # tensor whole from the same seed and keeps its block)
    t_one = time.monotonic()
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
    print(f"  the one-rank reference on the card: "
          f"{time.monotonic() - t_one:.1f} s")

    runs = [dict(label="tp_subgroups=1", tp_subgroups=1),
            dict(label="tp_subgroups=2 fixed", tp_subgroups=2),
            dict(label="tp_subgroups=2 auto", tp_subgroups=2, policy="auto",
                 bind=True)]
    frag = (PROMPTS, PROMPT_LEN // 4, cfg.d_model)
    mine = dict(name="phase 8", runs=runs, max_new=new,
                gather=dict(shape=frag, reps=5))
    # DBRX, 4 layers, over (1, 2, 2): TP inside the experts, on the same
    # spawn over a mesh of its own
    dbrx = dataclasses.replace(
        serve_config("dbrx_132b", layers=4, smoke=False),
        moe_capacity=RANKS_CF)
    dbrx_runs = [dict(label="per-expert all_reduce", deferred=False),
                 dict(label="deferred all_reduce", deferred=True)]
    pods, ep, tp = DBRX_TP_MESH
    dbrx_entry = dict(name="phase 8 dbrx", mesh=DBRX_TP_MESH, pods=pods,
                      ep=ep, tp=tp, cfg=dbrx, runs=dbrx_runs,
                      max_new=MAX_NEW,
                      prompts=make_prompts(dbrx, PROMPTS, PROMPT_LEN, seed=0))
    carried = ([gather_probe_entry()]
               + tp_families_models(tp_families_served(cards >= 4),
                                    TP_FAMILIES_NEW[4 if cards >= 4 else 1])
               + [train_entry("mistral", backend),
                  train_entry("tp families", backend, 14)]) if carry else []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.monotonic()
        spec = tp_spec(tmp, TP_MESH, backend, cfg, [], prompts=prompts,
                       models=[mine, dbrx_entry] + carried)
        if carry:   # phase 11's training: the gradient mean's groups
            spec.update(timeout_s=600, dp_servers=(TP_MESH[0],))
        spawned = ranks.run_ranks(ranks.serve_worker, spec,
                                  timeout_s=1800 if carry else 900)
    results = [r["models"]["phase 8"] for r in spawned]
    if carry:
        CARRIED["mistral"] = [r["models"]["phase 9"] for r in spawned]
        CARRIED["tp families"] = spawned
        CARRIED["train mistral"] = [r["models"]["phase 11 mistral"]
                                    for r in spawned]
        CARRIED["train tp families"] = [
            r["models"]["phase 14 tp families"] for r in spawned]
    print(f"  4 ranks spawned, served and joined in "
          f"{time.monotonic() - t0:.1f} s (DBRX over {DBRX_TP_MESH}"
          + (", phase 9's probes of the mesh, phase 14's models and their "
             "training and phase 11's Mistral-NeMo training" if carry
             else "") + " included)")
    spawn_split(spawned, "the spawn")
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
          f"({g['bytes'] / 1e6:.2f} MB), 2 domains of 2: walls ("
          f"{'the card transport' if backend == 'card' else backend}; "
          f"median of 5, "
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
                f"{st['decode_s'] * 1e3 / (new - 1):.3f} ms/token (the "
                f"slowest rank's)")
        if st["replay_decode_s"] is not None:
            line += (f"; a second call, every round replayed: "
                     f"{st['replay_decode_s'] * 1e3 / (new - 1):.3f} "
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
        if new < MAX_NEW:
            print(f"    the one-card cut to {new} new tokens gives up "
                  f"{MAX_NEW - new} decode rounds of this run a rank, "
                  f"{MAX_NEW - new} x 0 kernel launches (Mistral-NeMo's "
                  f"decode runs the plain decode attention, no kernel) and "
                  f"about {(MAX_NEW - new) * st['decode_s'] / (new - 1):.1f}"
                  f" s of wall at this run's decode rate")
    ranked = r0["runs"][labels[0]]
    ref = one_logits[0]
    rel = ((ranked["prefill_logits"] - ref).abs().max()
           / ref.abs().max()).item()
    # the one-rank run keeps its MAX_NEW tokens; the ranks' are its first
    equal, gap = ranks.near_ties(range(PROMPTS), ranked["tokens"],
                                 expected[:, :new], one_logits[:new])
    print(f"  4 ranks vs one: last-position prefill logits {rel:.3e} of max "
          f"|logit| (limit {REF_TOL}); {equal} of {PROMPTS} rows' tokens "
          f"equal over {new}; a row parts at a gap of {gap:.3e} at most "
          f"(limit {REF_TOL})")
    if not rel < REF_TOL or gap > REF_TOL:
        failures.append(f"4 ranks vs one: logits {rel:.3e}, gap {gap:.3e}")

    # DBRX, 4 layers, over (1, 2, 2), served on the same spawn
    results = [r["models"]["phase 8 dbrx"] for r in spawned]
    runs = dbrx_runs
    print(f"  DBRX-132B, 4 layers, over {DBRX_TP_MESH}, capacity factor "
          f"{RANKS_CF}: served on the spawn above over a mesh of its own "
          f"(its stretch \"model phase 8 dbrx\" in the split)")
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
        print("  link: no fabric measured (the ranks share one card: no "
              "link between them to time); the planner scores on the "
              "reference's default, the mesh-derived topology")
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
    MultiWrite's first and the baseline's last; ``[]`` when the runs hold
    no fixed pairs (no gate (c), nor (e)'s comparison of the pairs).
    Prints each run's plan,
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
    pairs = labels[:3] if pairs is None else pairs
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
    for r in results if pairs else ():
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
    """Every rank's engines decode by the rule: a CUDA graph over nccl;
    eager over gloo (its exchanges are staged through the host) and over
    the card transport (its exchanges meet at host barriers).  Returns the
    failures."""
    want = "graph" if backend == "nccl" else "eager"
    over = "the card transport" if backend == "card" else backend
    failures = []
    modes = {(run["decode_graph"]["mode"], run["decode_graph"]["reason"])
             for r in results for run in r["runs"].values()}
    for mode, reason in sorted(modes):
        print(f"  decode over {over}: {mode} ({reason})")
        if mode != want:
            failures.append(f"decode {mode} over {over}, not {want}")
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


def calibration_runs() -> list:
    """Phase 9's served DBRX runs: the calibrated plan and its fixed twin
    (phase 6 runs the fixed pairs on the same spawn and weights)."""
    return [dict(label="calibrated", policy="auto", calibrated=True,
                 bind=True),
            dict(label="calibrated-fixed", twin="calibrated")]


def calibration_entry(cfg) -> dict:
    """Phase 9's DBRX over 2 x 2 as one model of a ``serve_worker`` spawn
    (``ranks.serve_worker``'s ``models``): the calibration, then the
    served runs of :func:`calibration_runs`.  The directed rail probes
    sweep ``CAL_DIRECTIONS``: over the card transport an exchange costs
    about 0.8 ms whatever its bytes up to a 64 MB piece (four processes
    taking turns on the card), so the monitor's own sweep (256 KB to
    16 MB) is flat in the bytes and no fit clears the fitter's floor."""
    token_bytes = cfg.d_model * 2
    sweep = tuple(n * token_bytes for n in CAL_TOKENS)
    return dict(name="phase 9", max_new=CAL_NEW, runs=calibration_runs(),
                calibrate=dict(ops=("dispatch", "combine"), repeats=3,
                               payloads={"dispatch": sweep,
                                         "combine": sweep},
                               directions=CAL_DIRECTIONS,
                               check_packs=True,
                               scenario=dict(num_experts=cfg.num_experts,
                                             top_k=cfg.top_k,
                                             token_bytes=token_bytes)))


def gather_probe_entry() -> dict:
    """Phase 9's probes of Mistral-NeMo's model axis over (1, 1, 4) as one
    entry of a ``serve_worker`` spawn (``probe``): the AllGather sweep on
    the split-TP topology, the gather alone at the served fragment, the
    split-TP pick and the serve program, datasheet and calibrated."""
    import math

    from repro_torch.core.topology import split_tp_full_mesh
    from repro_torch.launch.serve import serve_config
    mcfg = serve_config("mistral_nemo_12b", layers=None, smoke=False)
    topo, _ = split_tp_full_mesh(TP_MESH[2], tp=TP_MESH[2] // 2)
    frag = (PROMPTS, PROMPT_LEN // TP_MESH[2], mcfg.d_model)
    return dict(name="phase 9", probe=True, topo=topo,
                calibrate=dict(ops=("allgather",), repeats=3,
                               payloads={"allgather": CAL_GATHER}),
                gather=dict(shape=frag, reps=5),
                split_tp=math.prod(frag) * 2,
                program=dict(cfg=mcfg, itemsize=2, tp_subgroups=2,
                             phases={"prefill": (PROMPTS, PROMPT_LEN),
                                     "decode": (PROMPTS, 1)}))


def calibrate_phase() -> dict:
    """The telemetry loop on the card, over 4 spawned ranks (nccl with a
    card a rank where there are 4 cards, else the card transport on card 0).

    DBRX-132B (4 layers, full width) over 2 pods x 2 ep ranks, capacity
    factor 4, a prompt of 512 tokens a rank: every rank runs one startup
    calibration (``ranks.live_calibration``, the steps of
    ``telemetry.startup_calibration`` with a ``LiveProbe`` over the rank
    mesh) on the topology the context's planner scores on: the dispatch
    and the combine, both plans each, at ``CAL_TOKENS`` tokens a rank of
    the model's own token bytes, and the directed rail probes; then the
    serve program planned on the datasheet and on the store's fitted model
    (``calibration=``), and DBRX served under the calibrated plan and its
    fixed twin (their walls printed beside phase 6's fixed pairs when
    phase 6 ran on the same spawn and weights).
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
    ties, exact launch counts); the gather bit-exact.  Either part rides
    an earlier phase's spawn when that phase carried it (``CARRIED``:
    phase 6's over 2 x 2, phase 8's over (1, 1, 4)), else it spawns its
    own.  Returns the kernel launches of the measured served runs, summed
    over ranks and runs."""
    import dataclasses
    import math
    import tempfile

    import torch

    from repro_torch.launch import ranks
    from repro_torch.launch.serve import make_prompts, serve_config

    cards = torch.cuda.device_count()
    backend = ranks_backend(cards)
    where = ("nccl, one card a rank" if backend == "nccl" else
             CARD_WHERE.format(world=4))
    cfg = dataclasses.replace(
        serve_config("dbrx_132b", layers=4, smoke=False),
        moe_capacity=RANKS_CF)
    world = RANKS[0] * RANKS[1]
    print(f"  {cards} card(s): {world} ranks over {where}")
    runs = calibration_runs()
    labels = [ranks.run_label(run) for run in runs]
    results = CARRIED.pop("dbrx", None)
    if results is not None:
        print("  DBRX over 2 x 2: calibrated and served on phase 6's spawn "
              "and weights (its split above)")
    else:
        prompts = make_prompts(cfg, PROMPTS, PROMPT_LEN, seed=0)
        with tempfile.TemporaryDirectory() as tmp:
            spec = dict(world=world, pods=RANKS[0], ep=RANKS[1],
                        **backend_keys(backend), device="cuda:0",
                        init_method=f"file://{tmp}/store", timeout_s=120,
                        out_dir=f"{tmp}/out", threads=2, cfg=cfg,
                        dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                        seed=0, prompts=prompts, warmup=True)
            spec.update(calibration_entry(cfg, backend))
            t0 = time.monotonic()
            results = ranks.run_ranks(ranks.serve_worker, spec,
                                      timeout_s=900)
        print(f"  {world} ranks spawned, calibrated, served and joined in "
              f"{time.monotonic() - t0:.1f} s")
        spawn_split(results, "the spawn")
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
    found, total, walls = check_served(results, runs, cfg, CAL_NEW,
                                       where, True, pairs=[])
    failures += found
    failures += check_decode_mode(results, backend)
    fixed = MEASURED.get("phase 6 walls", {})
    print("  walls, prefill ms / decode ms a token: " + "; ".join(
        f"{label} {walls[label][0]:.3f} / {walls[label][1]:.3f}"
        for label in labels) + (
        f" ({CAL_NEW} new tokens); phase 6's fixed pairs on the same spawn "
        f"and weights ({MAX_NEW} new tokens): " + "; ".join(
            f"{label} {w[0]:.3f} / {w[1]:.3f}"
            for label, w in list(fixed.items())[:3]) if fixed else ""))

    entry = gather_probe_entry()
    frag = entry["gather"]["shape"]
    mres = CARRIED.pop("mistral", None)
    if mres is not None:
        print(f"  Mistral-NeMo's model axis, {TP_MESH}: probed on phase 8's "
              f"spawn (its split above)")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            pods, ep, tp = TP_MESH
            spec = dict(world=pods * ep * tp, pods=pods, ep=ep, tp=tp,
                        **backend_keys(backend), device="cuda:0",
                        init_method=f"file://{tmp}/store", timeout_s=120,
                        out_dir=f"{tmp}/out", threads=2, **entry)
            t0 = time.monotonic()
            mres = ranks.run_ranks(ranks.probe_worker, spec, timeout_s=600)
        print(f"  Mistral-NeMo's model axis, {TP_MESH}: 4 ranks spawned, "
              f"probed and joined in {time.monotonic() - t0:.1f} s")
        spawn_split(mres, "the spawn")
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


def kernel_ms_by_name(fn, calls: int = 10, warm: bool = True) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, by name,
    from a ``torch.profiler`` trace of the device alone over ``calls``
    calls (after a warm one, unless ``warm`` is false)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    """The backward kernel's device time at one shape (causal with equal
    lengths, or no mask), each pass's from a profiler trace, its host
    issue, the plain backward's time, the backward of
    ``scaled_dot_product_attention`` on the same q, k, v, do and the
    bound; printed and returned as a kernels-line row's numbers."""
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
        return F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=kw["causal"], enable_gqa=True)
    # the backward alone: forward and backward captured together (so the
    # backward runs on the capturing stream), less the forward
    lib = device_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), do)) \
        - device_ms(sdpa)
    # q, o, do read and dq written; k, v read and dk, dv written; the lse
    # read; the five products of the pairs that attend
    nbytes = 2 * (4 * b * hq * sq * d + 4 * b * g * t * d) + 4 * b * hq * sq
    pairs = causal_pairs(sq, None) if kw["causal"] else sq * t
    flops = 10 * b * hq * d * pairs
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


def rounding_yardsticks(q, k, v, do, kw: dict, plain, exact, errs) -> None:
    """Beside the kernel's dq/dk/dv error ``errs`` against ``exact``
    (autograd of the plain forward in fp32), the errors of two other bf16
    backwards on the same inputs: the backward of
    ``scaled_dot_product_attention`` and the plain backward (``plain``,
    fp32 inside, bf16 out).  A kernel error within twice SDPA's is the
    rounding of bf16 gradients; more points at the kernel."""
    import torch
    import torch.nn.functional as F
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    sdpa = torch.autograd.grad(F.scaled_dot_product_attention(
        *leaves, is_causal=kw["causal"], enable_gqa=True), leaves, do)

    def err(got):
        return [(a.float() - e.float()).abs().max().item()
                for a, e in zip(got, exact)]
    lib, ref_ = err(sdpa), err(plain)
    print(f"  beside it, against the same fp32 gradients: the backward of "
          f"scaled_dot_product_attention (bf16) {lib[0]:.3e}/{lib[1]:.3e}/"
          f"{lib[2]:.3e}, the plain backward (bf16 out) {ref_[0]:.3e}/"
          f"{ref_[1]:.3e}/{ref_[2]:.3e}; kernel/sdpa "
          + "/".join(f"{a / b:.2f}" for a, b in zip(errs, lib)))


def attention_bwd_checks(failures: list) -> dict:
    """The attention backward kernel (and the forward's log-sum-exp)
    against the plain backward and against autograd of the plain forward,
    atol = rtol = 2e-2 of fp32, at DBRX's prefill shape and at edge cases;
    at DBRX's shape also two calls bit-identical; DBRX's shape and
    ``ATTN_BWD_LONG`` (held against the plain backward alone) timed beside
    the backward of ``scaled_dot_product_attention``, with the dK/dV
    blocks' balance as they ran; SeamlessM4T's encoder and decoder
    self-attention shapes (head_dim 64, non-causal and causal) timed as
    well."""
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
        # SeamlessM4T's training (phase 13) at head_dim 64 with MHA: the
        # encoder's self-attention and the decoder's cross-attention
        # non-causal, the decoder's self-attention causal over four q
        # tiles; and cross lengths apart, q longer than kv
        ("seamless-enc", (4, 16, 16, 512, 512, 64), False, None, None),
        ("seamless-dec", (4, 16, 16, 512, 512, 64), True, None, None),
        ("seamless-cross", (2, 16, 16, 300, 200, 64), False, None, None),
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
        if label == "seamless-dec":
            rounding_yardsticks(q, k, v, do, kw, plain, held[-1], errs)
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
        elif label in ("long", "seamless-enc", "seamless-dec"):
            if label == "long":
                dkdv_balance(shape, (q, k, v, out, do, lse), kw, failures)
            row[label] = dict(shape=list(shape), max_abs_err=max(errs),
                              **time_attention_bwd(
                                  label, (q, k, v, out, do, lse), lse_ref,
                                  kw))
        # the long shape's plain backward holds about 20 GB of fp32 scores
        del q, k, v, do, out, lse, lse_ref, got
        torch.cuda.empty_cache()
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:112", **row)


# ---------------------------------------------------------------------------
# phase 10 (continued): the scans' backward kernels and attention's at 256
# ---------------------------------------------------------------------------

# the scans' backward kernels against autograd of the fp32 per-step
# recurrence: within this share of each gradient's max |value|
SCAN_BWD_REL = 5e-2


def _rel_errs(got, exp) -> list:
    """max |got - exp| / max |exp| of each gradient (inf where got is not
    finite)."""
    import torch
    out = []
    for a, e in zip(got, exp):
        a, e = a.float(), e.float()
        out.append((a - e).abs().max().item() / max(e.abs().max().item(),
                                                    1e-30)
                   if torch.isfinite(a).all() else float("inf"))
    return out


def _scan_bwd_case(failures, name, label, call, exp, names) -> list:
    import torch
    got = call()
    torch.cuda.synchronize()
    errs = _rel_errs(got, exp)
    ok = all(e <= SCAN_BWD_REL for e in errs)
    print(f"  {name} {label}: max|err| / max|grad| " + ", ".join(
        f"d{n} {e:.2e}" for n, e in zip(names, errs))
        + f": {'within' if ok else 'OUTSIDE'} {SCAN_BWD_REL} of autograd of "
        f"the fp32 per-step recurrence")
    if not ok:
        failures.append(f"{name} {label}")
    return got


def _scan_bwd_row(name, source, replaces, call, again, plain, nbytes, flops,
                  failures) -> dict:
    """The served shape's two calls bit-identical, then its device time
    (a CUDA graph of 20 calls), host issue, the plain backward's time and
    the bound; no one library call computes a scan's gradient."""
    import torch
    same = all(torch.equal(a, b) for a, b in zip(again[0], again[1]))
    print(f"  {name} called twice at the served shape: "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        failures.append(f"{name}: two calls differ")
    ms = device_ms(call)
    issue = host_ms(call)
    plain_ms = time_ms(plain, iters=2, warmup=1)
    bnd, by = bound_ms(nbytes, flops)
    earlier = EARLIER_MS.get(name)
    then = "" if earlier is None else (
        f" (the first version: {earlier:.4f} ms, {earlier / ms:.2f}x "
        f"this time)")
    print(f"  {name} time (device, CUDA graph of 20 calls): kernel {ms:.4f} "
          f"ms{then}, plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}; "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP of products), "
          f"{bnd / ms:.1%} of the bound; library: none (no one PyTorch call "
          f"computes a scan's gradient); host issue {issue_text(issue)}")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=None, host_ms=issue[0])


def scan_bwd_checks(failures: list) -> dict:
    """The two scans' backward kernels against autograd of the fp32
    per-step recurrences (``ref.mamba2_ref``, ``ref.rwkv6_ref``) at the
    served shapes (Zamba2's [448, 512, 64] with one B/C group a sequence,
    RWKV6's [256, 512, 64]) and at edges: S off the 64-step chunks, one
    row, a B/C group a row (G = BH), an incoming final-state gradient, and
    RWKV-6's fast decays (chunk sums far below -88); each gradient within
    ``SCAN_BWD_REL`` of its max |value|; at the served shapes two calls
    bit-identical and timed.  Mamba2 also with three heads a B/C group,
    where the kernel's blocks own one head each.  Returns the kernels
    line's two rows."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mamba2_scan import (expand_groups,
                                                 mamba2_scan_bwd_plain,
                                                 sum_groups)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(90)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    rows = {}
    worst = 0.0
    m_cases = [  # label, (batch, heads, S, groups), final-state gradient
        ("zamba2", (4, 112, 512, "shared"), False),
        ("zamba2-dh-final", (1, 112, 512, "shared"), True),
        ("S=500", (2, 8, 500, "shared"), True),
        ("S=63", (2, 4, 63, "shared"), False),
        ("one-row", (1, 1, 65, "per-head"), True),
        ("G=BH", (2, 4, 130, "per-head"), True),
        # three heads a group: a block of one warpgroup a head
        ("odd-heads", (2, 3, 200, "shared"), True),
    ]
    for i, (label, (batch, heads, s, groups), final) in enumerate(m_cases):
        x, dt, a, b, c, d = scan_inputs_mamba2(batch, heads, s, groups,
                                               seed=91 + i)
        n, g = x.shape[0], b.shape[0]
        dy = rand(n, s, 64)
        dh = rand(n, 64, 64, dtype=torch.float32) if final else None
        exp = list(ref.grads_of(
            lambda *t: ref.mamba2_ref(*t, return_final=True),
            (x, dt, a, expand_groups(b, n), expand_groups(c, n), d), dy, dh))
        exp[3], exp[4] = sum_groups(exp[3], g), sum_groups(exp[4], g)

        def call():
            return ops.mamba2_scan_bwd(x, dt, a, b, c, d, dy, dh)
        got = _scan_bwd_case(failures, "mamba2_scan_bwd",
                             f"{label} [{n}, {s}, 64] G={g}"
                             + (" with dh_final" if final else ""), call, exp,
                             ("x", "dt", "a", "b", "c", "d"))
        worst = max(worst, max((a_.float() - e).abs().max().item()
                               for a_, e in zip(got, exp)))
        if label == "zamba2":
            # x, dy, dx bf16; dt, ddt fp32; B, C and their gradients per
            # group, bf16; a, d, da, dd; 10 products of 64^3 a chunk and
            # row (the reverse walk's 9 and the states' recompute)
            nbytes = (3 * n * s * 64 * 2 + 2 * n * s * 4 + 4 * g * s * 64 * 2
                      + 4 * n * 4)
            flops = 10 * 2 * 64 ** 3 * n * -(-s // 64)
            rows["mamba2_scan_bwd"] = _scan_bwd_row(
                "mamba2_scan_bwd",
                "src/repro_torch/kernels/csrc/mamba2_scan.cu",
                "src/repro/kernels/mamba2_scan.py:100", call,
                (got, call()),
                lambda: mamba2_scan_bwd_plain(x, dt, a, b, c, d, dy),
                nbytes, flops, failures)
        del x, dt, a, b, c, d, dy, dh, exp, got
    rows["mamba2_scan_bwd"]["max_abs_err"] = worst
    worst = 0.0
    r_cases = [  # label, inputs, final-state gradient
        ("rwkv6", lambda seed: scan_inputs_rwkv6(4, 64, 512, seed), False),
        ("rwkv6-dstate", lambda seed: scan_inputs_rwkv6(1, 64, 512, seed),
         True),
        ("S=500", lambda seed: scan_inputs_rwkv6(2, 4, 500, seed), True),
        ("S=63", lambda seed: scan_inputs_rwkv6(2, 4, 63, seed), False),
        ("one-row", lambda seed: scan_inputs_rwkv6(1, 1, 65, seed), True),
        ("fast-decays", lambda seed: rwkv6_fast_decay_inputs(8, 200, seed),
         True),
    ]
    for i, (label, make, final) in enumerate(r_cases):
        r, k, v, logw, u = make(101 + i)
        n, s = r.shape[:2]
        dy = rand(n, s, 64)
        dst = rand(n, 64, 64, dtype=torch.float32) if final else None
        exp = ref.grads_of(lambda *t: ref.rwkv6_ref(*t, return_final=True),
                           (r, k, v, logw, u), dy, dst)

        def call():
            return ops.rwkv6_scan_bwd(r, k, v, logw, u, dy, dst)
        sums = (torch.cumsum(logw[:, :32], 1)[:, -1].min().item())
        got = _scan_bwd_case(failures, "rwkv6_scan_bwd",
                             f"{label} [{n}, {s}, 64] (lowest 32-step logw "
                             f"sum {sums:.1f})"
                             + (" with dstate" if final else ""), call, exp,
                             ("r", "k", "v", "logw", "u"))
        worst = max(worst, max((a_.float() - e).abs().max().item()
                               for a_, e in zip(got, exp)))
        if label == "rwkv6":
            # r, k, v, dy, dr, dk, dv bf16; logw, dlogw fp32; u, du; a
            # chunk and row: 8 products of 64^3 (the state's update and dy
            # S0^T in the forward walk; dy v^T, v dy^T, v G^T, A^T dy, k~ G
            # and G's update), and the sub-chunk products of drs, dks and
            # A^T (6 blocks of 16 x 16 x 64 each) and their quadrants (12
            # of 8 x 8 x 64)
            nbytes = 7 * n * s * 64 * 2 + 2 * n * s * 64 * 4 + 2 * n * 64 * 4
            flops = 2 * n * -(-s // 64) * (8 * 64 ** 3 + 3 * 6 * 16 * 16 * 64
                                           + 12 * 8 * 8 * 64)
            rows["rwkv6_scan_bwd"] = _scan_bwd_row(
                "rwkv6_scan_bwd",
                "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                "src/repro/kernels/rwkv6_scan.py:97", call, (got, call()),
                lambda: ref.rwkv6_chunked_bwd(r, k, v, logw, u, dy),
                nbytes, flops, failures)
        del r, k, v, logw, u, dy, dst, exp, got
    rows["rwkv6_scan_bwd"]["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return rows


def attention_bwd_256(failures: list) -> dict:
    """The attention backward at head_dim 256: Gemma2's served prefill
    shape (q [2, 16, 8160, 256] over 8 kv heads, softcap 50, its 4,096
    window and global) against the plain backward, run a (batch, kv head)
    slice at a time (whole, its fp32 scores would take tens of GB), within
    atol = rtol = 2e-2; two calls bit-identical at both masks; timed
    (device, each pass from a profiler trace, host issue
    of 5 calls, the slices' plain backward, the bound, and the backward of
    ``flex_attention`` under ``torch.compile`` with the same cap and mask
    as the library call; the backward of ``scaled_dot_product_attention``
    without the softcap printed as a yardstick, not the same function).
    Then edges against autograd of the plain forward in fp32: one q row, a
    ragged length, a window under one tile, no mask with lengths apart, and
    q x 10 where the cap bites.  Returns the ``flash_attention_bwd`` row's
    ``head_dim_256`` entry."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_plain)
    from repro_torch.launch.host_issue import runs
    bf16 = torch.bfloat16
    b, hq, g, s, d = GEMMA_ATTN
    rep = hq // g

    def rand(seed, *shape, scale=1.0):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(bf16)
    q = rand(110, b, s, hq, d).transpose(1, 2)
    k = rand(111, b, s, g, d).transpose(1, 2)
    v = rand(112, b, s, g, d).transpose(1, 2)
    do = rand(113, b, s, hq, d).transpose(1, 2)
    entry = {"shape": [b, hq, g, s, s, d], "softcap": GEMMA_SOFTCAP,
             "library": "the backward of flex_attention (torch.compile), "
                        "score_mod c * tanh(s / c), causal block mask"}
    for window in (GEMMA_WINDOW, None):
        kw = dict(causal=True, window=window, softcap=GEMMA_SOFTCAP)
        tag = "global" if window is None else f"window {window}"
        out, lse = _forward(q, k, v, (True, window, GEMMA_SOFTCAP, None),
                            with_lse=True)

        def call():
            return ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)

        def plain_slices(check=None):
            for bb in range(b):
                for gg in range(g):
                    qs = slice(gg * rep, (gg + 1) * rep)
                    one = (q[bb:bb + 1, qs], k[bb:bb + 1, gg:gg + 1],
                           v[bb:bb + 1, gg:gg + 1])
                    exp = ref.attention_bwd_ref(
                        *one, out[bb:bb + 1, qs], do[bb:bb + 1, qs],
                        ref.attention_lse(one[0], one[1], **kw), **kw)
                    if check is not None:
                        check(bb, gg, qs, exp)
        got = call()
        errs, oks = [0.0, 0.0, 0.0], [True]

        def check(bb, gg, qs, exp):
            mine = (got[0][bb:bb + 1, qs], got[1][bb:bb + 1, gg:gg + 1],
                    got[2][bb:bb + 1, gg:gg + 1])
            for j, (a_, e) in enumerate(zip(mine, exp)):
                errs[j] = max(errs[j], (a_.float() - e.float()).abs().max()
                              .item())
                oks[0] &= torch.allclose(a_.float(), e.float(), **ATTN_TOL)
        plain_slices(check)
        torch.cuda.synchronize()
        print(f"  flash_attention_bwd gemma2 {tag} [{b}, {hq}, {s}, {d}] over "
              f"{g} kv heads, softcap {GEMMA_SOFTCAP}: dq/dk/dv max|err| "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} against the plain "
              f"backward ({b * g} slices): "
              f"{'within' if oks[0] else 'OUTSIDE'} atol=rtol=2e-2")
        if not oks[0]:
            failures.append(f"flash_attention_bwd gemma2 {tag}")
        same = all(torch.equal(a_, c_) for a_, c_ in zip(got, call()))
        print(f"  flash_attention_bwd gemma2 {tag} called twice: dq, dk, dv "
              f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            failures.append(f"flash_attention_bwd 256 {tag}: two calls differ")
        del got
        ms = device_ms(call)
        by_name = kernel_ms_by_name(call, calls=3, warm=False)
        passes = {part: sum(v for n, v in by_name.items() if part in n)
                  for part in ("prep_kernel", "dq_kernel", "dkdv_kernel")}
        issue = runs(call, 1, calls=5)[0]
        plain_ms = time_ms(plain_slices, iters=1, warmup=0)
        qs_, ks_, vs_ = (x.detach().requires_grad_(True) for x in (q, k, v))
        lib = None
        try:
            flex = flex_softcap(window, GEMMA_SOFTCAP, s)
            lib = (time_ms(lambda: torch.autograd.grad(
                flex(qs_, ks_, vs_), (qs_, ks_, vs_), do), iters=5)
                - time_ms(lambda: flex(qs_, ks_, vs_), iters=5))
        except Exception as err:  # the yardstick alone; the kernel is held
            print(f"  the backward of flex_attention did not run: {err!r}")
        sdpa = (time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qs_, ks_, vs_, is_causal=True,
                                           enable_gqa=True),
            (qs_, ks_, vs_), do), iters=5)
            - time_ms(lambda: F.scaled_dot_product_attention(
                qs_, ks_, vs_, is_causal=True, enable_gqa=True), iters=5))
        del qs_, ks_, vs_
        nbytes = 2 * (4 * b * hq * s * d + 4 * b * g * s * d) + 4 * b * hq * s
        flops = 10 * b * hq * d * causal_pairs(s, window)
        bnd, by = bound_ms(nbytes, flops)
        lib_txt = "not measured" if lib is None else (
            f"{lib:.4f} ms (kernel/flex {ms / lib:.2f}: "
            f"{'below' if ms < lib else 'NOT below'} it)")
        earlier = EARLIER_MS[f"flash_attention_bwd 256 {tag}"]
        split = ", ".join(f"{part.split('_')[0]} {v:.4f} ms" if v else
                          f"{part.split('_')[0]} not measured"
                          for part, v in passes.items())
        print(f"  flash_attention_bwd gemma2 {tag} time (device, CUDA graph "
              f"of 20 calls): kernel {ms:.4f} ms (profiler: {split}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s; the first version (mma.sync) "
              f"{earlier:.4f} ms, {earlier / ms:.2f}x this time; plain "
              f"({b * g} slices) {plain_ms:.4f} ms; the backward of "
              f"flex_attention {lib_txt}; bound {bnd:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), "
              f"{bnd / ms:.1%} of the bound; host issue {issue:.4f} ms a call "
              f"(one run of 5 calls); yardstick, not the same function: the "
              f"backward of scaled_dot_product_attention, causal, global, no "
              f"softcap, {sdpa:.4f} ms")
        entry["global" if window is None else "window"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
            library_ms=lib, max_abs_err=max(errs), host_ms=issue,
            sdpa_yardstick_ms=sdpa,
            pass_ms={part.split("_")[0]: v for part, v in passes.items()})
        del out, lse
        torch.cuda.empty_cache()
    del q, k, v, do
    # label, (b, heads, kv heads, Sq, Sk), causal, window, softcap, q x;
    # q x 10 scales dK with it (to about 10), so bf16's rounding of dS
    # before dS^T Q alone moves dK by more than 2e-2: that case is held
    # against the plain backward with P and dS rounded to bf16 where the
    # kernel rounds them, its distance from fp32 printed beside
    edges = [
        ("256-one-row", (1, 16, 8, 1, 1), True, None, GEMMA_SOFTCAP, 1.0),
        ("256-ragged", (2, 16, 8, 200, 200), True, GEMMA_WINDOW,
         GEMMA_SOFTCAP, 1.0),
        ("256-window-under-tile", (2, 16, 8, 300, 300), True, 20,
         GEMMA_SOFTCAP, 1.0),
        ("256-cross", (1, 4, 2, 77, 333), False, None, GEMMA_SOFTCAP, 1.0),
        ("256-cap-bites", (2, 16, 8, 300, 300), True, 20, 3.0, 1.0),
        ("256-cap-bites-q10", (2, 16, 8, 300, 300), True, 20, GEMMA_SOFTCAP,
         10.0),
    ]
    worst = 0.0
    for i, (label, (bb, h, gg, sq, sk), causal, window, cap, q_x) in \
            enumerate(edges):
        q = rand(120 + i, bb, sq, h, d, scale=q_x).transpose(1, 2)
        k = rand(130 + i, bb, sk, gg, d).transpose(1, 2)
        v = rand(140 + i, bb, sk, gg, d).transpose(1, 2)
        do = rand(150 + i, bb, sq, h, d).transpose(1, 2)
        kw = dict(causal=causal, window=window, softcap=cap)
        out, lse = _forward(q, k, v, (causal, window, cap, None),
                            with_lse=True)
        got = ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
        exact = torch.autograd.grad(flash_attention_plain(*leaves, **kw),
                                    leaves, do.float())
        exp, against, note = exact, "autograd of the plain forward", ""
        if cap != GEMMA_SOFTCAP or q_x > 1.0:
            leaves = [x.float().requires_grad_(True) for x in (q, k, v)]
            uncapped = torch.autograd.grad(flash_attention_plain(
                *leaves, **{**kw, "softcap": None}), leaves, do.float())
            bites = not all(torch.allclose(a_, e, **ATTN_TOL)
                            for a_, e in zip(uncapped, exact))
            note = (f"; without the cap the gradients move "
                    f"{'outside' if bites else 'WITHIN'} the tolerance")
            if not bites:
                failures.append(f"flash_attention_bwd {label}: the softcap "
                                f"does not bite")
        if q_x > 1.0:
            exp = [x.float() for x in ref.attention_bwd_ref(
                q, k, v, out, do, ref.attention_lse(q, k, **kw), **kw,
                operands=bf16)]
            against = "the plain backward with P and dS rounded to bf16"
            far = [(a_.float() - e).abs().max().item()
                   for a_, e in zip(got, exact)]
            note += (f"; from fp32 autograd {far[0]:.3e}/{far[1]:.3e}/"
                     f"{far[2]:.3e}, max|grad| " + "/".join(
                         f"{e.abs().max().item():.2f}" for e in exact))
        torch.cuda.synchronize()
        errs = [(a_.float() - e).abs().max().item() for a_, e in zip(got, exp)]
        ok = all(torch.allclose(a_.float(), e, **ATTN_TOL)
                 for a_, e in zip(got, exp))
        worst = max(worst, *errs)
        print(f"  flash_attention_bwd {label} {(bb, h, gg, sq, sk, d)} "
              f"causal={causal} window={window} softcap={cap}, q x {q_x:g}: "
              f"dq/dk/dv max|err| {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} "
              f"against {against}: {'within' if ok else 'OUTSIDE'} "
              f"atol=rtol=2e-2{note}")
        if not ok:
            failures.append(f"flash_attention_bwd {label}")
    entry["edges_max_abs_err"] = worst
    torch.cuda.empty_cache()
    return entry


def small_family_configs() -> list:
    """(label, config, sequence) of the small models whose bf16 gradients
    on the card are held to fp32 on the CPU beside the small DBRX: the
    Zamba2-, RWKV6- and Gemma2-shaped models of phase 4 (the scans at
    heads of 64, the shared block at head_dim 112; Gemma2 at head_dim 256
    with its softcaps and a 32-token window that 80 tokens overrun)."""
    from repro_torch.configs.base import get_config
    return [
        ("Zamba2-shaped", get_config("zamba2_7b").reduced(
            n_layers=4, d_model=448, n_heads=4, n_kv_heads=4, d_ff=512,
            vocab=1024, ssm_state=64, ssm_head_dim=64, shared_attn_every=2),
         100),
        ("RWKV6-shaped", get_config("rwkv6_7b").reduced(
            n_layers=2, d_model=512, d_ff=1024, vocab=1024,
            rwkv_head_dim=64, rwkv_decay_lora=64), 100),
        ("Gemma2-shaped", get_config("gemma2_9b").reduced(
            d_model=512, n_heads=2, d_head=256, d_ff=512, vocab=1024), 80),
    ]


def grad_reference_check(label: str = "DBRX-shaped", cfg=None,
                         seq: int = 64) -> None:
    """A small model (by default DBRX-shaped: head_dim 128, 4 experts all
    active) in bf16 on the card (kernels) against the same weights in fp32
    on the CPU (plain versions): one loss and backward of 4 x ``seq``
    tokens each; the loss within ``LOSS_GAP`` and every parameter's
    gradient at a cosine above ``GRAD_COSINE``, and the kernels' launches
    exactly one forward and one backward of each kernel a layer."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model, param_module
    from repro_torch.models.ssm import n_shared_calls
    from repro_torch.runtime.trainer import trainable

    if cfg is None:
        cfg = get_config("dbrx_132b").reduced(
            d_model=512, n_heads=4, n_kv_heads=2, d_ff=256, vocab=1024,
            num_experts=4, top_k=4)
    gpu = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    params = gpu.init(gen)
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu_params = param_module(cfg, device="cpu", dtype=torch.float32)
    cpu_params.load_state_dict({k: v.float().cpu()
                                for k, v in params.state_dict().items()})
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
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
    kind = {"moe": f", {cfg.num_experts} experts top-{cfg.top_k}",
            "hybrid": f", mamba heads of {cfg.ssm_head_dim}, ds "
                      f"{cfg.ssm_state}",
            "rwkv": f", wkv heads of {cfg.rwkv_head_dim}"}.get(cfg.family, "")
    print(f"  small {label} model ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, head_dim {cfg.head_dim}{kind}), loss and backward "
          f"of 4 x {seq} tokens: card bf16 {losses[0]:.5f} vs CPU fp32 "
          f"{losses[1]:.5f}, gap {gap:.3e} (limit {LOSS_GAP}); gradient "
          f"cosines of {len(cosines)} parameters, lowest "
          f"{cosines[worst]:.6f} ({worst}; limit {GRAD_COSINE}); kernel "
          f"launches {counts}")
    low = {k: v for k, v in cosines.items() if not v > GRAD_COSINE}
    if not gap < LOSS_GAP or low:
        raise AssertionError(f"small {label} gradients: loss gap {gap:.3e}, "
                             f"cosines below {GRAD_COSINE}: {low}")
    if cfg.family == "moe":
        want = {"dispatch_pack": 3 * cfg.n_layers,
                "dispatch_pack_bwd": 3 * cfg.n_layers,
                "flash_attention": cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
    elif cfg.family == "hybrid":
        want = {"mamba2_scan": cfg.n_layers,
                "mamba2_scan_bwd": cfg.n_layers,
                "flash_attention": n_shared_calls(cfg),
                "flash_attention_bwd": n_shared_calls(cfg)}
    elif cfg.family == "rwkv":
        want = {"rwkv6_scan": cfg.n_layers, "rwkv6_scan_bwd": cfg.n_layers}
    else:
        want = {"flash_attention": cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
    if counts != want:
        raise AssertionError(f"small {label}: launches {counts} != {want}")


def synthetic_trainer(cfg, lr: float, steps: int, ckpt_dir=None,
                      save_at: int = 1, batch: int = TRAIN_BATCH,
                      seq: int = TRAIN_SEQ):
    """The card's bf16 model of ``cfg`` and a function ``trainer(total,
    ckpt=False)`` that makes a fresh ``Trainer`` of it: ``batch`` x
    ``seq`` SyntheticLM tokens (seed 0) a step through
    ``batch_for_model``, AdamW (weight decay 0.01) on a cosine schedule of
    ``lr`` over ``steps`` with one warm-up step, weights drawn from seed 0,
    every step logged; with ``ckpt``, a checkpoint into ``ckpt_dir`` every
    ``save_at`` steps, restored from there when one exists."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=0))

    def make_batch(step):
        return batch_for_model(cfg, data.batch(step), device="cuda")

    def trainer(total, ckpt=False):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        return Trainer(model, adamw(lr=cosine_schedule(lr, warmup=1,
                                                       total=steps),
                                    weight_decay=0.01),
                       make_batch, TrainerConfig(
                           total_steps=total, checkpoint_every=save_at,
                           checkpoint_dir=str(ckpt_dir) if ckpt else None,
                           log_every=1),
                       generator=gen)
    return trainer


def train_gates(hist: list, counts: dict, want: dict,
                tokens: int = TRAIN_BATCH * TRAIN_SEQ) -> tuple[list, float]:
    """Prints each step of a trainer's ``hist`` and the mean wall of steps 2
    on with its tokens/s (``tokens`` a step).  Returns
    the failures of the training gates (launches ``counts`` equal to
    ``want``, finite losses and gradient norms, the mean loss of the last 3
    steps below that of the first 3) and that mean wall in ms."""
    import math
    for h in hist:
        print(f"  step {h['step']}: loss {h['loss']:.5f} (ce {h['ce']:.5f}, "
              f"aux {h['aux']:.5f}), grad norm {h['grad_norm']:.4f}, wall "
              f"{h['wall'] * 1e3:.1f} ms")
    walls = [h["wall"] for h in hist]
    step_ms = sum(walls[1:]) / (len(walls) - 1) * 1e3
    print(f"  first step {walls[0] * 1e3:.1f} ms; steps 2-{len(walls)} "
          f"{step_ms:.1f} ms a step, "
          f"{tokens / step_ms * 1e3:.1f} tokens/s")
    failures = []
    if counts != want:
        failures.append(f"launches {counts} != {want}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist):
        failures.append("a non-finite loss or gradient norm")
    first = sum(h["loss"] for h in hist[:3]) / 3
    last = sum(h["loss"] for h in hist[-3:]) / 3
    print(f"  mean loss of the first 3 steps {first:.5f}, of the last 3 "
          f"{last:.5f}")
    if not last < first:
        failures.append(f"the loss did not fall: {first:.5f} -> {last:.5f}")
    return failures, step_ms


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
    from repro_torch.kernels import ops
    from repro_torch.models.api import param_count

    cfg = dataclasses.replace(get_config("dbrx_132b"), n_layers=TRAIN_DEPTH)
    ckpt_dir = ROOT / "build" / "train_checkpoint"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    trainer = synthetic_trainer(cfg, TRAIN_LR, TRAIN_STEPS, ckpt_dir,
                                save_at=TRAIN_SAVE_AT)

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
    grad_bytes = {}                            # each gradient as made
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grad_bytes.__setitem__(
            n, p.grad.numel() * p.grad.element_size()))
        for n, p in tr.state.named().items()]
    ops.reset_launches()
    tr.run()                                   # steps 0-3, then the save
    for hook in hooks:
        hook.remove()
    save_s = timed["save_s"]
    tr.ckpt = None                             # no more saves
    tr.cfg = dataclasses.replace(tr.cfg, total_steps=TRAIN_STEPS,
                                 checkpoint_dir=None)
    tr.run()                                   # steps 4-7
    torch.cuda.synchronize()
    counts = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = tr.metrics_history
    named = tr.state.named()
    MEASURED["phase 10"] = dict(
        cfg=cfg, peak=torch.cuda.max_memory_allocated(),
        weights=sum(p.numel() * p.element_size() for p in named.values()),
        grads=sum(grad_bytes.values()),
        opt_state=sum(t.numel() * t.element_size() for t in
                      torch.utils._pytree.tree_leaves(tr.state.opt_state)
                      if isinstance(t, torch.Tensor)))
    want = launch_counts(dispatch_pack=3 * cfg.n_layers * TRAIN_STEPS,
                         dispatch_pack_bwd=3 * cfg.n_layers * TRAIN_STEPS,
                         flash_attention=cfg.n_layers * TRAIN_STEPS,
                         flash_attention_bwd=cfg.n_layers * TRAIN_STEPS)
    failures, step_ms = train_gates(hist, counts, want)
    print(f"  peak memory {peak_gb:.2f} GB (max_memory_allocated); "
          f"checkpoint of step {TRAIN_SAVE_AT} written in {save_s:.1f} s")
    print(f"  launches over {TRAIN_STEPS} steps: {counts} (expected {want}: "
          f"per step and layer 3 packs and 3 pack backwards, 1 attention "
          f"forward and 1 backward; nothing recomputed)")
    losses = [h["loss"] for h in hist]
    update_ms, clip_ms = time_update(tr)
    rest = step_ms - update_ms - clip_ms
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
    timed["restore_s"] = tr.ckpt.last_restore_s
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                     if f.is_file())
    tr.ckpt = None                             # continue without saving
    if tr.state.step != TRAIN_SAVE_AT:
        failures.append(f"the fresh trainer resumed at step {tr.state.step}")
    tr.run()
    again = [h["loss"] for h in tr.metrics_history]
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(again, losses[TRAIN_SAVE_AT:]))
    print(f"  restored at step {TRAIN_SAVE_AT} into a fresh trainer "
          f"(set-up and restore {restore_s:.1f} s, the restore alone "
          f"{timed['restore_s']:.1f} s: {ckpt_bytes / 1e9:.2f} GB on disk, "
          f"{ckpt_bytes / 1e9 / timed['restore_s']:.2f} GB/s; written at "
          f"{ckpt_bytes / 1e9 / save_s:.2f} GB/s): losses "
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
    disk = disk_rate(ckpt_dir, ckpt_bytes)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"  the disk where the checkpoint was written, a file of its "
          f"{disk['bytes'] / 1e9:.2f} GB in 64 MB pieces: written at "
          f"{disk['write_gb_s']:.2f} GB/s (no fsync, as the checkpoint), "
          f"read back at {disk['read_warm_gb_s']:.2f} GB/s (warm: the file "
          f"cache not dropped), zlib.crc32 at {disk['crc32_gb_s']:.2f} GB/s "
          f"(one pass each way); the checkpoint written at "
          f"{ckpt_bytes / 1e9 / save_s:.2f} GB/s and restored at "
          f"{ckpt_bytes / 1e9 / timed['restore_s']:.2f} GB/s")
    MEASURED["phase 10 disk"] = disk
    if failures:
        raise AssertionError(f"phase 10: {failures}")
    return counts


def disk_rate(directory, nbytes: int) -> dict:
    """The disk's own rates in ``directory``, for a checkpoint's write and
    restore to be read against: a file of ``nbytes`` of random bytes
    written in 64 MB pieces, as the checkpoint's zip writer writes (no
    ``fsync``, as it makes none), read back in 64 MB pieces (warm: the
    file cache is not dropped, so the read comes largely from memory), and
    ``zlib.crc32`` over a piece in memory: the one CRC pass the checkpoint
    makes each way.  The file is removed.  GB/s."""
    import os
    import zlib
    piece = 64 << 20
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"disk_rate.{os.getpid()}.bin")
    pieces = max(1, int(nbytes) // piece)
    data = os.urandom(piece)
    out = {"bytes": pieces * piece}
    try:
        t0 = time.monotonic()
        with open(path, "wb") as f:
            for _ in range(pieces):
                f.write(data)
        out["write_gb_s"] = pieces * piece / 1e9 / (time.monotonic() - t0)
        t0 = time.monotonic()
        with open(path, "rb") as f:
            while f.read(piece):
                pass
        out["read_warm_gb_s"] = pieces * piece / 1e9 / (time.monotonic()
                                                        - t0)
    finally:
        if os.path.exists(path):
            os.remove(path)
    t0 = time.monotonic()
    for _ in range(16):
        zlib.crc32(data)
    out["crc32_gb_s"] = 16 * piece / 1e9 / (time.monotonic() - t0)
    return out


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
    """Phase 10.  Returns (the kernels JSON rows of the four backward
    kernels, the launches of the full-width training run)."""
    failures: list = []
    rows = {"dispatch_pack_bwd": pack_bwd_checks(failures),
            "flash_attention_bwd": attention_bwd_checks(failures)}
    rows["flash_attention_bwd"]["head_dim_256"] = attention_bwd_256(failures)
    rows.update(scan_bwd_checks(failures))
    if failures:
        raise AssertionError(f"backward kernels disagree: {failures}")
    grad_reference_check()
    for label, cfg, seq in small_family_configs():
        grad_reference_check(label, cfg, seq)
    return rows, train_full_width()



# ---------------------------------------------------------------------------
# phase 11: training over ranks
# ---------------------------------------------------------------------------

# DBRX over 2 pods x 2 ep ranks at full width: (depth, steps, tokens a
# prompt) on one card (4 processes over the card transport) and on four
# (nccl, a card a rank);
# 4 prompts of SyntheticLM seed 0, one a rank; AdamW (bf16 state) on a
# cosine schedule; capacity factor RANKS_CF, so nothing is dropped
TRAIN_RANKS = {1: (1, 6, 512), 4: (2, 8, 512)}
# lr: at phase 10's 1e-3 the full-width models' loss spikes after the first
# update on one rank as over ranks (12.0 -> 20.9 in phase 10, 11.9 -> 26.7
# here), and 6 steps do not bring it back down
TRAIN_RANKS_BATCH, TRAIN_RANKS_SEQ, TRAIN_RANKS_LR = 4, 512, 1e-4
# Mistral-NeMo-12B over (1, 1, 4) TP ranks, full width
TP_TRAIN_DEPTH, TP_TRAIN_STEPS = 2, 4
TP_TRAIN_GAP = 2e-2           # step-1 loss and grad norm against one rank
# attention's backward under the loss's own cotangent, where it misses
# ranks.ATTN_BWD_REL: at most this many times SDPA's backward's error on
# the same inputs (phase 14; ROADMAP.md §3)
ATTN_BWD_SDPA = 2.0
# the step-0 gradients reduced once by each scheme (their first 8 M
# elements): layer 0's attention projections
SCHEME_LEAVES = ("blocks.0.attn.wq", "blocks.0.attn.wo")


def train_ranks_spec(tmp: str, mesh: tuple, backend: str, cfg, runs: list,
                     steps: int, seq: int, **kw) -> dict:
    import torch
    pods, ep, tp = mesh
    return dict(world=pods * ep * tp, pods=pods, ep=ep, tp=tp,
                **backend_keys(backend), device="cuda",
                init_method=f"file://{tmp}/store", timeout_s=600,
                out_dir=f"{tmp}/out", threads=2, dp_servers=(pods,),
                cfg=cfg, dtype=torch.bfloat16, seed=0,
                batch=TRAIN_RANKS_BATCH, seq=seq, steps=steps,
                lr=TRAIN_RANKS_LR, runs=runs, **kw)


def train_ranks_plan(which: str, backend: str) -> dict:
    """Phase 11's training ``which`` ("dbrx": the reduced DBRX and DBRX at
    full width over 2 x 2; "mistral": Mistral-NeMo over ``TP_MESH``), or
    phase 14's ("tp families": ``TP_FAMILIES_TRAIN`` over
    ``TP_FAMILIES_MESH``, each against one rank on rank 0) as
    the keys of a :func:`ranks.train_worker` spec: ``cfg``, ``runs``,
    ``steps``, ``seq`` and, over nccl, DBRX's ``measure_link``."""
    import dataclasses

    from repro_torch.configs.base import get_config
    if which == "tp families":
        runs = []
        for arch, depth in TP_FAMILIES_TRAIN:
            cfg = get_config(arch)
            runs.append(dict(label=arch, cfg=cfg if depth is None else
                             cfg.with_depth(depth), check_kernels=True,
                             one_rank=0,
                             remat_twin=arch in TP_FAMILIES_REMAT))
        runs.append(dict(label=REPLICATED_TWIN, cfg=replicated_twin(),
                         check_kernels=True, one_rank=0))
        return dict(cfg=runs[0]["cfg"], steps=TP_FAMILIES_STEPS,
                    seq=TRAIN_RANKS_SEQ, runs=runs)
    if which == "mistral":
        cfg = dataclasses.replace(get_config("mistral_nemo_12b"),
                                  n_layers=TP_TRAIN_DEPTH)
        return dict(cfg=cfg, steps=TP_TRAIN_STEPS, seq=TRAIN_RANKS_SEQ,
                    runs=[dict(label="tp", policy="auto", tp_subgroups=2,
                               check_kernels=True)])
    depth, steps, seq = TRAIN_RANKS[4 if backend == "nccl" else 1]
    small = get_config("dbrx_132b").reduced(
        d_model=512, n_heads=4, n_kv_heads=2, d_ff=256, vocab=1024,
        num_experts=8, top_k=2)
    small = dataclasses.replace(small, moe_capacity=RANKS_CF)
    cfg = dataclasses.replace(get_config("dbrx_132b"), n_layers=depth,
                              moe_capacity=RANKS_CF)
    link = 64 << 20 if backend == "nccl" else None
    return dict(cfg=cfg, steps=steps, seq=seq, measure_link=link,
                runs=[dict(label="reduced", cfg=small, grads=True,
                           grad_of="ce", steps=1),
                      dict(label="dbrx", policy="auto", check_kernels=True,
                           schemes=list(SCHEME_LEAVES),
                           fabric="measured" if link else None)])


def train_entry(which: str, backend: str, phase: int = 11) -> dict:
    """Phase ``phase``'s training ``which`` (:func:`train_ranks_plan`) as
    an entry of a serving spawn's ``models`` (:func:`ranks.serve_worker`),
    run after that spawn's serving on the same mesh."""
    import torch
    return dict(name=f"phase {phase} {which}", train=True,
                dtype=torch.bfloat16,
                seed=0, batch=TRAIN_RANKS_BATCH, lr=TRAIN_RANKS_LR,
                **train_ranks_plan(which, backend))


def one_rank_step0(cfg, seq: int, *, grads: bool) -> tuple:
    """The step-0 loss, ce and global gradient norm of ``cfg`` on one rank
    on the card (bf16, seed 0, ``TRAIN_RANKS_BATCH`` x ``seq`` tokens), and
    with ``grads`` the ce gradients by name (fp32, host)."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.models.api import build_model
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.runtime.trainer import trainable
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    named = trainable(params)
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                 global_batch=TRAIN_RANKS_BATCH,
                                 seed=0)).batch(0)
    loss, met = model.loss(params, batch_for_model(cfg, raw, device="cuda"))
    (met["ce"] if grads else loss).backward()
    out = (loss.item(), met["ce"].item(),
           global_norm({n: p.grad for n, p in named.items()}).item(),
           {n: p.grad.float().cpu() for n, p in named.items()}
           if grads else None)
    del model, params, named
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_run_lines(label: str, runs: list, failures: list, *,
                    where: str, yardstick: bool = False) -> dict:
    """Print a trained run of every rank (losses, the slowest rank's step
    split into its parts, the gradient sync, the peak memory) and gate
    it: finite losses and norms, the same grad norm on every rank, every
    replicated leaf the same bits on every rank, each backward kernel of
    the checked step held against its plain version (with ``yardstick``
    attention's also where, under the loss's own cotangent, it lies no
    further from the plain version than ``ATTN_BWD_SDPA`` times SDPA's
    backward on the same inputs, ROADMAP.md §3's rule).  Returns the
    kernel launches summed over the ranks."""
    import math

    from repro_torch.launch import ranks
    hist = [r["history"] for r in runs]
    first = runs[0]
    for step in range(len(hist[0])):
        slow = max(range(len(runs)), key=lambda i: hist[i][step]["wall"])
        h = hist[slow][step]
        print(f"  {label} step {h['step']}: loss {h['loss']:.5f} (ce "
              f"{h['ce']:.5f}, aux {h['aux']:.5f}), grad norm "
              f"{h['grad_norm']:.4f}; slowest rank {slow}: wall "
              f"{h['wall'] * 1e3:.1f} ms = forward+backward "
              f"{h['fwd_bwd_ms']:.1f} + gradient mean {h['sync_ms']:.1f} + "
              f"clip {h['clip_ms']:.1f} + update {h['update_ms']:.1f} ms "
              f"(CUDA events)")
    sync = (f"gradient mean {first['scheme']} run once after the backward "
            f"(the plan's grad_sync verdict: {first['decision']}; its "
            f"G={first['sync_g']} is not executed), "
            f"{first['sync_bytes'] / 1e9:.3f} GB of gradients all-reduced "
            f"a rank a step: "
            + ", ".join(f"{part} {v / 1e9:.3f}"
                        for part, v in first["sync_parts"].items())
            + " GB (the FSDP shards' and experts' over the pods alone; the "
            f"shards reduce-scattered over data in the backward)"
            if first["dp"] > 1 else
            "no gradient mean (one data-parallel rank)")
    print(f"  {label}: {sync}; MoE round trip {first['moe']}; peak memory a "
          f"rank "
          f"{max(r.get('peak_gb', 0.0) for r in runs):.2f} GB "
          f"(max_memory_allocated; {first['params'] / 1e9:.3f} B "
          f"parameters a rank); run {max(r['seconds'] for r in runs):.1f} "
          f"s {where}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for hs in hist for h in hs):
        failures.append(f"{label}: a non-finite loss or grad norm")
    norms = [[h["grad_norm"] for h in hs] for hs in hist]
    if any(n != norms[0] for n in norms):
        failures.append(f"{label}: grad norms differ over ranks {norms}")
    differ = sorted({n for r in runs for n in first["replicated"]
                     if r["digest"][n] != first["digest"][n]})
    # an FSDP shard is the same bits on the ranks of its (data, model)
    # coordinate: its pod replicas
    differ += sorted({n for r in runs for q in runs for n in first["fsdp"]
                      if (r["coords"]["data"], r["coords"]["model"])
                      == (q["coords"]["data"], q["coords"]["model"])
                      and r["digest"][n] != q["digest"][n]})
    # a segment of an FSDP shard that every model rank holds whole: the
    # same bits on the ranks of its data coordinate
    differ += sorted({n for r in runs for q in runs
                      for n in first["data_replicated"]
                      if r["coords"]["data"] == q["coords"]["data"]
                      and r["digest"][n] != q["digest"][n]})
    fsdp = (f", {len(first['fsdp'])} FSDP shards on their pod replicas"
            if first["fsdp"] else "")
    print(f"  {label}: {len(first['replicated'])} replicated leaves on "
          f"every rank{fsdp} "
          f"{'bit-identical' if not differ else 'DIFFER'}"
          f"{': ' + ', '.join(differ[:5]) if differ else ''}; grad norm the "
          f"same bits on every rank: {all(n == norms[0] for n in norms)}")
    if differ:
        failures.append(f"{label}: replicas differ: {differ[:5]}")
    checks = [c for r in runs for c in r.get("kernel_checks", [])]
    for name in ("dispatch_pack_bwd", "flash_attention_bwd",
                 "mamba2_scan_bwd", "rwkv6_scan_bwd"):
        mine = [c for c in checks if c[0] == name]
        if not mine:
            continue
        shapes = sorted({c[1] for c in mine})
        worst = max(c[2] for c in mine)
        rel = max(c[4] for c in mine)
        lib = {c[1]: c[4] for c in checks if c[0] == "sdpa_bwd"}
        held = all(c[3] or (yardstick and c[1] in lib
                            and c[4] <= ATTN_BWD_SDPA * lib[c[1]])
                   for c in mine)
        sdpa = [lib[c[1]] for c in mine if c[1] in lib]
        how = ("bit-exact" if name == "dispatch_pack_bwd" else
               f"against the plain backward on the inputs in fp32: each "
               f"gradient within {ranks.SCAN_BWD_REL} of its largest "
               f"element, worst {rel:.3e}" if "scan" in name else
               f"against autograd of the plain forward: max|err| under a "
               f"unit-scale randn cotangent, atol=rtol=2e-2; under the "
               f"loss's own cotangent {rel:.3e} of each gradient's largest "
               f"element, limit {ranks.ATTN_BWD_REL}"
               + (f"; SDPA's backward on the same inputs {max(sdpa):.3e}"
                  if sdpa else ""))
        print(f"  {label}: {name} at {len(mine)} calls of shapes {shapes} "
              f"against its plain version: max|err| {worst:.3e}, "
              f"{'held' if held else 'NOT HELD'} ({how})")
        if not held:
            failures.append(f"{label}: {name} disagrees at {shapes}")
    total = {}
    for r in runs:
        for name, n in r["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


def train_ranks_phase() -> dict:
    """Phase 11: training over ranks.

    DBRX-132B over 2 pods x 2 ep ranks, one prompt a rank (``TRAIN_RANKS``:
    nccl with a card a rank where there are 4 cards, else 4 processes on
    card 0 over the card transport): first the reduced DBRX, whose step-0
    ce and gradients (synced, gathered) are held against one rank on the card
    (ce within ``LOSS_GAP``, every gradient's cosine above
    ``GRAD_COSINE``); then the full width at ``TRAIN_RANKS``' depth,
    trained under the plan bound for the train program (the MoE round
    trip and the ``grad_sync`` verdict; over nccl on the fabric the ranks
    measured), whose step-0 backward holds every pack backward bit-exact
    and attention's backward within 2e-2 of autograd of its plain forward
    at the ranks' shapes, and whose step-0 gradients of
    ``SCHEME_LEAVES`` are reduced once by each scheme (each lossless one
    the mean within fp32 sum order, ``compressed`` within its int8
    tolerance).  Then Mistral-NeMo-12B over (1, 1, 4) at full width, depth
    ``TP_TRAIN_DEPTH``, through the split-TP MultiWrite gather
    (``tp_subgroups`` 2), against one rank's step-0 loss and grad norm.

    Gates: finite losses, the mean loss of DBRX's last 3 steps below its
    first 3, every replicated leaf bit-identical on every rank, the same
    grad norm on every rank, exact launch counts a step, each kernel
    against its plain version.  Each training rides an earlier phase's
    spawn when that phase carried it (``CARRIED``: DBRX phase 6's,
    Mistral-NeMo phase 8's), else it spawns its own.  Returns the kernel
    launches of the trained runs, summed over ranks."""
    import tempfile

    import torch

    from repro_torch.launch import ranks
    cards = torch.cuda.device_count()
    backend = ranks_backend(cards)
    depth, steps, seq = TRAIN_RANKS[4 if cards >= 4 else 1]
    where = ("over nccl, a card a rank" if backend == "nccl" else
             "over " + CARD_WHERE.format(world=4))

    def trained(which: str, mesh: tuple, title: str, phase: int) -> tuple:
        """The ranks' results of training ``which``, carried or spawned,
        and how long the ranks ran it."""
        results = CARRIED.pop(f"train {which}", None)
        if results is not None:
            print(f"  {title}: trained on phase {phase}'s spawn (its split "
                  f"above)")
            ran = max(sum(x["seconds"] for x in r["runs"].values())
                      for r in results)
            return results, f"{ran:.1f} s on phase {phase}'s spawn"
        plan = train_ranks_plan(which, backend)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            spec = train_ranks_spec(tmp, mesh, backend, plan.pop("cfg"),
                                    plan.pop("runs"), plan.pop("steps"),
                                    plan.pop("seq"), **plan)
            t0 = time.monotonic()
            results = ranks.run_ranks(ranks.train_worker, spec,
                                      timeout_s=900)
            spent = time.monotonic() - t0
        spawn_split(results, f"{title}'s spawn")
        return results, f"{spent:.1f} s with set-up"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(f"  cards: {'; '.join(smi)} (every time below is on them)")
    failures: list = []
    total: dict = {}
    plan = train_ranks_plan("dbrx", backend)
    cfg, small = plan["cfg"], plan["runs"][0]["cfg"]
    results, spawn_s = trained("dbrx", (2, 2, 1), "DBRX", 6)
    if plan["measure_link"]:
        print(f"  link: {results[0]['link']}")
    # the reduced model against one rank on the card
    red = results[0]["runs"]["reduced"]
    t_one = time.monotonic()
    loss, ce, _, grads = one_rank_step0(small, seq, grads=True)
    print(f"  the one-rank reference on the card (reduced DBRX): "
          f"{time.monotonic() - t_one:.1f} s")
    cosines = {}
    for name, g in grads.items():
        a = torch.from_numpy(red["grads"][name]).double().flatten()
        e = g.double().flatten()
        cosines[name] = (a @ e / (a.norm() * e.norm())).item()
    worst = min(cosines, key=cosines.get)
    gap = abs(red["step0"]["ce"] - ce)
    print(f"  reduced DBRX ({small.n_layers} layers, d_model "
          f"{small.d_model}, {small.num_experts} experts top-{small.top_k}) "
          f"over 2 x 2 against one rank on the card, step-0 ce "
          f"{red['step0']['ce']:.5f} vs {ce:.5f} (gap {gap:.3e}, limit "
          f"{LOSS_GAP}); gradient cosines of {len(cosines)} parameters "
          f"(synced over the ranks, gathered), lowest "
          f"{cosines[worst]:.6f} ({worst}; limit {GRAD_COSINE})")
    low = {k: v for k, v in cosines.items() if not v > GRAD_COSINE}
    if not gap < LOSS_GAP or low:
        failures.append(f"reduced DBRX over ranks: ce gap {gap:.3e}, "
                        f"cosines {low}")
    # DBRX at full width
    runs_ = [r["runs"]["dbrx"] for r in results]
    print(f"  DBRX-132B over 2 x 2, depth {depth}, {steps} steps of "
          f"{TRAIN_RANKS_BATCH} x {seq} tokens, {where}, FSDP over the "
          f"data axis ({len(runs_[0]['fsdp'])} leaves a rank cut in 2); "
          f"the ranks ran {spawn_s}")
    counts = train_run_lines("dbrx", runs_, failures, where=where)
    for r in results:
        run = r["runs"]["dbrx"]
        state = run["state_bytes"]
        print(f"  dbrx rank {r['rank']} {r['coords']}: weights "
              f"{state['weights'] / 1e9:.4f} GB, gradients "
              f"{state['grads'] / 1e9:.4f} GB, AdamW state "
              f"{state['opt_state'] / 1e9:.4f} GB; max_memory_allocated "
              f"of the steps {run['step_peak_bytes'] / 1e9:.3f} GB, of the "
              f"run {run['peak_gb']:.3f} GB")
    MEASURED["phase 11"] = dict(
        cfg=cfg, seq=seq, mesh=(2, 2, 1),
        ranks=[dict(r["runs"]["dbrx"]["state_bytes"],
                    peak=r["runs"]["dbrx"]["step_peak_bytes"],
                    staging=r["runs"]["dbrx"]["staging"]["card"])
               for r in sorted(results, key=lambda r: r["rank"])])
    hist = runs_[0]["history"]
    head = sum(h["loss"] for h in hist[:3]) / 3
    tail = sum(h["loss"] for h in hist[-3:]) / 3
    print(f"  dbrx: mean loss of the first 3 steps {head:.5f}, of the last "
          f"3 {tail:.5f}")
    if not tail < head:
        failures.append(f"dbrx: the loss did not fall: {head} -> {tail}")
    scheme, _, g = runs_[0]["moe"]["train"]
    per = {"hierarchical": 3, "baseline": 2}[scheme] * g * cfg.n_layers
    want = launch_counts(dispatch_pack=per * steps,
                         dispatch_pack_bwd=per * steps,
                         flash_attention=cfg.n_layers * steps,
                         flash_attention_bwd=cfg.n_layers * steps)
    print(f"  dbrx launches a rank over {steps} steps: "
          f"{runs_[0]['launches']} (expected {want}: a step and layer "
          f"{per // cfg.n_layers} packs and as many pack backwards for "
          f"{scheme} at G={g}, 1 attention forward and 1 backward)")
    for r in runs_:
        if r["launches"] != want:
            failures.append(f"dbrx launches {r['launches']} != {want}")
    for name, gapd in runs_[0]["schemes"].items():
        ok = gapd["gap"] <= gapd["bound"]
        print(f"  step-0 gradients of {', '.join(SCHEME_LEAVES)} (8 M "
              f"elements each) by {name}: max|mean - fp64 mean| "
              f"{gapd['gap']:.3e} of the largest mean (bound "
              f"{gapd['bound']:.3e}: {'within' if ok else 'OUTSIDE'}), "
              f"{gapd['ms']:.1f} ms (rank 0's wall)")
        if not ok:
            failures.append(f"scheme {name}: {gapd}")
    total.update(counts)
    del results, runs_
    gc.collect()
    torch.cuda.empty_cache()

    # Mistral-NeMo over 4 TP ranks
    tp_cfg = train_ranks_plan("mistral", backend)["cfg"]
    results, spawn_s = trained("mistral", TP_MESH, "Mistral-NeMo", 8)
    runs_ = [r["runs"]["tp"] for r in results]
    print(f"  Mistral-NeMo-12B over {TP_MESH}, depth {TP_TRAIN_DEPTH}, "
          f"{TP_TRAIN_STEPS} steps, tp_subgroups 2, {where}; the ranks ran "
          f"{spawn_s}")
    counts = train_run_lines("mistral", runs_, failures, where=where)
    want = launch_counts(flash_attention=tp_cfg.n_layers * TP_TRAIN_STEPS,
                         flash_attention_bwd=tp_cfg.n_layers
                         * TP_TRAIN_STEPS)
    for r in runs_:
        if r["launches"] != want:
            failures.append(f"mistral launches {r['launches']} != {want}")
    t_one = time.monotonic()
    loss, _, norm, _ = one_rank_step0(tp_cfg, TRAIN_RANKS_SEQ, grads=False)
    print(f"  the one-rank reference on the card (Mistral-NeMo): "
          f"{time.monotonic() - t_one:.1f} s")
    h0 = runs_[0]["history"][0]
    gaps = (abs(h0["loss"] - loss) / loss, abs(h0["grad_norm"] - norm)
            / norm)
    print(f"  mistral step 0 against one rank on the card: loss "
          f"{h0['loss']:.5f} vs {loss:.5f}, grad norm {h0['grad_norm']:.4f} "
          f"vs {norm:.4f} (relative gaps {gaps[0]:.3e}, {gaps[1]:.3e}; limit "
          f"{TP_TRAIN_GAP}); launches a rank {runs_[0]['launches']}")
    if not max(gaps) < TP_TRAIN_GAP:
        failures.append(f"mistral against one rank: {gaps}")
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n
    if failures:
        raise AssertionError(f"phase 11: {failures}")
    return total


# ---------------------------------------------------------------------------
# phase 12: the decoder-only secondary families at full width and depth
# ---------------------------------------------------------------------------

def families_phase() -> dict:
    """Gemma2-9B, StarCoder2-15B, Minitron-8B and Qwen2-VL-2B's backbone
    (``FAMILIES``) through :func:`serve_phase`, one at a time, each freed
    before the next; Gemma2's also takes a gradient on the card
    (:func:`gemma_gradient_runs`).  Returns the launches by model."""
    by_path = {}
    for arch, prompts_n, prompt_len, max_new in FAMILIES:
        print(f"  {arch}: {prompts_n} prompts x {prompt_len} tokens, "
              f"{max_new} new")
        by_path[arch] = serve_phase(
            arch, None, prompts_n=prompts_n, prompt_len=prompt_len,
            max_new=max_new,
            after=gemma_gradient_runs if arch == "gemma2_9b" else None)
    return by_path


def gemma_gradient_runs(engine, cfg) -> None:
    """Gemma2 at full width and depth on the card with its parameters
    trainable: one loss and backward of 1 x 64 tokens through the attention
    backward kernel at head_dim 256.  The loss and every gradient must be
    finite, and the kernels launch exactly one attention forward and one
    backward a layer (nothing plain in their place)."""
    import math

    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime.trainer import trainable
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    toks = torch.randint(0, cfg.vocab, (1, 64), generator=gen,
                         device="cuda", dtype=torch.int32)
    params = engine.params
    trainable(params)
    ops.reset_launches()
    loss, _ = engine.model.loss(params, {"tokens": toks, "labels": toks})
    loss.backward()
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launches().items() if v}
    finite = all(torch.isfinite(p.grad).all().item()
                 for p in params.parameters() if p.grad is not None)
    missing = [n for n, p in params.named_parameters() if p.grad is None]
    want = {"flash_attention": cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}
    print(f"  {cfg.name} gradient on the card at head_dim {cfg.head_dim}: "
          f"loss {loss.item():.5f} of 1 x 64 tokens, every gradient "
          f"{'finite' if finite else 'NOT FINITE'}, launches {counts} "
          f"(expected {want})")
    for p in params.parameters():
        p.grad = None
        p.requires_grad_(False)
    if not (math.isfinite(loss.item()) and finite) or missing \
            or counts != want:
        raise AssertionError(f"{cfg.name} gradient: loss {loss.item()}, "
                             f"finite {finite}, without a gradient "
                             f"{missing[:4]}, launches {counts} != {want}")


# ---------------------------------------------------------------------------
# phase 13: the encoder-decoder at full width and depth
# ---------------------------------------------------------------------------

def encdec_phase() -> dict:
    """SeamlessM4T-medium served through :func:`serve_phase` (``ENCDEC``:
    the gates of phase 5, exactly ``n_enc_layers + 2 * n_layers``
    attention launches a prefill and ``n_layers`` a decode round), freed,
    then trained (:func:`train_encdec`).  Returns the launches by path."""
    import torch
    arch, prompts_n, prompt_len, max_new = ENCDEC
    print(f"  {arch}: {prompts_n} prompts x {prompt_len} tokens, {max_new} "
          f"new")
    by_path = {arch: serve_phase(arch, None, prompts_n=prompts_n,
                                 prompt_len=prompt_len, max_new=max_new)}
    by_path[f"{arch}_train"] = train_encdec(arch)
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def train_encdec(arch: str) -> dict:
    """The encoder-decoder at full width and depth through ``Trainer``:
    ``ENCDEC_TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    SyntheticLM tokens (the stub frontend's embeddings as the source, the
    tokens as the target).  Gates: finite losses and gradient norms, the
    mean loss of the last 3 steps below that of the first 3, and exact
    launches: a step's forward runs attention ``n_enc_layers + 2 *
    n_layers`` times (with the log-sum-exp) and its backward as many
    backward kernels, nothing recomputed.  Returns the launches."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import param_count

    cfg = get_config(arch)
    trainer = synthetic_trainer(cfg, ENCDEC_TRAIN_LR, ENCDEC_TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    tr = trainer(ENCDEC_TRAIN_STEPS)
    ops.reset_launches()
    tr.run()
    torch.cuda.synchronize()
    counts = ops.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    a_step = cfg.n_enc_layers + 2 * cfg.n_layers
    want = launch_counts(flash_attention=a_step * ENCDEC_TRAIN_STEPS,
                         flash_attention_bwd=a_step * ENCDEC_TRAIN_STEPS)
    failures, _ = train_gates(tr.metrics_history, counts, want)
    print(f"  {cfg.name} trained: {param_count(tr.state.params) / 1e9:.3f} B "
          f"parameters, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, lr "
          f"{ENCDEC_TRAIN_LR}; peak memory {peak_gb:.2f} GB "
          f"(max_memory_allocated)")
    print(f"  launches over {ENCDEC_TRAIN_STEPS} steps: {counts} (expected "
          f"{want}: {a_step} attention forwards and {a_step} backwards a "
          f"step)")
    del tr, trainer
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"phase 13: {failures}")
    return counts


# ---------------------------------------------------------------------------
# phase 14: the hybrid, rwkv and encoder-decoder families over (1, 1, 4)
# ---------------------------------------------------------------------------

TP_FAMILIES_MESH = (1, 1, 4)
# (arch, its depth on one card (None: the published depth), the depth of
# its conditioned twin (None: none), the run's context knobs), served in
# this order on one spawn; Qwen2-VL's 2 kv heads over 4 model ranks with
# the KV length unsharded: the replicated layout.  A twin is the same
# architecture cut to a depth where one rank's bf16 logits lie within
# REF_TOL / 2 of its fp32 logits (Zamba2's first shared-block call comes
# after 6 blocks)
TP_FAMILIES = (("zamba2_7b", 24, 7, {}), ("rwkv6_7b", 8, 2, {}),
               ("seamless_m4t_medium", None, None, {}),
               ("qwen2_vl_2b", None, None, {"seq_shard_decode": False}))
TP_FAMILIES_NEW = {1: 8, 4: 32}         # new tokens on one card, on four
# the replicated twin: Qwen2-VL-2B's widths (d_model 1536, head_dim 128,
# M-RoPE, 2 kv heads, 151,936 vocab, tied) with 6 query heads and an FFN
# width of 8,962, neither of which divides over 4 model ranks, so its
# attention and MLP are whole on every rank (layers.splits), at depth 2;
# served (the KV length sharded) and trained on phase 14's spawns
REPLICATED_TWIN = "qwen2_vl_2b@6heads"
REPLICATED_LEAVES = ("blocks.0.attn.wq", "blocks.0.attn.wk",
                     "blocks.0.attn.wo", "blocks.0.mlp.w1", "blocks.0.mlp.w2")
# phase 14's training over TP_FAMILIES_MESH at full width: (arch, depth
# (None: the published depth)), the ill-conditioned stacks at their
# serving twins' depths (Zamba2's 7 blocks reach its shared block once);
# 4 Trainer steps of TRAIN_RANKS_BATCH x TRAIN_RANKS_SEQ tokens
TP_FAMILIES_TRAIN = (("zamba2_7b", 7), ("rwkv6_7b", 2),
                     ("seamless_m4t_medium", None))
# the stacks whose step 0 also runs under remat="full" beside "none" on the
# same weights and batch (ranks._remat_twin), and the scans whose forward
# launches remat doubles
TP_FAMILIES_REMAT = {"zamba2_7b": "mamba2_scan", "rwkv6_7b": "rwkv6_scan"}


def replicated_twin():
    """:data:`REPLICATED_TWIN`'s config."""
    import dataclasses

    from repro_torch.configs.base import get_config
    cfg = get_config("qwen2_vl_2b")
    return dataclasses.replace(cfg, name=REPLICATED_TWIN, n_layers=2,
                               n_heads=6, d_head=128, d_ff=8962)
TP_FAMILIES_STEPS = 4
TP_FAMILIES_GAP = 2e-2        # step-0 loss against one rank, relative


def tp_families_heading(four: bool) -> str:
    """Phase 14's title, with the one-card cuts named."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.ssm import n_shared_calls
    new = TP_FAMILIES_NEW[4 if four else 1]
    cuts = []
    for arch, depth, _, _ in TP_FAMILIES:
        if depth is not None and not four:
            cfg = get_config(arch)
            cut = f"{arch} at {depth} of {cfg.n_layers} blocks"
            if cfg.family == "hybrid":
                cut += (f" ({n_shared_calls(cfg.with_depth(depth))} calls "
                        f"of the shared block)")
            cuts.append(cut)
    return ("phase 14: Zamba2-7B, RWKV6-7B, SeamlessM4T-medium, "
            "Qwen2-VL-2B's backbone (replicated kv heads) and its 6-head "
            "twin (attention and MLP replicated) over (1, 1, 4) at full "
            "width, " + (f"full depth, {new} new tokens" if four
                         else f"{new} new tokens, cut on one card: "
                         + "; ".join(cuts)))


def _mamba2_steps(x, dt, a, b, c, d):
    """``ops.mamba2_scan``'s contract through the fp32 per-step
    recurrence."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba2_scan import expand_groups
    n = x.shape[0]
    return ref.mamba2_ref(x, dt, a, expand_groups(b, n), expand_groups(c, n),
                          d, return_final=True)


def _rwkv6_steps(r, k, v, logw, u):
    """``ops.rwkv6_scan``'s contract through the fp32 per-step recurrence
    (the chunked form overflows where a chunk's decays sum below -88)."""
    from repro_torch.kernels import ref
    return ref.rwkv6_ref(r, k, v, logw, u, return_final=True)


def fp32_prefill(cfg, params, prompts, max_len: int):
    """The last-position prefill logits [B, V] of ``params`` (bf16) cast to
    fp32, through fp32 plain versions of the kernels on the card (the
    scans' per-step recurrences): what one rank's bf16 run
    approximates."""
    from unittest import mock

    import torch

    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.api import build_model, param_module
    model = build_model(cfg, device="cuda", dtype=torch.float32)
    wide = param_module(cfg, device="cuda", dtype=torch.float32)
    wide.load_state_dict(params.state_dict())
    with torch.inference_mode(), mock.patch.multiple(
            ops, flash_attention=flash_attention_plain,
            mamba2_scan=_mamba2_steps, rwkv6_scan=_rwkv6_steps):
        logits, _ = model.prefill(
            wide, batch_for_model(cfg, {"tokens": prompts}, device="cuda"),
            model.init_cache(prompts.shape[0], max_len, torch.float32))
    out = logits.float().cpu()
    del wide, logits
    torch.cuda.empty_cache()
    return out


def tp_families_served(four: bool) -> list:
    """Phase 14's models in serving order: (name, cfg, knobs, the name of
    the model it is the twin of, or None)."""
    from repro_torch.launch.serve import serve_config
    served = []
    for arch, depth, twin, knobs in TP_FAMILIES:
        cfg = serve_config(arch, layers=None if four else depth,
                           smoke=False)
        served.append((arch, cfg, knobs, None))
        if twin is not None:
            served.append((f"{arch}@{twin}", cfg.with_depth(twin), knobs,
                           arch))
    served.append((REPLICATED_TWIN, replicated_twin(), {}, None))
    return served


def tp_families_models(served: list, new: int) -> list:
    """Phase 14's models as entries of a serving spawn's ``models``
    (:func:`ranks.serve_worker`): prompts of seed 0, one run each of
    ``new`` tokens, no warm-up."""
    from repro_torch.launch.serve import make_prompts
    return [dict(name=name, cfg=cfg,
                 prompts=make_prompts(cfg, PROMPTS, PROMPT_LEN, seed=0),
                 runs=[dict(label="tp4", **knobs)], warmup=False,
                 max_new=new)
            for name, cfg, knobs, _ in served]


def tp_families_phase() -> dict:
    """The hybrid, rwkv and encoder-decoder families and Qwen2-VL's
    backbone served over 4 tensor-parallel ranks (``TP_FAMILIES``; nccl
    with a card a rank where there are 4 cards, decode graphed; else 4
    processes on card 0 over the card transport, decode eager), 4 prompts
    x 512 tokens,
    greedy, seed-0 random weights, one spawn serving the models one after
    another (each rank's weights freed before the next), each held
    against a one-rank run of the same weights on the card.

    Gates, each model: every rank's tokens equal; exact launches of
    ``mamba2_scan``, ``rwkv6_scan`` and ``flash_attention`` on each rank;
    the decode mode; finite logits; and phase 6's gate (the last-position
    prefill logits within ``REF_TOL`` of max |logit| of one rank's, and a
    row's tokens parting from one rank's only at a near tie below it)
    where it is conditioned.  ``REF_TOL`` is a model's bf16 logits' gap
    from its fp32 logits, so one rank's weights also prefill in fp32
    (:func:`fp32_prefill`); a model whose one-rank bf16 logits lie further
    than ``REF_TOL / 2`` from those at its served depth (the random-weight
    Zamba2 and RWKV6 stacks: the reference's own Zamba2 at 24 blocks lies
    past ``REF_TOL`` from its fp32 logits, while in fp32 the port's 4
    ranks agree with one rank within 1e-4; ``tests/
    test_torch_tp_families.py``) has its gaps printed there, and its twin
    (the same architecture at the depth ``TP_FAMILIES`` names, served on
    the same spawn) must be conditioned and pass phase 6's gate.  Each
    rank's decode-state bytes print beside one rank's.  Returns the
    launches of the measured runs by model, summed over ranks.  The
    ranks' work rides phase 8's spawn when that phase carried it
    (``CARRIED``), else it spawns its own."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch import ranks
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.api import build_model
    from repro_torch.runtime.server import ServeConfig

    cards = torch.cuda.device_count()
    four = cards >= 4
    backend = ranks_backend(cards)
    new = TP_FAMILIES_NEW[4 if four else 1]
    pods, ep, tp = TP_FAMILIES_MESH
    where = ("nccl, one card a rank" if four else
             CARD_WHERE.format(world=4))
    print(f"  {cards} card(s): {pods * ep * tp} ranks over {where}")
    served = tp_families_served(four)
    twins = {arch for arch, _, twin, _ in TP_FAMILIES if twin is not None}
    refs = {}
    for name, cfg, _, _ in served:
        prompts = make_prompts(cfg, PROMPTS, PROMPT_LEN, seed=0)
        t_one = time.monotonic()
        model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        one = ranks.RecordingEngine(model, model.init(gen),
                                    ServeConfig(max_new_tokens=new),
                                    device="cuda")
        expected = one.generate(prompts)
        ref = one.step_logits[0]
        wide = fp32_prefill(cfg, one.params, prompts, PROMPT_LEN + new)
        bf16_rel = ((ref - wide).abs().max() / wide.abs().max()).item()
        refs[name] = (cfg, expected, list(one.step_logits), one.state,
                      bf16_rel)
        one.close()
        del one, model
        gc.collect()                    # the engine's binder cycle
        torch.cuda.empty_cache()
        print(f"  {name}: the one-rank references on the card, bf16 and "
              f"fp32 ({cfg.n_layers} blocks): "
              f"{time.monotonic() - t_one:.1f} s")
    results = CARRIED.pop("tp families", None)
    if results is not None:
        print(f"  the {len(served)} models over {TP_FAMILIES_MESH}: served "
              f"on phase 8's spawn (its split above)")
    else:
        models = tp_families_models(served, new)
        with tempfile.TemporaryDirectory() as tmp:
            spec = dict(world=pods * ep * tp, pods=pods, ep=ep, tp=tp,
                        **backend_keys(backend), device="cuda:0",
                        init_method=f"file://{tmp}/store", timeout_s=300,
                        out_dir=f"{tmp}/out", threads=2, seed=0,
                        dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                        models=models)
            t0 = time.monotonic()
            results = ranks.run_ranks(ranks.serve_worker, spec,
                                      timeout_s=900)
        print(f"  4 ranks spawned, served the {len(models)} models and "
              f"joined in {time.monotonic() - t0:.1f} s")
        spawn_split(results, "the spawn")
    failures, by_path = [], {}
    for name, _, _, twin_of in served:
        cfg, expected, one_logits, one_state, bf16_rel = refs[name]
        per = [dict(r["models"][name], rank=r["rank"]) for r in results]
        failures += check_decode_mode(per, backend)
        runs_ = [r["runs"]["tp4"] for r in per]
        run0 = runs_[0]
        want = expected_launches(cfg, new)
        total: dict = {}
        for r, run in zip(per, runs_):
            if not np.array_equal(run["tokens"], run0["tokens"]):
                failures.append(f"{name} rank {r['rank']}: other tokens")
            if run["launches"] != want:
                failures.append(f"{name} rank {r['rank']}: launches "
                                f"{run['launches']} != {want}")
            if run["nonfinite_logits"]:
                failures.append(f"{name} rank {r['rank']}: non-finite")
            for kernel, n in run["launches"].items():
                total[kernel] = total.get(kernel, 0) + n
        by_path[f"{name}_tp4"] = total
        ref = one_logits[0]
        rel = ((run0["prefill_logits"] - ref).abs().max()
               / ref.abs().max()).item()
        equal, gap = ranks.near_ties(range(PROMPTS), run0["tokens"],
                                     expected, one_logits)
        st = max(runs_, key=lambda run: run["prefill_s"])
        g = run0["decode_graph"]
        mem = per[0]["memory"]
        print(f"  {name} ({cfg.n_layers} blocks, {new} new): prefill "
              f"{st['prefill_s'] * 1e3:.3f} ms, decode "
              f"{st['decode_s'] * 1e3 / (new - 1):.3f} ms/token (the "
              f"slowest rank's; decode {g['mode']}: {g['captures']} "
              f"captures, {g['replays']} replays); weights a rank "
              f"{mem['all_gb']:.2f} GB, peak "
              f"{max(r['peak_gb'] for r in per):.2f} GB; launches a rank "
              f"{ {k: v for k, v in run0['launches'].items() if v} }")
        layout = ", ".join(f"{k} {list(v)}" for k, v in
                           run0["state"]["shapes"].items() if k != "pos")
        print(f"    decode state a rank {run0['state']['bytes'] / 1e6:.2f} "
              f"MB against one rank's {one_state['bytes'] / 1e6:.2f} MB "
              f"({layout})")
        conditioned = bf16_rel < REF_TOL / 2
        print(f"    4 ranks vs one: last-position prefill logits {rel:.3e} "
              f"of max |logit|; {equal} of {PROMPTS} rows' tokens equal "
              f"over {new}, a row parting at a gap of {gap:.3e} at most; "
              f"one rank's bf16 logits vs its fp32 logits {bf16_rel:.3e}: "
              + (f"held within {REF_TOL}" if conditioned else
                 f"not conditioned (above {REF_TOL / 2}), so not held "
                 f"here; its twin at fewer blocks is"))
        if conditioned and (not rel < REF_TOL or gap > REF_TOL):
            failures.append(f"{name}, 4 ranks vs one: logits {rel:.3e}, "
                            f"gap {gap:.3e}")
        if not conditioned and (twin_of is not None or name not in twins):
            failures.append(f"{name}: not conditioned ({bf16_rel:.3e}) and "
                            f"no conditioned twin holds it")
    if failures:
        raise AssertionError(f"phase 14: {failures}")
    by_path.update(tp_families_train(backend, where))
    return by_path


def train_launches(cfg, steps: int) -> dict:
    """Each kernel's launches in ``steps`` training steps of ``cfg`` on a
    rank: a forward and a backward of each scan a block, of attention a
    call (the shared block's calls, the encoder-decoder's three a decoder
    layer and one an encoder layer)."""
    from repro_torch.models.ssm import n_shared_calls
    if cfg.family == "hybrid":
        scans = dict(mamba2_scan=cfg.n_layers)
        attn = n_shared_calls(cfg)
    elif cfg.family == "rwkv":
        scans, attn = dict(rwkv6_scan=cfg.n_layers), 0
    else:
        scans = {}
        attn = cfg.n_layers + (cfg.n_enc_layers + cfg.n_layers
                               if cfg.family == "encdec" else 0)
    counts = {k: v * steps for k, v in scans.items()}
    counts.update({f"{k}_bwd": v * steps for k, v in scans.items()})
    return launch_counts(flash_attention=attn * steps,
                         flash_attention_bwd=attn * steps, **counts)


def one_rank_lines(label: str, loss: float, one: dict) -> list:
    """Print phase 14's step 0 of the ranks (``loss``) against one rank
    (``ranks._against_one_rank``'s ``one``) and return its failures: the
    loss's relative gap, an fp32 cosine, a conditioned leaf's bf16 cosine,
    a leaf zero on both sides."""
    def lowest(cos: dict) -> str:
        name = min(cos, key=cos.get)
        return f"{cos[name]:.6f} ({name})"
    c32, c16, cond = one["cosines_fp32"], one["cosines"], one["conditioning"]
    unreached = sorted({n for c in (c32, c16, cond) for n, v in c.items()
                        if v is None})
    c32 = {n: v for n, v in c32.items() if n not in unreached}
    held = {n: c16[n] for n in c16
            if n not in unreached and cond[n] > GRAD_COSINE}
    loose = {n: cond[n] for n in cond
             if n not in unreached and n not in held}
    gap = abs(loss - one["loss"]) / abs(one["loss"])
    print(f"  {label} step 0 against one rank on the card (rank 0, the "
          f"same weights and batch): loss {loss:.5f} vs {one['loss']:.5f} "
          f"(relative gap {gap:.3e}, limit {TP_FAMILIES_GAP}); "
          f"{len(c32)} gradients gathered to their global shapes; in fp32 "
          f"(the ranks' copies through the plain versions, one rank's "
          f"loss {one['fp32_loss']:.5f}) lowest cosine {lowest(c32)}; in "
          f"bf16 {len(held)} whose one-rank gradient is conditioned, "
          + (f"lowest cosine {lowest(held)}" if held else "none")
          + f"; {len(loose)} not conditioned, not held in bf16"
          + (f" (lowest one-rank bf16 against fp32 {lowest(loose)})"
             if loose else "") + f" (limit {GRAD_COSINE})")
    failures = []
    if not gap < TP_FAMILIES_GAP:
        failures.append(f"{label}: loss gap {gap:.3e} against one rank")
    for kind, cos in (("fp32", c32), ("bf16 conditioned", held)):
        low = {n: v for n, v in cos.items() if not v > GRAD_COSINE}
        if low:
            failures.append(f"{label}: {kind} cosines to one rank {low}")
    if unreached:
        failures.append(f"{label}: gradients zero on both sides, not "
                        f"compared: {unreached}")
    return failures


def tp_families_train(backend: str, where: str) -> dict:
    """Phase 14's training: ``TP_FAMILIES_TRAIN`` at full width over
    ``TP_FAMILIES_MESH``, ``TP_FAMILIES_STEPS`` ``Trainer`` steps of
    ``TRAIN_RANKS_BATCH`` x ``TRAIN_RANKS_SEQ`` ``SyntheticLM`` tokens
    each (AdamW, bf16 state, seed-0 weights), on phase 8's spawn when it
    carried them (``CARRIED``), else on a spawn of its own.  Rank 0 also
    runs one rank's step 0 of the same weights and batch on the card
    (``ranks._against_one_rank``).

    Gates, each model: finite losses, the same grad norm and every
    replicated leaf the same bits on every rank, each backward kernel of
    step 0 against its plain version at the ranks' shapes
    (:func:`train_run_lines`; attention's under the loss's own cotangent
    within ``ranks.ATTN_BWD_REL`` or within ``ATTN_BWD_SDPA`` times
    SDPA's backward's error on the same inputs: a non-causal attention
    over nearly uniform weights loses dq to bf16 cancellation in either);
    step 0's loss within
    ``TP_FAMILIES_GAP`` of one rank's; exact launches
    (:func:`train_launches`); every gradient gathered to its global shape
    at a cosine above ``GRAD_COSINE`` to one rank's in fp32 (the ranks'
    fp32 copies of their weights through the plain versions, against one
    rank's: the model-axis backward where no dtype makes the gradients
    ill-conditioned, ROADMAP.md §3); in bf16 each gradient whose one-rank
    bf16 value is conditioned (at a cosine above ``GRAD_COSINE`` to the
    same weights' fp32 one) at a cosine above ``GRAD_COSINE`` to one
    rank's, the others counted and printed; a gradient zero on both
    sides (a leaf the loss does not reach) fails.  Returns the launches
    by model, summed over ranks."""
    import tempfile

    from repro_torch.launch import ranks
    results = CARRIED.pop("train tp families", None)
    plan = train_ranks_plan("tp families", backend)
    models = [(run["label"], run["cfg"], run.get("steps", plan["steps"]))
              for run in plan["runs"]]
    if results is not None:
        print(f"  training the {len(models)} models over "
              f"{TP_FAMILIES_MESH}: on phase 8's spawn (its split above)")
    else:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            spec = train_ranks_spec(tmp, TP_FAMILIES_MESH, backend,
                                    plan.pop("cfg"), plan.pop("runs"),
                                    plan.pop("steps"), plan.pop("seq"),
                                    **plan)
            t0 = time.monotonic()
            results = ranks.run_ranks(ranks.train_worker, spec,
                                      timeout_s=900)
        print(f"  4 ranks spawned, trained the {len(models)} models and "
              f"joined in {time.monotonic() - t0:.1f} s")
        spawn_split(results, "the training spawn")
    failures, by_path = [], {}
    for label, cfg, steps in models:
        runs_ = [r["runs"][label] for r in results]
        print(f"  {label} at full width, {cfg.n_layers} blocks, trained "
              f"over {TP_FAMILIES_MESH}: {steps} step(s) of "
              f"{TRAIN_RANKS_BATCH} x {TRAIN_RANKS_SEQ} tokens, {where}")
        counts = train_run_lines(label, runs_, failures, where=where,
                                 yardstick=True)
        failures += one_rank_lines(label, runs_[0]["step0"]["loss"],
                                   runs_[0]["one_rank"])
        want = train_launches(cfg, steps)
        print(f"  {label} launches a rank: {runs_[0]['launches']} "
              f"(expected {want})")
        for r in runs_:
            if r["launches"] != want:
                failures.append(f"{label} launches {r['launches']} != "
                                f"{want}")
        by_path[f"{label}_tp4_train"] = counts
        if label in TP_FAMILIES_REMAT:
            failures += remat_lines(label, TP_FAMILIES_REMAT[label],
                                    [r["remat"] for r in runs_])
        if label == REPLICATED_TWIN:
            whole = [n for n in REPLICATED_LEAVES
                     if n not in runs_[0]["replicated"]]
            print(f"  {label}: {len(REPLICATED_LEAVES) - len(whole)} of "
                  f"{len(REPLICATED_LEAVES)} leaves of the replicated "
                  f"attention and MLP among the replicated leaves, the "
                  f"same bits on every rank (above)")
            if whole:
                failures.append(f"{label}: split, not replicated: {whole}")
    if failures:
        raise AssertionError(f"phase 14 training: {failures}")
    return by_path


def remat_lines(label: str, scan: str, twins: list) -> list:
    """Print and gate the step 0 of ``label`` under ``remat="full"`` beside
    ``"none"`` on every rank (``ranks._remat_twin``): the loss and every
    raw gradient the same bits (the kernels are deterministic and every
    rank recomputes the same exchanges in the same order), ``scan``'s
    forward launches doubled and its backward's unchanged.  Returns the
    failures."""
    failures, same = [], True
    for rank, twin in enumerate(twins):
        none, full = twin["none"], twin["full"]
        differ = sorted(n for n in none["digest"]
                        if full["digest"][n] != none["digest"][n])
        if full["loss"] != none["loss"] or differ:
            same = False
            failures.append(f"{label} rank {rank}: remat full vs none: loss "
                            f"{full['loss']} vs {none['loss']}, gradients "
                            f"differ: {differ[:5]}")
        fwd, bwd = none["launches"][scan], none["launches"][scan + "_bwd"]
        if not (fwd > 0 and full["launches"][scan] == 2 * fwd
                and full["launches"][scan + "_bwd"] == bwd):
            failures.append(f"{label} rank {rank}: launches under remat "
                            f"{full['launches']} against {none['launches']}")
    none, full = twins[0]["none"], twins[0]["full"]
    print(f"  {label} step 0 under remat=\"full\" beside \"none\" (same "
          f"weights and batch): loss {full['loss']:.6f} vs "
          f"{none['loss']:.6f}, {len(none['digest'])} gradients on each of "
          f"{len(twins)} ranks "
          f"{'bit-identical' if same else 'NOT bit-identical'}; "
          f"{scan} launches a rank {full['launches'][scan]} forward, "
          f"{full['launches'][scan + '_bwd']} backward (none: "
          f"{none['launches'][scan]}, {none['launches'][scan + '_bwd']}); "
          f"flash_attention {full['launches']['flash_attention']} vs "
          f"{none['launches']['flash_attention']}; peak memory a rank "
          f"{max(t['full']['peak_gb'] for t in twins):.2f} GB vs "
          f"{max(t['none']['peak_gb'] for t in twins):.2f} GB "
          f"(max_memory_allocated over the step, weights included)")
    return failures


# ---------------------------------------------------------------------------
# phase 16: the dry run against the card
# ---------------------------------------------------------------------------

# (c): one (16, 16) "mw" cell of each family (decode: the cheapest cell on
# the host; every family's model runs its rank's part of one step)
DRYRUN_CELLS = (("mistral_nemo_12b", "decode_32k"), ("dbrx_132b", "decode_32k"),
                ("zamba2_7b", "decode_32k"), ("rwkv6_7b", "decode_32k"),
                ("seamless_m4t_medium", "decode_32k"),
                # 12 query heads over 16 model ranks: attention replicated
                ("qwen2_vl_2b", "decode_32k"))


PEAK_RATIO = (0.9, 1.1)          # (b): predicted over measured peak


def dryrun_phase(parts: str = "abcd") -> None:
    """The dry run (``repro_torch.launch.dryrun``: the model code on meta
    tensors, on the host) held to what the card measured; ``parts``: which
    of (a)-(d) run (each needs its phase's measurements).

    (a) DBRX at phase 6's width, depth and capacity factor on a
    ``ShapeMesh`` of (2, 2, 1), phase 6's 4 x 512 prefill, the MultiWrite
    pair (variant ``mw``) and the baseline pair (``baseline``), each rank
    in turn: the pod-crossing bytes of the first prefill dispatch's token
    exchange (the first all-to-all on the pod axis of rows of d_model:
    its bytes times (pods - 1) / pods) equal to phase 6's
    ``pod_bytes["whole"]`` of that rank, hard.  (b) DBRX at phase 10's
    depth on one rank, training on phase 10's batch without recompute:
    the weight, gradient and AdamW-state bytes equal to phase 10's
    trainer's (its live state, and each gradient as autograd made it),
    hard; the predicted peak (each storage counted once) within
    ``PEAK_RATIO`` of phase 10's ``max_memory_allocated``, hard, printed
    split by category.  (c) One (16, 16) cell of each family
    (``DRYRUN_CELLS``), its memory, FLOPs, collective bytes and roofline
    line (the H100's data sheet).  (d) Phase 11's DBRX training (FSDP over
    the data axis) on a ``ShapeMesh`` of its (2, 2, 1), each rank in turn:
    the weight, gradient and AdamW-state bytes equal to that rank's in
    phase 11, hard; the predicted peak printed beside the rank's
    ``max_memory_allocated`` of its steps with their ratio, recorded (four
    processes share one card there)."""
    import dataclasses

    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import serve_config
    failures = []
    # (a)
    cfg = dataclasses.replace(serve_config("dbrx_132b", layers=4,
                                           smoke=False),
                              moe_capacity=RANKS_CF)
    shape = ShapeSpec("phase 6", PROMPT_LEN, PROMPTS, "prefill")
    pods = RANKS[0]
    pairs = MEASURED["pod bytes"] if "a" in parts else {}
    for pair, variant in zip(pairs, ("mw", "baseline")):
        measured = MEASURED["pod bytes"][pair]
        for rank in range(RANKS[0] * RANKS[1]):
            t0 = time.monotonic()
            r = dryrun.run_cell("dbrx_132b", shape, multi_pod=True,
                                rank=rank, mesh_shape=(*RANKS, 1),
                                config=cfg, variant=variant, verbose=False,
                                fabrics=())
            first = next(rec for rec in r["collectives"]["log"]
                         if rec[:2] == ["all-to-all", "pod"]
                         and rec[4][-1] == cfg.d_model)
            crossing = first[3] * (pods - 1) // pods
            print(f"  (a) {pair} ({variant}), rank {rank}: the dry run's "
                  f"pod-crossing bytes of the first prefill dispatch "
                  f"{crossing} ({first[0]} of {first[4]} over {first[1]}), "
                  f"phase 6 measured {measured[rank]}: "
                  f"{'equal' if crossing == measured[rank] else 'DIFFER'}; "
                  f"pod-axis bytes of the prefill {r['collectives']['by_axis'].get('pod', 0)} "
                  f"over {r['collectives']['num_ops']} exchanges "
                  f"({time.monotonic() - t0:.1f} s on the host)")
            if crossing != measured[rank]:
                failures.append(f"(a) {pair} rank {rank}: {crossing} != "
                                f"{measured[rank]}")
    # (b)
    if "b" in parts:
        ten = MEASURED["phase 10"]
        shape = ShapeSpec("phase 10", TRAIN_SEQ, TRAIN_BATCH, "train")
        t0 = time.monotonic()
        r = dryrun.run_cell("dbrx_132b", shape, multi_pod=False,
                            mesh_shape=(1, 1, 1), config=ten["cfg"],
                            knobs={"remat": "none"}, verbose=False,
                            fabrics=())
        failures += _state_bytes("(b)", r, ten, "phase 10's trainer")
        peak = r["memory"]["peak_live_bytes"]
        ratio = peak / ten["peak"]
        held = PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]
        print(f"  (b) DBRX-132B at depth {ten['cfg'].n_layers}, one rank, "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: predicted peak "
              f"{peak / 1e9:.3f} GB ({_peak_parts(r)}), phase 10's "
              f"max_memory_allocated {ten['peak'] / 1e9:.3f} GB: ratio "
              f"{ratio:.4f} ({'within' if held else 'OUTSIDE'} "
              f"{PEAK_RATIO}, hard); "
              f"{r['cost']['flops_per_device']:.4e} FLOPs, "
              f"{r['cost']['bytes_per_device']:.4e} bytes a step "
              f"({time.monotonic() - t0:.1f} s on the host)")
        if not held:
            failures.append(f"(b) peak ratio {ratio:.4f} outside "
                            f"{PEAK_RATIO}")
    # (d)
    if "d" in parts:
        eleven = MEASURED["phase 11"]
        shape = ShapeSpec("phase 11", eleven["seq"], TRAIN_RANKS_BATCH,
                          "train")
        for rank, got in enumerate(eleven["ranks"]):
            t0 = time.monotonic()
            r = dryrun.run_cell("dbrx_132b", shape, multi_pod=True,
                                rank=rank, mesh_shape=eleven["mesh"],
                                config=eleven["cfg"], variant="auto",
                                knobs={"remat": "none"}, verbose=False,
                                fabrics=())
            failures += _state_bytes(f"(d) rank {rank}", r, got,
                                     "phase 11's rank")
            peak = r["memory"]["peak_live_bytes"]
            fsdp = r["collectives"]["fsdp"]
            bare = got["peak"] - got["staging"]
            print(f"  (d) DBRX-132B at depth {eleven['cfg'].n_layers} over "
                  f"{eleven['mesh']}, FSDP, rank {rank}: predicted peak "
                  f"{peak / 1e9:.3f} GB ({_peak_parts(r)}), phase 11's "
                  f"max_memory_allocated of the steps "
                  f"{got['peak'] / 1e9:.3f} GB, of which the card "
                  f"transport's staging {got['staging'] / 1e9:.3f} GB (the "
                  f"dry run prices none): ratio {peak / got['peak']:.4f}, "
                  f"{peak / bare:.4f} without the staging (recorded, not "
                  f"gated: four processes share the card); FSDP wire bytes "
                  f"a step {fsdp} ({time.monotonic() - t0:.1f} s on the "
                  f"host)")
    # (c)
    for arch, shape_name in DRYRUN_CELLS if "c" in parts else ():
        t0 = time.monotonic()
        r = dryrun.run_cell(arch, shape_name, multi_pod=False,
                            verbose=False)
        rl, mm = r["roofline"], r["memory"]
        print(f"  (c) {arch} x {shape_name} x (16, 16) x mw, {r['kind']}: "
              f"argument {mm['argument_bytes'] / 2**30:.2f} GiB, peak "
              f"{mm['peak_live_bytes'] / 2**30:.2f} GiB a rank; "
              f"{r['cost']['flops_per_device']:.3e} FLOPs, "
              f"{r['cost']['bytes_per_device']:.3e} bytes a rank; "
              f"collective bytes by axis {r['collectives']['by_axis']}; "
              f"roofline (H100 data sheet): compute "
              f"{rl['compute_term_s'] * 1e3:.3f} ms, memory "
              f"{rl['memory_term_s'] * 1e3:.3f} ms, collective "
              f"{rl['collective_term_s'] * 1e3:.3f} ms -> {rl['dominant']} "
              f"({time.monotonic() - t0:.1f} s on the host)")
    if failures:
        raise AssertionError(f"phase 16: {failures}")


def _state_bytes(label: str, r: dict, measured: dict, where: str) -> list:
    """Print a dry-run train cell's weight, gradient and AdamW-state bytes
    beside ``measured``'s; the failures where they differ."""
    args, failures = r["memory"]["arguments"], []
    for part in ("weights", "grads", "opt_state"):
        same = args[part] == measured[part]
        print(f"  {label} {part}: the dry run {args[part]} bytes, {where} "
              f"{measured[part]}: {'equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"{label} {part}: {args[part]} != "
                            f"{measured[part]}")
    return failures


def _peak_parts(r: dict) -> str:
    """A dry-run cell's live bytes at its peak by category, in GB."""
    return ", ".join(f"{part} {v / 1e9:.3f}"
                     for part, v in r["memory"]["peak_parts"].items())


# ---------------------------------------------------------------------------
# phase 15: the hybrid, rwkv and Gemma2 families trained at full width
# ---------------------------------------------------------------------------

# (arch, depth, batch, sequence) at full width, each depth cut as far as one
# card and the script's time ask (the arithmetic prints beside the measured
# peak): Zamba2 at phase 14's 24 of 81 blocks (the shared block 3 times),
# RWKV6 at phase 14's 8 of 32, Gemma2 at 4 of 42 layers (2 windowed, 2
# global) over one sequence of 8,192 tokens, past its 4,096 window, through
# the training launcher
TRAIN_FAMILIES = (("zamba2_7b", 24, 4, 512), ("rwkv6_7b", 8, 4, 512),
                  ("gemma2_9b", 4, 1, 8192))
TRAIN_FAMILIES_STEPS, TRAIN_FAMILIES_LR = 8, 1e-4
# each family's backward kernel of the training step whose share of a step
# phase 15 reads from a profiler trace: (label, parts of its kernels' names)
STEP_KERNELS = {"zamba2_7b": ("mamba2_scan_bwd", ("mamba2_bwd_kernel",)),
                "rwkv6_7b": ("rwkv6_scan_bwd", ("rwkv6_bwd_kernel",)),
                "gemma2_9b": ("flash_attention_bwd at head_dim 256",
                              ("bwd256::",))}


def profile_last_step(tr, steps: int):
    """Arms a ``torch.profiler`` trace of the device over the last of the
    trainer ``tr``'s ``steps`` steps: it starts in the trainer's step hook
    once the step before is recorded and stops once the last is, so
    neither falls inside a step's wall, and the step is one of those
    trained and counted.  Returns ``finish()``, which gives each kernel's
    device ms in that step by name (empty if the step did not run)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    hook, traced = tr.step_hook, []

    def step_hook(step, row):
        if hook:
            hook(step, row)
        if step in (steps - 2, steps - 1):
            torch.cuda.synchronize()
            if step == steps - 2:
                prof.start()
            elif traced:
                prof.stop()
            traced.append(step)
    tr.step_hook = step_hook

    def finish() -> dict:
        out = collections.defaultdict(float)
        if len(traced) == 2:
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    out[evt.name] += evt.time_range.elapsed_us() / 1e3
        return dict(out)
    return finish


def family_launches(cfg, steps: int) -> dict:
    """Kernel launches of ``steps`` training steps of ``cfg``: each layer's
    forward once (the scans', or attention's with its log-sum-exp) and its
    backward once, nothing recomputed."""
    from repro_torch.models.ssm import n_shared_calls
    if cfg.family == "hybrid":
        per = dict(mamba2_scan=cfg.n_layers, mamba2_scan_bwd=cfg.n_layers,
                   flash_attention=n_shared_calls(cfg),
                   flash_attention_bwd=n_shared_calls(cfg))
    elif cfg.family == "rwkv":
        per = dict(rwkv6_scan=cfg.n_layers, rwkv6_scan_bwd=cfg.n_layers)
    else:
        per = dict(flash_attention=cfg.n_layers,
                   flash_attention_bwd=cfg.n_layers)
    return launch_counts(**{k: v * steps for k, v in per.items()})


def launcher_history(argv: list, before=None) -> tuple[list, int, object]:
    """``launch.train.main(argv)``, the training entry point a user calls,
    with the history of its ``Trainer``, the parameters it trained and what
    ``before(trainer)`` returned, run once before its steps (kept by
    wrapping ``Trainer.run`` for the call)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models.api import param_count
    from repro_torch.runtime.trainer import Trainer
    kept = {}
    run = Trainer.run

    def keep(self):
        kept["before"] = None if before is None else before(self)
        out = run(self)
        kept["hist"] = list(self.metrics_history)
        kept["params"] = param_count(self.state.params)
        return out
    Trainer.run = keep
    try:
        if launch_train.main(argv) != 0:
            raise AssertionError(f"launch.train {argv} did not return 0")
    finally:
        Trainer.run = run
    return kept["hist"], kept["params"], kept["before"]


def train_family(arch: str, depth: int, batch: int, seq: int) -> dict:
    """One family at full width, depth ``depth``, trained
    ``TRAIN_FAMILIES_STEPS`` steps of ``batch`` x ``seq`` SyntheticLM
    tokens (seed 0, seed-0 random weights, AdamW with bf16 state on a
    cosine schedule of ``TRAIN_FAMILIES_LR``): Gemma2 through
    ``launch.train.main``, the others through ``Trainer`` as phase 10.
    Prints the memory arithmetic beside the measured peak, and the device
    ms of the family's backward kernel (``STEP_KERNELS``) in the last step,
    traced by the profiler (``profile_last_step``).  Gates: finite losses and gradient norms, the mean
    loss of the last 3 steps below that of the first 3, exact launches.
    Returns the launches."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import param_count

    cfg = get_config(arch).with_depth(depth)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    ops.reset_launches()
    t0 = time.monotonic()

    def profiled(tr):
        return profile_last_step(tr, TRAIN_FAMILIES_STEPS)
    if arch == "gemma2_9b":
        how = "launch.train.main"
        hist, n_params, finish = launcher_history([
            "--arch", arch, "--layers", str(depth), "--batch", str(batch),
            "--seq", str(seq), "--steps", str(TRAIN_FAMILIES_STEPS),
            "--lr", str(TRAIN_FAMILIES_LR), "--seed", "0"], before=profiled)
    else:
        how = "Trainer"
        trainer = synthetic_trainer(cfg, TRAIN_FAMILIES_LR,
                                    TRAIN_FAMILIES_STEPS, batch=batch,
                                    seq=seq)
        tr = trainer(TRAIN_FAMILIES_STEPS)
        finish = profiled(tr)
        tr.run()
        hist = tr.metrics_history
        n_params = param_count(tr.state.params)
        del tr, trainer
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launches()
    by_name = finish()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    want = family_launches(cfg, TRAIN_FAMILIES_STEPS)
    # bf16 parameters, AdamW's bf16 first and second moments, bf16
    # gradients: 8 bytes a parameter; the rest of the peak is activations
    state_gb = 8 * n_params / 1e9
    print(f"  {cfg.name} at full width (d_model {cfg.d_model}), {depth} of "
          f"{get_config(arch).n_layers} layers, {batch} x {seq} tokens a "
          f"step, through {how}: {n_params / 1e9:.3f} B parameters; "
          f"parameters 2 B + AdamW state 4 B + gradients 2 B a parameter = "
          f"{state_gb:.2f} GB, measured peak {peak_gb:.2f} GB "
          f"(max_memory_allocated over {base_gb:.2f} GB already held), so "
          f"activations and scratch about {peak_gb - state_gb:.2f} GB; "
          f"{TRAIN_FAMILIES_STEPS} steps and set-up {wall:.1f} s")
    failures, step_ms = train_gates(hist, counts, want, tokens=batch * seq)
    print(f"  launches over {TRAIN_FAMILIES_STEPS} steps: "
          f"{ {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} })")
    label, parts = STEP_KERNELS[arch]
    total = sum(by_name.values())
    mine = sum(v for n, v in by_name.items() if any(x in n for x in parts))
    if total:
        print(f"  step {TRAIN_FAMILIES_STEPS} under torch.profiler: its "
              f"kernels' device time {total:.1f} ms, of which {label} "
              f"{mine:.3f} ms ({mine / total:.1%}), {mine / step_ms:.1%} of "
              f"the {step_ms:.1f} ms step wall of steps "
              f"2-{TRAIN_FAMILIES_STEPS}")
    else:
        print(f"  step {TRAIN_FAMILIES_STEPS} under torch.profiler: no "
              f"device events, {label}'s share of a step not measured")
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"phase 15 {arch}: {failures}")
    return counts


def train_families_phase() -> dict:
    """Phase 15: Zamba2-7B, RWKV6-7B and Gemma2-9B trained at full width
    (``TRAIN_FAMILIES``), one at a time, each freed before the next.
    Returns the launches by path."""
    return {f"{arch}_train": train_family(arch, depth, batch, seq)
            for arch, depth, batch, seq in TRAIN_FAMILIES}


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


class PhaseClock:
    """Each phase's title, then its wall once it ends (``phase N took X
    s``); ``summary`` prints every wall and the script's."""

    def __init__(self):
        self.started = time.monotonic()
        self.walls: dict = {}

    def __call__(self, n: int, title: str):
        import contextlib

        @contextlib.contextmanager
        def timed():
            print(title)
            t0 = time.monotonic()
            yield
            self.walls[n] = time.monotonic() - t0
            print(f"  phase {n} took {self.walls[n]:.1f} s")
        return timed()

    def summary(self) -> None:
        print("phase walls, s: " + ", ".join(
            f"{n} {w:.1f}" for n, w in self.walls.items())
            + f"; the script {time.monotonic() - self.started:.1f}")


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
                    help="phases 1, 2, 10 and 16 (b) only")
    ap.add_argument("--train-ranks-only", action="store_true",
                    help="phases 1, 2, 11 and 16 (d) only (on four cards: "
                         "nccl)")
    ap.add_argument("--families-only", action="store_true",
                    help="phases 1, 2 and 12 only")
    ap.add_argument("--encdec-only", action="store_true",
                    help="phases 1, 2 and 13 only")
    ap.add_argument("--tp-families-only", action="store_true",
                    help="phases 1, 2 and 14 only (on four cards: nccl)")
    ap.add_argument("--train-families-only", action="store_true",
                    help="phases 1, 2 and 15 only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")

    clock = PhaseClock()
    with clock(1, "phase 1: device"):
        kind = torch.cuda.get_device_name(0)
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
              f"python {sys.version.split()[0]}, {kind}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        print(smi.strip())

    with clock(2, "phase 2: build"):
        build_phase()
    cards = torch.cuda.device_count()
    four = cards >= 4
    depth, kimi_new = KIMI_DEPTH[4 if four else 1]
    kimi_title = (f"phase 7: Kimi-K2-1T over 2 pods x 8 ep ranks, depth "
                  f"{depth}")
    tp_new = TP_NEW[4 if four else 1]
    tp_title = ("phase 8: tensor parallelism, Mistral-NeMo-12B over (1, 1, "
                "4)" + ("" if tp_new == MAX_NEW else
                        f", {tp_new} new tokens on one card"))
    cal_title = ("phase 9: the telemetry loop, DBRX over 2 x 2 and "
                 "Mistral-NeMo over (1, 1, 4) calibrated on the card")
    train_title = (f"phase 10: training, the backward kernels and "
                   f"DBRX-132B at full width, depth {TRAIN_DEPTH}")
    ranks_depth = TRAIN_RANKS[4 if four else 1][0]
    train_ranks_title = (f"phase 11: training over ranks, DBRX-132B over 2 "
                         f"pods x 2 ep ranks at depth {ranks_depth} and "
                         f"Mistral-NeMo-12B over (1, 1, 4)")
    families_title = ("phase 12: Gemma2-9B, StarCoder2-15B, Minitron-8B and "
                      "Qwen2-VL-2B's backbone at full width and depth")
    encdec_title = ("phase 13: SeamlessM4T-medium, the encoder-decoder, "
                    "served and trained at full width and depth")
    tp_families_title = tp_families_heading(four)
    train_families_title = ("phase 15: Zamba2-7B, RWKV6-7B and Gemma2-9B "
                            "trained at full width")
    if args.kimi_only:
        with clock(7, kimi_title):
            kimi_phase(depth, kimi_new)
    elif args.families_only:
        with clock(12, families_title):
            counts = families_phase()
            print(f"  launches of phase 12's measured calls: {counts}")
    elif args.encdec_only:
        with clock(13, encdec_title):
            counts = encdec_phase()
            print(f"  launches of phase 13's measured call and training: "
                  f"{counts}")
    elif args.tp_only:
        with clock(8, tp_title):
            tp_phase()
    elif args.calibrate_only:
        with clock(9, cal_title):
            calibrate_phase()
    elif args.train_only:
        with clock(10, train_title):
            rows, counts = train_phase()
        with clock(16, "phase 16 (b): the dry run against phase 10"):
            dryrun_phase("b")
        for name, row in rows.items():
            row["launches"] = counts[name]
            row["launches_by_path"] = {"dbrx_132b_train": counts[name]}
    elif args.train_ranks_only:
        with clock(11, train_ranks_title):
            counts = train_ranks_phase()
            print(f"  launches of phase 11's trained runs, summed over "
                  f"ranks: {counts}")
        with clock(16, "phase 16 (d): the dry run against phase 11"):
            dryrun_phase("d")
    elif args.tp_families_only:
        with clock(14, tp_families_title):
            counts = tp_families_phase()
            print(f"  launches of phase 14's measured runs, summed over "
                  f"ranks: {counts}")
    elif args.train_families_only:
        with clock(15, train_families_title):
            counts = train_families_phase()
    elif args.ranks_only:
        for i, cf in enumerate(args.ranks_only):
            with clock(6, f"phase 6: DBRX over 2 pods x 2 ep ranks, "
                          f"capacity factor {cf}"):
                ranks_phase(cf, trace=args.trace if i == 0 else None)
    else:
        with clock(3, "phase 3: kernels vs plain versions"):
            sass_phase()
            rows = kernel_phase()
            rows.update(scan_phase())
            combine_phase()
        with clock(4, "phase 4: small-model reference"):
            reference_phase()
        by_path = {}
        with clock(5, "phase 5: serve"):
            for arch, layers in SERVES:
                by_path[arch] = serve_phase(arch, layers)
        with clock(6, "phase 6: DBRX over 2 pods x 2 ep ranks"):
            # phase 9's DBRX rides this spawn, its Mistral probes phase 8's
            by_path["dbrx_132b_2x2_ranks"] = ranks_phase(carry=True)
        with clock(7, kimi_title):
            by_path["kimi_k2_1t_2x8_ranks"] = kimi_phase(depth, kimi_new)
        with clock(8, tp_title):
            by_path["tp_ranks"] = tp_phase(carry=True)
        with clock(9, cal_title):
            by_path["dbrx_132b_2x2_calibrated"] = calibrate_phase()
        with clock(10, train_title):
            bwd_rows, by_path["dbrx_132b_train"] = train_phase()
            rows.update(bwd_rows)
        with clock(11, train_ranks_title):
            by_path["train_ranks"] = train_ranks_phase()
        with clock(12, families_title):
            by_path.update(families_phase())
        with clock(13, encdec_title):
            by_path.update(encdec_phase())
        with clock(14, tp_families_title):
            by_path.update(tp_families_phase())
        with clock(15, train_families_title):
            by_path.update(train_families_phase())
        with clock(16, "phase 16: the dry run against the card"):
            dryrun_phase()

        for name, row in rows.items():
            row["launches"] = sum(c.get(name, 0) for c in by_path.values())
            row["launches_by_path"] = {arch: c.get(name, 0)
                                       for arch, c in by_path.items()}
    clock.summary()
    if args.train_only or not any(
            (args.ranks_only, args.kimi_only, args.tp_only,
             args.calibrate_only, args.train_ranks_only, args.families_only,
             args.encdec_only, args.tp_families_only,
             args.train_families_only)):
        print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
