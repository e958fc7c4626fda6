"""One MoE layer of DBRX's width, forward and backward on one card.

  python3 src/repro_torch/launch/moe_backward.py [--src DIR] \\
      [--tokens 65536] [--repeats 3]

Runs ``models.moe.moe_ffn`` on one rank (the hierarchical pair at one
chunk) at DBRX-132B's width: d_model 6,144, 16 experts of FFN width
10,752, top-4, capacity factor 1.25, bf16, random weights of seed 0, on
``--tokens`` tokens, and its backward under a random cotangent, every
weight and the input taking a gradient.  After a warm step it prints, for
each of ``--repeats`` steps, the forward and the backward in ms (CUDA
events) and ``max_memory_allocated`` over the step.  A step that runs out
of memory is tried again at half the tokens, and the count that ran is
printed.  ``--src`` names the ``src`` directory whose ``repro_torch``
runs (default: this checkout's), so that two checkouts are timed by the
same code.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def step(layer, cfg, tokens: int, gen) -> tuple[float, float, float]:
    """(forward ms, backward ms, max_memory_allocated GB) of one step on
    ``tokens`` fresh tokens."""
    import torch

    from repro_torch.models import moe as M
    x = torch.randn((1, tokens, cfg.d_model), device="cuda",
                    generator=gen).to(torch.bfloat16).requires_grad_(True)
    ct = torch.randn((1, tokens, cfg.d_model), device="cuda",
                     generator=gen).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    y, _ = M.moe_ffn(layer, x, cfg, None)
    marks[1].record()
    y.backward(ct)
    marks[2].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for p in layer.parameters():
        p.grad = None
    return (marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2]),
            peak)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="the src directory whose repro_torch runs")
    ap.add_argument("--tokens", type=int, default=65536)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("moe_backward: no CUDA device")
    import repro_torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as M
    cfg = get_config("dbrx_132b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    layer = M.MoE(cfg.d_model, cfg.expert_d_ff, cfg.num_experts,
                  device="cuda", dtype=torch.bfloat16).reset_parameters(gen)
    for p in layer.parameters():
        p.requires_grad_(True)
    tokens = args.tokens
    print(f"moe_backward of {Path(repro_torch.__file__).parent} on "
          f"{torch.cuda.get_device_name(0)}: one DBRX-width MoE layer "
          f"(d_model {cfg.d_model}, {cfg.num_experts} experts of width "
          f"{cfg.expert_d_ff}, top-{cfg.top_k}, capacity factor "
          f"{cfg.moe_capacity}), bf16")
    while True:
        try:
            step(layer, cfg, tokens, gen)           # warm
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            print(f"  {tokens} tokens: out of memory, halved")
            tokens //= 2
    for i in range(args.repeats):
        fwd, bwd, peak = step(layer, cfg, tokens, gen)
        print(f"  {tokens} tokens, step {i}: forward {fwd:.3f} ms, backward "
              f"{bwd:.3f} ms, max_memory_allocated {peak:.3f} GB")


if __name__ == "__main__":
    main()
