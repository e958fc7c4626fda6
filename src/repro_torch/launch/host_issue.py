"""Host issue time per call of the kernel wrappers, at the main path's shapes.

  python3 src/repro_torch/launch/host_issue.py [--src DIR] [--repeats 15]

For each shape, times on the host clock runs of 40 wrapper calls issued
back to back without waiting for the device (the launches queue up behind
each other) and prints the median and the least of ``--repeats`` runs:
the three packs of a DBRX decode round (N = 4 to 6 rows of 6144 bf16),
attention at the DBRX and Zamba2 prefill shapes, and attention's backward
at DBRX's.  ``--src`` names the ``src`` directory whose ``repro_torch`` is
timed (default: this checkout's), so that the wrappers of two checkouts
are timed by the same code.  The host is shared and its noise moves between processes: run two
checkouts in alternating processes (A, B, B, A).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

CALLS = 40          # calls a run


def runs(fn, repeats: int, calls: int = CALLS) -> list[float]:
    """Milliseconds of host time per call of ``fn``, one entry for each of
    ``repeats`` runs of ``calls`` calls, after one warm call."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return out


def _cases():
    """(label, a call of the wrapper) at each shape."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import _forward
    bf16 = torch.bfloat16
    cases = []
    # a decode round's packs: 4 live tokens, top-4 of 16 experts, one slot
    # an expert at stage 3 (chip_smoke.py's decode1-3)
    for label, (n, d, c) in (("pack decode1", (4, 1, 5)),
                             ("pack decode2", (5, 1, 6)),
                             ("pack decode3", (6, 16, 1))):
        tokens = torch.randn((n, 6144), device="cuda").to(bf16)
        bitmap = torch.full((n,), (1 << min(d, 4)) - 1, dtype=torch.int32,
                            device="cuda")
        valid = torch.arange(n, device="cuda") < 4
        cases.append((label, lambda a=(tokens, bitmap, valid), d=d, c=c:
                      ops.dispatch_pack(*a, num_dests=d, capacity=c)))
    # attention at the prefill shapes, as views of [B, S, heads, D]
    for label, (hq, g, dh) in (("attention dbrx", (48, 8, 128)),
                               ("attention zamba2", (32, 32, 112))):
        q, k, v = (torch.randn((4, 512, heads, dh), device="cuda").to(bf16)
                   .transpose(1, 2) for heads in (hq, g, g))
        cases.append((label, lambda a=(q, k, v):
                      ops.flash_attention(*a, causal=True)))
    # the attention backward at DBRX's shape (two passes, five tensor maps
    # encoded a call), from the forward's own output and log-sum-exp
    q, k, v = (torch.randn((4, 512, heads, 128), device="cuda").to(bf16)
               .transpose(1, 2) for heads in (48, 8, 8))
    out, lse = _forward(q, k, v, (True, None, None, None), with_lse=True)
    do = torch.randn_like(out)
    cases.append(("attention backward dbrx", lambda:
                  ops.flash_attention_bwd(q, k, v, out, do, lse)))
    return cases


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--repeats", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("host_issue: no CUDA device")
    import repro_torch
    print(f"host issue per call of {Path(repro_torch.__file__).parent}, "
          f"ms ({args.repeats} runs of {CALLS} calls):")
    for label, fn in _cases():
        times = runs(fn, args.repeats)
        print(f"  {label}: median {statistics.median(times):.4f}, "
              f"least {min(times):.4f}")


if __name__ == "__main__":
    main()
