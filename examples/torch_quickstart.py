"""Quickstart of the PyTorch/CUDA port: MultiWrite in 60 seconds.

1. The semantic: one MultiWrite == one copy per bottleneck link.
2. The paper's AllGather schedules, the latency model and the planner.
3. The dispatch pack, the first stage of the MoE dispatch: the
   hand-written kernel on the card, held against its plain version.

Run on the card:   PYTHONPATH=src python examples/torch_quickstart.py
On the CPU:        PYTHONPATH=src python examples/torch_quickstart.py \\
                       --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import latency_model as lm
from repro_torch.core import planner as pl
from repro_torch.core import schedules as sch
from repro_torch.core.multiwrite import MultiWriteSimulator
from repro_torch.core.topology import split_tp_full_mesh, two_server_cluster
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref


def semantic() -> None:
    print("== MultiWrite semantic ==")
    topo = two_server_cluster()          # 2 servers x 8 NPUs, rail-optimized
    token = np.arange(7168, dtype=np.uint8)
    sim = MultiWriteSimulator(topo)
    for dst in (9, 10, 12, 15):          # unicast: 4 copies cross the rail
        sim.write(0, dst, "tok", token)
    print(f"unicast    rail bytes: {sim.link_bytes[(0, 8)]:8d} "
          f"(redundant: {sim.redundant_bytes()[(0, 8)]})")
    sim = MultiWriteSimulator(topo)
    sim.multiwrite(0, {d: "tok" for d in (9, 10, 12, 15)}, token)
    print(f"multiwrite rail bytes: {sim.link_bytes[(0, 8)]:8d} "
          f"(relay replicates at NPU8)")


def schedules() -> None:
    print("\n== AllGather on the split-TP full mesh (16 MB/rank) ==")
    frag = 16 * 2**20
    for scheme in ("baseline", "unicast_paired", "multiwrite_paired"):
        print(f"  {scheme:20s}: "
              f"{lm.allgather_latency(scheme, frag) * 1e6:7.1f} us")
    cut = 1 - (lm.allgather_latency("multiwrite_paired", frag)
               / lm.allgather_latency("baseline", frag))
    print(f"  -> MultiWrite cuts latency {100 * cut:.0f}% (paper Fig 6: "
          f"~30%)")
    topo8, domains = split_tp_full_mesh(8, tp=4)
    sim = MultiWriteSimulator(topo8)
    payloads = [np.random.default_rng(i).integers(0, 256, 4096,
                                                  dtype=np.uint8)
                for i in range(8)]
    sch.ALLGATHER_SCHEMES["multiwrite_paired"](sim, domains, payloads)
    sch.check_allgather(sim, domains, payloads)
    print("  schedule delivers every fragment bit-exactly: OK")
    print("\n== planner: baseline below the Fig 7 crossover, MultiWrite "
          "above ==")
    for frag in (256 * 2**10, 16 * 2**20):
        d = pl.default_planner().choose("allgather", frag, topo8)
        print(f"  {frag / 2**20:6.2f} MB -> {d.plan} (predicted "
              f"{d.predicted_s * 1e6:.0f} us, {d.speedup_pct:+.0f}% vs "
              f"baseline)")


def pack(device, tokens: int = 4096, width: int = 1024, dests: int = 8):
    """Pack ``tokens`` rows into ``dests`` send buffers by a random
    destination bitmap; returns the packed buffers."""
    print(f"\n== dispatch pack on {device} ({tokens} x {width}, {dests} "
          f"destinations) ==")
    gen = torch.Generator().manual_seed(0)
    rows = torch.randn(tokens, width, generator=gen).to(device,
                                                       torch.bfloat16)
    bitmap = torch.randint(0, 1 << dests, (tokens,), generator=gen,
                           dtype=torch.int32).to(device)
    valid = torch.ones(tokens, dtype=torch.bool, device=device)
    capacity = tokens // 2
    ops.reset_launches()
    out, src = ops.dispatch_pack(rows, bitmap, valid, num_dests=dests,
                                 capacity=capacity)
    want, want_src = ref.pack_ref(rows, bitmap, valid, dests, capacity)
    assert torch.equal(out, want) and torch.equal(src, want_src)
    kind = ("the CUDA kernel" if device.type == "cuda"
            else "the plain version")
    print(f"  {kind}: {int((src >= 0).sum())} rows packed, bit-exact "
          f"against the plain version; kernel launches "
          f"{ops.launches()['dispatch_pack']}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    ap.add_argument("--tokens", type=int, default=4096)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    semantic()
    schedules()
    pack(device, tokens=args.tokens)
    print("\nDone.  See examples/torch_train_100m.py for end-to-end "
          "training.")


if __name__ == "__main__":
    main()
