"""MoE dispatch demo of the PyTorch/CUDA port: the paper's Table-1
scenario.

Routes tokens top-4 over 16 experts (DBRX's routing) on 2 pods x 4
ranks, and runs BOTH dispatch schemes:

  baseline    one copy per (token, destination rank) crosses the pod axis
  multiwrite  ONE copy per (token, destination pod), relay replication

then compares (a) the pod-axis bytes a rank sends under each scheme, read
from the exchange log of a dry-run cell of one MoE layer (the
``ShapeMesh`` of ``launch/dryrun.py``: every exchange of the rank's
program logged with its axis and wire bytes, nothing allocated), and (b)
the MoE layer's outputs under both scheme pairs, computed by 8 spawned
ranks (gloo) on the card, or on the CPU with ``--device cpu``.

Run on the card:   PYTHONPATH=src python examples/torch_moe_dispatch_demo.py
On the CPU:        PYTHONPATH=src python examples/torch_moe_dispatch_demo.py \\
                       --device cpu
"""

import argparse
import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun, ranks

EXPERTS, TOPK = 16, 4
SCHEMES = {"baseline": ("baseline", "baseline"),
           "multiwrite": ("hierarchical", "hierarchical")}


def layer_config(width: int):
    """One MoE layer of DBRX's family at a demo width: 16 experts,
    top-4, no capacity drops."""
    return dataclasses.replace(
        get_config("dbrx_132b").reduced(n_layers=1, d_model=width,
                                        d_ff=2 * width,
                                        num_experts=EXPERTS),
        top_k=TOPK, moe_capacity=8.0)


def pod_bytes(cfg, pods: int, ep: int, tokens: int) -> dict:
    """{scheme: pod-axis wire bytes rank 0 sends}, from the exchange log
    of a dry-run prefill cell of the layer on (pods, ep, 1)."""
    shape = ShapeSpec("demo", tokens, pods * ep, "prefill")
    out = {}
    for name, (scheme, combine) in SCHEMES.items():
        r = dryrun.run_cell("dbrx_132b", shape, multi_pod=True,
                            mesh_shape=(pods, ep, 1), config=cfg,
                            knobs={"moe_scheme": scheme,
                                   "moe_combine": combine},
                            verbose=False, fabrics=())
        out[name] = r["collectives"]["by_axis"].get("pod", 0)
    return out


def layer_outputs(cfg, device, pods: int, ep: int, tokens: int) -> dict:
    """{scheme: the layer's output over every rank's rows}, from
    ``pods * ep`` spawned ranks on ``device``."""
    rng = np.random.default_rng(0)
    d, f = cfg.d_model, cfg.moe_d_ff
    weights = {"router": rng.normal(size=(d, EXPERTS)).astype(np.float32),
               "w1": (rng.normal(size=(EXPERTS, d, f)) / d ** 0.5
                      ).astype(np.float32),
               "w3": (rng.normal(size=(EXPERTS, d, f)) / d ** 0.5
                      ).astype(np.float32),
               "w2": (rng.normal(size=(EXPERTS, f, d)) / f ** 0.5
                      ).astype(np.float32)}
    world = pods * ep
    x = rng.normal(size=(world, tokens, d)).astype(np.float32)
    runs = [dict(label=name, scheme=s, combine=c, microbatch=1)
            for name, (s, c) in SCHEMES.items()]
    with tempfile.TemporaryDirectory() as tmp:
        got = ranks.run_ranks(ranks.dispatch_worker, dict(
            world=world, pods=pods, ep=ep, tp=1, backend="gloo",
            device=str(device), init_method=f"file://{Path(tmp) / 'store'}",
            timeout_s=120, out_dir=str(Path(tmp) / "out"), threads=1,
            cases=[], inputs=None,
            moe=[dict(name="layer", cfg=cfg, weights=weights, x=x,
                      runs=runs)]), timeout_s=600)
    return {name: np.concatenate([r["moe_ffn"]["layer"][name]["y"]
                                  for r in got])
            for name in SCHEMES}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--ep", type=int, default=4, help="ranks a pod")
    ap.add_argument("--tokens", type=int, default=64, help="a rank")
    ap.add_argument("--width", type=int, default=256)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = layer_config(args.width)
    outs = layer_outputs(cfg, device, args.pods, args.ep, args.tokens)
    err = float(np.abs(outs["baseline"] - outs["multiwrite"]).max())
    print(f"layer outputs equal across schemes on {device}: "
          f"max|diff| = {err:.2e}")
    assert err <= 1e-5 * float(np.abs(outs["baseline"]).max())
    sent = pod_bytes(cfg, args.pods, args.ep, args.tokens)
    b, m = sent["baseline"], sent["multiwrite"]
    print("pod-axis (slow link) wire bytes a rank sends, from the dry "
          "run's exchange log:")
    print(f"  baseline (unicast): {b:10.0f}")
    print(f"  multiwrite        : {m:10.0f}")
    print(f"  reduction         : {100 * (1 - m / b):.0f}%  (paper Table 1: "
          f"one crossing per pod vs per expert)")
    assert m < b
    print("OK")


if __name__ == "__main__":
    main()
