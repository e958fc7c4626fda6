"""Serving launcher: batched greedy generation with the port's ServeEngine.

On the card, with random weights: DBRX-132B at full width with its depth
cut to 4 layers, and Zamba2-7B and RWKV6-7B whole:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b \
      --layers 4 --prompts 4 --prompt-len 512 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b

On the CPU, the reduced config through the kernels' plain versions:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b \
      --device cpu --smoke --prompt-len 16 --max-new 4

Over ranks, under ``torchrun``: ``--pods P --ep D`` lays the P * D ranks out
as P pods of D ep ranks (DBRX's 16 experts: 4 a rank over 2 x 2; Kimi's
384: 24 a rank over 2 x 8), each rank serving its share of the prompts.
``--backend`` is required there: ``nccl`` gives each rank the card of its
local rank (there must be that many cards), ``gloo`` puts every rank on the
device ``--device`` names, and on a CUDA device without an index (the
default) local rank r on card ``r * cards // local ranks``.  Every rank
holds its non-expert weights whole, so Kimi at full width runs on four
cards at a cut depth:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch dbrx_132b --layers 4 --pods 2 --ep 2 --backend gloo
  PYTHONPATH=src torchrun --nproc-per-node 16 -m repro_torch.launch.serve \
      --arch kimi_k2_1t --layers 4 --pods 2 --ep 8 --backend gloo \
      --prompts 16

Over ranks the MoE round trip (dispatch scheme, return scheme, pipeline
depth G) comes from the planner under ``--plan-policy auto`` (the default,
as in the reference): both serving phases are declared as one collective
program, planned on ``--fabric`` (a registered name such as ``2x8``, or an
inline ``SxP[rR][@INTER[:INTRA]]`` in GB/s) and bound before the model is
built; rank 0 prints the plan.  Without ``--fabric`` the nccl ranks time
their link and plan on it; gloo ranks plan on the reference's mesh-derived
TPU fabric and say so.
``--plan-policy fixed`` runs the hierarchical pair at one chunk.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.h100 import fabric_spec
from repro_torch.core.topology import get_fabric
from repro_torch.device import resolve_device
from repro_torch.launch.ranks import link_probe_bytes, measure_link
from repro_torch.models.api import build_model
from repro_torch.parallel.context import (ParallelContext,
                                          build_collective_program)
from repro_torch.parallel.mesh import RankMesh
from repro_torch.runtime.server import ServeConfig, ServeEngine

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def serve_config(arch: str, *, layers: int | None, smoke: bool
                 ) -> ModelConfig:
    """The arch's published config with only its depth cut (``layers``),
    or its reduced smoke variant."""
    cfg = get_config(arch)
    if smoke:
        return cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def build_engine(cfg: ModelConfig, *, device=None, dtype=torch.bfloat16,
                 seed: int = 0, max_new: int = 32, temperature: float = 0.0,
                 cache_dtype=torch.bfloat16, pctx=None) -> ServeEngine:
    """Model with random weights from a seeded generator of ``device``
    (this rank's experts only, with a ``pctx``), wrapped in a
    ServeEngine."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, dtype=dtype, pctx=pctx)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    if dev.type == "cuda":
        # the draws' fp32 temporaries (4.7 GB for Kimi-K2's embedding) go
        # back to the card, which the other ranks of a host may share
        torch.cuda.empty_cache()
    return ServeEngine(model, params,
                       ServeConfig(max_new_tokens=max_new,
                                   temperature=temperature,
                                   cache_dtype=cache_dtype),
                       device=dev, pctx=pctx)


def join_ranks(pods: int, ep: int, backend: str | None, device):
    """Join the ``torchrun`` process group (its environment gives rank and
    world size) as ``pods`` x ``ep`` ranks.  Returns (pctx, device); (None,
    device) for one rank."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if pods * ep != world:
        raise ValueError(f"--pods {pods} x --ep {ep} != world size {world}")
    if world == 1:
        return None, device
    if backend == "nccl":
        local = int(os.environ["LOCAL_RANK"])
        cards = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if torch.cuda.device_count() < cards:
            raise RuntimeError(f"nccl: {cards} ranks on this host, "
                               f"{torch.cuda.device_count()} cards")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    elif backend == "gloo":
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            # the host's ranks in blocks over its cards
            local = int(os.environ["LOCAL_RANK"])
            device = torch.device("cuda", local * torch.cuda.device_count()
                                  // int(os.environ["LOCAL_WORLD_SIZE"]))
            torch.cuda.set_device(device)
    else:
        raise ValueError("--backend nccl or gloo is required over ranks")
    dist.init_process_group(backend, timeout=COLLECTIVE_TIMEOUT,
                            device_id=device if backend == "nccl" else None)
    mesh = RankMesh((pods, ep, 1), timeout=COLLECTIVE_TIMEOUT)
    return ParallelContext(mesh, pod_axis="pod" if pods > 1 else None), \
        device


def planning_fabric(pctx, cfg: ModelConfig, args, device) -> str | None:
    """The fabric ``--plan-policy auto`` plans on: ``--fabric`` when given.
    Otherwise over nccl the ranks time one ``all_to_all_single`` of a
    prefill dispatch's stage-1 size and plan on ``PxD@R:R`` from the
    measured per-pair rate; over gloo (host-staged, no link of the card to
    time) on the reference's mesh-derived TPU fabric, with a warning."""
    if args.fabric:
        return args.fabric
    rank0 = pctx.mesh.rank == 0
    if args.backend != "nccl":
        if rank0:
            print("warning: no --fabric over gloo: the planner scores on "
                  "the reference's mesh-derived TPU fabric")
        return None
    rows = max(1, args.prompts * args.prompt_len // pctx.dp_size)
    nbytes = link_probe_bytes(cfg, rows, args.pods, args.ep,
                              4 if args.smoke else 2)
    rate = measure_link(pctx.mesh, nbytes, device)
    spec = fabric_spec(args.pods, args.ep, rate)
    if rank0:
        print(f"link: all_to_all_single of {nbytes} bytes a rank, "
              f"{rate / 1e9:.3f} GB/s a pair -> fabric {spec}")
    return spec


def make_prompts(cfg: ModelConfig, prompts: int, prompt_len: int,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab,
                        size=(prompts, prompt_len)).astype(np.int32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="dbrx_132b, kimi_k2_1t, zamba2_7b or rwkv6_7b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay "
                         "the published ones)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config in fp32")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without one)")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pods", type=int, default=1,
                    help="pods of the rank mesh (under torchrun)")
    ap.add_argument("--ep", type=int, default=1,
                    help="ep ranks a pod (under torchrun)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="required over ranks: nccl (one card a rank) or "
                         "gloo (every rank on --device; without a card "
                         "index the host's ranks are laid over its cards "
                         "in blocks)")
    ap.add_argument("--plan-policy", choices=("auto", "fixed"),
                    default="auto",
                    help="over ranks, auto: the planner picks each phase's "
                         "MoE dispatch, combine and pipeline depth")
    ap.add_argument("--fabric", default=None,
                    help="fabric the planner scores on: a registered name "
                         "(2x8, 4x8, 2x8r2, 2x8asym, ...) or an inline spec "
                         "'SxP[rR][@INTER[:INTRA]]' in GB/s (default: "
                         "over nccl the measured link, over gloo the "
                         "reference's mesh-derived fabric)")
    ap.add_argument("--decode-slo-us", type=float, default=None,
                    help="decode-phase latency budget (us): the planner "
                         "rejects prefill plan combinations whose shared-"
                         "link traffic would push the decode round trip "
                         "past this cap")
    args = ap.parse_args(argv)

    cfg = serve_config(args.arch, layers=args.layers, smoke=args.smoke)
    pctx, device = join_ranks(args.pods, args.ep, args.backend, args.device)
    plan = fabric = None
    if pctx is not None:
        pctx = dataclasses.replace(pctx, plan_policy=args.plan_policy)
        if args.plan_policy == "auto" and cfg.is_moe:
            fabric = planning_fabric(pctx, cfg, args, device)
            pctx = dataclasses.replace(
                pctx, fabric=get_fabric(fabric) if fabric else None)
            # bind the plan of both phases before the model is built; site
            # keys embed the payload, so the itemsize is the model's
            budgets = ({"decode": args.decode_slo_us * 1e-6}
                       if args.decode_slo_us else None)
            program = build_collective_program(
                cfg, pctx, "serve",
                {"prefill": (args.prompts, args.prompt_len),
                 "decode": (args.prompts, 1)},
                itemsize=4 if args.smoke else 2, phase_budgets=budgets)
            plan = pctx.plan_collectives(program)
            pctx = pctx.bind(plan)
            if pctx.mesh.rank == 0:
                print(plan.summary())
    engine = build_engine(
        cfg, device=device,
        dtype=torch.float32 if args.smoke else torch.bfloat16,
        seed=args.seed, max_new=args.max_new, temperature=args.temperature,
        pctx=pctx)
    prompts = make_prompts(cfg, args.prompts, args.prompt_len, args.seed)
    out = engine.generate(prompts)
    if pctx is not None:
        dist.destroy_process_group()
    st = engine.stats
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "device": str(engine.device),
        "ranks": f"{args.pods} pods x {args.ep} ep",
        "plan": plan.fingerprint if plan is not None else None,
        "fabric": fabric,
        "shape": list(out.shape), "prefill_s": st["prefill_s"],
        "decode_s": st["decode_s"], "tokens": st["tokens"],
        "nonfinite_logits": st["nonfinite_logits"],
        "first_tokens": out[:, :8].tolist(),
    }
    if pctx is None or pctx.mesh.rank == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
