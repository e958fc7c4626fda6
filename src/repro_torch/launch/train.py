"""Training launcher, on one rank or over a rank mesh under ``torchrun``.

On the CPU, the reduced config in fp32 through the kernels' plain versions
(batch 4 x 64, as the reference's ``--smoke``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx_132b \\
      --smoke --device cpu --steps 3

Over 4 gloo ranks on the CPU, 2 pods x 2 ep ranks:

  PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch dbrx_132b --smoke --device cpu \\
      --pods 2 --ep 2 --backend gloo --steps 3

On the card the model is bf16 at the arch's full width; one card cannot
hold ``train_4k``'s 256 x 4096, so ``--batch`` and ``--seq`` cut it, and
``--layers`` cuts the depth:

  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx_132b \\
      --layers 2 --batch 4 --seq 512 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch seamless_m4t_medium --batch 4 --seq 512 --steps 8

(``--layers`` cuts an encoder-decoder's encoder and decoder alike)

and over four cards ``torchrun --nproc-per-node 4 ... --pods 2 --ep 2
--backend nccl``.

AdamW on the reference's cosine schedule, weight decay 0.01, parameters
and optimizer state in the model's dtype; ``SyntheticLM`` batches from
``--seed`` (over ranks each rank takes its data-parallel rows of the
global batch); checkpoints every ``--ckpt-every`` steps under
``--ckpt-dir`` (a run resumes from the latest one there; over ranks the
leaves are stored at their global shapes, so a checkpoint moves between
meshes).  ``--grad-accum N`` splits each batch into N micro-batches whose
fp32 gradients are summed (the reference's launcher takes the flag and
leaves it unused).

Over ranks the launcher declares the training phase's collective program
(the MoE round trip, the split-TP gather, the gradient AllReduce) and,
under ``--plan-policy auto``, binds the planner's plan for it before the
model is built, on ``--fabric`` or the mesh-derived default;
``--calibrate startup`` first fits the planner to a simulated probe's
records (``SimProbe``, as the reference), and ``online`` also re-probes
every ``--calibrate-every`` steps and feeds the step walls into the
pipelined MoE decision (``telemetry.StepAttribution``).  The plan's
``grad_sync`` verdict RUNS: every step's gradient mean over the
data-parallel ranks is ``planned_psum`` with its scheme
(``runtime.trainer.GradSync``), where the reference's jitted step runs the
implicit GSPMD ring whatever the verdict.  ``--variant`` applies one of
the dry run's ``VARIANTS`` (``launch/dryrun.py``) to the context, as the
reference's launcher does; ``--multi-pod`` asks for the production mesh
(2, 16, 16) of ``launch/mesh.py`` (the mesh's ``ValueError`` on any other
world size).  Over more than one data rank the parameters are FSDP-sharded
(ZeRO-3 over ``data``, the context's ``fsdp``, the reference's default:
``parallel.sharding.shard_fsdp``): each data-cut leaf, its gradient and
its AdamW state are the rank's ``1/data`` slice, gathered over ``data``
whenever the model reads the leaf; ``--variant nofsdp`` trains with every
leaf replicated over the data-parallel ranks instead:

  PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch mistral_nemo_12b --smoke \\
      --device cpu --ep 2 --tp 2 --backend gloo --steps 3 [--variant nofsdp]

  PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch zamba2_7b --smoke --device cpu \\
      --tp 2 --backend gloo --variant baseline --steps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, batch_for_model
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model, param_count_shape_only
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.parallel import sharding
from repro_torch.runtime.trainer import (GradSync, Trainer, TrainerConfig,
                                         make_train_step)
from repro_torch.telemetry.exporter import (add_metrics_args,
                                            finish_exporter_from_args,
                                            start_exporter_from_args)


def train_config(arch: str, *, smoke: bool, layers: int | None):
    """The arch's config with its depth cut (``layers``), or the reduced
    smoke variant."""
    cfg = get_config(arch)
    if smoke:
        return cfg.reduced()
    if layers is not None:
        cfg = cfg.with_depth(layers)
    return cfg


def micro_batches(batch: dict, grad_accum: int) -> dict:
    """[B, ...] leaves as [grad_accum, B / grad_accum, ...]."""
    if grad_accum == 1:
        return batch
    return {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                         *v.shape[1:]) for k, v in batch.items()}


def grad_sync_line(gs, scheme: str) -> str:
    """The log line of the planner's ``grad_sync`` verdict and what runs."""
    g = gs.shard_map_kwargs.get("microbatch", 1)
    return (f"planner gradient sync: {gs.plan} G={g} (serial "
            f"{gs.predicted_serial_s * 1e3:.2f}ms -> "
            f"{gs.predicted_s * 1e3:.2f}ms pipelined; ring baseline "
            f"{gs.baseline_s * 1e3:.2f}ms) — runs: planned_psum "
            f"reduce_scheme={scheme} over the data-parallel ranks, once "
            f"after the backward (the verdict's G is not executed)")


def plan_training(cfg, pctx, batch: int, seq: int, itemsize: int, log):
    """Bind the planner's plan of the training phase's collective program
    (``plan_policy="auto"``); returns (pctx, plan or None)."""
    from repro_torch.parallel.context import build_collective_program
    program = build_collective_program(cfg, pctx, "train",
                                       {"train": (batch, seq)},
                                       itemsize=itemsize)
    if pctx.plan_policy != "auto":
        log.info("planner fixed: moe_scheme=%s moe_combine=%s "
                 "moe_microbatch=%d; gradient sync: ring", pctx.moe_scheme,
                 pctx.moe_combine or pctx.moe_scheme, pctx.moe_microbatch)
        return pctx, None
    if not program.sites:
        log.info("planner auto: no collective sites to declare for this "
                 "config")
        return pctx, None
    eplan = pctx.plan_collectives(program)
    pctx = pctx.bind(eplan)
    for line in eplan.summary().splitlines():
        log.info("planner %s", line)
    joint = eplan.joint.get("train/moe_dispatch")
    if joint is not None and joint.microbatch > 1:
        log.info("planner pipelined MoE round trip: G=%d shared chunks "
                 "(serial %.1fus -> %.1fus predicted)", joint.microbatch,
                 joint.predicted_serial_s * 1e6, joint.predicted_s * 1e6)
    return pctx, eplan


def grad_sync_for(cfg, pctx, params, tokens_per_rank: int) -> tuple:
    """(the ``grad_sync`` verdict, the :class:`GradSync` running it) of
    training ``cfg``'s rank module ``params`` over ``pctx`` on
    ``tokens_per_rank`` tokens a step."""
    decision = pctx.grad_sync_plan(num_params=param_count_shape_only(cfg),
                                   tokens_per_rank=tokens_per_rank)
    return decision, GradSync(pctx, params, decision=decision)


@dataclasses.dataclass
class Training:
    """What :func:`build_training` sets up: the context with its plan
    bound (None on one rank), the plan, the model, its parameters, the
    ``grad_sync`` verdict and the :class:`GradSync` running it (None on one
    rank), the optimizer and the train step."""
    pctx: object
    plan: object
    model: object
    params: torch.nn.Module
    decision: object
    sync: GradSync | None
    opt: object
    train_step: object


def build_training(cfg, pctx, *, batch: int, seq: int, dtype, device,
                   lr: float, steps: int, warmup: int, grad_accum: int = 1,
                   seed: int = 0, weights=None, log=None,
                   max_grad_norm: float = 1.0) -> Training:
    """Set up training of ``cfg`` on ``batch`` x ``seq`` global tokens,
    on one rank (``pctx`` None) or over ``pctx``'s mesh: the training
    program's plan bound under ``plan_policy="auto"``
    (:func:`plan_training`), the model, its parameters (``weights``: the
    reference's as numpy, through ``convert.params_from_jax``; else drawn
    from ``seed``; FSDP-sharded over ``data`` under the context's
    ``fsdp``, ``sharding.shard_fsdp``), the ``grad_sync`` verdict (``ParallelContext.
    grad_sync_plan``) and its :class:`GradSync`, AdamW on the cosine
    schedule (weight decay 0.01) and ``make_train_step`` (clipping at
    ``max_grad_norm``, the reference's)."""
    log = log or logging.getLogger("repro_torch.train")
    plan = None
    if pctx is not None:
        pctx, plan = plan_training(cfg, pctx, batch, seq, dtype.itemsize,
                                   log)
    model = build_model(cfg, device=device, dtype=dtype, pctx=pctx)
    if weights is not None:
        from repro_torch.convert import params_from_jax
        params = params_from_jax(weights, cfg, device=device, dtype=dtype,
                                 pctx=pctx)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = model.init(gen)
    decision = sync = None
    if pctx is not None:
        dp = pctx.dp_size
        params = sharding.shard_fsdp(params, cfg, pctx)
        decision, sync = grad_sync_for(cfg, pctx, params, batch * seq // dp)
        if sync.fsdp:
            log.info("parameters: FSDP over %d data ranks (%d leaves a rank "
                     "holds its slice of)", pctx.data_size, len(sync.fsdp))
        elif dp > 1:
            log.info("parameters: replicated over the %d data-parallel "
                     "ranks", dp)
        if decision is not None:
            log.info(grad_sync_line(decision, sync.scheme))
        elif dp > 1:
            log.info("gradient sync: %s over the data-parallel ranks",
                     sync.scheme)
        else:
            log.info("gradient sync: none (one data-parallel rank)")
    opt = adamw(lr=cosine_schedule(lr, warmup=warmup, total=steps),
                weight_decay=0.01)
    step = make_train_step(model, opt, grad_accum=grad_accum, grad_sync=sync,
                           max_grad_norm=max_grad_norm)
    return Training(pctx, plan, model, params, decision, sync, opt, step)


def variant_context(pctx, variant: str, plan_policy, cfg, batch: int,
                    seq: int):
    """``pctx`` with the knobs of the dry run's ``VARIANTS[variant]``, as
    the reference's launcher applies them: the plan policy ``plan_policy``
    if given, else auto unless the variant pins a scheme or a policy (an
    explicit ablation); ``moe_microbatch="plan"`` is the G of the train
    program's joint decision at ``batch`` x ``seq``."""
    from repro_torch.launch.dryrun import VARIANTS, planned_microbatch
    kw = dict(VARIANTS[variant])
    pins = {"moe_scheme", "plan_policy"} & set(kw)
    planned = kw.pop("moe_microbatch", None) == "plan"
    pctx = dataclasses.replace(pctx, **kw)
    pctx = dataclasses.replace(pctx, plan_policy=plan_policy or (
        pctx.plan_policy if pins else "auto"))
    if planned:
        pctx = dataclasses.replace(pctx, moe_microbatch=planned_microbatch(
            pctx, cfg, "train", batch, seq))
    return pctx


def main(argv=None) -> int:
    from repro_torch.launch.dryrun import VARIANTS
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, fp32, batch 4 x 64 unless "
                         "--batch / --seq say otherwise")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without one); 'cpu' runs "
                         "the plain versions")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (full width)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: the shape's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pods", type=int, default=1,
                    help="pods of the rank mesh (under torchrun)")
    ap.add_argument("--ep", type=int, default=1,
                    help="ep (data-parallel) ranks a pod (under torchrun)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks of the model axis (under "
                         "torchrun)")
    ap.add_argument("--tp-subgroups", type=int, default=1,
                    help="split-TP domains of the model axis: 2 runs each "
                         "block's sequence gather as the MultiWrite "
                         "AllGather")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="required over ranks: nccl (one card a rank) or "
                         "gloo")
    ap.add_argument("--plan-policy", choices=("auto", "fixed"),
                    default=None,
                    help="over ranks, auto (the default): the planner picks "
                         "the MoE round trip, the split-TP gather and the "
                         "gradient sync's scheme; fixed: the hierarchical "
                         "pair at one chunk and the ring (or the "
                         "--variant's knobs)")
    ap.add_argument("--fabric", default=None,
                    help="fabric the planner scores on: a registered name "
                         "or 'SxP[rR][@INTER[:INTRA]]' in GB/s (default: "
                         "the mesh-derived shape)")
    ap.add_argument("--calibrate", choices=("off", "startup", "online"),
                    default="off",
                    help="startup: a probe sweep + fit before the plan is "
                         "bound; online: also re-probe every "
                         "--calibrate-every steps and feed the step walls "
                         "into the pipelined MoE decision")
    ap.add_argument("--calibrate-every", type=int, default=25)
    ap.add_argument("--calibration-store", default=None,
                    help="calibration JSONL path (default "
                         "results/calibration_torch/calibration.jsonl)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the production mesh (2, 16, 16) instead of "
                         "--pods/--ep/--tp (under torchrun, 512 ranks)")
    ap.add_argument("--variant", default=None, choices=list(VARIANTS),
                    help="over ranks, one of the dry run's VARIANTS: its "
                         "knobs on the context (plan policy auto unless "
                         "it pins a scheme or a policy)")
    add_metrics_args(ap)
    args = ap.parse_args(argv)

    from repro_torch.core.planner import _ep_topology, default_planner
    from repro_torch.core.topology import get_fabric
    from repro_torch.launch.mesh import production_shape
    from repro_torch.launch.serve import calibrate, join_ranks
    if args.multi_pod:
        args.pods, args.ep, args.tp = production_shape(multi_pod=True)
    fabric = get_fabric(args.fabric) if args.fabric else None
    servers = _ep_topology(args.pods, args.ep, fabric).meta.num_servers
    pctx, dev = join_ranks(args.pods, args.ep, args.backend, args.device,
                           tp=args.tp, tp_subgroups=args.tp_subgroups,
                           dp_servers=(servers,))
    dev = resolve_device(dev)
    rank0 = pctx is None or pctx.mesh.rank == 0
    logging.basicConfig(level=logging.INFO if rank0 else logging.WARNING)
    log = logging.getLogger("repro_torch.train")
    exporter = start_exporter_from_args(args) if rank0 else None

    cfg = train_config(args.arch, smoke=args.smoke, layers=args.layers)
    if args.smoke:
        batch, seq, dtype = args.batch or 4, args.seq or 64, torch.float32
    else:
        shape = SHAPES[args.shape]
        batch = args.batch or shape.global_batch
        seq = args.seq or shape.seq_len
        dtype = torch.bfloat16
    dp = 1 if pctx is None else pctx.dp_size
    if batch % (dp * args.grad_accum):
        raise ValueError(f"batch {batch} does not split into {dp} "
                         f"data-parallel ranks of {args.grad_accum} "
                         f"micro-batches")
    if pctx is not None:
        pctx = dataclasses.replace(pctx, plan_policy=args.plan_policy or
                                   "auto", fabric=fabric)
        if args.variant is not None:
            pctx = variant_context(pctx, args.variant, args.plan_policy,
                                   cfg, batch, seq)
            log.info("variant %s: %s", args.variant, VARIANTS[args.variant])

    monitor = probe = None
    if args.calibrate != "off":
        from repro_torch.telemetry import GroundTruth, SimProbe
        topo = (pctx.dp_topology if pctx is not None
                else get_fabric(args.fabric or "2x8"))
        probe = SimProbe(GroundTruth())
        store, monitor, event = calibrate(pctx, topo, args.calibration_store)
        log.info("calibration startup: %d store records, drift at fit "
                 "%.1f%%, recalibrated=%s", len(store),
                 100 * (event["drift"] if event else 0.0), bool(event))
        if pctx is not None:
            pctx = dataclasses.replace(pctx, calibration=store)

    run = build_training(cfg, pctx, batch=batch, seq=seq, dtype=dtype,
                         device=dev, lr=args.lr, steps=args.steps,
                         warmup=min(100, args.steps // 10 or 1),
                         grad_accum=args.grad_accum, seed=args.seed, log=log)
    pctx, eplan = run.pctx, run.plan
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=args.seed))
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.ckpt_every,
                         checkpoint_dir=args.ckpt_dir, log_every=10)

    # live step walls into the pipelined MoE decision's measurement rows
    attribution = None
    if monitor is not None and eplan is not None:
        from repro_torch.telemetry import StepAttribution
        joint = next((d for d in eplan.joint.values()
                      if d.microbatch > 1), None)
        if joint is not None:
            attribution = StepAttribution(
                default_planner(), joint,
                n_layers=max(1, cfg.n_layers
                             - getattr(cfg, "first_k_dense", 0)))
    step_hook = None
    if attribution is not None or args.calibrate == "online":
        every = max(1, args.calibrate_every)

        def step_hook(step, row):
            if attribution is not None:
                attribution.observe_step(row["wall"])
            if args.calibrate != "online" or step == 0 or step % every:
                return
            event = monitor.run_cycle(probe)
            if event:
                log.info("step %d: drift %.1f%% exceeded %.0f%%: "
                         "recalibrated (%d links refit)", step,
                         100 * event["drift"], 100 * monitor.threshold,
                         event["measured_links"])
                if pctx is not None and pctx.bound_plan_stale():
                    log.warning("step %d: the bound plan %s is stale under "
                                "the refit calibration; training keeps "
                                "executing it", step, eplan.fingerprint)

    trainer = Trainer(
        run.model, run.opt,
        lambda s: micro_batches(batch_for_model(cfg, data.batch(s),
                                                device=dev, pctx=pctx),
                                args.grad_accum),
        tcfg, params=run.params, step_hook=step_hook,
        train_step=run.train_step)
    hist = trainer.run()
    if rank0 and hist:
        print(f"final loss {hist[-1]['loss']:.4f} over {len(hist)} steps; "
              f"straggler events: {len(trainer.ledger.events)}")
    if rank0 and monitor is not None:
        rep = monitor.report()
        print(f"calibration: {rep['recalibrations']} recalibration(s), "
              f"drift {rep['drift_pct']:.1f}%, {rep['store_records']} store "
              f"records")
    if rank0 and attribution is not None:
        print(f"overlap feedback: {attribution.fed} step timing(s) fed into "
              f"the joint pipeline decision's measurement rows")
    if rank0:
        finish_exporter_from_args(args, exporter)
    if pctx is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
