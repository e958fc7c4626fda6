"""Serving launcher: batched greedy generation with the port's ServeEngine.

On the card, with random weights: DBRX-132B at full width with its depth
cut to 4 layers, and Mistral-NeMo-12B, Zamba2-7B, RWKV6-7B, Gemma2-9B,
StarCoder2-15B, Minitron-8B, Qwen2-VL-2B's backbone and SeamlessM4T-medium
whole:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b \
      --layers 4 --prompts 4 --prompt-len 512 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b \
      --prompts 2 --prompt-len 8160

Qwen2-VL's prompts are token ids that the reference's stub frontend
(``data.pipeline._stub_embed``) turns into its embeddings input, in the
prefill and for every sampled token.  SeamlessM4T's encoder takes the stub
frontend's embeddings of the prompt, and its decoder the prompt's tokens,
then each sampled token (``--arch seamless_m4t_medium``; ``--layers``
cuts the encoder and the decoder alike).

On the CPU, the reduced config through the kernels' plain versions:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b \
      --device cpu --smoke --prompt-len 16 --max-new 4

Over ranks, under ``torchrun``: ``--pods P --ep D --tp M`` lays the
P * D * M ranks out as P pods of D ep ranks of M tensor-parallel ranks
(DBRX's 16 experts: 4 a rank over 2 x 2; Kimi's 384: 24 a rank over 2 x 8;
Mistral-NeMo's 32 heads and 8 kv heads: 8 and 2 a rank over ``--tp 4``),
each data-parallel group serving its share of the prompts.
``--tp-subgroups 2`` divides the model axis into two split-TP domains, so
each block's sequence gather runs the MultiWrite AllGather.
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
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch mistral_nemo_12b --tp 4 --tp-subgroups 2 --backend nccl

Over ranks the MoE round trip (dispatch scheme, return scheme, pipeline
depth G) comes from the planner under ``--plan-policy auto`` (the default,
as in the reference): both serving phases are declared as one collective
program, planned on ``--fabric`` (a registered name such as ``2x8``, or an
inline ``SxP[rR][@INTER[:INTRA]]`` in GB/s) and bound before the model is
built; rank 0 prints the plan.  Without ``--fabric`` the nccl ranks time
their link and plan on it; gloo ranks plan on the reference's mesh-derived
TPU fabric and say so.  With a model axis the program also declares the
split-TP gather site of the prefill (two domains), planned on its split-TP
topology.  ``--plan-policy fixed`` runs the hierarchical pair at one chunk
and paired relaying at the analytic split.

``--calibrate startup`` runs the telemetry loop before the plan is bound
(a probe sweep of the collectives on the planning fabric, a fit, and the
process planner recalibrated on the fitted model), as the reference's
launcher does, with the reference's simulated probe (there is no flag for
a live one: a deployment passes a ``telemetry.LiveProbe`` to
``telemetry.startup_calibration``).  Records go to ``--calibration-store``
(default ``results/calibration_torch/calibration.jsonl``); the plan report
then carries the drift at fit.  ``--metrics-port`` serves the metrics
registry over HTTP and ``--metrics-snapshot`` writes it at exit (rank 0).

``--continuous`` drains a seeded open-loop Poisson stream (``--requests``
at ``--arrival-rate`` a second of the scheduler's virtual clock) through
the continuous-batching scheduler under planner admission, ``--prompts``
requests in flight at most, instead of one batched ``generate``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b \
      --device cpu --smoke --continuous --requests 8 --prompt-len 16 \
      --max-new 4

Decode runs as a CUDA graph per cohort shape on the card (eager on the CPU
and over gloo); the last lines say which, and count captures and replays.
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

from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config
from repro_torch.core.h100 import fabric_spec
from repro_torch.core.planner import _ep_topology, default_planner
from repro_torch.core.topology import get_fabric
from repro_torch.device import resolve_device
from repro_torch.launch.ranks import link_probe_bytes, measure_link
from repro_torch.models.api import build_model
from repro_torch.parallel.context import (ParallelContext,
                                          build_collective_program)
from repro_torch.parallel.mesh import RankMesh
from repro_torch.runtime.server import ServeConfig, ServeEngine
from repro_torch.telemetry import (CalibrationStore, DriftMonitor,
                                   GroundTruth, SimProbe,
                                   startup_calibration)
from repro_torch.telemetry.exporter import (add_metrics_args,
                                            finish_exporter_from_args,
                                            start_exporter_from_args)

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def serve_config(arch: str, *, layers: int | None, smoke: bool
                 ) -> ModelConfig:
    """The arch's published config with only its depth cut (``layers``),
    or its reduced smoke variant."""
    cfg = get_config(arch)
    if smoke:
        return cfg.reduced()
    if layers is not None:
        cfg = cfg.with_depth(layers)
    return cfg


def build_engine(cfg: ModelConfig, *, device=None, dtype=torch.bfloat16,
                 seed: int = 0, max_new: int = 32, temperature: float = 0.0,
                 cache_dtype=torch.bfloat16, pctx=None, calibration=None,
                 monitor=None) -> ServeEngine:
    """Model with random weights from a seeded generator of ``device``
    (this rank's experts only, with a ``pctx``), wrapped in a
    ServeEngine (with the telemetry store and monitor, if any)."""
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
                       device=dev, pctx=pctx, calibration=calibration,
                       monitor=monitor)


def join_ranks(pods: int, ep: int, backend: str | None, device, *,
               tp: int = 1, tp_subgroups: int = 1, dp_servers=()):
    """Join the ``torchrun`` process group (its environment gives rank and
    world size) as ``pods`` x ``ep`` x ``tp`` ranks (``dp_servers``: the
    server counts whose data-parallel groups the mesh makes).  Returns
    (pctx, device); (None, device) for one rank."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if pods * ep * tp != world:
        raise ValueError(f"--pods {pods} x --ep {ep} x --tp {tp} != world "
                         f"size {world}")
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
    mesh = RankMesh((pods, ep, tp), timeout=COLLECTIVE_TIMEOUT,
                    dp_servers=dp_servers)
    return ParallelContext(mesh, pod_axis="pod" if pods > 1 else None,
                           tp_subgroups=tp_subgroups), device


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


def calibrate(pctx, topo, path):
    """``--calibrate startup`` on ``topo``: ``startup_calibration`` with its
    simulated probe, returning (store, monitor, event).  Over ranks every
    rank reads the store's file before rank 0 appends this run's records
    to it (the others keep theirs in memory), so every rank fits the same
    records and binds the same plan."""
    if pctx is None:
        return startup_calibration(topo, path)
    store = CalibrationStore(":memory:")
    store.extend(CalibrationStore(path).records())
    dist.barrier()
    old = len(store)
    monitor = DriftMonitor(default_planner(), store, topo)
    event = (monitor.run_cycle(SimProbe(GroundTruth()))
             or monitor.recalibrate(force=True))
    if pctx.mesh.rank == 0:
        CalibrationStore(path).extend(store.records()[old:])
    return store, monitor, event


def serve_continuous(args, cfg: ModelConfig, engine: ServeEngine,
                     pctx) -> dict:
    """Drain a seeded Poisson arrival stream through the continuous-
    batching scheduler against the live engine, under planner admission;
    returns the scheduler's report.  Without a ``pctx`` the admission
    probe scores on ``--fabric`` (default ``2x8``)."""
    from repro_torch.serving import (AdmissionController, BatchScheduler,
                                     PlannerProbe, RequestQueue,
                                     TrafficConfig, TrafficGenerator)

    itemsize = 4 if args.smoke else 2
    probe = engine.plan_probe(itemsize)
    if probe is None:
        probe = PlannerProbe(
            get_fabric(args.fabric or "2x8"),
            token_bytes=cfg.d_model * itemsize,
            num_experts=getattr(cfg, "num_experts", 0) or 64,
            top_k=getattr(cfg, "top_k", 0) or 8)
    xover = probe.crossover_batch()
    anchor = int(xover) if xover != float("inf") else max(1, args.prompts)
    tpot_slo_s = (args.tpot_slo_us * 1e-6 if args.tpot_slo_us
                  else probe.decode_step_s(anchor) * 1.15)
    ttft_slo_s = (args.ttft_slo_us * 1e-6 if args.ttft_slo_us else 0.08)
    queue = RequestQueue()
    traffic = TrafficConfig(
        arrival_rate_rps=args.arrival_rate, num_requests=args.requests,
        prompt_lens=(args.prompt_len,), max_news=(args.max_new,),
        vocab=cfg.vocab, seed=args.seed)
    for req in TrafficGenerator(traffic).requests():
        queue.push(req)
    admission = AdmissionController(
        probe, capacity=args.prompts, policy="planner",
        tpot_slo_s=tpot_slo_s, ttft_slo_s=ttft_slo_s)
    sched = BatchScheduler(
        queue=queue, admission=admission, engine=engine, probe=probe,
        binder=engine.plan_binder if pctx is not None else None,
        plan_for_bucket=lambda b: engine.bucket_plan(b, args.prompt_len),
        eos_id=None, seed=args.seed)
    sched.run_until_drained()
    if pctx is None or pctx.mesh.rank == 0:
        print(f"continuous serving: capacity {args.prompts}, crossover "
              f"batch {anchor if xover != float('inf') else 'none'}, TPOT "
              f"SLO {tpot_slo_s * 1e6:.0f}us, TTFT SLO "
              f"{ttft_slo_s * 1e3:.0f}ms")
    rep = sched.report(ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s)
    rep["wall"] = dict(sched.wall)
    return rep


def print_plans(plans: dict) -> None:
    """The reference launcher's lines for ``engine.stats["plans"]``."""
    for phase, per_op in plans.items():
        if phase == "execution_plan":
            print(f"execution plan fingerprint: {per_op}")
        elif phase == "stale":
            print(f"bound plan stale: {per_op}")
        elif phase == "planner":
            print(f"planner: {'/'.join(per_op['search'])} search, "
                  f"{per_op['combos_scored']}/{per_op['product']} "
                  f"combination(s) scored across {per_op['phases']} "
                  f"phase(s) in {per_op['planning_wall_s'] * 1e3:.1f}ms")
        elif phase == "calibration":
            last = per_op.get("last_recalibration")
            print(f"calibration: drift {per_op['drift_pct']:.1f}% over "
                  f"{per_op['observations']} probe(s), "
                  f"{per_op['recalibrations']} recalibration(s)"
                  + (f", last refit {last['measured_links']} links"
                     if last else ""))
        elif phase == "phases":
            for ph, rep in per_op.items():
                line = (f"phase[{ph}]: {rep['score_s'] * 1e6:.1f}us "
                        f"(contention +{rep['contention_s'] * 1e6:.1f}us)")
                if rep.get("budget_s"):
                    line += (f", budget {rep['budget_s'] * 1e6:.0f}us "
                             f"{'ok' if rep.get('budget_ok') else 'VIOLATED'}")
                print(line)
        else:
            for op, rep in per_op.items():
                if rep:
                    print(f"planner[{phase}/{op}]: {rep['plan']} "
                          f"predicted={rep['predicted_us']:.1f}us "
                          f"vs baseline={rep['baseline_us']:.1f}us "
                          f"({rep['speedup_pct']:+.1f}%)")


def graph_line(stats: dict) -> str:
    """One line for ``engine.stats["decode_graph"]``."""
    g = stats["decode_graph"]
    return (f"decode: {g['mode']} ({g['reason']}); {g['captures']} "
            f"capture(s) in {g['capture_s'] * 1e3:.1f} ms, {g['replays']} "
            f"replay(s), {g['eager_rounds']} eager round(s)")


def make_prompts(cfg: ModelConfig, prompts: int, prompt_len: int,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab,
                        size=(prompts, prompt_len)).astype(np.int32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="one of configs.base.ARCH_IDS: " + ", ".join(
                        ARCH_IDS))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay "
                         "the published ones; an encoder-decoder's encoder "
                         "too)")
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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks of the model axis (under "
                         "torchrun)")
    ap.add_argument("--tp-subgroups", type=int, default=1,
                    help="split-TP domains of the model axis: 2 runs each "
                         "block's sequence gather as the MultiWrite "
                         "AllGather")
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
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching serving tier: seeded open-"
                         "loop Poisson arrivals drain through the "
                         "iteration-level scheduler under planner "
                         "admission (at most --prompts in flight), instead "
                         "of one batched generate")
    ap.add_argument("--requests", type=int, default=16,
                    help="continuous mode: requests in the arrival stream")
    ap.add_argument("--arrival-rate", type=float, default=100.0,
                    help="continuous mode: Poisson arrival rate (requests "
                         "a second of the scheduler's virtual clock)")
    ap.add_argument("--ttft-slo-us", type=float, default=None,
                    help="continuous mode: time-to-first-token SLO (us) for "
                         "admission pressure and the SLO-good count "
                         "(default 80000)")
    ap.add_argument("--tpot-slo-us", type=float, default=None,
                    help="continuous mode: time-per-output-token SLO (us); "
                         "admission holds the decode batch at the largest "
                         "size whose predicted step meets it (default: "
                         "1.15 x the predicted step at the scheme-"
                         "crossover batch)")
    ap.add_argument("--calibrate", choices=("off", "startup"),
                    default="off",
                    help="telemetry: probe sweep + fit before the plan is "
                         "bound, so the planner scores on the fitted link "
                         "rates; the plan report then carries the drift")
    ap.add_argument("--calibration-store", default=None,
                    help="calibration JSONL path (default "
                         "results/calibration_torch/calibration.jsonl)")
    add_metrics_args(ap)
    args = ap.parse_args(argv)

    cfg = serve_config(args.arch, layers=args.layers, smoke=args.smoke)
    pctx, device = join_ranks(args.pods, args.ep, args.backend, args.device,
                              tp=args.tp, tp_subgroups=args.tp_subgroups)
    rank0 = pctx is None or pctx.mesh.rank == 0
    exporter = start_exporter_from_args(args) if rank0 else None
    plan = fabric = None
    if pctx is not None:
        # serving never shards weights over the data axis (the reference's
        # serving cells turn FSDP off): only training runs ``shard_fsdp``
        pctx = dataclasses.replace(pctx, plan_policy=args.plan_policy)
        if args.plan_policy == "auto" and cfg.is_moe:
            fabric = planning_fabric(pctx, cfg, args, device)
            pctx = dataclasses.replace(
                pctx, fabric=get_fabric(fabric) if fabric else None)
    # the fabric is resolved before telemetry: the probe's records and the
    # planner's lookups share one topology key
    store = monitor = None
    if args.calibrate != "off":
        topo = (_ep_topology(pctx.num_pods, pctx.data_size, pctx.fabric)
                if pctx is not None else get_fabric(args.fabric or "2x8"))
        store, monitor, event = calibrate(pctx, topo, args.calibration_store)
        if rank0:
            print(f"calibration: {len(store)} records, "
                  f"recalibrated={bool(event)}"
                  + (f", drift at fit {100 * event['drift']:.1f}%"
                     if event else ""))
    if (pctx is not None and args.plan_policy == "auto"
            and (cfg.is_moe or args.tp > 1)):
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
        pctx=pctx, calibration=store, monitor=monitor)
    if args.continuous:
        rep = serve_continuous(args, cfg, engine, pctx)
        engine.close()
        if pctx is not None:
            dist.destroy_process_group()
        if rank0:
            print(f"served {rep['completed']}/{args.requests} request(s) in "
                  f"{rep['iterations']} iteration(s), horizon "
                  f"{rep['horizon_s'] * 1e3:.3f}ms, max in-flight "
                  f"{rep['max_in_flight']}")
            print(f"TTFT p50/p99 {rep['ttft_p50_s'] * 1e3:.3f}/"
                  f"{rep['ttft_p99_s'] * 1e3:.3f}ms, TPOT p50/p99 "
                  f"{rep['tpot_p50_s'] * 1e6:.1f}/"
                  f"{rep['tpot_p99_s'] * 1e6:.1f}us (virtual clock: the "
                  f"planner's predicted collective times), queue-wait p99 "
                  f"{rep['queue_wait_p99_s'] * 1e3:.3f}ms")
            print(f"admission: holds={rep['admission_holds']} "
                  f"rejects={sum(rep['admission_rejects'].values())}; plan "
                  f"prefetches={rep['prefetch_rebinds']} "
                  f"swaps={rep.get('plan_swaps', 0)} cold retraces="
                  f"{rep.get('cold_retraces', 0)}; SLO-good "
                  f"{rep['slo_good']}/{rep['completed']} (goodput "
                  f"{rep['goodput_rps']:.1f}/s)")
            print(f"measured walls: prefill {rep['wall']['prefill_s']:.3f} "
                  f"s, decode {rep['wall']['decode_s']:.3f} s")
            print(graph_line(engine.stats))
            finish_exporter_from_args(args, exporter)
        return {"report": rep, "decode_graph": engine.stats["decode_graph"]}
    prompts = make_prompts(cfg, args.prompts, args.prompt_len, args.seed)
    out = engine.generate(prompts)
    engine.close()
    if pctx is not None:
        dist.destroy_process_group()
    st = engine.stats
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "device": str(engine.device),
        "ranks": f"{args.pods} pods x {args.ep} ep x {args.tp} tp",
        "plan": plan.fingerprint if plan is not None else None,
        "fabric": fabric,
        "shape": list(out.shape), "prefill_s": st["prefill_s"],
        "decode_s": st["decode_s"], "tokens": st["tokens"],
        "nonfinite_logits": st["nonfinite_logits"],
        "decode_graph": st["decode_graph"],
        "first_tokens": out[:, :8].tolist(),
    }
    if rank0:
        print_plans(st.get("plans", {}))
        print(graph_line(st))
        print(json.dumps(result))
        finish_exporter_from_args(args, exporter)
    return result


if __name__ == "__main__":
    main()
