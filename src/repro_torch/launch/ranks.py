"""Rank workers: one process per rank of a ``torch.distributed`` run on one
host, spawned and joined with a deadline.

``chip_smoke.py`` spawns :func:`serve_worker` as 4 ranks (2 pods x 2 ep
ranks) serving DBRX-132B, as 16 gloo ranks (2 pods x 8) serving
Kimi-K2-1T, and as 4 tensor-parallel ranks (1 x 1 x 4) serving
Mistral-NeMo-12B and (1 x 2 x 2) serving DBRX on the card(s); the CPU
tests spawn it, :func:`dispatch_worker`, :func:`gather_worker` and
:func:`probe_worker` (the telemetry's ``LiveProbe``) as 4, 8 or 16 gloo
ranks at small sizes.  A spec's mesh is ``(pods, ep, tp)``
(``tp`` default 1).  The ranks
of one card can share one copy of the non-expert weights
(:func:`shared_weights`, ``run_ranks(shared=...)``).

A run names the MoE round trip it executes (:func:`run_context`): a fixed
``(scheme, combine, microbatch)`` triple, a bound ``ExecutionPlan``
(``"plan"``), or ``policy="auto"`` on a fabric, planned ad hoc at each
layer or bound once from ``build_collective_program`` (``"bind"``).
``fabric="measured"`` takes the fabric that :func:`measure_link` timed on
these ranks.  This module
imports neither JAX nor the reference package, because a spawned child
re-imports the module that defines its target.

Each worker joins the process group through ``spec["init_method"]`` (a
``file://`` store in the tests, so parallel test workers never share a
port), with ``spec["timeout_s"]`` on every collective, and writes its
results to ``<spec["out_dir"]>/rank<r>.pt``, which :func:`run_ranks` reads
back once every rank has exited.
"""

from __future__ import annotations

import datetime
import gc
import os
import time
from concurrent.futures import ThreadPoolExecutor
from multiprocessing.connection import wait
from multiprocessing.reduction import ForkingPickler
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import collectives as cl
from repro_torch.core.h100 import fabric_spec, moe_compute_s
from repro_torch.core.topology import get_fabric
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model
from repro_torch.parallel.context import (ParallelContext,
                                          build_collective_program)
from repro_torch.parallel.mesh import RankMesh
from repro_torch.runtime.server import ServeConfig, ServeEngine
from repro_torch.serving import (AdmissionController, BatchScheduler,
                                 RequestQueue, TrafficConfig,
                                 TrafficGenerator)

# (moe_scheme, moe_combine) pairs the workers run, in this order
SCHEME_PAIRS = (("hierarchical", "hierarchical"),
                ("hierarchical", "baseline"),
                ("baseline", "baseline"))


def fixed_runs(pairs=SCHEME_PAIRS, microbatch: int = 1) -> list[dict]:
    """Run specs of fixed scheme pairs at one chunk count."""
    return [dict(scheme=s, combine=c, microbatch=microbatch)
            for s, c in pairs]


def run_label(run: dict) -> str:
    """``scheme+combine`` (``@G<g>`` above one chunk) of a fixed run, else
    the run's own ``label``."""
    if "label" in run:
        return run["label"]
    g = run.get("microbatch", 1)
    return (f"{run['scheme']}+{run['combine']}"
            + (f"@G{g}" if g > 1 else ""))


def run_ranks(fn, spec: dict, *, timeout_s: float, shared=None) -> list:
    """Spawn ``spec["world"]`` processes running ``fn(rank, spec)``, wait
    for all of them at most ``timeout_s`` seconds, and return each rank's
    results.  A rank that raises or dies fails the run (the others are
    killed); so does one still running at the deadline.

    ``shared`` maps a device (:func:`rank_device`) to what the ranks on it
    take as ``spec["shared"]``, such as :func:`shared_weights`: each rank
    is given its own device's alone, its tensors pickled by
    ``torch.multiprocessing`` as CUDA IPC handles (shared memory on the
    CPU).  A handle that does not open fails the rank.  The caller keeps
    ``shared`` referenced until this returns, when every rank has
    exited.  Every rank frees what it received before it exits, so the
    caller's own last reference then frees the memory."""
    world = spec["world"]
    out_dir = Path(spec["out_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")

    def pickled(rank: int) -> bytes:
        mine = spec if shared is None else dict(
            spec, shared=shared[rank_device(rank, spec)])
        return bytes(ForkingPickler.dumps(mine))

    # each rank's spec pickled here, one after another (a storage is moved
    # to shared memory the first time it is pickled); the processes start
    # together, since a start blocks until its child has imported its
    # modules when the pickle outgrows the pipe
    procs = [ctx.Process(target=_rank_main, name=f"rank {rank}",
                         args=(fn, rank, pickled(rank)))
             for rank in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        with ThreadPoolExecutor(world) as pool:
            list(pool.map(lambda proc: proc.start(), procs))
        running = list(procs)
        while running:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{len(running)} of {world} ranks still "
                                   f"running after {timeout_s} s")
            wait([proc.sentinel for proc in running], timeout=left)
            for proc in [p for p in running if p.exitcode is not None]:
                running.remove(proc)
                if proc.exitcode != 0:
                    raise RuntimeError(f"{proc.name} of {world} exited with "
                                       f"code {proc.exitcode}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            if proc.pid is not None:
                proc.join(timeout=30)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(fn, rank: int, spec: bytes) -> None:
    # set before the rank's first CUDA call: its allocator then grows its
    # segments in place, so a peak strands no reserved blocks (16 ranks
    # share one card's memory in chip_smoke's phase 7)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    fn(rank, ForkingPickler.loads(spec))
    # an engine and its PlanBinder hold each other: free them while the
    # process lives, so that the tensors it received as CUDA IPC handles
    # release the sender's memory (at exit the cycle would never be freed,
    # and the sender would keep the memory for good)
    gc.collect()


def rank_device(rank: int, spec: dict) -> torch.device:
    """nccl: the card of the rank's index (one card a rank).  gloo: the
    device the spec names; a CUDA device without an index lays the ranks
    over the cards present in blocks, rank r on card ``r * cards //
    world``."""
    if spec["backend"] == "nccl":
        return torch.device("cuda", rank)
    dev = torch.device(spec["device"])
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank * torch.cuda.device_count()
                            // spec["world"])
    return dev


def shared_weights(spec: dict) -> dict:
    """One copy of ``spec["cfg"]``'s non-expert weights for each device the
    ranks of ``spec`` run on, drawn from ``spec["seed"]`` as each rank's own
    draw would be (``transformer.shared_weights``): device -> tensors by
    name, for ``run_ranks(shared=...)``."""
    out = {}
    for rank in range(spec["world"]):
        dev = rank_device(rank, spec)
        if dev in out:
            continue
        gen = torch.Generator(device=dev)
        gen.manual_seed(spec["seed"])
        out[dev] = T.shared_weights(spec["cfg"], generator=gen, device=dev,
                                    dtype=spec["dtype"])
        if dev.type == "cuda":          # the draws' fp32 temporaries
            torch.cuda.empty_cache()
    return out


def init_rank(rank: int, spec: dict) -> RankMesh:
    """Join the process group and build the (pods, ep, tp) rank mesh."""
    torch.set_num_threads(spec.get("threads", 1))
    dev = rank_device(rank, spec)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=spec["timeout_s"])
    dist.init_process_group(spec["backend"], init_method=spec["init_method"],
                            rank=rank, world_size=spec["world"],
                            timeout=timeout,
                            device_id=dev if spec["backend"] == "nccl"
                            else None)
    return RankMesh((spec["pods"], spec["ep"], spec.get("tp", 1)),
                    timeout=timeout)


def _save(rank: int, spec: dict, result) -> None:
    path = Path(spec["out_dir"]) / f"rank{rank}.pt"
    torch.save(result, path.with_suffix(".tmp"))
    os.replace(path.with_suffix(".tmp"), path)


def pod_send_bytes(state, row_bytes: int) -> tuple[int, int]:
    """(whole, occupied) bytes of token rows that one dispatch puts on the
    pod group for the other pods, counted from this rank's own send
    buffers: MultiWrite's stage-1 buffers of the remote pods (one copy per
    (token, remote pod)), or the baseline's buffers of the remote pods'
    ranks (one copy per (token, remote rank)).  ``whole`` counts every
    capacity slot, ``occupied`` the slots that hold a row."""
    mesh = state.mesh
    p, d = mesh.num_pods, mesh.ep_per_pod
    maps = (state.map_pod if isinstance(state, cl.DispatchState)
            else state.map_rank.reshape(p, d * state.map_rank.shape[1]))
    my_pod = mesh.axis_index(mesh.pod_axis)
    rows = maps[[q for q in range(p) if q != my_pod]]
    return rows.numel() * row_bytes, int((rows >= 0).sum()) * row_bytes


class RecordingEngine(ServeEngine):
    """A ServeEngine that keeps the logits of this rank's rows at every
    sampling step (host copies, fp32)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.step_logits: list = []

    def _sample(self, state):
        self.step_logits.append(state.logits.float().cpu())
        return super()._sample(state)


def _dispatches(record: dict):
    """Patches that keep the expert ids, state and row bytes of the first
    MoE dispatch made while they are in place, and append to
    ``record["pairs"]`` each dispatch's (token, expert) pairs given and
    kept at this rank's experts (a device count, read after the run)."""
    record["pairs"] = []

    def wrap(fn):
        def call(tokens, ids, gates, dcfg, mesh, **kw):
            out = fn(tokens, ids, gates, dcfg, mesh, **kw)
            if "state" not in record:
                record.update(ids=ids, state=out[2], row_bytes=tokens.shape[1]
                              * tokens.element_size())
            record["pairs"].append((ids.numel(), (out[2].map_exp >= 0).sum()))
            return out
        return call
    return [mock.patch.object(cl, name, wrap(getattr(cl, name)))
            for name in ("hierarchical_dispatch", "baseline_dispatch")]


def _checked_packs(record: list):
    """A patch of the collectives' pack that holds each call's packed
    buffer and slot map, bit for bit, against ``ref.pack_ref`` on the same
    inputs (rows as the transport left them, holes included) and appends
    ``(rows, valid rows, dests, capacity, bit-exact)`` to ``record``.  It
    launches nothing of its own: it checks the outputs the path goes on
    with."""
    fn = cl.pack_by_bitmap

    def call(tokens, bitmap, valid, num_dests, capacity):
        out, idx = fn(tokens, bitmap, valid, num_dests, capacity)
        exp_out, exp_idx = ref.pack_ref(tokens, bitmap, valid, num_dests,
                                        capacity)
        ints = torch.int16 if out.element_size() == 2 else torch.int32
        exact = (torch.equal(idx, exp_idx)
                 and torch.equal(out.view(ints), exp_out.view(ints)))
        record.append((tokens.shape[0], int(valid.sum()), num_dests,
                       capacity, exact))
        return out, idx
    return mock.patch.object(cl, "pack_by_bitmap", call)


def run_context(mesh: RankMesh, pods: int, run: dict, *, fabric=None,
                cfg=None, phases=None, itemsize: int = 2, calibration=None
                ) -> ParallelContext:
    """The context a run executes under.  ``run``: ``scheme``/``combine``/
    ``microbatch`` (the fixed knobs), ``calibrated`` (plan on the
    ``calibration`` store's fitted model), ``tp_subgroups``,
    ``seq_shard_decode`` and ``deferred`` (``moe_deferred_tp_reduce``) of
    the model axis, ``policy`` ("fixed" or "auto"),
    ``fabric`` (a spec ``get_fabric`` takes, "measured" for ``fabric``, or
    None for the mesh-derived topology), ``plan`` (an ExecutionPlan to
    bind), ``program`` (a CollectiveProgram to plan on the context's
    fabric and bind) or ``bind`` (plan ``phases`` of ``cfg`` with
    ``build_collective_program`` at ``itemsize`` and bind the result)."""
    spec = run.get("fabric")
    if spec == "measured":
        spec = fabric
    pctx = ParallelContext(
        mesh, pod_axis="pod" if pods > 1 else None,
        plan_policy=run.get("policy", "fixed"),
        moe_scheme=run.get("scheme", "hierarchical"),
        moe_combine=run.get("combine"),
        moe_microbatch=run.get("microbatch", 1),
        tp_subgroups=run.get("tp_subgroups", 1),
        seq_shard_decode=run.get("seq_shard_decode", True),
        moe_deferred_tp_reduce=run.get("deferred", False),
        fabric=get_fabric(spec) if spec else None,
        calibration=calibration if run.get("calibrated") else None)
    if run.get("plan") is not None:
        pctx = pctx.bind(run["plan"])
    elif run.get("program") is not None:
        pctx = pctx.bind(pctx.plan_collectives(run["program"]))
    elif run.get("bind"):
        program = build_collective_program(cfg, pctx, "serve", phases,
                                           itemsize=itemsize)
        pctx = pctx.bind(pctx.plan_collectives(program))
    return pctx


def resolved(pctx, cfg, phases: dict, itemsize: int) -> dict:
    """phase -> the ``(scheme, combine, G)`` an MoE layer of ``cfg`` runs
    under ``pctx`` on one rank's rows of the phase's (batch, seq); none for
    a dense ``cfg``."""
    out = {}
    if not cfg.is_moe:
        return out
    for phase, (batch, seq) in phases.items():
        n = max(1, batch * seq // pctx.dp_size)
        kw = M.pipeline_config(pctx, cfg, n, cfg.d_model, cfg.expert_d_ff,
                               itemsize)
        out[phase] = (kw["moe_scheme"], kw["moe_combine"], kw["microbatch"])
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_link(mesh: RankMesh, nbytes: int, device, *, reps: int = 10,
                 rounds: int = 3) -> float:
    """The per-pair rate of an ``all_to_all_single`` over every rank of the
    mesh: ``nbytes`` a rank (one block of ``nbytes / world`` to each rank)
    in bytes a second of one block.  Each round issues ``reps`` exchanges
    back to back between two synchronisations, so the ranks' skew at the
    start falls on the first alone; the median round, the slowest rank's.
    Every rank returns the same number."""
    world = dist.get_world_size()
    n = nbytes // 2 // world * world
    send = torch.ones(n, dtype=torch.bfloat16, device=device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)                    # warm-up
    walls = []
    for _ in range(rounds):
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_to_all_single(recv, send)
        _sync(device)
        walls.append((time.perf_counter() - t0) / reps)
    wall = torch.tensor([float(np.median(walls))], dtype=torch.float64,
                        device=device)
    dist.all_reduce(wall, op=dist.ReduceOp.MAX)
    return (n * 2 / world) / float(wall)


def link_probe_bytes(cfg, rows: int, pods: int, ep: int,
                     itemsize: int = 2) -> int:
    """Bytes a rank sends in the stage-1 (pod) exchange of one dispatch of
    ``rows`` rows a rank at ``cfg``'s capacity factor: P x Cp rows of
    ``d_model`` elements, the size :func:`measure_link` times."""
    dcfg = M.balanced_capacities(rows, cfg.top_k, pods, ep,
                                 max(1, cfg.num_experts // (pods * ep)),
                                 cfg.moe_capacity)
    return pods * max(1, round(rows * dcfg.pod_capacity)) * cfg.d_model \
        * itemsize


def plan_decisions(mesh: RankMesh, pods: int, cfg, phases: dict,
                   spec: str | None, itemsize: int = 2,
                   calibration=None) -> dict:
    """What the planner decides for ``cfg``'s serve program on fabric
    ``spec`` (None: the mesh-derived topology), on the datasheet or with a
    ``calibration`` store on its fitted model: per phase the coupled
    (scheme, combine, G) and the modelled serial and pipelined seconds of
    the round trip, and the host time of one ``moe_pipeline_kwargs`` call
    under the bound plan and under ad-hoc ``auto`` (first call on a fresh
    context, then a repeated call)."""
    want = {"policy": "auto", "fabric": spec,
            "calibrated": calibration is not None}
    auto = run_context(mesh, pods, want, calibration=calibration)
    program = build_collective_program(cfg, auto, "serve", phases,
                                       itemsize=itemsize)
    eplan = auto.plan_collectives(program)
    out = {"fabric": spec or "mesh-derived", "fingerprint":
           eplan.fingerprint, "calibrated": calibration is not None,
           "phases": {}, "host_us": {}}
    for phase in phases:
        anchor = f"{phase}/moe_dispatch"
        d = eplan.joint[anchor]
        kw = eplan.site_kwargs(anchor)
        out["phases"][phase] = dict(
            scheme=kw["moe_scheme"], combine=kw.get("moe_combine"),
            microbatch=kw.get("microbatch", 1), plan=d.plan,
            serial_s=d.predicted_serial_s, pipelined_s=d.predicted_s)
    batch, seq = phases["prefill"]
    n = batch * seq // auto.dp_size
    ask = dict(tokens_per_rank=n, token_bytes=cfg.d_model * itemsize,
               compute_s=moe_compute_s(n, cfg.top_k, cfg.d_model,
                                       cfg.expert_d_ff))
    for name, pctx in (("bound", auto.bind(eplan)),
                       ("auto", run_context(mesh, pods, want,
                                            calibration=calibration))):
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            pctx.moe_pipeline_kwargs(cfg.num_experts, cfg.top_k, **ask)
            walls.append((time.perf_counter() - t0) * 1e6)
        out["host_us"][name] = walls
    return out


# kernel names in a device trace: the exchanges, and the GEMMs (cuBLAS's
# gemm/nvjet/xmma kernels and CUTLASS's)
EXCHANGE_KERNELS = ("nccl",)
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def _layer_input(moe, cfg, rows: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    return torch.randn((1, rows, cfg.d_model), generator=gen, device=device
                       ).to(moe.w1.dtype)


def layer_walls(moe, cfg, pctx, rows: int, device, reps: int = 5) -> dict:
    """One MoE layer's ``moe_ffn`` on ``rows`` random tokens a rank, after
    two warm-up calls: the host time until the call returns (``issue_ms``)
    and until the device is done (``wall_ms``), medians of ``reps``.  All
    ranks run it together."""
    x = _layer_input(moe, cfg, rows, device)
    issue, wall = [], []
    with torch.inference_mode():
        for i in range(reps + 2):
            _sync(device)
            dist.barrier()
            _sync(device)
            t0 = time.perf_counter()
            M.moe_ffn(moe, x, cfg, pctx, with_aux=False)
            t1 = time.perf_counter()
            _sync(device)
            if i >= 2:
                issue.append((t1 - t0) * 1e3)
                wall.append((time.perf_counter() - t0) * 1e3)
    return {"issue_ms": float(np.median(issue)),
            "wall_ms": float(np.median(wall))}


def trace_moe_layer(moe, cfg, pctx, rows: int, device, path: str) -> dict:
    """One MoE layer's ``moe_ffn`` on ``rows`` random tokens a rank, traced
    with ``torch.profiler`` (two untraced calls first) on every rank; rank 0
    writes the Chrome trace to ``path``.  Returns from this rank's trace the
    device time of the exchange kernels, of the GEMMs, and how much of the
    exchanges' time the GEMMs overlap, with the streams each ran on."""
    import json

    from torch.profiler import ProfilerActivity, profile
    x = _layer_input(moe, cfg, rows, device)
    with torch.inference_mode():
        for _ in range(2):
            M.moe_ffn(moe, x, cfg, pctx, with_aux=False)
        _sync(device)
        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
                ) as prof:
            M.moe_ffn(moe, x, cfg, pctx, with_aux=False)
            _sync(device)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(path).with_suffix(f".rank{dist.get_rank()}.json")
    prof.export_chrome_trace(str(tmp))
    events = json.loads(tmp.read_text())["traceEvents"]
    if dist.get_rank() == 0:
        os.replace(tmp, path)
    else:
        tmp.unlink()
    kernels = [e for e in events if e.get("cat") == "kernel"]

    def spans(names):
        return [(e["ts"], e["ts"] + e["dur"], e.get("tid"))
                for e in kernels
                if any(n in e["name"].lower() for n in names)]
    exch, gemm = spans(EXCHANGE_KERNELS), spans(GEMM_KERNELS)
    overlap = 0.0
    for a0, a1, _ in exch:
        cover = sorted((max(a0, b0), min(a1, b1)) for b0, b1, _ in gemm
                       if b0 < a1 and b1 > a0)
        end = a0
        for c0, c1 in cover:                 # the union of the GEMMs in it
            if c1 > end:
                overlap += c1 - max(c0, end)
                end = c1
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name") == "cudaLaunchKernel"]
    return {"kernels": len(kernels), "launch_calls": len(launches),
            "exchange_us": sum(b - a for a, b, _ in exch),
            "gemm_us": sum(b - a for a, b, _ in gemm),
            "overlap_us": overlap,
            "exchange_streams": sorted({str(t) for *_, t in exch}),
            "gemm_streams": sorted({str(t) for *_, t in gemm})}


def near_ties(mine, tokens, ref_tokens, ref_logits) -> tuple[int, float]:
    """(rows of ``mine`` whose tokens equal the reference run's, the widest
    gap) where a row parts from the reference at step t: the gap is how far
    below its best logit the reference run put the token this run took,
    over max |logit|."""
    equal, worst = 0, 0.0
    for local, row in enumerate(mine):
        diff = np.flatnonzero(tokens[row] != ref_tokens[row])
        if not diff.size:
            equal += 1
            continue
        lg = ref_logits[int(diff[0])][local]
        took = int(tokens[row, diff[0]])
        worst = max(worst, ((lg.max() - lg[took]) / lg.abs().max()).item())
    return equal, worst


def _memory(params, device) -> dict:
    """Bytes of this rank's expert weights and of all its weights.  On the
    CPU, whether its non-expert weights lie in shared memory; on the card
    what the rank itself holds (``memory_allocated``, which does not count
    memory opened from another process's IPC handle) and the card's free
    memory once every rank has built its weights."""
    weights = {"experts": 0, "all": 0}
    for name, t in params.named_parameters():
        nbytes = t.numel() * t.element_size()
        weights["all"] += nbytes
        if T.is_expert_weight(name):
            weights["experts"] += nbytes
    out = {f"{key}_gb": val / 1e9 for key, val in weights.items()}
    dist.barrier()
    if device.type == "cpu":
        out["weights_shared"] = all(
            t.is_shared() for name, t in params.named_parameters()
            if not T.is_expert_weight(name))
    else:
        torch.cuda.synchronize(device)
        out["own_gb"] = torch.cuda.memory_allocated(device) / 1e9
        out["reserved_gb"] = torch.cuda.memory_reserved(device) / 1e9
        out["card_free_gb"] = torch.cuda.mem_get_info(device)[0] / 1e9
    return out


def grouped_requests(cfg, *, requests: int, group: int, prompt_len: int,
                     max_new: int, rate: float, seed: int) -> list:
    """The seeded Poisson stream of ``TrafficGenerator`` with its requests
    arriving in groups of ``group``, each at its first request's time: the
    cohorts a scheduler forms from it then hold a multiple of ``group``
    rows, as the data-parallel ranks need (one row a rank)."""
    reqs = TrafficGenerator(TrafficConfig(
        arrival_rate_rps=rate, num_requests=requests,
        prompt_lens=(prompt_len,), max_news=(max_new,), vocab=cfg.vocab,
        seed=seed)).requests()
    for i, req in enumerate(reqs):
        req.arrival_s = reqs[i - i % group].arrival_s
    return reqs


def continuous_run(mesh: RankMesh, spec: dict, params, device, fabric
                   ) -> dict:
    """Serve ``spec["continuous"]`` (``requests``, ``prompt_len``,
    ``max_new``, ``rate``, ``capacity``, and ``group``: requests arrive in
    groups of that many, by default one a data-parallel rank; 1 leaves the
    Poisson stream as it is, whose cohorts the engine pads over the ranks)
    through the continuous-batching scheduler under planner admission,
    with the plan bound for ``group`` rows and the plan of each batch
    bucket the admission grows into staged through the engine's
    ``PlanBinder`` (a TPOT SLO of twice the probe's step at capacity, so
    nothing is held).  Returns the report, the decode mode and counts, the
    walls, the rows of each cohort prefilled and each request's tokens."""
    cont, cfg = spec["continuous"], spec["cfg"]
    group = cont.get("group", mesh.axis_size("pod", "data"))
    itemsize = spec["dtype"].itemsize
    phases = {"prefill": (group, cont["prompt_len"]), "decode": (group, 1)}
    pctx = run_context(mesh, spec["pods"], {
        "policy": "auto", "fabric": "measured" if fabric else None,
        "bind": True}, fabric=fabric, cfg=cfg, phases=phases,
        itemsize=itemsize)
    model = build_model(cfg, device=device, dtype=spec["dtype"], pctx=pctx)
    engine = ServeEngine(model, params, ServeConfig(
        max_new_tokens=cont["max_new"], cache_dtype=spec["cache_dtype"]),
        device=device, pctx=pctx)
    cohorts = []
    start = engine.start_cohort

    def recording(prompts, *args, **kw):
        cohorts.append(len(prompts))
        return start(prompts, *args, **kw)
    engine.start_cohort = recording
    probe = engine.plan_probe(itemsize)
    tpot_slo_s = 2.0 * probe.decode_step_s(cont["capacity"])
    queue = RequestQueue()
    for req in grouped_requests(
            cfg, requests=cont["requests"], group=group,
            prompt_len=cont["prompt_len"], max_new=cont["max_new"],
            rate=cont["rate"], seed=spec["seed"]):
        queue.push(req)
    sched = BatchScheduler(
        queue=queue, admission=AdmissionController(
            probe, capacity=cont["capacity"], policy="planner",
            tpot_slo_s=tpot_slo_s, ttft_slo_s=0.08),
        engine=engine, probe=probe, binder=engine.plan_binder,
        plan_for_bucket=lambda b: engine.bucket_plan(b, cont["prompt_len"]),
        seed=spec["seed"])
    sched.run_until_drained()
    engine.close()
    return {"report": sched.report(ttft_slo_s=0.08, tpot_slo_s=tpot_slo_s),
            "decode_graph": dict(engine.stats["decode_graph"]),
            "wall": dict(sched.wall), "bound_bucket": sched.bound_bucket,
            "cohorts": cohorts,
            "tokens": {r.rid: list(r.tokens) for r in sched.completed}}


def _probe_failures() -> float:
    """Probes failed so far in this process, over every reason and
    fabric (``repro_probe_failures_total``)."""
    from repro_torch.telemetry import default_registry
    return sum(v for _, v in default_registry()[
        "repro_probe_failures_total"].samples())


def _live_probe(mesh: RankMesh, device, **kw):
    """A ``LiveProbe`` of this rank mesh: the MoE over pod x data (pod
    when the mesh has pods), the AllGather over the model axis."""
    from repro_torch.telemetry import LiveProbe
    return LiveProbe(mesh, pod_axis="pod" if mesh.shape["pod"] > 1 else None,
                     device=device, **kw)


def live_calibration(mesh: RankMesh, device, topo, opts: dict) -> tuple:
    """One startup calibration on these ranks, the steps of
    ``telemetry.startup_calibration`` with a ``LiveProbe``: a DriftMonitor
    on a fresh Planner (the process planner keeps the datasheet) runs one
    cycle of sweeps on ``topo`` into a ``:memory:`` store, then
    recalibrates.  ``opts``: the probe's ``repeats``, the ``ops`` swept
    (the AllGather over the model axis, the MoE over pod x data; the
    directed rail probes follow), ``payloads`` (op -> sweep) and
    ``scenario`` (``num_experts``, ``top_k``, ``token_bytes``).  With
    ``check_packs`` the MoE sweeps first run once, unrecorded, with every
    pack held against its plain version (:func:`_checked_packs`), so that
    the timed sweeps carry no check.  Returns (store, report): every record, the fits and
    the drift at fit, the calibrated model against the datasheet, the
    probes that failed (the checking pass included) and the checked
    packs."""
    from repro_torch.core.latency_model import DEFAULT
    from repro_torch.core.planner import Planner
    from repro_torch.telemetry import (CalibrationStore, DriftMonitor,
                                       calibrated_hw, probe_sweep, topo_key)

    ops, payloads = tuple(opts["ops"]), opts.get("payloads")
    scenario = opts.get("scenario", {})
    before = _probe_failures()
    packs: list = []
    if opts.get("check_packs"):
        with _checked_packs(packs):
            probe_sweep(topo, _live_probe(mesh, device, repeats=1),
                        ops=[op for op in ops if op in ("dispatch",
                                                        "combine")],
                        payloads=payloads, **scenario)
    store = CalibrationStore(":memory:")
    monitor = DriftMonitor(Planner(), store, topo)
    t0 = time.perf_counter()
    probe = _live_probe(mesh, device, repeats=opts.get("repeats", 3))
    event = (monitor.run_cycle(probe, ops=ops, payloads=payloads, **scenario)
             or monitor.recalibrate(force=True))
    wall = time.perf_counter() - t0
    hw = calibrated_hw(store, topo)
    keep = ("op", "plan", "payload_bytes", "predicted_s", "measured_s",
            "bottleneck_role", "source", "fabric")
    return store, {
        "fabric": topo_key(topo), "wall_s": wall,
        "records": [{k: r[k] for k in keep} for r in store.records()],
        "fits": event["fits"], "drift": event["drift"],
        "drift_by_op": event["drift_by_op"],
        "measured_links": event["measured_links"],
        "hw": hw.fingerprint(), "default": DEFAULT.fingerprint(),
        "link_bw": {f"{a}>{b}": bw for (a, b), bw in hw.link_bw},
        "alpha_base": hw.alpha_base,
        "failures": _probe_failures() - before,
        "packs": packs}


def probe_worker(rank: int, spec: dict) -> None:
    """``LiveProbe`` on these ranks, for the tests and for chip_smoke's
    phase 9.  ``spec["calibrate"]``: :func:`live_calibration` on
    ``spec["topo"]``.  ``spec["timeout"]``: a sweep (``ops``, ``payloads``)
    under a probe deadline of ``timeout_s`` and one attempt a probe: the
    records kept and the probes failed.  ``spec["dispatch_bytes"]``: the
    rows and row bytes that each dispatch probe of the calibration hands
    the dispatch (a patch of both dispatches).  ``spec["scan"]``: one
    ``FailureDetector`` scan of every rail of the topology through the
    probe's single-rail ``linkprobe``: whether the dead set changed, and
    the links declared dead.  ``spec["gather"]``:
    :func:`tp_gather_probe`.  ``spec["split_tp"]`` (fragment bytes): the
    planner's split-TP AllGather pick on the topology, on the datasheet
    and on the calibrated model.  ``spec["program"]`` (``cfg``,
    ``phases``, ``itemsize``, ``tp_subgroups``): the serve program planned
    by a context without and with ``calibration=`` the store, its
    fingerprint and split-TP decision each."""
    from repro_torch.core.latency_model import DEFAULT
    from repro_torch.core.planner import Planner
    from repro_torch.telemetry import ProbePolicy, calibrated_hw, probe_sweep
    mesh = init_rank(rank, spec)
    dev = rank_device(rank, spec)
    topo = spec.get("topo")
    results: dict = {"rank": rank}
    calls: list = []

    def recording(fn):
        def call(tokens, ids, gates, dcfg, epmesh, **kw):
            calls.append((tokens.shape[0],
                          tokens.shape[1] * tokens.element_size()))
            return fn(tokens, ids, gates, dcfg, epmesh, **kw)
        return call
    patches = ([mock.patch.object(cl, name, recording(getattr(cl, name)))
                for name in ("hierarchical_dispatch", "baseline_dispatch")]
               if spec.get("dispatch_bytes") else [])
    store = None
    if spec.get("calibrate"):
        for patch in patches:
            patch.start()
        try:
            store, results["calibration"] = live_calibration(
                mesh, dev, topo, spec["calibrate"])
        finally:
            for patch in patches:
                patch.stop()
        results["dispatch_calls"] = calls
    if spec.get("timeout"):
        opts = spec["timeout"]
        before = _probe_failures()
        probe = _live_probe(mesh, dev, repeats=1,
                            timeout_s=opts["timeout_s"])
        records = probe_sweep(topo, probe, ops=opts["ops"],
                              payloads=opts["payloads"],
                              policy=ProbePolicy(retries=0),
                              **opts.get("scenario", {}))
        results["timeout"] = {
            "records": len(records),
            "failures": _probe_failures() - before}
    if spec.get("scan"):
        from repro_torch.telemetry.failover import FailureDetector
        detector = FailureDetector(topo)
        changed = detector.scan(_live_probe(mesh, dev, repeats=1))
        results["scan"] = {"changed": changed, "rails": len(detector.rails),
                           "dead": sorted(detector.dead_links())}
    if spec.get("gather"):
        results["gather"] = tp_gather_probe(mesh, dev, **spec["gather"])
    if spec.get("split_tp"):
        results["split_tp"] = {}
        for name, hw in (("datasheet", None),
                         ("calibrated", calibrated_hw(store, topo))):
            d = Planner().choose("allgather", float(spec["split_tp"]), topo,
                                 hw, executable_only=True, num_domains=2)
            results["split_tp"][name] = {
                "plan": d.plan, "split": d.shard_map_kwargs.get("split"),
                "predicted_s": d.predicted_s}
    if spec.get("program"):
        job = spec["program"]
        results["program"] = {}
        for name, cal in (("datasheet", None), ("calibrated", store)):
            pctx = ParallelContext(mesh, tp_subgroups=job["tp_subgroups"],
                                   plan_policy="auto", calibration=cal)
            program = build_collective_program(
                job["cfg"], pctx, "serve", job["phases"],
                itemsize=job["itemsize"])
            eplan = pctx.plan_collectives(program)
            d = eplan.decision("prefill/split_tp_gather")
            _, hw = pctx._plan_topo_hw(0)
            results["program"][name] = {
                "fingerprint": eplan.fingerprint, "plan": d.plan,
                "split": d.shard_map_kwargs.get("split"),
                "predicted_s": d.predicted_s,
                "hw_fitted": hw not in (None, DEFAULT)}
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, results)


def serve_worker(rank: int, spec: dict) -> None:
    """One rank of ``spec["cfg"]`` served through ``ServeEngine.generate``
    for each run of ``spec["runs"]`` (default: the fixed scheme pairs of
    ``spec["schemes"]``), on weights drawn from ``spec["seed"]`` (this
    rank's experts only; with ``spec["shared"]`` the non-expert weights are
    those tensors, made once for the card).  Every rank passes the global
    ``spec["prompts"]``.  ``results["memory"]`` holds the bytes of the
    rank's weights and, on the card, what it holds itself.

    Per run it records the resolved ``(scheme, combine, G)`` of prefill and
    decode, the global tokens, the walls, the kernel launches of the
    measured run, the logits of its rows at prefill, the pod-group bytes and
    the load of each expert from this rank's rows in the first (prefill)
    dispatch, the (token, expert) pairs each dispatch was given and kept at
    this rank's experts (in call order, prefill first), and how its tokens
    stand against the first run's (rows equal, widest near-tie gap).  A run
    with ``twin`` (an earlier run's label) runs fixed at the triple its twin
    resolved for prefill and is held against the twin instead.  With
    ``spec["warmup"]`` every run first makes an unmeasured run (a prefill
    and one decode step) that holds every pack against its plain version
    (:func:`_checked_packs`); with ``spec["temperature"]`` a
    sampled ``generate`` follows the measured one, seeded from
    ``spec["sample_seed"]``, unless the run says ``sample=False``.  With
    ``spec["measure_link"]`` (bytes a rank) the ranks first time the
    exchange (:func:`measure_link`), and ``spec["decide"]`` lists fabrics
    (specs, "measured", "measured-pod:<GB/s>", or None) whose planner
    decisions are reported.  ``spec["calibrate"]`` (:func:`live_calibration`
    options) first calibrates on the topology the planner scores the
    context on, reports the decisions on the datasheet and on the store's
    fitted model, and gives the store to runs marked ``calibrated``.
    ``spec["trace"]``
    (``{"run": label, "path": ...}``) times one MoE layer at the prefill
    rows under each run's context (:func:`layer_walls`) and traces it under
    that run's (:func:`trace_moe_layer`).  ``spec["continuous"]`` adds a
    run through the continuous-batching scheduler (:func:`continuous_run`)
    after the others.  Each run records its engine's decode mode and graph
    counts (``decode_graph``) and, under a graph, the decode wall of a
    second call of the same shape, every round a replay
    (``replay_decode_s``); under a graph (nccl) the dispatch patches
    see the prefill and the first two decode rounds only, since a replay
    runs no Python.  ``spec["weights"]`` (the reference's parameters as
    numpy arrays) replaces the seeded draw (``convert.params_from_jax``,
    this rank's shard).  Over a model axis a run records the decision of
    its split-TP gather site (the plan report's ``split_tp_gather``), and
    ``spec["gather"]`` times the gather alone (:func:`tp_gather_probe`);
    ``spec["keep_logits"]`` keeps every step's logits of the rank's rows
    (``step_logits``), and ``same_logits`` says whether they are the bits
    of the run it is held against.
    The MoE records (pairs, loads, pod bytes) are kept for MoE models, the
    pod bytes with pods only."""
    mesh = init_rank(rank, spec)
    dev = rank_device(rank, spec)
    cfg, prompts = spec["cfg"], spec["prompts"]
    phases = {"prefill": prompts.shape, "decode": (prompts.shape[0], 1)}
    itemsize = spec["dtype"].itemsize
    runs = spec.get("runs") or fixed_runs(spec["schemes"])
    results = {"rank": rank, "device": str(dev), "runs": {},
               "decisions": []}
    fabric = rate = None
    if spec.get("measure_link"):
        rate = measure_link(mesh, spec["measure_link"], dev)
        fabric = fabric_spec(spec["pods"], spec["ep"], rate)
        results["link"] = {"bytes": spec["measure_link"], "pair_rate": rate,
                           "fabric": fabric}
    for want in spec.get("decide", ()):
        if want is not None and want.startswith("measured"):
            if rate is None:
                raise ValueError(f"fabric {want!r} needs measure_link")
            pod = want.partition(":")[2]
            want = fabric_spec(spec["pods"], spec["ep"], rate,
                               float(pod) * 1e9 if pod else None)
        results["decisions"].append(plan_decisions(
            mesh, spec["pods"], cfg, phases, want, itemsize))
    store = None
    if spec.get("calibrate"):
        topo, _ = run_context(mesh, spec["pods"], {})._plan_topo_hw(
            cfg.num_experts)
        store, results["calibration"] = live_calibration(
            mesh, dev, topo, spec["calibrate"])
        for cal in (None, store):
            results["decisions"].append(plan_decisions(
                mesh, spec["pods"], cfg, phases, None, itemsize,
                calibration=cal))
    params = None
    contexts, refs = {}, {}
    if spec.get("gather"):
        results["gather"] = tp_gather_probe(mesh, dev, **spec["gather"])
    for run in runs:
        label = run_label(run)
        if "twin" in run:
            scheme, combine, g = \
                results["runs"][run["twin"]]["resolved"]["prefill"]
            run = dict(run, scheme=scheme, combine=combine, microbatch=g)
        pctx = contexts[label] = run_context(
            mesh, spec["pods"], run, fabric=fabric, cfg=cfg, phases=phases,
            itemsize=itemsize, calibration=store)
        model = build_model(cfg, device=dev, dtype=spec["dtype"], pctx=pctx)
        if params is None:
            if spec.get("weights") is not None:
                from repro_torch.convert import params_from_jax
                params = params_from_jax(spec["weights"], cfg, device=dev,
                                         dtype=spec["dtype"], pctx=pctx)
            else:
                gen = torch.Generator(device=dev)
                gen.manual_seed(spec["seed"])
                params = model.init(gen, shared=spec.get("shared"))
            if dev.type == "cuda":      # the draws' fp32 temporaries
                torch.cuda.empty_cache()
            results["memory"] = _memory(params, dev)
        engine = RecordingEngine(
            model, params, ServeConfig(max_new_tokens=spec["max_new"],
                                       cache_dtype=spec["cache_dtype"]),
            device=dev, pctx=pctx)
        mine = engine._my_rows(np.arange(prompts.shape[0]))
        packs: list = []
        if spec.get("warmup"):
            with _checked_packs(packs):
                engine.generate(prompts, max_new=2)
            engine.stats.update(prefill_s=0.0, decode_s=0.0, tokens=0)
        engine.step_logits.clear()
        record: dict = {}
        patches = _dispatches(record)
        for patch in patches:
            patch.start()
        ops.reset_launches()
        try:
            out = engine.generate(prompts)
        finally:
            for patch in patches:
                patch.stop()
        counts = ops.launches()
        logits = list(engine.step_logits)
        stats = dict(engine.stats)
        if stats["decode_graph"]["mode"] == "graph":
            # the same shape again: every decode round a replay
            engine.stats.update(prefill_s=0.0, decode_s=0.0)
            engine.generate(prompts)
            stats["replay_decode_s"] = engine.stats["decode_s"]
        engine.close()
        sampled = None
        if spec.get("temperature") and run.get("sample", True):
            hot = ServeEngine(model, params, ServeConfig(
                max_new_tokens=spec["max_new"],
                temperature=spec["temperature"],
                cache_dtype=spec["cache_dtype"]), device=dev, pctx=pctx)
            sampled = hot.generate(prompts, seed=spec["sample_seed"])
            hot.close()
        refs[label] = (out, logits)
        against = run.get("twin", run_label(runs[0]))
        equal, gap = near_ties(mine, out, *refs[against])
        res = results["runs"][label] = {
            "resolved": resolved(pctx, cfg, phases, itemsize),
            "plan": (pctx.execution_plan.fingerprint
                     if pctx.execution_plan is not None else None),
            "tokens": out, "launches": counts,
            "prefill_s": stats["prefill_s"],
            "decode_s": stats["decode_s"],
            "replay_decode_s": stats.get("replay_decode_s"),
            "nonfinite_logits": stats["nonfinite_logits"],
            "prefill_logits": logits[0],
            "step_logits": logits if spec.get("keep_logits") else None,
            "vs": {"run": against, "rows_equal": equal, "rows": len(mine),
                   "widest_gap": gap},
            "same_logits": len(logits) == len(refs[against][1]) and all(
                torch.equal(a, b) for a, b in zip(logits, refs[against][1])),
            "pod": mesh.coords["pod"], "packs": packs, "sampled": sampled,
            "decode_graph": dict(stats["decode_graph"]),
            "split_tp": stats.get("plans", {}).get("prefill", {}).get(
                "split_tp_gather")}
        if "state" in record:
            res.update(
                pairs=[(given, int(kept)) for given, kept in record["pairs"]],
                expert_load=torch.bincount(
                    record["ids"].reshape(-1).long(),
                    minlength=cfg.num_experts).cpu().numpy())
            if spec["pods"] > 1:
                whole, occupied = pod_send_bytes(record["state"],
                                                 record["row_bytes"])
                base, mw = cl.dispatch_pod_bytes(
                    record["ids"], record["state"].cfg, record["state"].mesh,
                    record["row_bytes"], elem_bytes=1)
                res.update(pod_bytes={"whole": whole, "occupied": occupied},
                           analytic_pod_bytes={"baseline": base,
                                               "multiwrite": mw})
    if spec.get("continuous"):
        results["continuous"] = continuous_run(mesh, spec, params, dev,
                                               fabric)
    if dev.type == "cuda":
        results["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if spec.get("trace"):
        moe = next(b.moe for b in params.blocks if b.moe is not None)
        rows = prompts.size // mesh.axis_size("pod", "data")
        results["layer_walls"] = {
            label: layer_walls(moe, cfg, contexts[label], rows, dev)
            for label in contexts}
        results["trace"] = trace_moe_layer(
            moe, cfg, contexts[spec["trace"]["run"]], rows, dev,
            spec["trace"]["path"])
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, results)


def dispatch_worker(rank: int, spec: dict) -> None:
    """The MoE round trips of ``spec["cases"]`` on this rank's rows of the
    inputs in ``spec["inputs"]`` (an ``.npz``: per case ``<case>/tokens``,
    ``/ids``, ``/gates`` over all ranks' rows, and the dispatch config).
    Experts scale their rows by ``(expert + 1) / 100`` where a case says so
    (the dense oracle of ``tests/multidev/check_collectives.py``) and are
    the identity otherwise.  Saves every pack map, the expert gates and the
    combined output of each case."""
    mesh = init_rank(rank, spec)
    results = {}
    data = np.load(spec["inputs"]) if spec["cases"] else None
    for case in spec["cases"]:
        name, scheme, combine = case["name"], case["scheme"], case["combine"]
        cfg = cl.DispatchConfig(**case["dcfg"])
        epmesh = cl.EPMesh(pod_axis="pod", ep_axis="data",
                           num_pods=spec["pods"], ep_per_pod=spec["ep"],
                           ranks=mesh)
        per = data[f"{name}/tokens"].shape[0] // spec["world"]
        rows = slice(rank * per, (rank + 1) * per)
        tok, ids, gates = (torch.from_numpy(data[f"{name}/{key}"][rows])
                           for key in ("tokens", "ids", "gates"))
        dispatch = (cl.hierarchical_dispatch if scheme == "hierarchical"
                    else cl.baseline_dispatch)
        exp_tok, exp_gate, state = dispatch(tok, ids, gates, cfg, epmesh)
        per_rank = cfg.num_experts // epmesh.num_ranks
        if case["scaled"]:
            experts = rank * per_rank + torch.arange(per_rank)
            exp_tok = exp_tok * ((experts + 1.0) * 0.01)[:, None, None]
        combine_fn = {"hierarchical": cl.hierarchical_combine,
                      "unicast": cl.hierarchical_combine_unicast,
                      "baseline": cl.baseline_combine}[combine]
        out = combine_fn(exp_tok, exp_gate, state)
        maps = ({"map_pod": state.map_pod, "map_ep": state.map_ep,
                 "map_exp": state.map_exp, "recv_src": state.recv_src}
                if scheme == "hierarchical" else
                {"map_rank": state.map_rank, "map_exp": state.map_exp})
        results[name] = {**{k: v.numpy() for k, v in maps.items()},
                         "exp_gate": exp_gate.numpy(), "out": out.numpy()}
    results["moe_ffn"] = _moe_ffn_case(rank, spec, mesh)
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, results)


def _moe_ffn_case(rank: int, spec: dict, mesh: RankMesh) -> dict:
    """``moe_ffn`` for each job of ``spec["moe"]``: the job's MoE layer
    (``cfg``, its reference weights ``weights``) on this rank's
    data-parallel rows of ``x``, its experts and, over a model axis, its
    block of their hidden width, under each run of ``runs`` (default: the
    fixed scheme pairs at one chunk).  Returns per job and run label the
    output, the aux and the resolved round trip."""
    from repro_torch.convert import block_of
    from repro_torch.models.layers import tp_of
    out = {}
    dp, dp_index = mesh.axis_size("pod", "data"), mesh.axis_index("pod",
                                                                  "data")
    for job in spec["moe"]:
        cfg, weights = job["cfg"], job["weights"]
        x = torch.from_numpy(job["x"])
        per = x.shape[0] // dp
        x = x[dp_index * per:(dp_index + 1) * per]
        layer = None
        res = out[job["name"]] = {}
        for run in job.get("runs") or fixed_runs():
            pctx = run_context(mesh, spec["pods"], run)
            if layer is None:
                first, local = M.expert_shard(pctx, cfg.num_experts)
                d_ff = weights["w1"].shape[-1]
                layer = M.MoE(cfg.d_model, d_ff, cfg.num_experts,
                              device="cpu", dtype=torch.float32,
                              first=first, local=local, tp=tp_of(pctx))
                with torch.no_grad():
                    layer.router.copy_(torch.from_numpy(weights["router"]))
                    for key in ("w1", "w3", "w2"):
                        w = weights[key][first:first + local]
                        if key in layer.shards:
                            w = block_of(w, layer.shards[key])
                        getattr(layer, key).copy_(torch.from_numpy(
                            np.ascontiguousarray(w)))
            y, aux = M.moe_ffn(layer, x, cfg, pctx)
            kw = M.pipeline_config(pctx, cfg, x.shape[0] * x.shape[1],
                                   cfg.d_model, layer.d_ff,
                                   x.element_size())
            res[run_label(run)] = {"y": y.numpy(), "aux": float(aux),
                                   "resolved": kw}
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def tp_gather_probe(mesh: RankMesh, device, *, shape, dtype=torch.bfloat16,
                    num_domains: int = 2, reps: int = 5) -> dict:
    """The split-TP AllGather alone over the model axis in ``num_domains``
    domains, at a fragment of ``shape`` a rank (random, seeded by rank):
    the plain domain ``all_gather`` (``allgather_reference``), MultiWrite
    paired relaying at the analytic split, full relaying at 0.5, and the
    planner's choice for the fragment (``allgather_plan`` under "auto").
    Returns the plan's name and split, whether each result is bit-exact
    against the plain one, and each one's wall (ms, host clock: the median
    of ``reps`` calls after a warm-up, each between a barrier and a
    synchronisation; the slowest rank's)."""
    from repro_torch.core.schedules import optimal_split
    gen = torch.Generator(device=device)
    gen.manual_seed(100 + mesh.rank)
    x = torch.randn(tuple(shape), generator=gen, device=device).to(dtype)
    pctx = ParallelContext(mesh, pod_axis="pod" if mesh.shape["pod"] > 1
                           else None, tp_subgroups=num_domains,
                           plan_policy="auto")
    decision = pctx.allgather_plan(x.numel() * x.element_size(),
                                   num_domains=num_domains)
    kw = dict(num_domains=num_domains)
    calls = {
        "plain": lambda: cl.allgather_reference(x, mesh, "model",
                                                num_domains),
        "paired": lambda: cl.multiwrite_allgather(
            x, mesh, "model", split=optimal_split("multiwrite_paired"),
            mode="paired", **kw),
        "full": lambda: cl.multiwrite_allgather(
            x, mesh, "model", split=0.5, mode="full", **kw),
        "planned": lambda: cl.planned_allgather(
            x, mesh, "model", decision=decision, **kw)}
    ref = calls["plain"]()
    out = {"shape": list(shape), "bytes": x.numel() * x.element_size(),
           "plan": decision.plan,
           "split": decision.shard_map_kwargs.get("split"),
           "mode": decision.shard_map_kwargs.get("mode"),
           "exact": {}, "wall_ms": {}}
    for name, fn in calls.items():
        out["exact"][name] = _same_bits(fn(), ref)
        walls = []
        for _ in range(reps):
            dist.barrier()
            _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = torch.tensor([float(np.median(walls))], dtype=torch.float64,
                            device=device)
        dist.all_reduce(wall, op=dist.ReduceOp.MAX)
        out["wall_ms"][name] = float(wall)
    return out


def gather_worker(rank: int, spec: dict) -> None:
    """The AllGather half on this rank's block of each input of
    ``spec["inputs"]`` (an ``.npz``), over the model axis of a (1, 1, world)
    mesh: each case of ``spec["cases"]`` names its input ``x`` (all ranks'
    rows), an ``op`` ("reference", "multiwrite", "planned" or "split_tp")
    and its arguments (``mode``, ``split``, ``num_domains``, ``hw`` as a
    name of ``core.latency_model``, ``policy``).  Saves each case's
    result."""
    from repro_torch.core import latency_model as lm
    from repro_torch.models.layers import split_tp_allgather
    mesh = init_rank(rank, spec)
    data = np.load(spec["inputs"])
    results = {}
    for case in spec["cases"]:
        x = torch.from_numpy(data[case["x"]])
        per = x.shape[0] // spec["world"]
        x = x[rank * per:(rank + 1) * per]
        nd = case.get("num_domains", 2)
        if case["op"] == "reference":
            y = cl.allgather_reference(x, mesh, "model", nd)
        elif case["op"] == "multiwrite":
            y = cl.multiwrite_allgather(x, mesh, "model", num_domains=nd,
                                        split=case["split"],
                                        mode=case["mode"])
        elif case["op"] == "planned":
            hw = case.get("hw")
            y = cl.planned_allgather(x, mesh, "model", num_domains=nd,
                                     hw=getattr(lm, hw) if hw else None)
        else:
            pctx = ParallelContext(mesh, tp_subgroups=nd,
                                   plan_policy=case["policy"])
            y = split_tp_allgather(x, pctx)
        results[case["name"]] = y.numpy()
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, results)
