"""Rank workers: one process per rank of a ``torch.distributed`` run on one
host, spawned and joined with a deadline.

``chip_smoke.py`` spawns :func:`serve_worker` as 4 ranks (2 pods x 2 ep
ranks) serving DBRX-132B, as 16 gloo ranks (2 pods x 8) serving
Kimi-K2-1T, as 4 tensor-parallel ranks (1 x 1 x 4) serving
Mistral-NeMo-12B and, one spawn for all four, Zamba2-7B, RWKV6-7B,
SeamlessM4T-medium and Qwen2-VL-2B, and (1 x 2 x 2) serving DBRX on the
card(s), and
:func:`train_worker` as 4 ranks training DBRX over 2 x 2 and Mistral-NeMo
over (1, 1, 4); the CPU tests spawn them, :func:`dispatch_worker`,
:func:`gather_worker` and :func:`probe_worker` (the telemetry's
``LiveProbe``) as 3, 4, 8 or 16 gloo ranks at small sizes.  A spec's
mesh is ``(pods, ep, tp)`` (``tp`` default 1).  The ranks of one card can
share one copy of the non-expert weights (:func:`shared_weights`,
``run_ranks(shared=...)``).

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

import dataclasses
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
from repro_torch.checkpoint.store import CheckpointManager, ShardLayout
from repro_torch.parallel import mesh as mesh_ops
from repro_torch.parallel import sharding
from repro_torch.parallel.mesh import (RankMesh, axis_names,
                                       process_group)
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


# wall-clock marks of this rank's process (``time.time()``, a clock its
# parent shares), saved with its results under "marks"
_MARKS: list = []


def mark(label: str) -> None:
    """Note the wall clock at ``label``: :func:`_save` keeps the marks
    with the rank's results, beside :func:`run_ranks`' own spawn and join
    times (``"spawn"``), so a caller can split a spawn's wall."""
    _MARKS.append((label, time.time()))


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
    caller's own last reference then frees the memory.

    The ranks are forked from a fork server that imported this module
    once (started at the first call, with this process's environment then,
    and ending with this process).  A rank's results that are a dict gain
    ``"marks"`` (:func:`mark`) and ``"spawn"``: this process's wall clock
    before the first start and after the last exit."""
    world = spec["world"]
    out_dir = Path(spec["out_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    # a fork server imports torch and this package once, before any CUDA
    # call (it makes none), and forks every rank from there
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])

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
    started = time.time()
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
    joined = time.time()
    results = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
               for r in range(world)]
    for res in results:
        if isinstance(res, dict):
            res["spawn"] = (started, joined)
    return results


def _rank_main(fn, rank: int, spec: bytes) -> None:
    # set before the rank's first CUDA call: its allocator then grows its
    # segments in place, so a peak strands no reserved blocks (16 ranks
    # share one card's memory in chip_smoke's phase 7)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    _MARKS.clear()
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


def transport_of(spec: dict) -> str:
    """The mesh's transport a spec asks for: ``spec["transport"]``
    ("card": the exchanges through the memory of the one device every rank
    lies on, beside a gloo group; valid only with the gloo backend and
    every rank of the world on one device, else it raises), by default the
    backend's own collectives."""
    transport = spec.get("transport", "backend")
    if transport == "card":
        if spec["backend"] != "gloo":
            raise ValueError(f"the card transport runs beside gloo, not "
                             f"{spec['backend']}")
        devices = {rank_device(r, spec) for r in range(spec["world"])}
        if len(devices) != 1:
            raise ValueError(f"the card transport needs every rank on one "
                             f"device; the spec lays its {spec['world']} "
                             f"ranks over {sorted(map(str, devices))}")
    elif transport != "backend":
        raise ValueError(f"transport {transport!r}: 'backend' or 'card'")
    return transport


def init_rank(rank: int, spec: dict) -> RankMesh:
    """Join the process group and build the (pods, ep, tp) rank mesh over
    the spec's transport (:func:`transport_of`)."""
    transport = transport_of(spec)
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
    mesh = RankMesh((spec["pods"], spec["ep"], spec.get("tp", 1)),
                    timeout=timeout, dp_servers=spec.get("dp_servers", ()),
                    transport=transport)
    mark("ready")
    return mesh


def call_worker(rank: int, spec: dict) -> None:
    """One rank that joins the mesh and saves ``spec["call"](mesh, device,
    spec)``: a module-level function (pickled by reference) for a check
    that needs no worker of its own."""
    mesh = init_rank(rank, spec)
    result = spec["call"](mesh, rank_device(rank, spec), spec)
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, result)


def _save(rank: int, spec: dict, result) -> None:
    if isinstance(result, dict):
        mark("done")
        result["marks"] = list(_MARKS)
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
    sampling step (host copies, fp32), and the shapes and bytes of the
    decode state it sampled from (:func:`state_of`)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.step_logits: list = []
        self.state: dict = {}

    def _sample(self, state):
        self.step_logits.append(state.logits.float().cpu())
        self.state = state_of(state.slot.cache)
        return super()._sample(state)


def state_of(cache: dict) -> dict:
    """``{"shapes": {name: shape}, "bytes": total}`` of a decode cache's
    tensors (a list of per-layer tensors by its first one's shape and its
    length: ``(n, *shape)``); the host scalars left out."""
    shapes, total = {}, 0
    for name, val in cache.items():
        if isinstance(val, torch.Tensor):
            shapes[name] = tuple(val.shape)
            total += val.numel() * val.element_size()
        elif isinstance(val, list) and val and isinstance(val[0],
                                                          torch.Tensor):
            shapes[name] = (len(val),) + tuple(val[0].shape)
            total += sum(t.numel() * t.element_size() for t in val)
    return {"shapes": shapes, "bytes": total}


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
    directed rail probes follow), ``payloads`` (op -> sweep),
    ``directions`` (the directed probes' sweep; default the monitor's) and
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
                                       calibrated_hw, probe_link_directions,
                                       probe_sweep, topo_key)
    from repro_torch.telemetry.probe import DIRECTION_SWEEP

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
    # ``DriftMonitor.run_cycle``'s steps, the directed probes at their sweep
    records = probe_sweep(topo, probe, ops=ops, payloads=payloads,
                          hw=monitor.planner.hw, **scenario)
    records += probe_link_directions(
        topo, probe, payloads=opts.get("directions", DIRECTION_SWEEP),
        hw=monitor.planner.hw)
    monitor.store.extend(records)
    for r in records:
        monitor.observe(r)
    event = monitor.check() or monitor.recalibrate(force=True)
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
    mesh = init_rank(rank, spec)
    results = _probe(mesh, rank, rank_device(rank, spec), spec)
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, results)


def _probe(mesh: RankMesh, rank: int, dev, spec: dict) -> dict:
    """:func:`probe_worker`'s work on the joined mesh."""
    from repro_torch.core.latency_model import DEFAULT
    from repro_torch.core.planner import Planner
    from repro_torch.telemetry import ProbePolicy, calibrated_hw, probe_sweep
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
        mark("calibration")
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
    return results


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
    pod bytes with pods only.  Each run also records the rank's decode
    state as it last sampled (``state``: :func:`state_of`).

    ``spec["models"]``: a list of specs, each updating ``spec`` for one
    model (its ``name``, ``cfg``, ``prompts``, ``runs``, ``weights``,
    ...), served one after another on the one spawned mesh, each model's
    weights freed before the next; the results are then ``{"models":
    {name: that model's results}}``.  A model whose ``cfg``, ``seed``,
    dtype and mesh equal the one before it, with no ``weights``, serves on
    the same weights.  An entry with ``mesh`` (``(pods, ep, tp)``, with its
    ``pods``, ``ep`` and ``tp``) runs over a mesh of that shape made over
    the same processes, on the spawn's transport.  An entry with ``transport_check``
    (``{"cases", "barriers"}``) runs :func:`transport_check` over the
    spawn's transport (each case's ``mesh`` a shape; default the spawn's);
    a mesh made for it alone frees its staging after.  An entry with
    ``probe`` runs :func:`probe_worker`'s
    work instead (its ``topo``, ``calibrate``, ``gather``, ...), so a
    calibration of the same mesh needs no spawn of its own; an entry with
    ``train`` runs :func:`train_worker`'s (its ``cfg``, ``runs``,
    ``batch``, ``seq``, ``steps``, ``lr``, ...) after the served weights
    and engines are freed, so a training run over the same mesh needs
    none either (the mesh is built with the top-level ``dp_servers`` that
    its gradient mean needs)."""
    mesh = init_rank(rank, spec)
    dev = rank_device(rank, spec)
    if not spec.get("models"):
        results, _ = _serve(mesh, rank, dev, spec)
    else:
        results = {"rank": rank, "device": str(dev), "models": {}}
        kept = key = None
        meshes = {(tuple(mesh.shape.values()), mesh.transport): mesh}

        def mesh_of(shape):
            """The spawn's mesh of ``shape`` over the same processes, on
            the spawn's transport (made once)."""
            key = (tuple(shape), mesh.transport)
            if key not in meshes:
                meshes[key] = RankMesh(
                    key[0], transport=mesh.transport,
                    dp_servers=spec.get("dp_servers", ()),
                    timeout=datetime.timedelta(seconds=spec["timeout_s"]))
            return meshes[key]
        for sub in spec["models"]:
            one = {k: v for k, v in spec.items() if k != "models"}
            one.update(sub)
            if one.get("transport_check"):
                check = one["transport_check"]
                cases = [dict(c, mesh=tuple(c.get("mesh", mesh.shape.values()
                                                  ))) for c in check["cases"]]
                own = {s: mesh_of(s) for s in sorted({c["mesh"]
                                                     for c in cases})}
                results["models"][sub["name"]] = transport_check(
                    own, dev, cases, barriers=check.get("barriers", 0))
                for s, m in own.items():       # extra meshes' staging
                    if m is not mesh:
                        m.close()
                mark(f"model {sub['name']}")
                continue
            here = mesh_of(one.get("mesh", mesh.shape.values()))
            if one.get("probe"):
                results["models"][sub["name"]] = _probe(here, rank, dev, one)
                mark(f"model {sub['name']}")
                continue
            if one.get("train"):
                kept = key = None       # the served weights and engines
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                results["models"][sub["name"]] = _train(here, rank, dev, one)
                mark(f"model {sub['name']}")
                continue
            same = (one.get("weights") is None
                    and (one["cfg"], one["seed"], one["dtype"],
                         tuple(here.shape.values())) == key)
            if not same:
                kept = None
                gc.collect()            # the engines' binder cycles
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            results["models"][sub["name"]], kept = _serve(
                here, rank, dev, one, params=kept)
            key = (one["cfg"], one["seed"], one["dtype"],
                   tuple(here.shape.values()))
            mark(f"model {sub['name']}")
        del kept
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, results)


def _serve(mesh: RankMesh, rank: int, dev, spec: dict, params=None
           ) -> tuple:
    """:func:`serve_worker`'s work for one model on the joined mesh:
    (results, the rank's weights), on ``params`` when given."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
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
        mark("calibration")
    contexts, refs = {}, {}
    if spec.get("gather"):
        results["gather"] = tp_gather_probe(mesh, dev, **spec["gather"])
        mark("gather")
    for run in runs:
        label = run_label(run)
        if "twin" in run:
            scheme, combine, g = \
                results["runs"][run["twin"]]["resolved"]["prefill"]
            run = dict(run, scheme=scheme, combine=combine, microbatch=g)
        # serving never shards weights over the data axis (the reference's
        # serving cells turn FSDP off): only ``_train`` runs ``shard_fsdp``
        pctx = contexts[label] = run_context(
            mesh, spec["pods"], run, fabric=fabric, cfg=cfg, phases=phases,
            itemsize=itemsize, calibration=store)
        model = build_model(cfg, device=dev, dtype=spec["dtype"], pctx=pctx)
        if "memory" in results:
            pass
        elif params is not None:        # the model before's, kept
            results["memory"] = dict(_memory(params, dev), kept=True)
        else:
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
            mark("weights")
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
            "state": engine.state,
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
        mark(f"run {label}")
    if spec.get("continuous"):
        results["continuous"] = continuous_run(mesh, spec, params, dev,
                                               fabric)
        mark("continuous")
    if dev.type == "cuda":
        results["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    results["staging"] = mesh.staging_bytes()
    if spec.get("trace"):
        moe = next(b.moe for b in params.blocks if b.moe is not None)
        rows = prompts.size // mesh.axis_size("pod", "data")
        results["layer_walls"] = {
            label: layer_walls(moe, cfg, contexts[label], rows, dev)
            for label in contexts}
        results["trace"] = trace_moe_layer(
            moe, cfg, contexts[spec["trace"]["run"]], rows, dev,
            spec["trace"]["path"])
    return results, params


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
    (``cfg``, its reference weights ``weights``) on the rank's device
    (:func:`rank_device`), on this rank's
    data-parallel rows of ``x``, its experts and, over a model axis, its
    block of their hidden width, under each run of ``runs`` (default: the
    fixed scheme pairs at one chunk).  Returns per job and run label the
    output, the aux and the resolved round trip; with a cotangent ``ct``
    (over every rank's rows) also the gradients of ``sum(y * ct)`` (the
    aux left out) in the rank's rows of x, the router and its experts."""
    from repro_torch.convert import block_of
    from repro_torch.models.layers import tp_of
    out = {}
    dev = rank_device(rank, spec)
    dp, dp_index = mesh.axis_size("pod", "data"), mesh.axis_index("pod",
                                                                  "data")
    for job in spec["moe"]:
        cfg, weights = job["cfg"], job["weights"]
        x = torch.from_numpy(job["x"]).to(dev)
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
                              device=dev, dtype=torch.float32,
                              first=first, local=local, tp=tp_of(pctx))
                with torch.no_grad():
                    layer.router.copy_(torch.from_numpy(weights["router"])
                                       .to(dev))
                    for key in ("w1", "w3", "w2"):
                        w = weights[key][first:first + local]
                        if key in layer.shards:
                            w = block_of(w, layer.shards[key])
                        getattr(layer, key).copy_(torch.from_numpy(
                            np.ascontiguousarray(w)).to(dev))
            ct = job.get("ct")
            if ct is not None:
                xg = x.clone().requires_grad_(True)
                for p in layer.parameters():
                    p.requires_grad_(True)
                    p.grad = None
                y, aux = M.moe_ffn(layer, xg, cfg, pctx)
                (y * torch.from_numpy(ct[dp_index * per:(dp_index + 1) * per]
                                      ).to(dev)).sum().backward()
                grads = {"x": xg.grad.cpu().numpy(),
                         **{k: p.grad.cpu().numpy().copy()
                            for k, p in layer.named_parameters()}}
                y = y.detach()
            else:
                y, aux = M.moe_ffn(layer, x, cfg, pctx)
                grads = None
            kw = M.pipeline_config(pctx, cfg, x.shape[0] * x.shape[1],
                                   cfg.d_model, layer.d_ff,
                                   x.element_size())
            res[run_label(run)] = {"y": y.cpu().numpy(), "aux": float(aux),
                                   "resolved": kw, "grads": grads,
                                   "experts": (first, local)}
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


# ---------------------------------------------------------------------------
# training over ranks
# ---------------------------------------------------------------------------

REDUCE_SCHEMES = ("ring", "tree", "hierarchical", "multiwrite", "compressed")


def psum_checks(mesh: RankMesh, inputs: np.ndarray, device, *,
                axes=("pod", "data"), num_servers: int = 2,
                rounds: int = 0) -> dict:
    """Each scheme of ``planned_psum`` (``reduce_scheme`` pinned) on this
    rank's row of ``inputs`` [ranks, N] (fp32), over the data-parallel
    ``axes``.  Returns every scheme's mean (numpy); with ``rounds``, also
    the mean of ``rounds`` steps of ``compressed_psum`` on the same input
    with its residual fed back (``compressed_ef``), which converges on
    the exact mean."""
    from repro_torch.parallel.compression import compressed_psum
    me = mesh.axis_index(*axes)
    g = torch.from_numpy(np.ascontiguousarray(inputs[me])).to(device)
    out = {}
    for scheme in REDUCE_SCHEMES:
        out[scheme] = cl.planned_psum(g, mesh, axes, num_servers=num_servers,
                                      reduce_scheme=scheme).cpu().numpy()
    if rounds:
        err, acc = None, torch.zeros_like(g)
        for _ in range(rounds):
            mean, err = compressed_psum(g, mesh, axes, err)
            acc += mean
        out["compressed_ef"] = (acc / rounds).cpu().numpy()
    return out


def leaf_digest(t: torch.Tensor) -> tuple:
    """A fingerprint of a tensor's bits: the sums of its elements' integer
    views, plain and weighted by a fixed pseudo-random sequence, a slice
    at a time (exact integer arithmetic on the tensor's device)."""
    from repro_torch.optim.optimizers import CHUNK
    ints = {2: torch.int16, 4: torch.int32}[t.element_size()]
    flat = t.detach().contiguous().view(-1).view(ints)
    gen = torch.Generator(device=t.device)
    gen.manual_seed(1234)
    weights = torch.randint(1, 1 << 30, (min(CHUNK, flat.numel()),),
                            generator=gen, device=t.device)
    plain = weighted = 0
    for lo in range(0, flat.numel(), CHUNK):
        part = flat[lo:lo + CHUNK].long()
        plain += int(part.sum())
        weighted += int((part * weights[:part.numel()]).sum())
    return plain, weighted


def _step0(mesh: RankMesh, model, params, sync, batch: dict,
           run: dict) -> dict:
    """One forward and backward on the step-0 batch, before training and
    without an update (the gradients are freed on return): with
    ``check_kernels`` each backward kernel held against its plain version
    (:func:`_checked_backwards`), with ``schemes`` the raw gradients of
    those leaves reduced by each scheme (:func:`_scheme_gaps`), then the
    sync's losses and global norm, and with ``grads`` the synced gradients
    at their global shapes (:func:`_global_grads`)."""
    from repro_torch.runtime.trainer import fill_missing_grads, trainable
    named = trainable(params)
    out: dict = {"kernel_checks": []}
    patches = (_checked_backwards(out["kernel_checks"])
               if run.get("check_kernels") else [])
    for patch in patches:
        patch.start()
    try:
        loss, met = model.loss(params, batch)
        (met[run["grad_of"]] if "grad_of" in run else loss).backward()
    finally:
        for patch in patches:
            patch.stop()
    fill_missing_grads(named)
    if run.get("schemes"):
        out["schemes"] = _scheme_gaps(mesh, sync.pctx, named, run["schemes"])
    step0 = sync.metrics({"loss": loss.detach(),
                          **{k: v.detach() for k, v in met.items()}})
    out["step0"] = {k: float(v) for k, v in step0.items()}
    grads = sync({n: p.grad for n, p in named.items()})
    out["step0"]["grad_norm"] = float(sync.global_norm(grads))
    if run.get("grads"):
        out["grads"] = _global_grads(sync, params)
    if run.get("one_rank") is not None:
        whole = _global_grads(sync, params, host=False)
        whole32 = _fp32_grads(model.cfg, sync, params, batch)
        if mesh.rank == 0:
            out["one_rank"] = _against_one_rank(model.cfg, batch, whole,
                                                run["one_rank"], whole32)
        del whole, whole32
    for p in named.values():
        p.grad = None
    return out


def _remat_twin(model, params, batch: dict, dev) -> dict:
    """The step-0 forward and backward of ``model`` under ``remat`` "none",
    then "full", on the same weights and batch, without an update: per
    setting the loss, the kernel launches, each raw gradient's
    :func:`leaf_digest` and, on the card, the step's
    ``max_memory_allocated`` in GB (its peak, weights included)."""
    from repro_torch.runtime.trainer import fill_missing_grads, trainable
    named = trainable(params)
    out = {}
    for remat in ("none", "full"):
        step = dataclasses.replace(
            model, pctx=dataclasses.replace(model.pctx, remat=remat))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        loss, _ = step.loss(params, batch)
        loss.backward()
        fill_missing_grads(named)
        out[remat] = {"loss": float(loss.detach()), "launches": ops.launches(),
                      "digest": {n: leaf_digest(p.grad)
                                 for n, p in named.items()}}
        if dev.type == "cuda":
            out[remat]["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        for p in named.values():
            p.grad = None
    return out


def _global_grads(sync, params, host: bool = True) -> dict:
    """Rank 0: every gradient at its global shape (numpy fp32, or with
    ``host`` False a tensor on the gradient's device in its dtype), the
    experts and model-axis blocks gathered; the others: an empty dict."""
    layout = ShardLayout(params, sync.pctx)
    out = {}
    for name, p in params.named_parameters():
        whole = layout.gather(f"params/{name}", p.grad)
        if whole is not None:
            out[name] = whole.float().cpu().numpy() if host else whole
    return out


def global_state(layout, tree) -> dict:
    """Rank 0: every leaf of a checkpointed tree (parameters, optimizer
    state, step) at its global shape, by its path, as fp32 numpy (every
    rank calls it; the others get an empty dict)."""
    from repro_torch.checkpoint.store import _flatten_with_paths
    out = {}
    for key, leaf in _flatten_with_paths(tree):
        whole = layout.gather(key, leaf)
        if whole is not None:
            out[key] = whole.detach().float().cpu().numpy()
    return out


def _plain_kernels():
    """The kernel ops patched to their plain versions (fp32 on the card)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.mamba2_scan import mamba2_scan_plain
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
    return mock.patch.multiple(ops, flash_attention=flash_attention_plain,
                               mamba2_scan=mamba2_scan_plain,
                               rwkv6_scan=rwkv6_scan_plain)


def _fp32_grads(cfg, sync, params, batch: dict) -> dict:
    """Every rank's step-0 gradients of an fp32 copy of its own weights,
    through the kernels' plain versions over the same mesh, gathered to
    their global shapes on rank 0 (tensors on its device; an empty dict
    on the others): the ranks' model-axis backward where no dtype makes
    its gradients ill-conditioned."""
    from repro_torch.models.api import param_module
    from repro_torch.runtime.trainer import fill_missing_grads, trainable
    dev = next(params.parameters()).device
    wide = sharding.shard_fsdp(param_module(
        cfg, device=dev, dtype=torch.float32, pctx=sync.pctx), cfg, sync.pctx)
    wide.load_state_dict(params.state_dict())
    named = trainable(wide)
    with _plain_kernels():
        loss, _ = build_model(cfg, device=dev, dtype=torch.float32,
                              pctx=sync.pctx).loss(wide, batch)
        loss.backward()
    fill_missing_grads(named)
    sync({n: p.grad for n, p in named.items()})
    out = _global_grads(sync, wide, host=False)
    del wide, named, loss
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def cosines(a: dict, b: dict) -> dict:
    """Each gradient's cosine of ``a`` to ``b`` (in fp64, a leaf at a
    time), None where both are zero (a leaf the loss does not reach: not
    compared)."""
    out = {}
    for n in b:
        x, y = a[n].double().flatten(), b[n].double().flatten()
        out[n] = (float(x @ y / (x.norm() * y.norm()))
                  if x.any() or y.any() else None)
        del x, y
    return out


def _against_one_rank(cfg, batch: dict, grads: dict, seed: int,
                      grads32: dict) -> dict:
    """One rank's step-0 loss and gradients of ``cfg`` (weights drawn from
    ``seed`` on this rank's device, as every rank draws them whole and
    keeps its cut) on the whole batch ``batch`` (a model rank's rows are
    the whole batch when the data axis has one rank), against the
    gathered ``grads``: the loss and each gradient's cosine
    (:func:`cosines`).  Also how well the model's dtype conditions its
    gradients: the cosine of each of one rank's gradients to those of the
    same weights in fp32 through the kernels' plain versions
    (``conditioning``); and the ranks' own fp32 gradients ``grads32``
    (:func:`_fp32_grads`) against those (``cosines_fp32``)."""
    from repro_torch.models.api import param_module
    from repro_torch.runtime.trainer import fill_missing_grads, trainable
    dev = next(iter(grads.values())).device

    def step(params, dtype) -> tuple:
        named = trainable(params)
        loss, _ = build_model(cfg, device=dev, dtype=dtype).loss(params,
                                                                 batch)
        loss.backward()
        fill_missing_grads(named)
        return loss.item(), {n: p.grad for n, p in named.items()}
    dtype = next(iter(grads.values())).dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = build_model(cfg, device=dev, dtype=dtype).init(gen)
    loss, mine = step(params, dtype)
    out = {"loss": loss, "cosines": cosines(grads, mine)}
    wide = param_module(cfg, device=dev, dtype=torch.float32)
    wide.load_state_dict(params.state_dict())
    del params
    with _plain_kernels():
        out["fp32_loss"], exact = step(wide, torch.float32)
    out["conditioning"] = cosines(mine, exact)
    out["cosines_fp32"] = cosines(grads32, exact)
    del wide, mine, exact
    gc.collect()
    return out


def train_worker(rank: int, spec: dict) -> None:
    """One rank of ``spec["cfg"]`` trained over the (pods, ep, tp) mesh for
    each run of ``spec["runs"]``, set up by ``launch.train.build_training``
    as ``launch.train`` sets it up: the weights from ``spec["weights"]``
    (the reference's parameters as numpy) or drawn from ``spec["seed"]``;
    the global batch ``spec["batch"]`` x ``spec["seq"]`` of ``SyntheticLM``
    seed 0, this rank's rows; AdamW on a cosine schedule at ``spec["lr"]``
    (warm-up 1) for ``spec["steps"]`` steps through ``Trainer``.

    A run may name its own ``cfg`` and ``weights``.  Its context is
    :func:`run_context`'s with ``seq_parallel`` (default on), ``fsdp``
    (default on, the reference's) and ``remat`` (default "none"), and it
    clips at ``max_grad_norm`` (default 1.0); under
    ``policy`` "auto" the train program's plan is bound and the gradient
    mean runs its ``grad_sync`` verdict (the ring under "fixed");
    ``grads`` first
    records the step-0 gradients after the sync, gathered to their global
    shapes on rank 0, and the step-0 losses, without updating (the
    gradients of ``grad_of``, "ce" or "aux", instead of the loss's when
    the run names it);
    ``state`` records every leaf of the trained state (parameters, AdamW
    state) at its global shape on rank 0 (:func:`global_state`), and
    ``resave`` (a directory) checkpoints the state there at the end of the
    run (after a ``restore`` and no steps: the restored state);
    ``check_kernels`` holds each backward kernel of that step against its
    plain version on the same inputs (:func:`_checked_backwards`);
    ``one_rank`` (a seed) has rank 0 run that step on one rank of the
    seed's weights and hold the gathered gradients to it
    (:func:`_against_one_rank`); ``remat_twin`` runs that step's forward
    and backward under ``remat`` "none" and "full" (:func:`_remat_twin`); ``ckpt`` (``{"dir", "every"}``) checkpoints; ``restore`` (a
    directory) resumes from its latest checkpoint; ``fabric="measured"``
    plans on the fabric :func:`measure_link` timed (``spec["measure_link"]``
    bytes a rank).  A run's ``schemes``
    (leaf names) reduces the step-0 gradients of those leaves once by each
    scheme (:func:`_scheme_gaps`).  Per run it records the history
    (losses, grad norms, each step's parts in ms), the kernel launches,
    the resolved scheme, bytes (all-reduced a step, and by part:
    ``GradSync.bytes_parts``) and G of the sync, the rank's weight,
    gradient (as autograd made them) and AdamW-state bytes
    (``state_bytes``), on the card the peak of its steps alone
    (``step_peak_bytes``) and of the whole run (``peak_gb``), the rank's
    mesh coordinates, the FSDP shards (``fsdp``: under the context's
    ``fsdp`` over more than one data rank, ``sharding.shard_fsdp``), and a
    digest of every leaf and of every segment of a split leaf that each
    model rank holds whole (``GradSync.whole_parts``), these listed with
    the replicated leaves (``data_replicated`` for an FSDP shard's)."""
    mesh = init_rank(rank, spec)
    results = _train(mesh, rank, rank_device(rank, spec), spec)
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, results)


def _train(mesh: RankMesh, rank: int, dev, spec: dict) -> dict:
    """:func:`train_worker`'s work on the joined mesh: the rank's
    results."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, \
        batch_for_model
    from repro_torch.launch.train import build_training
    from repro_torch.models.api import param_count
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    dtype = spec["dtype"]
    results = {"rank": rank, "device": str(dev), "runs": {},
               "coords": dict(mesh.coords)}
    phases = {"train": (spec["batch"], spec["seq"])}
    fabric = None
    if spec.get("measure_link"):
        rate = measure_link(mesh, spec["measure_link"], dev)
        fabric = fabric_spec(spec["pods"], spec["ep"], rate)
        results["link"] = {"bytes": spec["measure_link"], "pair_rate": rate,
                           "fabric": fabric}
    for run in spec["runs"]:
        label = run["label"]
        t0 = time.monotonic()
        cfg = run.get("cfg", spec["cfg"])
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                      global_batch=spec["batch"], seed=0))
        if run.get("fabric") == "measured":
            if fabric is None:
                raise ValueError("fabric 'measured' needs measure_link")
            run = dict(run, fabric=fabric)
        steps = run.get("steps", spec["steps"])
        pctx = run_context(mesh, spec["pods"], run)
        pctx = dataclasses.replace(
            pctx, seq_parallel=run.get("seq_parallel", True),
            fsdp=run.get("fsdp", True), remat=run.get("remat", pctx.remat))
        built = build_training(
            cfg, pctx, batch=spec["batch"],
            seq=spec["seq"], dtype=dtype, device=dev, lr=spec["lr"],
            steps=spec["steps"], warmup=1, seed=spec.get("seed", 0),
            weights=run.get("weights", spec.get("weights")),
            max_grad_norm=run.get("max_grad_norm", 1.0))
        pctx, params, sync = built.pctx, built.params, built.sync
        decision = built.decision
        if dev.type == "cuda":          # the draws' fp32 temporaries
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        res = results["runs"][label] = {
            "scheme": sync.scheme, "sync_bytes": sync.bytes,
            "sync_parts": sync.bytes_parts,
            "sync_g": (decision.shard_map_kwargs.get("microbatch", 1)
                       if decision is not None else 1),
            "decision": (None if decision is None else decision.plan),
            "dp": pctx.dp_size,
            "params": param_count(params),
            "moe": resolved(pctx, cfg, phases, dtype.itemsize)}

        def make_batch(step):
            return batch_for_model(cfg, data.batch(step), device=dev,
                                   pctx=pctx)
        if run.get("grads") or run.get("check_kernels") or \
                run.get("schemes") or run.get("one_rank") is not None:
            res.update(_step0(mesh, built.model, params, sync, make_batch(0),
                              run))
        before = 0          # the run's peak so far: the twin resets it
        if run.get("remat_twin"):
            if dev.type == "cuda":
                before = torch.cuda.max_memory_allocated(dev)
            res["remat"] = _remat_twin(built.model, params, make_batch(0),
                                       dev)
        ckpt = run.get("ckpt") or {}
        directory = run.get("restore") or ckpt.get("dir")
        trainer = Trainer(
            built.model, built.opt, make_batch,
            TrainerConfig(total_steps=steps,
                          checkpoint_every=ckpt.get("every", 1 << 30),
                          checkpoint_dir=directory, log_every=1 << 30),
            params=params, train_step=built.train_step)
        res["start_step"] = trainer.state.step
        if run.get("restore"):
            trainer.ckpt = None             # continue without saving
        named = trainer.state.named()
        made = {}                           # each gradient as autograd made it
        hooks = [p.register_post_accumulate_grad_hook(
            lambda p, n=n: made.__setitem__(
                n, p.grad.numel() * p.grad.element_size()))
            for n, p in named.items()]
        if dev.type == "cuda":          # the steps' own peak from here
            before = max(before, torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        res["history"] = trainer.run()
        res["launches"] = ops.launches()
        if dev.type == "cuda":
            res["step_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        for hook in hooks:
            hook.remove()
        res["state_bytes"] = {
            "weights": sum(p.numel() * p.element_size()
                           for p in named.values()),
            "grads": sum(made.values()),
            "opt_state": sum(t.numel() * t.element_size() for t in
                             torch.utils._pytree.tree_leaves(
                                 trainer.state.opt_state)
                             if isinstance(t, torch.Tensor))}
        res["shapes"] = {n: tuple(p.shape) for n, p in named.items()}
        if run.get("state") or run.get("resave"):
            layout = ShardLayout(params, pctx)
            if run.get("state"):
                res["state"] = global_state(layout, trainer.state.tree())
            if run.get("resave"):
                CheckpointManager(run["resave"], layout=layout).save(
                    trainer.state.step, trainer.state.tree())
        res["digest"] = {n: leaf_digest(p)
                         for n, p in params.named_parameters()}
        res["fsdp"] = sorted(sync.fsdp)
        res["coords"] = dict(mesh.coords)
        res["replicated"] = sorted(n for n in res["digest"]
                                   if n not in sync.expert
                                   and n not in sync.split
                                   and n not in sync.fsdp)
        # the segments of a split leaf that every model rank holds whole
        # (Mamba2's in_proj B/C columns), meant to stay the same bits too:
        # on every rank, or, of an FSDP shard (cut over ``data`` along
        # another dim), on every rank of its data coordinate
        named = dict(params.named_parameters())
        res["data_replicated"] = []
        for n, (dim, local) in sync.whole_parts.items():
            for lo, hi in local:
                key = f"{n}[{dim}:{lo}:{hi}]"
                res["digest"][key] = leaf_digest(
                    named[n].narrow(dim, lo, hi - lo))
                res["data_replicated" if n in sync.fsdp
                    else "replicated"].append(key)
        res["split"] = sorted(sync.split)
        if dev.type == "cuda":
            res["peak_gb"] = max(before, res["step_peak_bytes"]) / 1e9
        res["staging"] = mesh.staging_bytes()
        res["seconds"] = time.monotonic() - t0
        mark(f"run {label}")
        del trainer, params, sync, built
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


ATTN_BWD_TOL = dict(atol=2e-2, rtol=2e-2)     # as chip_smoke's phase 10
# the loss's own cotangent: each of dq, dk, dv within this share of its
# largest element (the loss's gradients are far below ATTN_BWD_TOL's atol)
ATTN_BWD_REL = 2e-2


def attention_bwd_check(backward, ctx, grad_out: torch.Tensor) -> tuple:
    """Hold ``backward(ctx, cotangent)`` (attention's autograd backward on
    the saved q, k, v, output and lse) against autograd of the plain
    forward in fp32 on the same inputs, twice: for a unit-scale randn
    cotangent (seed 0) of ``grad_out``'s layout, each of dq, dk, dv within
    ``ATTN_BWD_TOL`` as phase 10 holds it; for ``grad_out`` itself, each
    within ``ATTN_BWD_REL`` of its largest element.  Returns (the
    backward's result for ``grad_out``, the unit cotangent's max |err|, the
    largest of grad_out's three errors relative to their scales, whether
    the unit cotangent's are within ``ATTN_BWD_TOL``)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _, _ = ctx.saved_tensors
    causal, window, softcap, scale = ctx.mask
    gen = torch.Generator(device=grad_out.device)
    gen.manual_seed(0)
    unit = torch.empty_like(grad_out)
    unit.copy_(torch.randn(grad_out.shape, generator=gen,
                           device=grad_out.device))
    with torch.enable_grad():
        leaves = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
        plain = fa.flash_attention_plain(*leaves, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale)
        want_unit = torch.autograd.grad(plain, leaves, unit.float(),
                                        retain_graph=True)
        want = torch.autograd.grad(plain, leaves, grad_out.float())
    got_unit = backward(ctx, unit)[:3]
    out = backward(ctx, grad_out)
    err = max(float((a.float() - e).abs().max())
              for a, e in zip(got_unit, want_unit))
    held = all(torch.allclose(a.float(), e, **ATTN_BWD_TOL)
               for a, e in zip(got_unit, want_unit))
    rel = 0.0
    for a, e in zip(out[:3], want):
        big = float(e.abs().max())
        gap = float((a.float() - e).abs().max())
        rel = max(rel, gap / big if big > 0 else float("inf"))
    return out, err, rel, held


SCAN_BWD_REL = 5e-2     # as chip_smoke's phase 10: of each gradient's max


def _scan_bwd_check(name: str, got: tuple, plain, inputs: tuple) -> tuple:
    """A scan's backward kernel result ``got`` against its plain version
    ``plain`` on the same inputs in fp32: (max |err|, the largest error
    relative to its gradient's largest element)."""
    want = plain(*(None if t is None else t.float() for t in inputs))
    err = rel = 0.0
    for a, e in zip(got, want):
        gap = float((a.float() - e).abs().max())
        big = float(e.abs().max())
        err = max(err, gap)
        rel = max(rel, gap / big if big > 0 else (0.0 if gap == 0 else
                                                  float("inf")))
    return err, rel


def sdpa_bwd_rel(ctx, grad_out: torch.Tensor):
    """The yardstick of :func:`attention_bwd_check`'s relative error under
    the loss's own cotangent: the backward of
    ``scaled_dot_product_attention`` in the saved tensors' dtype on the
    same q, k, v and cotangent, its largest error against autograd of the
    plain forward in fp32 relative to each gradient's largest element
    (None where the mask has a window or a softcap SDPA does not take)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    q, k, v = ctx.saved_tensors[:3]
    causal, window, softcap, scale = ctx.mask
    if window is not None or softcap is not None:
        return None
    with torch.enable_grad():
        exact = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
        want = torch.autograd.grad(fa.flash_attention_plain(
            *exact, causal=causal, scale=scale), exact, grad_out.float())
        lib = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        got = torch.autograd.grad(F.scaled_dot_product_attention(
            *lib, is_causal=causal, scale=scale, enable_gqa=True), lib,
            grad_out.to(q.dtype))
    return max(float((a.float() - e).abs().max() / e.abs().max())
               for a, e in zip(got, want))


def _checked_backwards(record: list):
    """Patches of the kernels' autograd backward that hold each call's
    result, as the path goes on with it, against the plain version on the
    same inputs and append ``(kernel, shape, max |err|, held, relative
    err)`` to ``record``: the pack's backward bit-exact against
    ``ref.pack_bwd_ref`` (its error relative to the largest element);
    attention's by :func:`attention_bwd_check`, and where only its
    relative error misses ``ATTN_BWD_REL``, SDPA's relative error on the
    same inputs as ``("sdpa_bwd", shape, rel, True, rel)``
    (:func:`sdpa_bwd_rel`); each scan's against its plain backward on the inputs in fp32, every gradient within
    ``SCAN_BWD_REL`` of its largest element; attention and the scans each
    shape once.  The attention check launches the backward once more, for
    its unit cotangent."""
    from repro_torch.kernels import dispatch_pack as dp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6
    pack_bwd, attn_bwd = dp._Pack.backward, fa._Attention.backward
    scan_bwds = {m2._Mamba2Scan: ("mamba2_scan_bwd", m2._Mamba2Scan.backward,
                                  m2.mamba2_scan_bwd_plain),
                 r6._RWKV6Scan: ("rwkv6_scan_bwd", r6._RWKV6Scan.backward,
                                 _rwkv6_bwd_plain)}
    seen = set()

    def pack(ctx, grad_out, grad_idx):
        out = pack_bwd(ctx, grad_out, grad_idx)
        (src_idx,) = ctx.saved_tensors
        want = ref.pack_bwd_ref(grad_out, src_idx, ctx.rows)
        err = float((out[0].float() - want.float()).abs().max())
        big = float(want.float().abs().max())
        record.append(("dispatch_pack_bwd", tuple(grad_out.shape), err,
                       _same_bits(out[0], want), err / big if big else err))
        return out

    def attention(ctx, grad_out):
        q, k = ctx.saved_tensors[:2]
        if tuple(q.shape) in seen:
            return attn_bwd(ctx, grad_out)
        seen.add(tuple(q.shape))
        out, err, rel, unit = attention_bwd_check(attn_bwd, ctx, grad_out)
        shape = tuple(q.shape) + (k.shape[1],)
        record.append(("flash_attention_bwd", shape, err,
                       unit and rel <= ATTN_BWD_REL, rel))
        if unit and rel > ATTN_BWD_REL:
            lib = sdpa_bwd_rel(ctx, grad_out)
            if lib is not None:
                record.append(("sdpa_bwd", shape, lib, True, lib))
        return out

    def scan(fn):
        name, backward, plain = scan_bwds[fn]

        def check(ctx, dy, dstate):
            out = backward(ctx, dy, dstate)
            x = ctx.saved_tensors[0]
            if (name, tuple(x.shape)) in seen:
                return out
            seen.add((name, tuple(x.shape)))
            dy = torch.zeros_like(x if fn is m2._Mamba2Scan
                                  else ctx.saved_tensors[2]) \
                if dy is None else dy
            err, rel = _scan_bwd_check(name, out, plain, (
                *ctx.saved_tensors, dy, dstate))
            record.append((name, tuple(x.shape), err, rel <= SCAN_BWD_REL,
                           rel))
            return out
        return check

    return [mock.patch.object(dp._Pack, "backward", staticmethod(pack)),
            mock.patch.object(fa._Attention, "backward",
                              staticmethod(attention))] + [
        mock.patch.object(fn, "backward", staticmethod(scan(fn)))
        for fn in scan_bwds]


def _rwkv6_bwd_plain(r, k, v, logw, u, dy, dstate=None):
    """RWKV-6's plain backward (the CPU path of ``rwkv6_scan_bwd``) on any
    device."""
    from repro_torch.kernels.rwkv6_scan import PLAIN_CHUNK
    return ref.rwkv6_chunked_bwd(r, k, v, logw, u, dy, dstate,
                                 chunk=PLAIN_CHUNK)


def _scheme_gaps(mesh: RankMesh, pctx, named: dict, leaves) -> dict:
    """The step-0 gradients of ``leaves`` (their first 8 M elements, fp32)
    reduced once by each scheme of ``planned_psum`` over the data-parallel
    axes: each scheme's largest gap to the fp64 mean of every rank's
    gradients (gathered), relative to the mean's largest magnitude, the
    bound it is held to in the same unit (fp32 sum order for the lossless
    schemes, the int8 tolerance for ``compressed``) and its wall (ms, this
    rank)."""
    out = {}
    parts = [named[n].grad.reshape(-1)[:1 << 23].float() for n in leaves]
    wanted, biggest = [], []
    for part in parts:
        every = mesh.all_gather(part, pctx.dp_axes)
        wanted.append(every.double().mean(dim=0))
        biggest.append(float(every.abs().max()))
        del every
    for scheme in REDUCE_SCHEMES:
        gap = bound = 0.0
        _sync(part.device)
        t0 = time.perf_counter()
        means = [cl.planned_psum(part, mesh, pctx.dp_axes,
                                 num_servers=pctx.num_servers,
                                 reduce_scheme=scheme) for part in parts]
        _sync(part.device)
        wall = (time.perf_counter() - t0) * 1e3
        for mean, want, big in zip(means, wanted, biggest):
            scale = max(float(want.abs().max()), 1e-30)
            gap = max(gap, float((mean.double() - want).abs().max()) / scale)
            # fp32 sums of R terms: R ulps of the largest term; int8: two
            # quantisation steps of the largest term and of the mean
            bound = max(bound, (
                2 * (big / 127 + scale / 127) if scheme == "compressed"
                else mesh.axis_size(*pctx.dp_axes)
                * float(torch.finfo(torch.float32).eps) * big) / scale)
        out[scheme] = {"gap": gap, "bound": bound, "ms": wall}
    return out


# the exchanges :func:`exchange_worker` differentiates, over a model axis
# of 4 ranks: name -> (kind, arguments); the ppermute leaves rank 3 out
EXCHANGE_PERM = ((0, 1), (1, 2), (2, 0))
EXCHANGES = {"all_to_all": (), "all_gather": (), "ppermute": (),
             "reduce_scatter": (), "mean": (),
             "gather_reference": (2,),
             "gather_paired": (0.25, "paired"),
             "gather_full": (0.25, "full")}


def exchange(name: str, x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """One exchange of :data:`EXCHANGES` of x over the model axis."""
    from repro_torch.parallel import mesh as mesh_ops
    group, n = mesh.group("model"), mesh.axis_size("model")
    args = EXCHANGES[name]
    if name == "all_to_all":
        return mesh_ops.all_to_all(x, group)
    if name == "all_gather":
        return mesh.all_gather(x, "model")
    if name == "ppermute":
        return mesh.ppermute(x, "model", EXCHANGE_PERM)
    if name == "reduce_scatter":
        return mesh_ops.reduce_scatter(x, group, n)
    if name == "mean":
        return mesh_ops.mean(x, group, n)
    if name == "gather_reference":
        return cl.allgather_reference(x, mesh, "model", *args)
    split, mode = args
    return cl.multiwrite_allgather(x, mesh, "model", split=split, mode=mode)


def exchange_worker(rank: int, spec: dict) -> None:
    """Each exchange of :data:`EXCHANGES` on this rank's block of
    ``spec["inputs"]`` (an ``.npz``: ``x`` [ranks, ...] and per exchange
    ``<name>/ct`` [ranks, ...], each rank's cotangent of its output): the
    output and the input's gradient.  Then the Megatron pair on a model
    axis where every rank computes the same loss: ``y = g(f(h) @ w1_r)
    @ w2_r`` summed, ``loss = sum(y * c)`` from ``spec["fg"]`` (``h``,
    ``w1`` [D, F], ``w2`` [F, D], ``c``; rank r's column block of w1 and
    row block of w2), with *f*/*g* (``fg``) and with
    ``torch.distributed.nn.functional.all_reduce`` in place of *g* and no
    *f* (``nn``): the gradients of ``h``, ``w1`` and ``w2``."""
    import torch.distributed.nn.functional as dist_nn

    from repro_torch.models import layers as L
    mesh = init_rank(rank, spec)
    data = np.load(spec["inputs"])
    results = {}
    for name in EXCHANGES:
        x = torch.from_numpy(data["x"][rank]).requires_grad_(True)
        y = exchange(name, x, mesh)
        y.backward(torch.from_numpy(data[f"{name}/ct"][rank]))
        results[name] = {"y": y.detach().numpy(), "dx": x.grad.numpy()}
    fg = {k: torch.from_numpy(v) for k, v in spec["fg"].items()}
    n = mesh.axis_size("model")
    part = fg["w1"].shape[1] // n
    cols = slice(rank * part, (rank + 1) * part)
    pctx = ParallelContext(mesh)
    for how in ("fg", "nn"):
        h = fg["h"].clone().requires_grad_(True)
        w1 = fg["w1"][:, cols].clone().requires_grad_(True)
        w2 = fg["w2"][cols].clone().requires_grad_(True)
        if how == "fg":
            y = L.reduce_over_model(torch.tanh(L.to_model(h, pctx) @ w1)
                                    @ w2, pctx)
        else:
            y = dist_nn.all_reduce(torch.tanh(h @ w1) @ w2,
                                   group=process_group(mesh.group("model")))
        (y * fg["c"]).sum().backward()
        results[how] = {"h": h.grad.numpy(), "w1": w1.grad.numpy(),
                        "w2": w2.grad.numpy()}
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, results)


def psum_worker(rank: int, spec: dict) -> None:
    """:func:`psum_checks` of ``spec["psum"]`` (an input [ranks, N]) over
    the data-parallel axes of the (pods, ep) mesh; also the pod-aware
    ``hierarchical_psum`` over (pod, data), and ``tree_compressed_psum``
    of a dict of two leaves cut from the input (the first 600 elements as
    [20, 30], the rest flat) with its residuals."""
    from repro_torch.parallel.compression import (hierarchical_psum,
                                                  tree_compressed_psum)
    mesh = init_rank(rank, spec)
    dev = rank_device(rank, spec)
    axes = ("pod", "data")
    results = psum_checks(mesh, spec["psum"], dev, axes=axes,
                          **spec.get("psum_kw", {}))
    g = torch.from_numpy(np.ascontiguousarray(
        spec["psum"][mesh.axis_index(*axes)])).to(dev)
    if spec["pods"] > 1 and spec["ep"] > 1:
        results["pod_aware"] = hierarchical_psum(g, mesh, "pod",
                                                 "data").cpu().numpy()
    means, errs = tree_compressed_psum(
        {"a": g[:600].reshape(20, 30), "b": g[600:]}, mesh, axes)
    results["tree_compressed"] = {
        k: (means[k].cpu().numpy(), errs[k].cpu().numpy()) for k in means}
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, results)


# ---------------------------------------------------------------------------
# the card transport against gloo on the same ranks
# ---------------------------------------------------------------------------

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32, "bool": torch.bool}
# unit roundoff of a sum's dtype: (n - 1) u sum|x| bounds a sum of n terms
# added one after another (the recursive summation bound)
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}


def case_input(case: dict, member: int, device, seed: int = 0
               ) -> torch.Tensor:
    """Member ``member``'s input of a :func:`transport_check` case, drawn
    from ``seed``, the case's ``index`` and the member: every rank can draw
    every member's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + case["index"] * 1009 + member)
    dtype, shape = DTYPES[case["dtype"]], tuple(case["shape"])
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=gen,
                             device=device).bool()
    return torch.randint(-(1 << 20), 1 << 20, shape, generator=gen,
                         device=device, dtype=dtype)


def _collective(kind: str, x: torch.Tensor, group, n: int, me: int):
    if kind == "all_to_all":
        return mesh_ops._all_to_all(x, group)
    if kind == "all_gather":
        return mesh_ops._all_gather(x, group, n)
    if kind == "reduce_scatter":
        return mesh_ops._reduce_scatter(x, group, n)
    if kind == "all_reduce":
        return mesh_ops._all_reduce_(x.clone(), group)
    if kind == "ppermute":           # each member to the next
        perm = [(i, (i + 1) % n) for i in range(n)]
        return mesh_ops._ppermute(x, group, n, me, dict(perm),
                                  {d: s for s, d in perm})
    raise ValueError(kind)


def _sum_check(case: dict, got: torch.Tensor, n: int, me: int, device,
               seed: int) -> dict:
    """A sum's output against every member's input drawn again here: the
    bits of the sum in group-rank order in the dtype, and the largest
    error against the fp64 sum beside the recursive summation bound
    ``(n - 1) u sum|x|``, in pieces of 16 M elements."""
    parts = [case_input(case, m, device, seed) for m in range(n)]
    if case["kind"] == "reduce_scatter":
        parts = [p[me] for p in parts]
    order = parts[0].clone()
    for p in parts[1:]:
        order += p
    u = UNIT_ROUNDOFF[got.dtype]
    flat = [p.reshape(-1) for p in parts]
    g = got.reshape(-1)
    err, over, step = 0.0, 0, 1 << 24
    for lo in range(0, g.numel(), step):
        hi = min(g.numel(), lo + step)
        exact = sum(f[lo:hi].double() for f in flat)
        mag = sum(f[lo:hi].double().abs() for f in flat)
        e = (g[lo:hi].double() - exact).abs()
        err = max(err, float(e.max()))
        over += int((e > (n - 1) * u * mag).sum())
    return {"rank_order": _same_bits(got, order), "fp64_err": err,
            "over_bound": over}


def _digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def _slowest_ms(wall: float, group) -> float:
    """The largest of the group's walls (seconds -> ms), over gloo."""
    t = torch.tensor([wall], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=process_group(group))
    return float(t) * 1e3


def transport_check(meshes: dict, device, cases: list, *, seed: int = 0,
                    reps: int = 3, barriers: int = 0) -> dict:
    """Each case of ``cases`` run on the card transport and on gloo, on the
    same ranks.  A case: ``name``, ``kind`` (all_to_all, all_gather,
    reduce_scatter, all_reduce, ppermute: each member to the next),
    ``mesh`` (a key of ``meshes``, card-transport ``RankMesh`` es of the
    one world), ``axis`` and ``members`` (blocks of the axis's
    coordinates, each rank in the one that holds it; default: the whole
    axis),
    ``shape`` (a member's input) and ``dtype``; a card-transport mesh
    lends each group its gloo subgroup (``pg``); its input drawn by
    :func:`case_input`.  Per case: the card's output bit for bit against
    gloo's (``same_bits``; gloo runs the group's own gloo subgroup), for a
    sum also :func:`_sum_check` and the output's digest (every member's
    must agree for an all-reduce), and the walls of the slowest member
    (ms): gloo's one call, the card's median of ``reps`` after a first
    call.  With ``barriers``, the cost of one barrier of the first mesh's
    world: ``barriers`` of the card transport's flags and a tenth as many
    of gloo's own (us, the slowest rank's mean)."""
    out = {"cases": {}}
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    for index, case in enumerate(cases):
        case = dict(case, index=index)
        mesh = meshes[case["mesh"]]
        names = axis_names(case["axis"])
        group = mesh.group(*names)
        if case.get("members") is not None:     # the block holding me
            group = mesh.subgroup(names, next(
                m for m in case["members"] if mesh.axis_index(*names) in m))
        n, me = group.size, group.me
        x = case_input(case, me, device, seed)
        sync()
        dist.barrier(group=group.pg)
        t0 = time.perf_counter()
        ref = _collective(case["kind"], x, group.pg, n, me)
        sync()
        gloo_ms = _slowest_ms(time.perf_counter() - t0, group)
        got = _collective(case["kind"], x, group, n, me)
        walls = []
        for _ in range(reps):
            sync()
            dist.barrier(group=group.pg)
            t0 = time.perf_counter()
            again = _collective(case["kind"], x, group, n, me)
            sync()
            walls.append(time.perf_counter() - t0)
            same = _same_bits(again, got)
            del again
            if not same:
                raise AssertionError(f"{case['name']}: two card calls differ")
        res = {"kind": case["kind"], "group": list(group.ranks),
               "shape": tuple(x.shape), "dtype": case["dtype"],
               "bytes": x.numel() * x.element_size(),
               "same_bits": _same_bits(got, ref), "gloo_ms": gloo_ms,
               "card_ms": _slowest_ms(float(np.median(walls)), group)}
        if case["kind"] in ("all_reduce", "reduce_scatter"):
            res.update(_sum_check(case, got, n, me, device, seed),
                       digest=_digest(got))
            res["gloo_fp64_err"] = _sum_check(case, ref, n, me, device,
                                              seed)["fp64_err"]
        out["cases"][case["name"]] = res
        del x, ref, got
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if barriers:
        world = next(iter(meshes.values())).world_group()
        world.barrier()
        t0 = time.perf_counter()
        for _ in range(barriers):
            world.barrier()
        card_us = (time.perf_counter() - t0) / barriers
        k = max(1, barriers // 10)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(k):
            dist.barrier()
        gloo_us = (time.perf_counter() - t0) / k
        out["barrier_us"] = {"card": _slowest_ms(card_us, world) * 1e3,
                             "gloo": _slowest_ms(gloo_us, world) * 1e3,
                             "card_n": barriers, "gloo_n": k}
    out["staging"] = {str(key): m.staging_bytes()
                      for key, m in meshes.items()}
    return out


def card_transport_worker(rank: int, spec: dict) -> None:
    """The card transport held against gloo on the same ranks (``spec``'s
    world over gloo, ``spec["transport"]`` ignored): :func:`transport_check`
    of ``spec["cases"]`` on card meshes of the shapes the cases name
    (``spec["barriers"]`` too; ``spec["piece_bytes"]``, default
    ``mesh.PIECE_BYTES``, is the card meshes' piece); with ``spec["exchanges"]`` (the inputs of
    :func:`exchange_worker`) every exchange of :data:`EXCHANGES` and its
    gradient over the model axis of (1, 1, 4) on each transport; with
    ``spec["serve"]`` (a spec update) that model served by :func:`_serve`
    over 2 x 2 on each transport; with ``spec["train"]`` that training run
    by :func:`_train` over (1, 2, 2) on each.  Results by transport
    ("gloo", "card")."""
    base = init_rank(rank, dict(spec, transport="backend", pods=1, ep=1,
                                tp=spec["world"]))
    dev = rank_device(rank, spec)
    timeout = datetime.timedelta(seconds=spec["timeout_s"])

    def meshes(shape):
        return {"gloo": RankMesh(shape, timeout=timeout,
                                 dp_servers=spec.get("dp_servers", ())),
                "card": RankMesh(shape, timeout=timeout, transport="card",
                                 dp_servers=spec.get("dp_servers", ()),
                                 piece_bytes=spec.get(
                                     "piece_bytes", mesh_ops.PIECE_BYTES))}
    results: dict = {"rank": rank}
    if spec.get("cases"):
        shapes = {tuple(c["mesh"]) for c in spec["cases"]}
        card = {s: meshes(s)["card"] for s in sorted(shapes)}
        results["check"] = transport_check(card, dev, spec["cases"],
                                           barriers=spec.get("barriers", 0))
    if spec.get("exchanges"):
        data = np.load(spec["exchanges"])
        results["exchanges"] = {}
        for how, mesh in (("gloo", base), *meshes((1, 1, spec["world"]))
                          .items()):
            got = results["exchanges"].setdefault(how, {})
            for name in EXCHANGES:
                x = torch.from_numpy(data["x"][rank]).requires_grad_(True)
                y = exchange(name, x, mesh)
                y.backward(torch.from_numpy(data[f"{name}/ct"][rank]))
                got[name] = {"y": y.detach().numpy(), "dx": x.grad.numpy()}
    for key, shape, work in (("serve", (2, 2, 1), _serve),
                             ("train", (1, 2, 2), _train)):
        if not spec.get(key):
            continue
        sub = dict(spec, **spec[key], pods=shape[0], ep=shape[1],
                   tp=shape[2])
        results[key] = {}
        for how, mesh in meshes(shape).items():
            got = work(mesh, rank, dev, sub)
            results[key][how] = got[0] if key == "serve" else got
    dist.barrier()
    dist.destroy_process_group()
    _save(rank, spec, results)
