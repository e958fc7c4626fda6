"""Rank workers: one process per rank of a ``torch.distributed`` run on one
host, spawned and joined with a deadline.

``chip_smoke.py`` spawns :func:`serve_worker` as 4 ranks (2 pods x 2 ep
ranks) serving DBRX-132B on the card; the CPU tests spawn it and
:func:`dispatch_worker` as 4 gloo ranks at small sizes.  This module
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
import os
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import collectives as cl
from repro_torch.kernels import ops, ref
from repro_torch.models.api import build_model
from repro_torch.parallel.context import ParallelContext
from repro_torch.parallel.mesh import RankMesh
from repro_torch.runtime.server import ServeConfig, ServeEngine

# (moe_scheme, moe_combine) pairs the workers run, in this order
SCHEME_PAIRS = (("hierarchical", "hierarchical"),
                ("hierarchical", "baseline"),
                ("baseline", "baseline"))


def run_ranks(fn, spec: dict, *, timeout_s: float) -> list:
    """Spawn ``spec["world"]`` processes running ``fn(rank, spec)``, wait
    for all of them at most ``timeout_s`` seconds, and return each rank's
    results.  A rank that raises or dies fails the run (the others are
    terminated); so does one still running at the deadline."""
    world = spec["world"]
    out_dir = Path(spec["out_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.spawn(fn, args=(spec,), nprocs=world, join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=30)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def rank_device(rank: int, spec: dict) -> torch.device:
    """nccl: the card of the rank's index (one card a rank); gloo: the
    device the spec names, shared by every rank."""
    if spec["backend"] == "nccl":
        return torch.device("cuda", rank)
    return torch.device(spec["device"])


def init_rank(rank: int, spec: dict) -> RankMesh:
    """Join the process group and build the (pods, ep, 1) rank mesh."""
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
    return RankMesh((spec["pods"], spec["ep"], 1), timeout=timeout)


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


def _first_dispatch(record: dict):
    """Patches that keep the expert ids, state and row bytes of the first
    MoE dispatch made while they are in place."""
    def wrap(fn):
        def call(tokens, ids, gates, dcfg, mesh):
            out = fn(tokens, ids, gates, dcfg, mesh)
            if not record:
                record.update(ids=ids, state=out[2], row_bytes=tokens.shape[1]
                              * tokens.element_size())
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


def serve_worker(rank: int, spec: dict) -> None:
    """One rank of ``spec["cfg"]`` served through ``ServeEngine.generate``
    for each (scheme, combine) pair of ``spec["schemes"]``, on weights drawn
    from ``spec["seed"]`` (this rank's experts only).  Every rank passes the
    global ``spec["prompts"]``.  Per pair it records the global tokens, the
    walls, the kernel launches of the measured run, the logits of its rows
    at prefill, and the pod-group bytes of the first (prefill) dispatch.
    With ``spec["warmup"]`` an unmeasured run (a prefill and one decode
    step) comes first and holds every pack against its plain version
    (:func:`_checked_packs`); with ``spec["temperature"]`` a sampled
    ``generate`` follows the measured one, seeded from
    ``spec["sample_seed"]``."""
    mesh = init_rank(rank, spec)
    dev = rank_device(rank, spec)
    cfg, prompts = spec["cfg"], spec["prompts"]
    results = {"rank": rank, "device": str(dev), "pairs": {}}
    params = None
    for scheme, combine in spec["schemes"]:
        pctx = ParallelContext(mesh, pod_axis="pod" if spec["pods"] > 1
                               else None, moe_scheme=scheme,
                               moe_combine=combine)
        model = build_model(cfg, device=dev, dtype=spec["dtype"], pctx=pctx)
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(spec["seed"])
            params = model.init(gen)
        engine = RecordingEngine(
            model, params, ServeConfig(max_new_tokens=spec["max_new"],
                                       cache_dtype=spec["cache_dtype"]),
            device=dev, pctx=pctx)
        packs: list = []
        if spec.get("warmup"):
            with _checked_packs(packs):
                engine.generate(prompts, max_new=2)
            engine.stats.update(prefill_s=0.0, decode_s=0.0, tokens=0)
        engine.step_logits.clear()
        record: dict = {}
        patches = _first_dispatch(record)
        for patch in patches:
            patch.start()
        ops.reset_launches()
        try:
            out = engine.generate(prompts)
        finally:
            for patch in patches:
                patch.stop()
        counts = ops.launches()
        sampled = None
        if spec.get("temperature"):
            sampled = ServeEngine(
                model, params, ServeConfig(
                    max_new_tokens=spec["max_new"],
                    temperature=spec["temperature"],
                    cache_dtype=spec["cache_dtype"]),
                device=dev, pctx=pctx).generate(prompts,
                                                seed=spec["sample_seed"])
        whole, occupied = pod_send_bytes(record["state"],
                                         record["row_bytes"])
        base, mw = cl.dispatch_pod_bytes(
            record["ids"], record["state"].cfg, record["state"].mesh,
            record["row_bytes"], elem_bytes=1)
        results["pairs"][f"{scheme}+{combine}"] = {
            "tokens": out, "launches": counts,
            "prefill_s": engine.stats["prefill_s"],
            "decode_s": engine.stats["decode_s"],
            "nonfinite_logits": engine.stats["nonfinite_logits"],
            "prefill_logits": engine.step_logits[0],
            "pod_bytes": {"whole": whole, "occupied": occupied},
            "analytic_pod_bytes": {"baseline": base, "multiwrite": mw},
            "pod": mesh.coords["pod"], "packs": packs, "sampled": sampled}
    if dev.type == "cuda":
        results["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
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
    data = np.load(spec["inputs"])
    results = {}
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
    """``moe_ffn`` of layer 0 of ``spec["moe"]["cfg"]`` with a fixed pctx,
    on this rank's rows of ``spec["moe"]["x"]`` and its experts of the
    layer's reference weights ``spec["moe"]["weights"]``, for every scheme
    pair."""
    from repro_torch.models import moe as M
    job = spec["moe"]
    cfg, weights = job["cfg"], job["weights"]
    x = torch.from_numpy(job["x"])
    per = x.shape[0] // spec["world"]
    x = x[rank * per:(rank + 1) * per]
    out = {}
    for scheme, combine in SCHEME_PAIRS:
        pctx = ParallelContext(mesh, pod_axis="pod", moe_scheme=scheme,
                               moe_combine=combine)
        first, local = M.expert_shard(pctx, cfg.num_experts)
        layer = M.MoE(cfg.d_model, cfg.expert_d_ff, cfg.num_experts,
                      device="cpu", dtype=torch.float32, first=first,
                      local=local)
        with torch.no_grad():
            layer.router.copy_(torch.from_numpy(weights["router"]))
            for key in ("w1", "w3", "w2"):
                getattr(layer, key).copy_(torch.from_numpy(
                    weights[key][first:first + local]))
        y, aux = M.moe_ffn(layer, x, cfg, pctx)
        out[f"{scheme}+{combine}"] = {"y": y.numpy(), "aux": float(aux)}
    return out
