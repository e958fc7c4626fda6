"""The dry run: every (arch x shape x mesh) cell priced on the meta device.

The port's counterpart of the reference's ``src/repro/launch/dryrun.py``,
which lowers and compiles each cell for 256 or 512 forced CPU devices and
reads XLA's memory and cost analyses and its HLO.  PyTorch has no such
compiler, so the port runs its OWN model code for one rank of the
production mesh on ``torch.device("meta")``: tensors with shapes and no
storage, nothing allocated on any device.

  * the rank's model is built on ``meta`` with the cell's context over a
    :class:`~repro_torch.parallel.mesh.ShapeMesh` (the production mesh
    seen from one rank, no process group), so each module holds the
    rank's cut as it does when it runs;
  * the cell's function runs: for a train cell the training step of
    ``launch.train.build_training``: the rank's parameters FSDP-sharded
    over ``data`` (``parallel.sharding.shard_fsdp``, ZeRO-3 under the
    context's ``fsdp``: each data-cut leaf gathered whenever it is read,
    its gradient reduce-scattered), the loss, its backward, the gradient
    sync (``runtime.trainer.GradSync``) and the AdamW update
    (``runtime.trainer.make_train_step``, the optimizer state made on
    ``meta`` at the shards' shapes); for a prefill cell ``Model.prefill``
    into a cache of the prompt's length; for a decode cell one
    ``Model.decode_step`` over a cache of the shape's length;
  * under four counters:
      - FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` without its
        module tracker (:class:`Flops`) plus the kernels' own (their
        wrappers' meta branches, ``kernels/cost.py``);
      - HBM bytes: every op's inputs and outputs (the traffic of eager
        PyTorch; allocations and views move nothing), plus the kernels';
      - the peak of the live bytes, each storage counted once: the
        arguments (weights, optimizer state, batch, cache: the storages
        that exist before the step, which an in-place write or an
        ``out=`` op does not count again) plus the storages the step makes
        (:class:`Traffic`: the gradients as autograd makes them, the
        activations saved for the backward, the gathered FSDP weights, and
        transients), split by those categories at the peak;
      - collective wire bytes by mesh axis and by kind, from the
        ``ShapeMesh``'s log of every exchange the step ran: the model's,
        the FSDP gathers and reduce-scatters (``collectives["fsdp"]``) and
        the gradient sync's (``collectives["grad_sync"]``).
  * the roofline's three terms use the H100's data-sheet figures (H100
    SXM5 80GB at 700 W, labelled in every result): dense bf16 989.4
    TFLOP/s, HBM3 3.35 TB/s, NVLink 450 GB/s a direction inside a node of
    eight, 50 GB/s a GPU between nodes (the ``pod`` axis);
  * the planner's report of the cell (``planner_cell_report``), priced at
    the H100's peak unless ``peak_flops`` says otherwise.

A width that does not divide over the model axis (Qwen2-VL-2B's 12 heads
over 16 ranks) leaves its module whole on every model rank
(``layers.splits``), where the reference's GSPMD cuts the matrix's
columns in the middle of a head.  A cell that fails for another reason is
recorded as an ``error`` naming it.  Results go to
``results/dryrun_torch/``.

Usage (on the CPU; nothing is allocated):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx_132b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeSpec,
                                      cell_is_skipped, get_config,
                                      shapes_for)
from repro_torch.core.h100 import H100_BF16_PEAK_FLOPS, moe_compute_s
from repro_torch.parallel import sharding

# H100 SXM5 80GB (700 W) data-sheet figures
PEAK_FLOPS = H100_BF16_PEAK_FLOPS    # dense bf16 / card
HBM_BW = 3.35e12                     # bytes/s / card, HBM3
NVLINK_BW = 450e9                    # bytes/s / card, one direction
INTER_NODE_BW = 50e9                 # bytes/s / card between nodes
HARDWARE = ("H100 SXM5 80GB, 700 W, data sheet: 989.4 TFLOP/s dense bf16, "
            "3.35 TB/s HBM3, NVLink 450 GB/s a direction, 50 GB/s a GPU "
            "between nodes (pod axis)")

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# Named sharding/schedule variants (pctx overrides).  "mw" is the
# paper-faithful default; the rest are §Perf hillclimb levers.
# moe_microbatch="plan" derives the pipeline chunk count G from the
# planner's overlap-aware dispatch decision for the CELL's workload
# (batch, fabric, modeled expert compute) instead of a hard-coded
# preset — the knob the pipelined scoring mode genuinely tunes.
VARIANTS = {
    "mw": {},                                   # MultiWrite hierarchical EP
    "auto": {"plan_policy": "auto"},            # planner-chosen schemes
    "baseline": {"moe_scheme": "baseline"},     # unicast EP dispatch
    "nosp": {"seq_parallel": False},            # no sequence parallelism
    "selrem": {"remat": "selective"},           # selective remat
    "nofsdp": {"fsdp": False},                  # pure DP (replicated params)
    # hillclimb combos (§Perf):
    "mwopt": {"moe_deferred_tp_reduce": True,   # deferred expert-TP psum
              "moe_microbatch": "plan"},        # + planned pipeline chunks
    "mwdefer": {"moe_deferred_tp_reduce": True},
    "mwmicro": {"moe_microbatch": "plan"},
    "baseopt": {"moe_scheme": "baseline",
                "moe_deferred_tp_reduce": True, "moe_microbatch": "plan"},
}

# optimizer-moment dtype per variant (memory lever for the 1T cell)
VARIANT_OPT_DTYPE = {"mwopt": torch.bfloat16, "baseopt": torch.bfloat16}


# ---------------------------------------------------------------------------
# input shapes
# ---------------------------------------------------------------------------

def batch_shapes(cfg, shape: ShapeSpec) -> dict:
    """{name: (global shape, dtype)} of the cell's batch (the reference's
    ``batch_shapes``)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        if cfg.input_mode == "embeddings" and cfg.family != "encdec":
            return {"embeds": ((b, 1, cfg.d_model), torch.bfloat16)}
        return {"tokens": ((b, 1), i32)}
    if cfg.family == "encdec":
        return {"src_embeds": ((b, s, cfg.d_model), torch.bfloat16),
                "tgt_tokens": ((b, s), i32),
                "labels": ((b, s), i32)}
    if cfg.input_mode == "embeddings":
        return {"embeds": ((b, s, cfg.d_model), torch.bfloat16),
                "positions": ((b, s, 3), i32),
                "labels": ((b, s), i32)}
    out = {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
    if shape.kind == "prefill":
        out.pop("labels")
    return out


def model_flops_per_step(arch: str, shape: ShapeSpec) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) — the §Roofline 'useful FLOPs'."""
    from repro_torch.models.api import param_count_shape_only
    cfg = get_config(arch)
    n = param_count_shape_only(cfg)
    if cfg.is_moe:
        per_rank_share = cfg.top_k / cfg.num_experts
        # active = non-expert params + top_k/E of expert params
        expert = (cfg.n_layers - cfg.first_k_dense) * cfg.num_experts * \
            (3 * cfg.d_model * cfg.expert_d_ff)
        n = n - expert + expert * per_rank_share
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n * tokens


# ---------------------------------------------------------------------------
# the planner's report (the reference's, on the port's planner)
# ---------------------------------------------------------------------------

# Fabric axis of the planner report grid: every cell additionally carries
# the dispatch+combine decision on each of these registered fabrics
# (--fabric overrides; see core.topology.FABRICS / parse_fabric).
DEFAULT_REPORT_FABRICS = ("2x8", "4x8", "2x8r2")


def planner_cell_report(arch: str, shape: ShapeSpec, pctx,
                        fabrics=DEFAULT_REPORT_FABRICS,
                        calibration=None, budget_s=None,
                        peak_flops: float = PEAK_FLOPS,
                        config=None) -> dict:
    """Which plan the planner picks for this cell, and the predicted
    delta vs the baseline plan: the reference's report, the cell's
    collective program planned jointly (the MoE pair's shared G, the
    gradient sync of a train cell), the what-if axes over ``fabrics``,
    under a ``calibration`` store's fitted hardware model and a phase
    budget ``budget_s`` (``config``: instead of the arch's).  The expert compute the pipelined scoring prices
    is at ``peak_flops`` (the H100's; the reference's TPU peak gives the
    reference's report)."""
    from repro_torch.core import planner as pl
    cal_store = None
    if calibration is not None:
        from repro_torch.telemetry import resolve_store
        cal_store = resolve_store(calibration)
    cfg = config or get_config(arch)
    out = {"policy": pctx.plan_policy}
    n_local = _cell_tokens_per_rank(shape, pctx)
    cell_compute_s = _cell_compute_s(cfg, shape, pctx, peak_flops)
    eplan = None
    if cfg.is_moe:
        eplan = _cell_execution_plan(cfg, shape, pctx, budget_s=budget_s,
                                     peak_flops=peak_flops)
        role_d = f"{shape.kind}/moe_dispatch"
        out["execution_plan"] = eplan.fingerprint
        out["moe_dispatch"] = eplan.decision(role_d).report()
        out["moe_combine"] = eplan.decision(
            f"{shape.kind}/moe_combine").report()
        joint = eplan.joint.get(role_d)
        out["moe_joint"] = joint.report() if joint else None
        planned_g = joint.microbatch if joint else 1
        g_knob = (planned_g if pctx.plan_policy == "auto"
                  else int(pctx.moe_microbatch))
        out["moe_microbatch"] = {
            "executed": max(1, math.gcd(g_knob, n_local)),
            "planned": planned_g,
            "compute_s": cell_compute_s,
        }
    if shape.kind == "train":
        if eplan is None:
            eplan = _cell_execution_plan(cfg, shape, pctx,
                                         budget_s=budget_s,
                                         peak_flops=peak_flops)
            out["execution_plan"] = eplan.fingerprint
        gs = eplan.decisions.get("train/grad_sync")
        if gs is not None:
            out["grad_sync"] = gs.report()
    if eplan is not None:
        out["phases"] = {ph: dict(rep)
                         for ph, rep in eplan.phase_report.items()}
        out["planner_stats"] = dict(eplan.planner_stats)
    from repro_torch.core.topology import get_fabric, split_tp_full_mesh
    topo, _ = split_tp_full_mesh(8, tp=4)
    frag = n_local * cfg.d_model * 2
    d = pl.default_planner().choose("allgather", frag, topo)
    out["allgather_ref_8x4"] = {"frag_bytes": frag, **d.report()}
    out["fabrics"] = {}
    for fname in fabrics or ():
        ftopo = get_fabric(fname)
        cell = {"allgather": pl.default_planner().choose(
            "allgather", frag, ftopo).report()}
        moe_kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k,
                      token_bytes=cfg.d_model * 2, compute_s=cell_compute_s)
        if cfg.is_moe:
            for op in ("dispatch", "combine"):
                cell[op] = pl.default_planner().choose(
                    op, n_local * cfg.d_model * 2, ftopo, **moe_kw).report()
        if cal_store is not None:
            from repro_torch.telemetry import calibrated_hw
            hw_cal = calibrated_hw(cal_store, ftopo)
            cal = {"fitted": bool(hw_cal.link_bw),
                   "allgather": pl.default_planner().choose(
                       "allgather", frag, ftopo, hw_cal).report()}
            if cfg.is_moe:
                for op in ("dispatch", "combine"):
                    cal[op] = pl.default_planner().choose(
                        op, n_local * cfg.d_model * 2, ftopo, hw_cal,
                        **moe_kw).report()
            cell["calibrated"] = cal
        out["fabrics"][fname] = cell
    if cal_store is not None:
        out["calibration_store"] = {"path": cal_store.path,
                                    "records": len(cal_store),
                                    "fabrics": cal_store.fabrics()}
    return out


def _cell_tokens_per_rank(shape: ShapeSpec, pctx) -> int:
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    return max(1, tokens // (pctx.num_pods * pctx.data_size))


def _cell_program(cfg, shape: ShapeSpec, pctx, budget_s=None,
                  peak_flops: float = PEAK_FLOPS):
    """The ONE declared collective program of this cell (phase ==
    shape.kind), shared by the "plan" preset, the auto-policy binding and
    the cell report."""
    from repro_torch.parallel.context import build_collective_program
    seq = shape.seq_len if shape.kind != "decode" else 1
    return build_collective_program(
        cfg, pctx, "dryrun", {shape.kind: (shape.global_batch, seq)},
        phase_budgets={shape.kind: budget_s} if budget_s else None,
        peak_flops=peak_flops)


def _cell_execution_plan(cfg, shape: ShapeSpec, pctx, budget_s=None,
                         peak_flops: float = PEAK_FLOPS):
    """Jointly-planned ExecutionPlan of this cell's program (planned
    regardless of policy)."""
    return pctx.plan_collectives(_cell_program(
        cfg, shape, pctx, budget_s=budget_s, peak_flops=peak_flops))


def _cell_compute_s(cfg, shape: ShapeSpec, pctx,
                    peak_flops: float = PEAK_FLOPS) -> float:
    """Modeled per-rank expert-FFN time of this cell at ``peak_flops``."""
    if not cfg.is_moe:
        return 0.0
    return moe_compute_s(_cell_tokens_per_rank(shape, pctx), cfg.top_k,
                         cfg.d_model, cfg.expert_d_ff, tp=pctx.model_size,
                         peak_flops=peak_flops)


def planned_microbatch(pctx, cfg, kind: str, batch: int, seq: int,
                       peak_flops: float = PEAK_FLOPS) -> int:
    """The ``moe_microbatch`` preset "plan": the G of the joint pipeline
    decision of the ``kind`` phase's program at ``batch`` x ``seq``,
    clamped to a divisor of the rank's tokens."""
    if not cfg.is_moe:
        return 1
    shape = ShapeSpec("cell", seq, batch, kind)
    eplan = _cell_execution_plan(cfg, shape, pctx, peak_flops=peak_flops)
    joint = eplan.joint.get(f"{kind}/moe_dispatch")
    g = joint.microbatch if joint else 1
    return max(1, math.gcd(g, _cell_tokens_per_rank(shape, pctx)))


def _cell_pctx(arch: str, shape: ShapeSpec, multi_pod: bool, variant: str,
               *, rank: int = 0, mesh_shape=None, config=None, knobs=None,
               peak_flops: float = PEAK_FLOPS):
    """The cell's context over a ``ShapeMesh`` seen from ``rank``: the
    variant's knobs (then ``knobs``), dense weights replicated over data
    in serving cells, a planned G for the "plan" presets, and under
    ``auto`` the cell's jointly planned ExecutionPlan bound."""
    from repro_torch.launch.mesh import shape_pctx
    cfg = config or get_config(arch)
    kw = dict(VARIANTS[variant])
    if shape.kind != "train":
        kw.setdefault("fsdp", False)
    else:
        # the reference's default: each block's activations recomputed in
        # the backward (the port's runs default to none)
        kw.setdefault("remat", "full")
    kw.update(knobs or {})
    planned_g = kw.get("moe_microbatch") == "plan"
    if planned_g:
        kw.pop("moe_microbatch")
    pctx = shape_pctx(multi_pod=multi_pod, rank=rank, shape=mesh_shape, **kw)
    if planned_g:
        seq = shape.seq_len if shape.kind != "decode" else 1
        pctx = dataclasses.replace(pctx, moe_microbatch=planned_microbatch(
            pctx, cfg, shape.kind, shape.global_batch, seq, peak_flops))
    if pctx.plan_policy == "auto":
        program = _cell_program(cfg, shape, pctx, peak_flops=peak_flops)
        if program.sites:
            pctx = pctx.bind(pctx.plan_collectives(program))
    return pctx


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

_NO_TRAFFIC = ("empty", "new_empty", "empty_like", "empty_strided",
               "detach", "lift_fresh")
# ops that read (or write) only the indexed rows of their first input
_GATHERS = ("index", "index_select", "gather", "embedding", "take")
_SCATTERS = ("index_put", "index_put_", "scatter", "scatter_",
             "scatter_add", "scatter_add_", "index_add", "index_add_",
             "index_copy", "index_copy_")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_ALIASING: dict = {}


def _may_alias(func) -> bool:
    """Whether ``func`` may return a storage it was given: a view, an
    in-place or ``out=`` op (its schema marks the alias), or
    ``_unsafe_view``, whose schema does not.  Any other op returns new
    storages."""
    if func not in _ALIASING:
        _ALIASING[func] = (func.is_view or func._schema.is_mutable or any(
            r.alias_info is not None for r in func._schema.returns)
            or func.overloadpacket.__name__ == "_unsafe_view")
    return _ALIASING[func]


PEAK_PARTS = ("gradients", "saved activations", "gathered weights",
              "transients")


class Traffic(TorchDispatchMode):
    """Every op's input and output bytes (views and allocations aside),
    and the peak of the bytes of the storages made inside, alive at once:
    each storage is held by a weak reference and counted until it dies.
    A storage is made inside when an op returns it without taking it as an
    input: a view, an in-place op or an ``out=`` op returns a storage it
    was given, so a storage that existed when the mode started (a weight,
    an optimizer moment, the cache) is never counted, however often it is
    written.  The dead are swept out, and the peak read, whenever the count
    has grown by 1/64 of the peak since the last reading (a sweep every op
    would cost the square of the live storages), so the peak may be short
    by that much.  At each new peak the live bytes are split by
    ``PEAK_PARTS`` (:attr:`at_peak`): the storages of the ``.grad`` of
    ``params``, those :meth:`tag` named (saved for the backward, gathered
    FSDP weights), and the rest; with ``makers`` also by the op and the
    model code that made each storage (:attr:`makers_at_peak`: "op @ the
    innermost three frames of the port's code", bytes).  An indexing op is
    counted by the rows it reads or writes, not by the whole tensor it
    indexes."""

    def __init__(self, params=(), makers: bool = False):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.now = 0
        self.peak = 0
        self.at_peak = dict.fromkeys(PEAK_PARTS, 0)
        self.makers_at_peak: dict = {}
        self.params = list(params)
        self._next = 0
        self._live: dict = {}
        self._tags: dict = {}
        self._makers = {} if makers else None

    def tag(self, t: torch.Tensor, part: str) -> None:
        """Count ``t``'s storage as ``part`` at the peak, if it was made
        inside and has no part yet."""
        key = t.untyped_storage()._cdata
        if key in self._live:
            self._tags.setdefault(key, part)

    def _forget(self, key) -> None:
        self.now -= self._live.pop(key)[1]
        self._tags.pop(key, None)
        if self._makers is not None:
            self._makers.pop(key, None)

    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            self._forget(key)

    @staticmethod
    def _maker(name: str) -> str:
        """``name`` @ the innermost three frames of the port's model code
        on the stack."""
        frames, f = [], sys._getframe(2)
        while f is not None and len(frames) < 3:
            path = f.f_code.co_filename
            if "repro_torch" in path and not path.endswith("dryrun.py"):
                frames.append(f"{f.f_code.co_name}:{f.f_lineno}")
            f = f.f_back
        return f"{name} @ {' < '.join(frames)}"

    def _split(self) -> dict:
        out = dict.fromkeys(PEAK_PARTS, 0)
        grads = {p.grad.untyped_storage()._cdata for p in self.params
                 if p.grad is not None}
        for key, (_, nbytes) in self._live.items():
            part = ("gradients" if key in grads
                    else self._tags.get(key, "transients"))
            out[part] += nbytes
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _NO_TRAFFIC:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if name in _GATHERS:
                # the rows read are the rows written, and the indices
                ins = [t for t in ins[1:] if not t.is_floating_point()]
                self.bytes += sum(_nbytes(t) for t in ins) + 2 * sum(
                    _nbytes(t) for t in outs)
            elif name in _SCATTERS:
                # the indices and the values read, as many bytes written
                src = ins[1:]
                self.bytes += sum(_nbytes(t) for t in src) + max(
                    (_nbytes(t) for t in src), default=0)
            else:
                self.bytes += sum(_nbytes(t) for t in ins + outs)
        given = None
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            seen = self._live.get(key)
            if seen is not None and not seen[0].expired():
                continue
            if given is None:
                given = ({a.untyped_storage()._cdata
                          for a in tree_leaves((args, kwargs))
                          if isinstance(a, torch.Tensor)}
                         if _may_alias(func) else ())
            if key in given:
                continue                   # a view, in place, or out=
            if seen is not None:           # a dead storage's address
                self._forget(key)
            self._live[key] = (StorageWeakRef(st), st.nbytes())
            self.now += st.nbytes()
            if self._makers is not None:
                self._makers[key] = self._maker(name)
            if self.now > self._next:
                self._sweep()
                if self.now > self.peak:
                    self.peak = self.now
                    self.at_peak = self._split()
                    if self._makers is not None:
                        self.makers_at_peak = self._by_maker()
                self._next = self.peak + self.peak // 64
        return out

    def _by_maker(self) -> dict:
        out: dict = {}
        for key, (_, nbytes) in self._live.items():
            maker = self._makers.get(key, "?")
            out[maker] = out.get(maker, 0) + nbytes
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


class _Global:
    """A module tracker that tracks nothing: every FLOP under "Global"."""
    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return None


class Flops(FlopCounterMode):
    """``FlopCounterMode`` with its module tracker left out.  The tracker
    hooks the gradients of every module's inputs and outputs, and under
    remat those hooks hold each recomputed block's graph, with its
    recomputed activations, in a reference cycle until Python's collector
    runs, so :class:`Traffic`'s peak would count blocks whose backward has
    ended.  The totals are the same; there is no per-module table."""

    def __init__(self):
        super().__init__(display=False)
        self.mod_tracker = _Global()


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _meta_batch(cfg, shape: ShapeSpec, pctx) -> dict:
    return {name: torch.empty(s, dtype=dt, device="meta")
            for name, (s, dt) in sharding.batch_shapes(
                batch_shapes(cfg, shape), pctx).items()}


def _run(model, params, cfg, shape: ShapeSpec, pctx, opt_dtype):
    """The cell's function on the meta device; returns (kind, the argument
    bytes by part, the output bytes, the function, the parameters whose
    gradients it makes, its gradient sync or None).  A train cell over
    ranks shards the parameters
    as ``launch.train.build_training`` does (FSDP under the context's
    ``fsdp``) and syncs the gradients by its ``GradSync``; its
    ``arguments["grads"]`` is the gradients' bytes, which the step makes
    (the peak counts them as they are made, not as an argument)."""
    from repro_torch.launch.train import grad_sync_for
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import (TrainState, make_train_step,
                                             trainable)
    batch = _meta_batch(cfg, shape, pctx)
    rows = next(iter(batch.values())).shape[0]
    if shape.kind == "train":
        sync = None
        if model.pctx is not None:
            params = sharding.shard_fsdp(params, cfg, pctx)
            tokens = math.prod(next(iter(batch.values())).shape[:2])
            sync = _Marked(grad_sync_for(cfg, pctx, params, tokens)[1],
                           pctx.mesh)
        named = trainable(params)
        opt = adamw(lr=1e-4, opt_dtype=opt_dtype)
        state = TrainState(params, opt.init(named), 0)
        args = {"weights": _tree_bytes(list(params.parameters())),
                "batch": _tree_bytes(batch),
                "opt_state": _tree_bytes(state.opt_state),
                "grads": _tree_bytes(list(named.values()))}
        step = make_train_step(model, opt, grad_sync=sync)
        return ("train", args, 0, lambda: step(state, batch),
                list(named.values()), sync)
    args = {"weights": _tree_bytes(list(params.parameters())),
            "batch": _tree_bytes(batch)}
    cache_len = shape.seq_len
    cache = model.init_cache(rows, cache_len)
    args["cache"] = _tree_bytes(cache)
    fn = model.prefill if shape.kind == "prefill" else model.decode_step
    return (shape.kind, args, args["cache"],
            lambda: fn(params, batch, cache), [], None)


@contextlib.contextmanager
def _watching_gathers(seen):
    """Show ``seen`` each FSDP leaf ``sharding.gather_leaf`` gathers whole
    while the block runs (the dry run counts their bytes apart)."""
    real = sharding.gather_leaf

    def watched(shard, dim, pctx):
        whole = real(shard, dim, pctx)
        seen(whole)
        return whole
    sharding.gather_leaf = watched
    try:
        yield
    finally:
        sharding.gather_leaf = real


class _Marked:
    """A ``GradSync`` that notes where the mesh's log stood when the
    gradient sync began, so the exchanges of the forward and backward and
    those of the sync are told apart."""

    def __init__(self, sync, mesh):
        self.sync, self.mesh, self.at = sync, mesh, None

    def __call__(self, grads):
        self.at = len(self.mesh.log)
        return self.sync(grads)

    def __getattr__(self, name):
        return getattr(self.sync, name)


def _collective_parts(log: list, sync_at, regather: int) -> dict:
    """The wire bytes of the FSDP exchanges (the data axis's all-gathers
    and reduce-scatters before the gradient sync: the weights gathered in
    the forward, gathered again by a block's recompute in the backward,
    ``regather``, and the gradients reduce-scattered) and of the gradient
    sync by axis."""
    step = log if sync_at is None else log[:sync_at]
    fsdp = {"all-gather": -regather, "regather": regather,
            "reduce-scatter": 0}
    for kind, axis, wire, _, _ in step:
        if axis == "data" and kind in fsdp:
            fsdp[kind] += wire
    sync: dict = {}
    for kind, axis, wire, _, _ in ([] if sync_at is None else log[sync_at:]):
        sync[axis] = sync.get(axis, 0) + wire
    return {"fsdp": fsdp, "grad_sync": sync}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             variant: str = "mw", verbose: bool = True,
             fabrics=DEFAULT_REPORT_FABRICS, calibration=None,
             budget_s=None, rank: int = 0, mesh_shape=None, config=None,
             knobs=None, peak_flops: float = PEAK_FLOPS,
             makers: int = 0) -> dict:
    """One cell: the rank ``rank`` of the production mesh (or of
    ``mesh_shape``) runs the cell's function on ``meta`` (``shape_name``:
    a name of ``SHAPES`` or a ``ShapeSpec``); ``config``
    replaces the arch's config (a cut depth or a reduced width, for the
    card script's and the tests' checks; the model FLOPs are then not
    reported); ``knobs`` override the variant's; ``makers``: report
    the live bytes at the peak of the ``makers`` largest makers (op and
    model code, :class:`Traffic`; slower).  On a mesh of one rank
    the model is built without a context, as one rank trains and serves.
    The reference's result keys where the quantity is the same."""
    from repro_torch.kernels import cost
    from repro_torch.models.api import build_model, param_module
    mesh = "multi" if multi_pod else "single"
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else SHAPES[shape_name])
    skip = cell_is_skipped(arch, shape.name)
    if skip:
        return {"arch": arch, "shape": shape.name, "mesh": mesh,
                "variant": variant, "skipped": skip}
    cfg = config or get_config(arch)
    t0 = time.monotonic()
    pctx = _cell_pctx(arch, shape, multi_pod, variant, rank=rank,
                      mesh_shape=mesh_shape, config=config, knobs=knobs,
                      peak_flops=peak_flops)
    chips = math.prod(pctx.mesh.shape.values())
    mctx = pctx if chips > 1 else None
    # bf16 parameters, as the card trains and serves
    model = build_model(cfg, device="meta", dtype=torch.bfloat16, pctx=mctx)
    params = param_module(cfg, device="meta", dtype=torch.bfloat16,
                          pctx=mctx)
    kind, argb, outb, fn, grads_of, sync = _run(
        model, params, cfg, shape, pctx, VARIANT_OPT_DTYPE.get(variant))
    pctx.mesh.log.clear()
    traffic, flops = Traffic(grads_of, makers=bool(makers)), Flops()
    saved = torch.autograd.graph.saved_tensors_hooks(
        lambda t: (traffic.tag(t, "saved activations"), t)[1], lambda t: t)
    regather = []

    def gathered(t):
        traffic.tag(t, "gathered weights")
        if torch._C._current_graph_task_id() != -1:    # a recompute
            regather.append(_nbytes(t) * (pctx.data_size - 1)
                            // pctx.data_size)
    with _watching_gathers(gathered), cost.recording() as kernels, flops, \
            traffic, saved:
        fn()
    t_run = time.monotonic() - t0
    per_kernel: dict = {}
    for name, f, b in kernels:
        row = per_kernel.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        row["launches"] += 1
        row["flops"] += f
        row["bytes"] += b
    kflops = sum(r["flops"] for r in per_kernel.values())
    kbytes = sum(r["bytes"] for r in per_kernel.values())
    flops_dev = float(flops.get_total_flops()) + kflops
    bytes_dev = float(traffic.bytes) + kbytes
    log = pctx.mesh.log
    executed = {"by_axis": pctx.mesh.bytes_by("axis"),
                "by_kind": pctx.mesh.bytes_by("kind"), "num_ops": len(log),
                "log": [list(rec) for rec in log],
                **_collective_parts(log, None if sync is None else sync.at,
                                    sum(regather))}
    by_axis = executed["by_axis"]
    argument = sum(v for k, v in argb.items() if k != "grads")
    compute_term = flops_dev / PEAK_FLOPS
    memory_term = bytes_dev / HBM_BW
    inter = by_axis.get("pod", 0)
    intra = sum(v for k, v in by_axis.items() if k != "pod")
    collective_term = intra / NVLINK_BW + inter / INTER_NODE_BW
    mflops = model_flops_per_step(arch, shape) if config is None else None
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh, "variant": variant,
        "kind": kind, "chips": chips, "rank": rank,
        "mesh_shape": list(pctx.mesh.shape.values()),
        "layers": cfg.n_layers, "trace_s": round(t_run, 1),
        "hardware": HARDWARE,
        "memory": {
            # the storages that exist before the step (the gradients, in
            # ``arguments`` for the record, are made by it)
            "argument_bytes": argument, "arguments": argb,
            "output_bytes": outb,
            "peak_live_bytes": argument + traffic.peak,
            "temp_bytes": traffic.peak,
            "peak_parts": {"arguments": argument, **traffic.at_peak},
            "peak_makers": dict(list(traffic.makers_at_peak.items())[
                :makers]),
            # a serving cell's cache under the reference's layout
            "cache_reference_layout_bytes": _reference_cache_bytes(
                model, cfg, shape, pctx),
        },
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev,
                 "flops_kernels": kflops, "bytes_kernels": kbytes,
                 "ops": traffic.ops, "kernels": per_kernel},
        "launches": {name: row["launches"]
                     for name, row in per_kernel.items()},
        "collectives": executed,
        "planner": planner_cell_report(arch, shape, pctx, fabrics=fabrics,
                                       calibration=calibration,
                                       budget_s=budget_s,
                                       peak_flops=peak_flops, config=cfg),
        "roofline": {
            "compute_term_s": compute_term,
            "memory_term_s": memory_term,
            "collective_term_s": collective_term,
            "collective_term_nvlink_only_s": (intra + inter) / NVLINK_BW,
            "dominant": max(
                [("compute", compute_term), ("memory", memory_term),
                 ("collective", collective_term)], key=lambda kv: kv[1])[0],
            "model_flops_global": mflops,
            "useful_flops_ratio": (mflops / (flops_dev * chips)
                                   if mflops and flops_dev else None),
        },
    }
    if verbose:
        _print_cell(result)
    return result


def _reference_cache_bytes(model, cfg, shape: ShapeSpec, pctx):
    """A serving cell's cache bytes on one rank under the reference's
    ``cache_specs`` rules (``sharding.cache_shapes``) on the whole model's
    cache; None for a train cell."""
    if shape.kind == "train":
        return None
    whole = dataclasses.replace(model, pctx=None).init_cache(
        shape.global_batch, shape.seq_len)
    leaves = {}
    for name, val in whole.items():
        for i, t in enumerate(val if isinstance(val, list) else [val]):
            if isinstance(t, torch.Tensor):
                leaves[f"{name}.{i}"] = (tuple(t.shape), t.element_size())
    cut = sharding.cache_shapes({n: s for n, (s, _) in leaves.items()}, cfg,
                                pctx)
    return sum(math.prod(cut[n]) * size for n, (_, size) in leaves.items())


def _gb(x):
    return "?" if x is None else f"{x / 2**30:.2f}GiB"


def _print_cell(result: dict) -> None:
    mm, r = result["memory"], result["roofline"]
    print(f"[{result['arch']} x {result['shape']} x {result['mesh']} x "
          f"{result['variant']}] kind={result['kind']} "
          f"trace={result['trace_s']}s")
    print(f"  memory/rank: args={_gb(mm['argument_bytes'])} "
          f"peak={_gb(mm['peak_live_bytes'])} "
          f"out={_gb(mm['output_bytes'])}")
    print("  at the peak: " + ", ".join(
        f"{part} {_gb(v)}" for part, v in mm["peak_parts"].items()))
    for maker, v in mm.get("peak_makers", {}).items():
        print(f"    {_gb(v)}  {maker}")
    print(f"  flops/rank={result['cost']['flops_per_device']:.3e} "
          f"bytes/rank={result['cost']['bytes_per_device']:.3e}")
    col = result["collectives"]
    print(f"  collective bytes by axis: "
          f"{ {k: _gb(v) for k, v in col['by_axis'].items()} } (FSDP "
          f"{ {k: _gb(v) for k, v in col['fsdp'].items()} }, gradient sync "
          f"{ {k: _gb(v) for k, v in col['grad_sync'].items()} })")
    print(f"  roofline (H100 data sheet): "
          f"compute={r['compute_term_s'] * 1e3:.2f}ms "
          f"memory={r['memory_term_s'] * 1e3:.2f}ms "
          f"collective={r['collective_term_s'] * 1e3:.2f}ms "
          f"-> dominant={r['dominant']}")
    for op_name, pr in result["planner"].items():
        if isinstance(pr, dict) and "plan" in pr:
            print(f"  planner[{op_name}]: {pr['plan']} "
                  f"predicted={pr['predicted_us']:.1f}us "
                  f"vs baseline={pr['baseline_us']:.1f}us "
                  f"({pr['speedup_pct']:+.1f}%)")
    mb = result["planner"].get("moe_microbatch")
    if mb:
        print(f"  planner[microbatch]: executed={mb['executed']} "
              f"planned={mb['planned']}")
    for ph, rep in result["planner"].get("phases", {}).items():
        line = (f"  planner[phase {ph}]: {rep['score_s'] * 1e6:.1f}us "
                f"(contention +{rep['contention_s'] * 1e6:.1f}us)")
        if rep.get("budget_s"):
            line += (f", budget {rep['budget_s'] * 1e6:.0f}us "
                     f"{'ok' if rep.get('budget_ok') else 'VIOLATED'}")
        print(line)


def cell_path(arch, shape_name, multi_pod, variant):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    mesh = "multi" if multi_pod else "single"
    return os.path.join(RESULTS_DIR,
                        f"{arch}__{shape_name}__{mesh}__{variant}.json")


def run_and_save(arch, shape_name, multi_pod, variant="mw", force=False,
                 fabrics=DEFAULT_REPORT_FABRICS, calibration=None,
                 budget_s=None, makers: int = 0) -> dict:
    """:func:`run_cell` cached as JSON under ``results/dryrun_torch/``; a
    failed cell is recorded as an ``error`` entry.  A cached cell's
    planner section is refreshed when the fabrics, a calibration store or
    a phase budget ask for it; ``makers`` runs the cell again."""
    path = cell_path(arch, shape_name, multi_pod, variant)
    if os.path.exists(path) and not force and not makers:
        with open(path) as f:
            result = json.load(f)
        cached = set(result.get("planner", {}).get("fabrics", {}))
        if "planner" in result and (cached != set(fabrics or ())
                                    or calibration is not None
                                    or budget_s is not None):
            pctx = _cell_pctx(arch, SHAPES[shape_name], multi_pod, variant)
            result["planner"] = planner_cell_report(
                arch, SHAPES[shape_name], pctx, fabrics=fabrics,
                calibration=calibration, budget_s=budget_s)
            with open(path, "w") as f:
                json.dump(result, f, indent=1)
        return result
    try:
        result = run_cell(arch, shape_name, multi_pod=multi_pod,
                          variant=variant, fabrics=fabrics,
                          calibration=calibration, budget_s=budget_s,
                          makers=makers)
    except Exception as e:  # record failures — they are bugs to fix
        result = {"arch": arch, "shape": shape_name,
                  "mesh": "multi" if multi_pod else "single",
                  "variant": variant, "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
        print(f"FAILED [{arch} x {shape_name}]: {e}", file=sys.stderr)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--variant", default="mw", choices=list(VARIANTS))
    ap.add_argument("--fabric", default=",".join(DEFAULT_REPORT_FABRICS),
                    help="comma list of fabrics (registered names or "
                         "parseable specs like 4x8, 2x8r2@12.5) for the "
                         "per-cell planner what-if axis; '' disables")
    ap.add_argument("--calibration", default=None,
                    help="telemetry calibration store (JSONL path): every "
                         "cell's planner section additionally reports the "
                         "decisions under the store's FITTED hardware "
                         "model — the measured-fabric what-if axis")
    ap.add_argument("--phase-budget-us", type=float, default=None,
                    help="latency budget (us) for each cell's phase: the "
                         "contention-aware sweep reports whether any "
                         "feasible plan combination met it")
    ap.add_argument("--peak-makers", type=int, default=0, metavar="N",
                    help="print the live bytes at the peak of the N "
                         "largest makers (op and model code; slower; a "
                         "cached cell runs again)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape x mesh) cell")
    ap.add_argument("--force", action="store_true")
    from repro_torch.telemetry.exporter import (add_metrics_args,
                                                finish_exporter_from_args,
                                                start_exporter_from_args)
    add_metrics_args(ap)
    args = ap.parse_args(argv)
    exporter = start_exporter_from_args(args)
    fabrics = tuple(f for f in args.fabric.split(",") if f)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in shapes_for(arch):
                for mp in meshes:
                    cells.append((arch, shape, mp, args.variant))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mp in meshes:
            cells.append((args.arch, args.shape, mp, args.variant))

    budget_s = (args.phase_budget_us * 1e-6
                if args.phase_budget_us else None)
    failures = 0
    for arch, shape, mp, variant in cells:
        r = run_and_save(arch, shape, mp, variant, force=args.force,
                         fabrics=fabrics, calibration=args.calibration,
                         budget_s=budget_s, makers=args.peak_makers)
        if "error" in r:
            failures += 1
    print(f"\n{len(cells) - failures}/{len(cells)} cells OK")
    finish_exporter_from_args(args, exporter)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
