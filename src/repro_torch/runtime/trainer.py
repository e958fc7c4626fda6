"""Fault-tolerant training loop, on one rank or over a rank mesh.

Port of ``src/repro/runtime/trainer.py``.  The behaviours are the
reference's:

* **checkpoint/restart**: periodic checkpoints (atomic commit,
  :mod:`repro_torch.checkpoint.store`); on start the trainer resumes from
  the latest one, and the (seed, step)-addressable data stream replays the
  same batches from there, so a resumed run equals an uninterrupted one;
* **step retry + rollback**: a step that raises :class:`TransientFault` is
  retried; after ``max_retries`` the trainer rolls back to the last
  checkpoint and continues;
* **straggler detection**: an EWMA + deviation ledger of step walls, whose
  outliers call ``straggler_hook``;
* **gradient accumulation** over micro-batches, global-norm clipping, and
  the ``grad_sync`` hook applied to the gradients before clipping.

What differs, because PyTorch runs eagerly and the state of a large model
fills the card: the step is no jitted pure function but updates the
parameters (a module) and the optimizer state IN PLACE, through
``Optimizer.apply``, clipping the gradients in place first; a step that
raises before its update (a fault hook, a failed forward) leaves the state
as it was.  A resume or a rollback copies the checkpoint into the live
tensors.  The trainer takes a parameter module (``params``) or draws one
from a ``torch.Generator`` on the model's device.  A step's wall is taken
after its metrics are read to the host, so it is the step's device time
too.  At the end of a run the final state is saved unless the periodic
save has just written that step (the reference writes it twice).

Over ranks (a model built with a ``pctx``) each rank's loss is its own
rows' mean, and :class:`GradSync` is the ``grad_sync`` hook: the reference's
closure over ``planned_psum``.  The gradients of the leaves replicated over
the data-parallel ranks are averaged over them by the scheme of the
planner's ``grad_sync`` verdict; an expert's gradient has come back summed
over the data-parallel ranks whose rows it served (the exchanges'
backward), so it is divided by their count instead; an FSDP shard's
(``parallel.sharding.shard_fsdp``) has come back summed over ``data`` by
its gather's reduce-scatter, so it is divided by ``data`` and averaged
over the pods alone.  The clip uses the global gradient's norm, each
expert shard, FSDP shard and model-axis block counted once, so every rank
clips by the same factor and the replicas stay bit-identical.  Checkpoints hold every leaf at its
global shape (:class:`~repro_torch.checkpoint.store.ShardLayout`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.checkpoint.store import CheckpointManager, ShardLayout
from repro_torch.optim.optimizers import (Optimizer, _slices,
                                          clip_by_global_norm_, global_norm)
from repro_torch.parallel import mesh as mesh_ops

log = logging.getLogger("repro_torch.trainer")


class TransientFault(RuntimeError):
    """A retryable failure (injected in tests; device errors in prod)."""


def trainable(params: nn.Module) -> dict:
    """Turn on ``requires_grad`` for every floating parameter of the module
    (they are made without it, for serving) and return them by name."""
    named = {}
    for name, p in params.named_parameters():
        if p.is_floating_point():
            p.requires_grad_(True)
            named[name] = p
    return named


def fill_missing_grads(named: dict) -> None:
    """Give each parameter that the loss does not reach a zero gradient,
    as ``jax.grad`` gives it (Zamba2 cut below its first shared-block
    call leaves the shared block unused)."""
    for p in named.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    opt_state: Any
    step: int

    def named(self) -> dict:
        return {n: p for n, p in self.params.named_parameters()
                if p.requires_grad}

    def tree(self) -> dict:
        """The checkpointed tree: parameters by name, optimizer state, and
        the step as a 0-d int64 tensor."""
        return {"params": self.named(), "opt": self.opt_state,
                "step": torch.tensor(self.step, dtype=torch.int64)}


class GradSync:
    """The planner-routed gradient reduction of training over ranks: called
    on the gradient dict of one rank (in place, before clipping).

    ``decision``: the ``grad_sync`` verdict (``ParallelContext.
    grad_sync_plan``); its ``reduce_scheme`` runs through ``planned_psum``
    over the data-parallel axes (over the pod axis alone for an FSDP
    shard), a leaf at a time in fp32 slices of at most ``CHUNK`` elements;
    None runs the flat ring.  Every exchange goes through
    ``parallel.mesh``, so on a ``ShapeMesh`` (the dry run) each is
    logged.
    :meth:`global_norm` is the global gradient's norm, :meth:`metrics` the
    losses' means over the data-parallel ranks."""

    def __init__(self, pctx, params: nn.Module, *, decision=None):
        from repro_torch.models import moe as M
        from repro_torch.models.transformer import is_expert_weight
        self.pctx, self.mesh = pctx, pctx.mesh
        self.decision = decision
        self.scheme = (decision.shard_map_kwargs.get("reduce_scheme", "ring")
                       if decision is not None else "ring")
        named = dict(params.named_parameters())
        self.expert = {n for n in named if is_expert_weight(n)}
        split = {f"{prefix}.{name}".lstrip(".")
                 for prefix, sub in params.named_modules()
                 for name in getattr(sub, "shards", {})}
        # the expert leaves whose width is cut over the model axis (the
        # others are whole on every model rank: ``layers.splits``)
        self.expert_split = split & self.expert
        self.split = split - self.expert
        # the FSDP shards (``sharding.shard_fsdp``), cut over ``data``
        self.fsdp = {f"{prefix}.{name}".lstrip(".")
                     for prefix, sub in params.named_modules()
                     for name in getattr(sub, "fsdp_dims", {})}
        # the column segments of a split leaf that every model rank holds
        # whole (Mamba2's in_proj B/C), as (dim, [(lo, hi)] of the rank's
        # own columns): the norm takes them from the first model rank only
        self.whole_parts = {}
        for prefix, sub in params.named_modules():
            for name, segs_of in getattr(sub, "segments_of", {}).items():
                dim, _, mine = sub.shards[name]
                common = set.intersection(*(set(segs_of(q)) for q in range(
                    pctx.model_size)))
                local, at = [], 0
                for lo, hi in mine:
                    if (lo, hi) in common:
                        local.append((at, at + hi - lo))
                    at += hi - lo
                self.whole_parts[f"{prefix}.{name}".lstrip(".")] = \
                    dim, local
        # experts replicated over the pods when EP spans the data axis alone
        experts = M.num_experts(params)
        self.expert_pods = bool(experts) and pctx.num_pods > 1 and \
            pctx.pod_axis not in M.expert_axes(pctx, experts)
        # the bytes this rank all-reduces a step, by part: the leaves
        # replicated over the data-parallel ranks (fp32, over them), the
        # FSDP shards (fp32; their reduce-scatter over ``data`` runs in the
        # backward) and the experts (in their dtype, where EP leaves the
        # pods out) over the pods alone
        self.bytes_parts = {
            "replicated": 4 * sum(
                p.numel() for n, p in named.items()
                if n not in self.expert and n not in self.fsdp)
            if pctx.dp_size > 1 else 0,
            "fsdp": 4 * sum(named[n].numel() for n in self.fsdp)
            if pctx.num_pods > 1 else 0,
            "experts": sum(named[n].numel() * named[n].element_size()
                           for n in self.expert) if self.expert_pods else 0}
        self.bytes = sum(self.bytes_parts.values())

    def __call__(self, grads: dict) -> dict:
        from repro_torch.core.collectives import planned_psum
        pctx, dp = self.pctx, self.pctx.dp_size
        data, pods = pctx.data_size, pctx.num_pods
        with torch.no_grad():
            for name, g in grads.items():
                if name in self.expert:
                    if self.expert_pods:
                        mesh_ops._all_reduce_(g, self.mesh.group("pod"))
                    g.div_(dp)
                    continue
                if name in self.fsdp:
                    for part in _slices(g):
                        mean = part.float() / data
                        if pods > 1:
                            mean = planned_psum(mean, self.mesh,
                                                pctx.pod_axis,
                                                reduce_scheme=self.scheme)
                        part.copy_(mean)
                    continue
                if dp == 1:
                    continue
                for part in _slices(g):
                    part.copy_(planned_psum(part.float(), self.mesh,
                                            pctx.dp_axes,
                                            num_servers=pctx.num_servers,
                                            reduce_scheme=self.scheme))
        return grads

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The norm of the global gradient, the same bits on every rank:
        each rank adds the squares of the parts it is the first holder of
        (the replicated leaves on rank 0, the model-axis blocks on the
        first data-parallel rank, of these the segments every model rank
        holds whole on the first model rank only, each FSDP shard on its
        first pod (on every data rank, each its own slice), each expert
        shard on its first pod, and on its first model rank too where the
        expert width is whole on every model rank), and one ``all_reduce``
        over the world sums them."""
        pctx = self.pctx
        first_dp = pctx.dp_index == 0
        first_model = self.mesh.coords[pctx.model_axis] == 0
        first_pod = not self.expert_pods or self.mesh.coords["pod"] == 0
        pod0 = self.mesh.coords["pod"] == 0
        parts = {}
        for name, g in grads.items():
            first = pod0 if name in self.fsdp else first_dp
            if name in self.expert:
                mine = first_pod and (first_model or
                                      name in self.expert_split)
            elif name in self.split:
                mine = first
                if mine and not first_model and name in self.whole_parts:
                    dim, skip = self.whole_parts[name]
                    at = 0
                    for i, (lo, hi) in enumerate(skip + [(g.shape[dim],) * 2]):
                        if lo > at:
                            parts[f"{name}/{i}"] = g.narrow(dim, at, lo - at)
                        at = hi
                    continue
            else:
                mine = first and first_model
            if mine:
                parts[name] = g
        total = (global_norm(parts) ** 2 if parts else
                 torch.zeros((), dtype=torch.float32,
                             device=next(iter(grads.values())).device))
        mesh_ops._all_reduce_(total, self.mesh.world_group())
        return torch.sqrt(total)

    def metrics(self, metrics: dict) -> dict:
        """Each metric's mean over the data-parallel ranks (a rank's loss
        is its own rows' mean)."""
        if self.pctx.dp_size == 1:
            return metrics
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].detach().float() for k in keys])
        mesh_ops._all_reduce_(vals, self.mesh.group(*self.pctx.dp_axes))
        vals = vals / self.pctx.dp_size
        return dict(zip(keys, vals))


class _Marks:
    """Points in a step's stream of work: CUDA events on the card, the
    host clock on the CPU; :meth:`ms` gives the milliseconds between
    consecutive marks (on the card it waits for the last)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            evt = torch.cuda.Event(enable_timing=True)
            evt.record()
            self.marks.append(evt)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> list:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                       self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


STEP_PARTS = ("fwd_bwd_ms", "sync_ms", "clip_ms", "update_ms")


def make_train_step(model, optimizer: Optimizer, *, grad_accum: int = 1,
                    max_grad_norm: float = 1.0,
                    grad_sync: Optional[Callable[[dict], dict]] = None):
    """The train step: ``step(state, batch) -> (state, metrics)``, the
    state updated in place.  With ``grad_accum > 1`` every leaf of the batch
    has a leading micro-batch dim [grad_accum, ...]: the fp32 gradients of
    the micro-batches are summed and divided by ``grad_accum``, as the
    reference's scan does.  ``grad_sync``: a callable on the gradient dict
    applied before clipping (the planner-routed gradient reduction of
    training over ranks, a :class:`GradSync`; None on one rank); when it
    has ``global_norm`` the clip takes that norm, and its ``metrics``
    averages the reported losses.  The metrics also hold the milliseconds
    of the forward and backward, the gradient sync, the clip and the update
    (``STEP_PARTS``; CUDA events on the card, which cost next to nothing:
    the step waits for its metrics on the host anyway)."""

    def step_fn(state: TrainState, batch):
        named = state.named()
        marks = _Marks(next(iter(named.values())).device)
        for p in named.values():
            p.grad = None
        if grad_accum == 1:
            loss, metrics = model.loss(state.params, batch)
            loss.backward()
            fill_missing_grads(named)
            grads = {n: p.grad for n, p in named.items()}
        else:
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in named.items()}
            lsum = 0.0
            for i in range(grad_accum):
                mb = {k: v[i] for k, v in batch.items()}
                mloss, _ = model.loss(state.params, mb)
                mloss.backward()
                fill_missing_grads(named)
                for n, p in named.items():
                    gsum[n] += p.grad.float()
                    p.grad = None
                lsum = lsum + mloss.detach()
            grads = {n: g / grad_accum for n, g in gsum.items()}
            loss = lsum / grad_accum
            metrics = {}
        marks.mark()
        if grad_sync is not None:
            grads = grad_sync(grads)
        marks.mark()
        norm_fn = getattr(grad_sync, "global_norm", None)
        gnorm = clip_by_global_norm_(
            grads, max_grad_norm, norm_fn(grads) if norm_fn else None)
        marks.mark()
        with torch.no_grad():
            optimizer.apply(grads, state.opt_state, named, state.step)
        for p in named.values():
            p.grad = None
        del grads
        state.step += 1
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}}
        if hasattr(grad_sync, "metrics"):
            out = grad_sync.metrics(out)
        out["grad_norm"] = gnorm
        marks.mark()
        out.update(zip(STEP_PARTS, marks.ms()))
        return state, out

    return step_fn


@dataclasses.dataclass
class StragglerLedger:
    """EWMA + deviation tracking of per-step wall time."""
    alpha: float = 0.1
    threshold: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    events: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        if self.n < 5:          # warmup: compile steps excluded
            self.mean = dt if self.n == 0 else \
                (1 - self.alpha) * self.mean + self.alpha * dt
            self.n += 1
            return False
        dev = dt - self.mean
        self.var = (1 - self.alpha) * self.var + self.alpha * dev * dev
        sigma = max(self.var ** 0.5, 1e-6, 0.05 * self.mean)
        is_out = dev > self.threshold * sigma
        if is_out:
            self.events.append((step, dt, self.mean))
        else:
            self.mean += self.alpha * dev
        self.n += 1
        return is_out


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: Optional[str] = None
    keep_last_k: int = 3
    max_retries: int = 2
    log_every: int = 10


class Trainer:
    """Drives the train step with the fault-tolerance behaviours.
    ``make_batch(step)`` must be deterministic in step (checkpoint/restart
    replays exactly).  ``params``: the parameter module to train (its
    floating parameters are made trainable); without it the model draws
    one from ``generator`` (a ``torch.Generator`` of the model's device;
    seed 0 when None).  Over ranks (a model with a ``pctx``) every rank
    runs the same loop on its own shard, its checkpoints hold global
    leaves, and ``train_step`` is a step with a :class:`GradSync`."""

    def __init__(self, model, optimizer: Optimizer, make_batch: Callable,
                 cfg: TrainerConfig, *, params: nn.Module | None = None,
                 generator: torch.Generator | None = None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 straggler_hook: Optional[Callable[[int, float], None]] = None,
                 step_hook: Optional[Callable[[int, dict], None]] = None,
                 train_step=None, plan_binder=None):
        self.model = model
        self.optimizer = optimizer
        self.make_batch = make_batch
        self.cfg = cfg
        self.fault_hook = fault_hook
        self.straggler_hook = straggler_hook
        # called after every completed step with (step, metrics row)
        self.step_hook = step_hook
        self.ledger = StragglerLedger()
        # optional hot plan re-bind: a PlanBinder whose artifact IS the step
        # function; a re-bind staged mid-run swaps it in at a step boundary
        self.plan_binder = plan_binder
        if plan_binder is not None and plan_binder.artifact is not None:
            train_step = plan_binder.artifact
        self.train_step = train_step or make_train_step(model, optimizer)
        self.metrics_history: list[dict] = []
        if params is None:
            if generator is None:
                generator = torch.Generator(device=model.device)
                generator.manual_seed(0)
            params = model.init(generator)
        named = trainable(params)
        self.state = TrainState(params, optimizer.init(named), 0)
        pctx = getattr(model, "pctx", None)
        self.ckpt = (CheckpointManager(
            cfg.checkpoint_dir, keep_last_k=cfg.keep_last_k,
            layout=None if pctx is None else ShardLayout(params, pctx))
            if cfg.checkpoint_dir else None)
        self._maybe_resume()

    # -- checkpoint/restart ----------------------------------------------------
    def _restore(self, step: int) -> None:
        tree = self.state.tree()
        self.ckpt.restore_into(step, tree)
        self.state.step = int(tree["step"])

    def _maybe_resume(self):
        if not self.ckpt:
            return
        latest = self.ckpt.latest_step()
        if latest is None:
            return
        self._restore(latest)
        log.info("resumed from checkpoint step %s", latest)

    def _save(self, step: int):
        if self.ckpt:
            self.ckpt.save(step, self.state.tree(),
                           extra={"wall_time": time.time()})

    def _rollback(self):
        if not self.ckpt:
            raise RuntimeError("fault without checkpointing enabled")
        latest = self.ckpt.latest_step()
        if latest is None:
            raise RuntimeError("fault before first checkpoint")
        self._restore(latest)
        log.warning("rolled back to checkpoint step %s", latest)

    # -- main loop ----------------------------------------------------------------
    def run(self) -> list[dict]:
        while self.state.step < self.cfg.total_steps:
            step = self.state.step
            if self.plan_binder is not None \
                    and self.plan_binder.swap_if_pending():
                self.train_step = self.plan_binder.artifact
            batch = self.make_batch(step)
            t0 = time.monotonic()
            for attempt in range(self.cfg.max_retries + 1):
                try:
                    if self.fault_hook:
                        self.fault_hook(step)
                    new_state, metrics = self.train_step(self.state, batch)
                    break
                except TransientFault:
                    log.warning("transient fault at step %d (attempt %d)",
                                step, attempt + 1)
                    if attempt == self.cfg.max_retries:
                        self._rollback()
                        new_state, metrics = None, None
                        break
            if new_state is None:       # rolled back; re-enter loop
                continue
            self.state = new_state
            values = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0   # the float()s waited for the card
            row = {"step": step, "wall": dt, **values}
            if self.ledger.record(step, dt) and self.straggler_hook:
                self.straggler_hook(step, dt)
            self.metrics_history.append(row)
            from repro_torch.telemetry import metrics as _metrics
            _metrics.default_registry()["repro_step_wall_seconds"].observe(
                dt, phase="train")
            if self.step_hook:
                self.step_hook(step, row)
            if step % self.cfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", step,
                         row.get("loss", float("nan")), dt * 1e3)
            next_step = step + 1
            if self.ckpt and next_step % self.cfg.checkpoint_every == 0:
                self._save(next_step)
        # the final state, unless the periodic save just wrote it
        if self.ckpt and self.ckpt.latest_step() != self.state.step:
            self._save(self.state.step)
        return self.metrics_history
