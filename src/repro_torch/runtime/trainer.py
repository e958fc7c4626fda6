"""Fault-tolerant training loop on one rank.

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
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm_

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


def make_train_step(model, optimizer: Optimizer, *, grad_accum: int = 1,
                    max_grad_norm: float = 1.0,
                    grad_sync: Optional[Callable[[dict], dict]] = None):
    """The train step: ``step(state, batch) -> (state, metrics)``, the
    state updated in place.  With ``grad_accum > 1`` every leaf of the batch
    has a leading micro-batch dim [grad_accum, ...]: the fp32 gradients of
    the micro-batches are summed and divided by ``grad_accum``, as the
    reference's scan does.  ``grad_sync``: a callable on the gradient dict
    applied before clipping (the planner-routed gradient reduction of
    training over ranks; None on one rank)."""

    def step_fn(state: TrainState, batch):
        named = state.named()
        for p in named.values():
            p.grad = None
        if grad_accum == 1:
            loss, metrics = model.loss(state.params, batch)
            loss.backward()
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
                for n, p in named.items():
                    gsum[n] += p.grad.float()
                    p.grad = None
                lsum = lsum + mloss.detach()
            grads = {n: g / grad_accum for n, g in gsum.items()}
            loss = lsum / grad_accum
            metrics = {}
        if grad_sync is not None:
            grads = grad_sync(grads)
        gnorm = clip_by_global_norm_(grads, max_grad_norm)
        with torch.no_grad():
            optimizer.apply(grads, state.opt_state, named, state.step)
        for p in named.values():
            p.grad = None
        del grads
        state.step += 1
        out = {"loss": loss.detach(), "grad_norm": gnorm,
               **{k: v.detach() for k, v in metrics.items()}}
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
    seed 0 when None)."""

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
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir,
                                       keep_last_k=cfg.keep_last_k)
                     if cfg.checkpoint_dir else None)
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
