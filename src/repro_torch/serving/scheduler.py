"""Iteration-level (continuous-batching) request scheduler.

Own copy of the reference's ``repro/serving/scheduler.py`` in engine mode:
the scheduler drives a live ``ServeEngine``, and its clock advances by the
measured wall time of each phase.  The planner probe, the plan binder and
the metrics plane arrive with the port's planner and telemetry slices.

One scheduling **iteration** = (1) consult the admission controller and
prefill the joining requests as a new *cohort*, (2) run one decode round
over every in-flight cohort.  Finished sequences release their capacity at
the iteration boundary and new requests join right behind them.

A **cohort** is the set of requests admitted together: one prefill call,
position-aligned thereafter.  Rows are numerically independent under
greedy decoding, which is why the continuous path is bit-exact against
one-shot ``generate`` for the same request set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.queue import Request, RequestQueue


def batch_bucket(batch: int) -> int:
    """Power-of-two decode-batch bucket (copy of the reference's
    ``core/plan.py::batch_bucket``)."""
    if batch <= 1:
        return 1
    return 1 << int(math.ceil(math.log2(float(batch))))


def _pctl(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); nan when empty."""
    if not values:
        return float("nan")
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(np.ceil(q / 100.0 * len(vs))) - 1))
    return vs[idx]


@dataclasses.dataclass
class _Cohort:
    requests: List[Request]
    state: object = None          # engine cohort state
    pending: object = None        # last sampled tokens, next decode input

    @property
    def live(self) -> int:
        return sum(1 for r in self.requests if not r.done)

    @property
    def finished(self) -> bool:
        return all(r.done for r in self.requests)


class BatchScheduler:
    """Continuous-batching scheduler over a request queue.

    ``engine``: a ServeEngine-compatible object providing
    ``start_cohort(prompts, max_new, seed)`` and
    ``step_cohort(state, tokens)``.
    """

    def __init__(self, *, queue: RequestQueue,
                 admission: AdmissionController, engine,
                 eos_id: Optional[int] = None, seed: int = 0,
                 max_iterations: int = 1_000_000) -> None:
        self.queue = queue
        self.admission = admission
        self.engine = engine
        self.eos_id = eos_id
        self.seed = seed
        self.max_iterations = max_iterations
        self.now = 0.0
        self.cohorts: List[_Cohort] = []
        self.completed: List[Request] = []
        self.iterations = 0
        self.max_in_flight = 0
        self.wall = {"prefill_s": 0.0, "decode_s": 0.0}

    # -- introspection -------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return sum(c.live for c in self.cohorts)

    @property
    def idle(self) -> bool:
        return not self.cohorts and not len(self.queue)

    # -- the iteration -------------------------------------------------------
    def step(self) -> bool:
        """One scheduling iteration; False when fully idle (queue empty
        and nothing in flight)."""
        self.iterations += 1
        joiners: List[Request] = []
        ready = self.queue.ready_count(self.now)
        if ready:
            dec = self.admission.decide(in_flight=self.in_flight,
                                        ready=ready)
            if dec.admit > 0:
                joiners = self.queue.pop_ready(self.now, dec.admit)
        if not joiners and not self.cohorts:
            nxt = self.queue.next_arrival_s(self.now)
            if nxt is None:
                return False
            self.now = max(self.now, nxt)   # idle: jump to next arrival
            return True
        old_cohorts = list(self.cohorts)
        dt = 0.0
        # prefill the joining cohort while the others decode
        if joiners:
            dt += self._admit(joiners)
        # one decode round over the in-flight cohorts
        if old_cohorts:
            dt += self._decode_round(old_cohorts)
        self.now += dt
        self._finalize()
        self.max_in_flight = max(self.max_in_flight, self.in_flight)
        return True

    def _admit(self, joiners: List[Request]) -> float:
        prompt_len = joiners[0].prompt_len
        if any(r.prompt_len != prompt_len for r in joiners):
            raise ValueError("one cohort = one prompt_len (pad upstream)")
        for r in joiners:
            r.admit_s = self.now
        cohort = _Cohort(requests=joiners)
        prompts = np.stack([np.asarray(r.prompt, np.int32) for r in joiners])
        state, toks, wall = self.engine.start_cohort(
            prompts, max_new=max(r.max_new for r in joiners), seed=self.seed)
        cohort.state = state
        cohort.pending = toks
        self.wall["prefill_s"] += wall
        self._emit(cohort, cohort.pending)
        self.cohorts.append(cohort)
        return wall

    def _decode_round(self, cohorts: List[_Cohort]) -> float:
        dt = 0.0
        for cohort in cohorts:
            state, toks, wall = self.engine.step_cohort(cohort.state,
                                                        cohort.pending)
            cohort.state = state
            cohort.pending = toks
            self.wall["decode_s"] += wall
            dt += wall
            self._emit(cohort, toks)
        return dt

    def _emit(self, cohort: _Cohort, tokens) -> None:
        """Credit one emitted token per live row (timestamps land in
        :meth:`_finalize`, after the iteration's dt is on the clock)."""
        for i, req in enumerate(cohort.requests):
            if req.done:
                continue
            tok = int(tokens[i])
            req.tokens.append(tok)
            req.emitted += 1
            if req.first_token_s is None:
                req.first_token_s = -1.0   # sentinel: stamp in _finalize
            if self.eos_id is not None and tok == self.eos_id:
                req.eos = True

    def _finalize(self) -> None:
        """Stamp this iteration's emissions/finishes at the advanced
        clock and retire fully-done cohorts."""
        keep = []
        for cohort in self.cohorts:
            for req in cohort.requests:
                if req.first_token_s == -1.0:
                    req.first_token_s = self.now
                if req.done and req.finish_s is None:
                    req.finish_s = self.now
                    self.completed.append(req)
            if not cohort.finished:
                keep.append(cohort)
        self.cohorts = keep

    # -- run loop ------------------------------------------------------------
    def run_until_drained(self) -> "BatchScheduler":
        """Run until the queue is empty and every cohort retired."""
        for _ in range(self.max_iterations):
            if not self.step():
                return self
        raise RuntimeError(f"scheduler did not drain within "
                           f"{self.max_iterations} iterations")

    # -- reporting -----------------------------------------------------------
    def report(self) -> dict:
        ttfts = [r.ttft_s for r in self.completed if r.ttft_s is not None]
        tpots = [r.tpot_s for r in self.completed if r.tpot_s is not None]
        waits = [r.queue_wait_s for r in self.completed
                 if r.queue_wait_s is not None]
        return {
            "completed": len(self.completed),
            "pending": len(self.queue),
            "in_flight": self.in_flight,
            "iterations": self.iterations,
            "max_in_flight": self.max_in_flight,
            "horizon_s": self.now,
            "ttft_p50_s": _pctl(ttfts, 50), "ttft_p99_s": _pctl(ttfts, 99),
            "tpot_p50_s": _pctl(tpots, 50), "tpot_p99_s": _pctl(tpots, 99),
            "queue_wait_p99_s": _pctl(waits, 99),
        }
