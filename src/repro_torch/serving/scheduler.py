"""Iteration-level (continuous-batching) request scheduler.

One scheduling **iteration** = (1) land any staged plan swap at the
step boundary (``PlanBinder.swap_if_pending`` — a pointer flip when the
bucket plan was prefetched), (2) consult the admission controller and
prefill the joining requests as a new *cohort*, (3) run one decode
round over every in-flight cohort.  Finished sequences release their
admission capacity at the iteration boundary and new requests join
right behind them — there is no drain-the-batch barrier
(``static_batching=True`` restores the barrier as the benchmark
baseline: nothing is admitted while any cohort is in flight).

A **cohort** is the set of requests admitted together: one prefill
call, position-aligned thereafter (every row advances one token per
iteration).  Cohorts are how iteration-level scheduling meets the
model API's static shapes — caches carry a single shared length
scalar, so joiners get their own cache rows at their own positions
instead of being scattered into a misaligned one.  Rows are
numerically independent under greedy decoding, which is why the
continuous path is bit-exact against one-shot ``generate`` for the
same request set (asserted in tests/test_serving.py).

Time is **virtual**: the clock advances by planner-predicted phase
times from a :class:`~repro_torch.serving.admission.PlannerProbe` (falling
back to measured wall when an engine runs without a probe), so the
whole tier is deterministic and CPU-simulation-testable.  With
``engine=None`` no tokens are computed at all — pure scheduling
simulation, what ``bench_serving`` sweeps and the stress soak drives.

Own copy of the reference's ``repro/serving/scheduler.py``, with one
addition: a retired cohort's state goes back to the engine
(``end_cohort``, where the engine has one), so that the port's engine can
hand the cohort's cache and decode graph to a later cohort of the same
shape.  Over ranks every rank runs this scheduler on the global requests;
the engine reports the slowest rank's walls, so every rank's clock, and
so every admission decision, agrees.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.plan import batch_bucket
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.queue import CLASS_TTFT_SLACK, Request, RequestQueue


def _metrics():
    from repro_torch.telemetry import metrics as _m
    return _m.default_registry()


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
    state: object = None          # engine cohort state (None in sim mode)
    pending: object = None        # last sampled tokens, next decode input

    @property
    def live(self) -> int:
        return sum(1 for r in self.requests if not r.done)

    @property
    def finished(self) -> bool:
        return all(r.done for r in self.requests)


class BatchScheduler:
    """Continuous-batching scheduler over a request queue.

    ``engine``: optional ServeEngine-compatible object providing
    ``start_cohort(prompts, max_new, seed)`` and
    ``step_cohort(state, tokens)``; None = pure scheduling simulation.
    ``probe``: optional PlannerProbe supplying virtual step times (and
    SLO denominators).  ``binder``/``plan_for_bucket``: the plan-prefetch
    seam — admission decisions that cross a batch bucket stage the
    bucket's plan so the swap at the next iteration is warm.
    """

    def __init__(self, *, queue: RequestQueue,
                 admission: AdmissionController,
                 engine=None, probe=None, binder=None,
                 plan_for_bucket: Optional[Callable] = None,
                 static_batching: bool = False,
                 eos_id: Optional[int] = None, seed: int = 0,
                 max_iterations: int = 1_000_000) -> None:
        self.queue = queue
        self.admission = admission
        self.engine = engine
        self.probe = probe
        self.binder = binder
        self.plan_for_bucket = plan_for_bucket
        self.static_batching = static_batching
        self.eos_id = eos_id
        self.seed = seed
        self.max_iterations = max_iterations
        self.now = 0.0
        self.step_time_scale = 1.0      # soak harness: degraded-fabric stall
        self.cohorts: List[_Cohort] = []
        self.completed: List[Request] = []
        self.iterations = 0
        self.max_in_flight = 0
        self.prefetch_rebinds = 0
        self.bound_bucket: Optional[int] = None
        self._staged_bucket: Optional[int] = None
        self.wall = {"prefill_s": 0.0, "decode_s": 0.0}

    # -- introspection -------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return sum(c.live for c in self.cohorts)

    @property
    def idle(self) -> bool:
        return not self.cohorts and not len(self.queue)

    # -- plan staging --------------------------------------------------------
    def _stage_bucket(self, bucket: int) -> None:
        if self.binder is None or self.plan_for_bucket is None:
            self.bound_bucket = bucket   # tracked, nothing to build
            return
        plan = self.plan_for_bucket(bucket)
        if plan is None:
            self.bound_bucket = bucket
            return
        if self.binder.stage(plan):
            self._staged_bucket = bucket
            self.prefetch_rebinds += 1
            _metrics()["repro_plan_prefetch_total"].inc(
                program=plan.program.name)
        else:
            self.bound_bucket = bucket   # already active

    # -- the iteration -------------------------------------------------------
    def step(self) -> bool:
        """One scheduling iteration; False when fully idle (queue empty
        and nothing in flight)."""
        self.iterations += 1
        # (1) step boundary: staged bucket/failover plans land here
        if self.binder is not None and self.binder.swap_if_pending():
            if self._staged_bucket is not None:
                self.bound_bucket = self._staged_bucket
                self._staged_bucket = None
        # (2) admission
        joiners: List[Request] = []
        ready = self.queue.ready_count(self.now)
        barrier = self.static_batching and bool(self.cohorts)
        if ready and not barrier:
            dec = self.admission.decide(
                in_flight=self.in_flight, ready=ready,
                oldest_wait_s=self.queue.oldest_wait_s(self.now),
                bound_bucket=self.bound_bucket)
            if dec.stage_bucket is not None:
                self._stage_bucket(dec.stage_bucket)
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
        # (3) prefill the joining cohort while the others decode
        if joiners:
            dt += self._admit(joiners)
        # (4) one decode round over the in-flight cohorts
        if old_cohorts:
            dt += self._decode_round(old_cohorts)
        self.now += dt
        self._finalize()
        reg = _metrics()
        reg["repro_serving_queue_depth"].set(self.queue.ready_count(self.now))
        reg["repro_serving_in_flight"].set(self.in_flight)
        self.max_in_flight = max(self.max_in_flight, self.in_flight)
        return True

    def _admit(self, joiners: List[Request]) -> float:
        n = len(joiners)
        prompt_len = joiners[0].prompt_len
        if any(r.prompt_len != prompt_len for r in joiners):
            raise ValueError("one cohort = one prompt_len (pad upstream)")
        in_flight_after = self.in_flight + n
        for r in joiners:
            r.admit_s = self.now
            if self.probe is not None:
                r.predicted_ttft_s = self.probe.prefill_s(n, prompt_len)
                r.predicted_tpot_s = self.probe.decode_step_s(
                    in_flight_after)
        if self.bound_bucket is None or self.static_batching:
            # first admission (or a fresh static batch): the plan bound
            # at startup covers this bucket
            self.bound_bucket = batch_bucket(max(1, in_flight_after))
        cohort = _Cohort(requests=joiners)
        dt = 0.0
        if self.engine is not None:
            prompts = np.stack([np.asarray(r.prompt, np.int32)
                                for r in joiners])
            state, toks, wall = self.engine.start_cohort(
                prompts, max_new=max(r.max_new for r in joiners),
                seed=self.seed)
            cohort.state = state
            cohort.pending = toks
            self.wall["prefill_s"] += wall
            if self.probe is None:
                dt = wall
        if self.probe is not None:
            dt = self.probe.prefill_s(n, prompt_len) * self.step_time_scale
        self._emit(cohort, cohort.pending)
        self.cohorts.append(cohort)
        _metrics()["repro_requests_total"].inc(n, outcome="admitted")
        return dt

    def _decode_round(self, cohorts: List[_Cohort]) -> float:
        dt = 0.0
        total = sum(c.live for c in cohorts)   # payload BEFORE finishes
        for cohort in cohorts:
            if self.engine is not None:
                state, toks, wall = self.engine.step_cohort(
                    cohort.state, cohort.pending)
                cohort.state = state
                cohort.pending = toks
                self.wall["decode_s"] += wall
                if self.probe is None:
                    dt += wall
                self._emit(cohort, toks)
            else:
                self._emit(cohort, None)
        if self.probe is not None:
            if total > 0:
                dt = self.probe.decode_step_s(
                    total, bound_batch=self.bound_bucket) * \
                    self.step_time_scale
        return dt

    def _emit(self, cohort: _Cohort, tokens) -> None:
        """Credit one emitted token per live row (timestamps land in
        :meth:`_finalize`, after the iteration's dt is on the clock)."""
        for i, req in enumerate(cohort.requests):
            if req.done:
                continue
            tok = None if tokens is None else int(tokens[i])
            if tok is not None:
                req.tokens.append(tok)
            req.emitted += 1
            if req.first_token_s is None:
                req.first_token_s = -1.0   # sentinel: stamp in _finalize
            if tok is not None and self.eos_id is not None and \
                    tok == self.eos_id:
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
                    self._complete(req)
            if cohort.finished:
                self._retire(cohort)
                continue    # exit: capacity released this boundary
            keep.append(cohort)
        self.cohorts = keep

    def _retire(self, cohort: _Cohort) -> None:
        end = getattr(self.engine, "end_cohort", None)
        if end is not None and cohort.state is not None:
            end(cohort.state)
        cohort.state = None

    def _complete(self, req: Request) -> None:
        self.completed.append(req)
        reg = _metrics()
        reg["repro_requests_total"].inc(outcome="completed")
        if req.queue_wait_s is not None:
            reg["repro_request_queue_wait_seconds"].observe(req.queue_wait_s)
        if req.ttft_s is not None:
            reg["repro_request_ttft_seconds"].observe(req.ttft_s)
        if req.tpot_s is not None:
            reg["repro_request_tpot_seconds"].observe(req.tpot_s)
        if req.predicted_ttft_s is not None:
            from repro_torch.telemetry import slo as _slo
            _slo.observe_request(
                {"ttft": req.ttft_s, "tpot": req.tpot_s},
                {"ttft": req.predicted_ttft_s, "tpot": req.predicted_tpot_s},
                slack=CLASS_TTFT_SLACK.get(req.slo_class, 1.0))

    # -- run loops -----------------------------------------------------------
    def run_until_drained(self) -> "BatchScheduler":
        """Run until the queue is empty and every cohort retired."""
        for _ in range(self.max_iterations):
            if not self.step():
                return self
        raise RuntimeError(f"scheduler did not drain within "
                           f"{self.max_iterations} iterations")

    def run_for(self, duration_s: float) -> "BatchScheduler":
        """Advance the virtual clock by ``duration_s`` (the soak
        harness's per-epoch window); returns early when fully idle."""
        t_end = self.now + duration_s
        for _ in range(self.max_iterations):
            if self.now >= t_end:
                return self
            if not self.step():
                self.now = t_end
                return self
        raise RuntimeError("run_for exceeded max_iterations")

    # -- reporting -----------------------------------------------------------
    def report(self, *, ttft_slo_s: Optional[float] = None,
               tpot_slo_s: Optional[float] = None) -> dict:
        ttfts = [r.ttft_s for r in self.completed if r.ttft_s is not None]
        tpots = [r.tpot_s for r in self.completed if r.tpot_s is not None]
        waits = [r.queue_wait_s for r in self.completed
                 if r.queue_wait_s is not None]
        out = {
            "completed": len(self.completed),
            "pending": len(self.queue),
            "in_flight": self.in_flight,
            "iterations": self.iterations,
            "max_in_flight": self.max_in_flight,
            "horizon_s": self.now,
            "ttft_p50_s": _pctl(ttfts, 50), "ttft_p99_s": _pctl(ttfts, 99),
            "tpot_p50_s": _pctl(tpots, 50), "tpot_p99_s": _pctl(tpots, 99),
            "queue_wait_p99_s": _pctl(waits, 99),
            "prefetch_rebinds": self.prefetch_rebinds,
            "admission_holds": self.admission.holds,
            "admission_rejects": dict(self.admission.rejected),
        }
        if self.binder is not None:
            out["plan_swaps"] = self.binder.swaps
            out["cold_retraces"] = self.binder.cold_retraces
        if ttft_slo_s is not None or tpot_slo_s is not None:
            good = [r for r in self.completed
                    if (ttft_slo_s is None or (r.ttft_s or 0.0)
                        <= ttft_slo_s * CLASS_TTFT_SLACK.get(r.slo_class, 1.0))
                    and (tpot_slo_s is None or r.tpot_s is None
                         or r.tpot_s <= tpot_slo_s)]
            out["slo_good"] = len(good)
            out["goodput_rps"] = (len(good) / self.now if self.now > 0
                                  else 0.0)
        return out
