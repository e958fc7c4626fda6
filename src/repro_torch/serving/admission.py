"""Planner-informed admission control.

The controller answers one question per scheduling iteration: *how many
queued requests may join the decode batch right now?*  Its policy is
informed by the planner's own batch-dependent knowledge (the Fig 8
scheme crossovers the planner reproduces):

- :class:`PlannerProbe` is the latency oracle — planner decisions for
  the decode-phase MoE round trip (dispatch + combine) at any batch
  bucket, the emergent scheme-crossover batch
  (:func:`~repro_torch.core.planner.emergent_flip_batch`), and the penalty of
  executing a *stale* scheme (the one bound for a smaller bucket) at a
  grown payload.  Every query rides the planner's LRU, so per-step
  admission checks never re-sweep.

- :class:`AdmissionController.decide` grows the batch greedily up to
  capacity, EXCEPT when the planner predicts the grown bucket's decode
  step would blow the TPOT SLO (the ``phase_budgets`` decode budget by
  default) — then it holds the batch at the largest SLO-feasible size
  below the crossover.  When growth crosses a batch-bucket boundary and
  IS admitted, the decision carries ``stage_bucket`` so the scheduler
  stages the next bucket's plan through ``PlanBinder`` ahead of the
  join: the swap at the next step boundary is a pointer flip, never a
  cold retrace.

A ``policy="greedy"`` controller is the crossover-oblivious baseline
``bench_serving`` compares against: it admits everything and never
stages a re-bind, so a grown batch keeps executing the scheme that won
at the small bucket.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.plan import batch_bucket

POLICIES = ("planner", "greedy")


def _metrics():
    from repro_torch.telemetry import metrics as _m
    return _m.default_registry()


class PlannerProbe:
    """Planner-backed latency oracle for one serving fabric.

    ``token_bytes`` is the per-token activation payload (d_model *
    itemsize, matching the traced dtype).  All queries are scored at
    power-of-two batch buckets and memoized locally on top of the
    planner's own LRU.
    """

    def __init__(self, topo, *, token_bytes: int = 14336,
                 num_experts: int = 64, top_k: int = 8, hw=None,
                 planner=None, d_model: int = 7168, f_shard: int = 2048,
                 tp: int = 1) -> None:
        from repro_torch.core.planner import default_planner
        self.topo = topo
        self.token_bytes = int(token_bytes)
        self.num_experts = int(num_experts)
        self.top_k = int(top_k)
        self.hw = hw
        self.planner = planner or default_planner()
        self.d_model = int(d_model)
        self.f_shard = int(f_shard)
        self.tp = max(1, int(tp))
        self._decisions: dict = {}
        self._xover: Optional[float] = None

    # -- planner decisions ---------------------------------------------------
    def decision(self, op: str, batch: int):
        """Planner decision for ``op`` at the bucketed per-rank batch."""
        b = batch_bucket(max(1, int(batch)))
        key = (op, b)
        d = self._decisions.get(key)
        if d is None:
            from repro_torch.core.latency_model import expert_compute_time_s
            compute_s = expert_compute_time_s(
                b, self.top_k, self.d_model, self.f_shard)
            d = self.planner.choose(
                op, float(b) * self.token_bytes, self.topo, self.hw,
                token_bytes=self.token_bytes, num_experts=self.num_experts,
                top_k=self.top_k, compute_s=compute_s)
            self._decisions[key] = d
        return d

    @staticmethod
    def _candidate_s(decision, scheme: str) -> float:
        """Predicted latency of a SPECIFIC scheme at the decision's
        payload (the stale-plan penalty lookup); falls back to the
        worst scored candidate when the scheme was not swept."""
        for name, _knobs, score in decision.candidates:
            if name == scheme:
                return float(score)
        scores = [float(s) for _n, _k, s in decision.candidates]
        return max(scores) if scores else float(decision.predicted_s)

    def scheme_at(self, batch: int) -> str:
        """Winning decode dispatch scheme at this batch bucket."""
        return self.decision("dispatch", batch).plan

    def decode_step_s(self, batch: int,
                      bound_batch: Optional[int] = None) -> float:
        """Predicted decode-step collective time (dispatch + combine) at
        the bucketed ``batch``.  With ``bound_batch`` given, the step is
        costed as if executing the scheme pair *bound for that bucket* —
        what a crossover-oblivious scheduler actually runs after the
        batch grew past the plan it bound."""
        d = self.decision("dispatch", batch)
        c = self.decision("combine", batch)
        if bound_batch is None or \
                batch_bucket(max(1, bound_batch)) == batch_bucket(
                    max(1, batch)):
            return float(d.predicted_s) + float(c.predicted_s)
        bd = self.decision("dispatch", bound_batch)
        bc = self.decision("combine", bound_batch)
        return (self._candidate_s(d, bd.plan) +
                self._candidate_s(c, bc.plan))

    def prefill_s(self, batch: int, prompt_len: int) -> float:
        """Predicted prefill collective time: the MoE round trip at
        ``batch * prompt_len`` tokens per rank."""
        tokens = max(1, int(batch) * int(prompt_len))
        d = self.decision("dispatch", tokens)
        c = self.decision("combine", tokens)
        return float(d.predicted_s) + float(c.predicted_s)

    def crossover_batch(self) -> float:
        """Smallest per-rank decode batch where the planner leaves the
        baseline dispatch scheme (inf: baseline always wins)."""
        if self._xover is None:
            from repro_torch.core.planner import emergent_flip_batch
            self._xover = emergent_flip_batch(
                "dispatch", self.topo, token_bytes=self.token_bytes,
                hw=self.hw, planner=self.planner,
                num_experts=self.num_experts, top_k=self.top_k)
        return self._xover


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admit: int                      # requests to admit this iteration
    held: int                       # ready requests deferred by policy
    target_batch: int               # in-flight sequences after admission
    stage_bucket: Optional[int]     # bucket plan to stage pre-join, or None
    reason: str


class AdmissionController:
    """Decide per-iteration admission; see module docstring."""

    def __init__(self, probe: Optional[PlannerProbe] = None, *,
                 capacity: int = 64, policy: str = "planner",
                 tpot_slo_s: Optional[float] = None,
                 ttft_slo_s: Optional[float] = None,
                 max_join: Optional[int] = None) -> None:
        if policy not in POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"expected one of {POLICIES}")
        self.probe = probe
        self.capacity = max(1, int(capacity))
        self.policy = policy
        self.tpot_slo_s = tpot_slo_s
        self.ttft_slo_s = ttft_slo_s
        # cap on joins per iteration: bounds the prefill chunk a deep
        # backlog can inject between two decode rounds (None: no cap)
        self.max_join = max_join
        self.holds = 0              # iterations that held below crossover
        self.held_requests = 0
        self.rejected = {}          # reason -> count

    def _reject(self, reason: str, n: int) -> None:
        if n <= 0:
            return
        self.rejected[reason] = self.rejected.get(reason, 0) + n
        _metrics()["repro_admission_rejects_total"].inc(n, reason=reason)

    def _max_slo_batch(self, lo: int, hi: int) -> int:
        """Largest target batch in (lo, hi] whose bucketed decode step
        meets the TPOT SLO; ``lo`` when none does."""
        best = lo
        for t in range(hi, lo, -1):
            if self.probe.decode_step_s(t) <= self.tpot_slo_s:
                best = t
                break
        return best

    def decide(self, *, in_flight: int, ready: int,
               oldest_wait_s: float = 0.0,
               bound_bucket: Optional[int] = None) -> AdmissionDecision:
        """One admission verdict.  ``bound_bucket`` is the batch bucket
        of the currently bound/staged plan (None: untracked)."""
        in_flight = max(0, int(in_flight))
        ready = max(0, int(ready))
        if ready == 0:
            return AdmissionDecision(0, 0, in_flight, None, "idle")
        free = self.capacity - in_flight
        if free <= 0:
            self._reject("capacity", ready)
            return AdmissionDecision(0, ready, in_flight, None, "capacity")
        want = min(free, ready)
        if self.max_join is not None:
            want = min(want, max(1, int(self.max_join)))
        target = in_flight + want
        if self.policy == "greedy" or self.probe is None or \
                self.tpot_slo_s is None:
            # crossover-oblivious: admit everything, stage nothing
            return AdmissionDecision(want, 0, target, None, "greedy")
        admit, reason = want, "admit"
        if self.probe.decode_step_s(target) > self.tpot_slo_s:
            feasible = self._max_slo_batch(in_flight, target)
            ttft_pressure = (self.ttft_slo_s is not None and
                             oldest_wait_s > 0.5 * self.ttft_slo_s)
            if ttft_pressure:
                # the queue head is about to blow its TTFT SLO — admit
                # anyway and eat the TPOT band; starving the queue to
                # protect TPOT just moves the SLO violation upstream
                reason = "ttft_pressure"
            else:
                admit = max(0, feasible - in_flight)
                reason = "tpot_slo_hold"
                self.holds += 1
                self.held_requests += want - admit
                self._reject("tpot_slo", want - admit)
        new_target = in_flight + admit
        stage = None
        if admit > 0:
            new_bucket = batch_bucket(max(1, new_target))
            if bound_bucket is not None and \
                    new_bucket != batch_bucket(max(1, bound_bucket)):
                stage = new_bucket
                xover = self.probe.crossover_batch()
                if reason == "admit":
                    reason = ("crossover_rebind"
                              if (xover is not math.inf and
                                  batch_bucket(max(1, bound_bucket)) <
                                  xover <= new_bucket)
                              else "bucket_rebind")
        return AdmissionDecision(admit, want - admit, new_target, stage,
                                 reason)
