"""Admission control: how many queued requests join the decode batch.

Own copy of the reference's ``repro/serving/admission.py``, greedy only:
admit everything up to capacity.  The planner-informed policy
(``PlannerProbe``, TPOT-SLO holds, bucket plan staging) and the inputs it
reads arrive with the port's planner slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admit: int                      # requests to admit this iteration
    held: int                       # ready requests left waiting
    target_batch: int               # in-flight sequences after admission
    reason: str


class AdmissionController:
    """Decide per-iteration admission: grow the batch up to capacity."""

    def __init__(self, *, capacity: int = 64) -> None:
        self.capacity = max(1, int(capacity))

    def decide(self, *, in_flight: int, ready: int) -> AdmissionDecision:
        in_flight = max(0, int(in_flight))
        ready = max(0, int(ready))
        if ready == 0:
            return AdmissionDecision(0, 0, in_flight, "idle")
        free = self.capacity - in_flight
        if free <= 0:
            return AdmissionDecision(0, ready, in_flight, "capacity")
        want = min(free, ready)
        return AdmissionDecision(want, 0, in_flight + want, "greedy")
