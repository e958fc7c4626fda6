"""Request lifecycle + the deadline-class-aware admission queue.

A :class:`Request` carries its whole serving lifecycle in virtual time
(seconds on the scheduler's clock, never the wall): arrival, admission
(queue exit), first token (TTFT) and finish — the quantities the
per-request SLO classes and the serving histograms cut.

:class:`RequestQueue` is an arrival-time-gated priority FIFO: only
requests whose ``arrival_s`` has passed are visible, and within the
visible set the deadline classes pop in priority order
(``interactive`` before ``standard`` before ``batch``), FIFO inside a
class.  The queue never drops — backpressure is the admission
controller's job, and the stress soak asserts a dark rail drains the
queue without losing a request.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

DEADLINE_CLASSES = ("interactive", "standard", "batch")

# TTFT slack multiplier per deadline class: an interactive request cuts
# its SLO against the raw planner prediction; batch traffic tolerates a
# deep queue before its class degrades.
CLASS_TTFT_SLACK = {"interactive": 1.0, "standard": 2.0, "batch": 8.0}


@dataclasses.dataclass
class Request:
    """One serving request, in virtual time."""

    rid: int
    arrival_s: float = 0.0
    prompt: object = None            # np.ndarray [prompt_len] int32, or None
    prompt_len: int = 0
    max_new: int = 32
    slo_class: str = "standard"
    # -- lifecycle (stamped by the scheduler) --------------------------------
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    tokens: list = dataclasses.field(default_factory=list)
    emitted: int = 0                 # tokens emitted so far (sim + engine)
    eos: bool = False                # finished by EOS (vs max_new)
    # planner predictions captured at admission (SLO denominators)
    predicted_ttft_s: Optional[float] = None
    predicted_tpot_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.slo_class not in DEADLINE_CLASSES:
            raise ValueError(f"unknown deadline class {self.slo_class!r}; "
                             f"expected one of {DEADLINE_CLASSES}")
        if self.prompt is not None and not self.prompt_len:
            self.prompt_len = len(self.prompt)
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")

    # -- derived latencies ---------------------------------------------------
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_s is None:
            return None
        return self.admit_s - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, queue wait included."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token over the decode tail (excludes the
        prefill-produced first token); None until >= 2 tokens landed."""
        if self.finish_s is None or self.first_token_s is None:
            return None
        if self.emitted < 2:
            return None
        return (self.finish_s - self.first_token_s) / (self.emitted - 1)

    @property
    def done(self) -> bool:
        return self.eos or self.emitted >= self.max_new


class RequestQueue:
    """Arrival-gated, deadline-class-prioritized FIFO."""

    def __init__(self) -> None:
        self._pending: List[Request] = []
        self._seq = itertools.count()   # stable FIFO tiebreak
        self._order: dict = {}
        self.pushed = 0
        self.popped = 0

    def push(self, req: Request) -> None:
        self._order[id(req)] = next(self._seq)
        self._pending.append(req)
        self.pushed += 1

    def __len__(self) -> int:
        return len(self._pending)

    def ready(self, now: float) -> List[Request]:
        """Arrived-but-unadmitted requests, in pop order."""
        cls_rank = {c: i for i, c in enumerate(DEADLINE_CLASSES)}
        ready = [r for r in self._pending if r.arrival_s <= now]
        ready.sort(key=lambda r: (cls_rank[r.slo_class], r.arrival_s,
                                  self._order[id(r)]))
        return ready

    def ready_count(self, now: float) -> int:
        return sum(1 for r in self._pending if r.arrival_s <= now)

    def oldest_wait_s(self, now: float) -> float:
        waits = [now - r.arrival_s for r in self._pending
                 if r.arrival_s <= now]
        return max(waits) if waits else 0.0

    def next_arrival_s(self, now: Optional[float] = None) -> Optional[float]:
        """Earliest future arrival (or earliest at all when ``now`` is
        None); None when the queue is empty."""
        times = [r.arrival_s for r in self._pending
                 if now is None or r.arrival_s > now]
        if not times and now is not None:
            times = [r.arrival_s for r in self._pending]
        return min(times) if times else None

    def pop_ready(self, now: float, n: int) -> List[Request]:
        """Admit up to ``n`` arrived requests in priority order."""
        take = self.ready(now)[:max(0, int(n))]
        taken = {id(r) for r in take}
        self._pending = [r for r in self._pending if id(r) not in taken]
        for r in take:
            self._order.pop(id(r), None)
        self.popped += len(take)
        return take
