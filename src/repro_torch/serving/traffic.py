"""Open-loop traffic generation: seeded Poisson arrivals.

The generator emits a fixed request list up front — interarrival gaps
drawn from an exponential distribution (the open-loop Poisson process
serving benchmarks standard on), prompt/output lengths and deadline
classes drawn from configurable discrete distributions.  Everything is
a pure function of the seed: no wall clock, no global RNG state, so a
scheduler driven by this traffic is deterministic and CPU-testable the
same way SimProbe makes the telemetry loop testable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.queue import DEADLINE_CLASSES, Request


def _normalize(probs: Optional[Sequence[float]], n: int) -> np.ndarray:
    if probs is None:
        return np.full(n, 1.0 / n)
    p = np.asarray(probs, float)
    if len(p) != n or (p < 0).any() or p.sum() <= 0:
        raise ValueError("probs must be non-negative, same length as "
                         "choices, and sum > 0")
    return p / p.sum()


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Open-loop arrival process, all in virtual seconds."""

    arrival_rate_rps: float = 8.0        # mean requests/second (Poisson)
    num_requests: int = 64
    prompt_lens: Sequence[int] = (128,)
    prompt_len_probs: Optional[Sequence[float]] = None
    max_news: Sequence[int] = (32,)
    max_new_probs: Optional[Sequence[float]] = None
    slo_classes: Sequence[str] = ("standard",)
    slo_class_probs: Optional[Sequence[float]] = None
    vocab: int = 0                        # > 0: draw prompt token ids too
    seed: int = 0

    def __post_init__(self) -> None:
        if self.arrival_rate_rps <= 0:
            raise ValueError("arrival_rate_rps must be > 0")
        if self.num_requests < 1:
            raise ValueError("num_requests must be >= 1")
        for c in self.slo_classes:
            if c not in DEADLINE_CLASSES:
                raise ValueError(f"unknown deadline class {c!r}")


class TrafficGenerator:
    """Deterministic request stream for one :class:`TrafficConfig`."""

    def __init__(self, cfg: TrafficConfig) -> None:
        self.cfg = cfg

    def requests(self) -> List[Request]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        gaps = rng.exponential(1.0 / cfg.arrival_rate_rps,
                               size=cfg.num_requests)
        arrivals = np.cumsum(gaps)
        p_len = _normalize(cfg.prompt_len_probs, len(cfg.prompt_lens))
        p_new = _normalize(cfg.max_new_probs, len(cfg.max_news))
        p_cls = _normalize(cfg.slo_class_probs, len(cfg.slo_classes))
        lens = rng.choice(np.asarray(cfg.prompt_lens, int),
                          size=cfg.num_requests, p=p_len)
        news = rng.choice(np.asarray(cfg.max_news, int),
                          size=cfg.num_requests, p=p_new)
        classes = rng.choice(np.asarray(cfg.slo_classes, object),
                             size=cfg.num_requests, p=p_cls)
        out: List[Request] = []
        for i in range(cfg.num_requests):
            prompt = None
            if cfg.vocab > 0:
                prompt = rng.integers(1, cfg.vocab, size=int(lens[i]),
                                      dtype=np.int64).astype(np.int32)
            out.append(Request(rid=i, arrival_s=float(arrivals[i]),
                               prompt=prompt, prompt_len=int(lens[i]),
                               max_new=int(news[i]),
                               slo_class=str(classes[i])))
        return out
