"""Dependency-free metrics plane: counters / gauges / histograms with
Prometheus text exposition rendering.

This is the OBSERVABILITY face of the planner/telemetry loop — every
seam of the closed loop (planner decisions, drift watchdog,
recalibrations, plan binds/replans/stale events, step wall times, SLO
verdicts) increments a metric here, and the exporter
(:mod:`repro_torch.telemetry.exporter`) serves the rendered registry at
``/metrics`` or snapshots it to a file.  Zero third-party dependencies:
a scrape target must never be the thing that breaks the server.

Label scheme (keep it small — cardinality is a production budget):

    op             collective op ("dispatch", "allgather", ...)
    payload_bucket power-of-two payload bucket (bytes, as a string)
    fabric         topology name the decision/probe was scored on
    phase          program phase ("train" | "prefill" | "decode")
    scheme         winning plan name ("unicast", "multiwrite", ...)
    program        declared CollectiveProgram name
    fingerprint    ExecutionPlan fingerprint (bind/replan/stale events)
    slo            SLO class ("good" | "acceptable" | "poor" | "unknown")

Every metric this plane can emit is declared ONCE in
:data:`METRIC_SPECS`; :func:`default_registry` pre-registers all of
them so a scrape always exposes the full schema (HELP/TYPE headers even
before the first sample) and METRICS.md can be checked against the spec
table mechanically (the CI docs-sync gate).
"""

from __future__ import annotations

import math
import threading
from typing import Iterable, Mapping, Optional, Sequence

# default latency buckets (seconds): 1us .. ~100s, 4 per decade — wide
# enough for a 10us decode collective and a multi-minute compile step
DEFAULT_BUCKETS = tuple(
    round(10.0 ** (e / 4.0), 10) for e in range(-24, 9)
)


def _escape_label(v: object) -> str:
    return (str(v).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _label_key(labelnames: Sequence[str], labels: Mapping) -> tuple:
    extra = set(labels) - set(labelnames)
    if extra:
        raise ValueError(f"unknown label(s) {sorted(extra)}; "
                         f"declared: {list(labelnames)}")
    return tuple(str(labels.get(name, "")) for name in labelnames)


class Metric:
    """Base: one named metric with a fixed label schema."""

    type = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    # -- introspection (tests / snapshots) -----------------------------------
    def value(self, **labels) -> float:
        return self._values.get(_label_key(self.labelnames, labels), 0.0)

    def samples(self) -> list[tuple[dict, float]]:
        """[(labels dict, value), ...] sorted by label values."""
        return [(dict(zip(self.labelnames, key)), v)
                for key, v in sorted(self._values.items())]

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    # -- rendering -----------------------------------------------------------
    def _render_series(self, suffix: str, key: tuple, value: float,
                       extra: Sequence[tuple] = ()) -> str:
        pairs = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(self.labelnames, key)]
        pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
        label_s = "{" + ",".join(pairs) + "}" if pairs else ""
        return f"{self.name}{suffix}{label_s} {_format_value(value)}"

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.type}"]
        for key in sorted(self._values):
            lines.append(self._render_series("", key, self._values[key]))
        return lines


class Counter(Metric):
    type = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(Metric):
    type = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics: an observation
    equal to a bucket's upper bound ``le`` lands IN that bucket)."""

    type = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = tuple(bs)
        # per label key: [bucket counts..., +Inf count, sum]
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        v = float(value)
        with self._lock:
            row = self._series.get(key)
            if row is None:
                row = [0] * (len(self.buckets) + 1) + [0.0]
                self._series[key] = row
            for i, b in enumerate(self.buckets):
                if v <= b:
                    row[i] += 1
                    break
            else:
                row[len(self.buckets)] += 1
            row[-1] += v

    # -- introspection -------------------------------------------------------
    def count(self, **labels) -> int:
        row = self._series.get(_label_key(self.labelnames, labels))
        return int(sum(row[:-1])) if row else 0

    def sum(self, **labels) -> float:
        row = self._series.get(_label_key(self.labelnames, labels))
        return float(row[-1]) if row else 0.0

    def bucket_counts(self, **labels) -> dict:
        """Cumulative count per ``le`` bound (including ``+Inf``)."""
        row = self._series.get(_label_key(self.labelnames, labels))
        if row is None:
            row = [0] * (len(self.buckets) + 1) + [0.0]
        out, acc = {}, 0
        for b, c in zip(self.buckets, row):
            acc += c
            out[b] = acc
        out[math.inf] = acc + row[len(self.buckets)]
        return out

    def samples(self) -> list[tuple[dict, float]]:
        return [(dict(zip(self.labelnames, key)), float(sum(row[:-1])))
                for key, row in sorted(self._series.items())]

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.type}"]
        for key in sorted(self._series):
            acc = 0
            row = self._series[key]
            for i, b in enumerate(self.buckets):
                acc += row[i]
                lines.append(self._render_series(
                    "_bucket", key, acc, extra=(("le", _format_value(b)),)))
            acc += row[len(self.buckets)]
            lines.append(self._render_series(
                "_bucket", key, acc, extra=(("le", "+Inf"),)))
            lines.append(self._render_series("_sum", key, row[-1]))
            lines.append(self._render_series("_count", key, acc))
        return lines


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Named metric collection rendering Prometheus text exposition."""

    def __init__(self) -> None:
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _register(self, metric: Metric) -> Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric) or \
                        existing.labelnames != metric.labelnames:
                    raise ValueError(
                        f"metric {metric.name!r} re-registered with a "
                        f"different type/label schema")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help, labelnames))

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help, labelnames, buckets))

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def __getitem__(self, name: str) -> Metric:
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every series (registrations stay)."""
        for m in self._metrics.values():
            m.clear()

    def render(self) -> str:
        """Prometheus text exposition (deterministic: metrics sorted by
        name, series sorted by label values)."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# text-format parsing (tests + the stress harness's scrape assertions)
# ---------------------------------------------------------------------------

def parse_text(text: str) -> dict:
    """Parse Prometheus text exposition back into
    ``{(name, (sorted (label, value) pairs)): float}`` — the round-trip
    half of the render/parse contract tests hold."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, _, rest = line.partition("{")
            labels_s, _, value_s = rest.rpartition("} ")
            labels = []
            for item in _split_labels(labels_s):
                k, _, v = item.partition("=")
                v = v.strip('"').replace("\\\"", "\"") \
                     .replace("\\n", "\n").replace("\\\\", "\\")
                labels.append((k, v))
            key = (name, tuple(sorted(labels)))
        else:
            name, _, value_s = line.rpartition(" ")
            key = (name, ())
        value_s = value_s.strip()
        value = (math.inf if value_s == "+Inf"
                 else -math.inf if value_s == "-Inf" else float(value_s))
        out[key] = value
    return out


def _split_labels(s: str) -> Iterable[str]:
    """Split ``k1="v1",k2="v2"`` respecting quoted/escaped commas."""
    out, cur, in_q, esc = [], [], False, False
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


# ---------------------------------------------------------------------------
# the metric schema (the ONE place a metric name may be introduced;
# METRICS.md must document every name here — CI greps for drift)
# ---------------------------------------------------------------------------

# planning wall times run 100us..10s; step walls run 1ms..minutes
_WALL_BUCKETS = tuple(round(10.0 ** (e / 2.0), 10) for e in range(-8, 5))

METRIC_SPECS = {
    # -- planner -------------------------------------------------------------
    "repro_planner_decisions_total": dict(
        type="counter", labels=("op", "scheme", "fabric", "payload_bucket"),
        help="Fresh planner decisions (cache misses swept and logged), "
             "by winning scheme."),
    "repro_planner_cache_hits_total": dict(
        type="counter", labels=(),
        help="Planner LRU cache hits (per-op and program caches)."),
    "repro_planner_cache_misses_total": dict(
        type="counter", labels=(),
        help="Planner LRU cache misses (fresh sweeps)."),
    "repro_planner_decision_flips_total": dict(
        type="counter", labels=("op", "fabric", "payload_bucket"),
        help="Fresh decisions whose winning scheme differs from the "
             "previous decision for the same (op, fabric, payload) cell "
             "— the in-process plan churn a recalibration causes."),
    "repro_planner_decision_log_dropped_total": dict(
        type="counter", labels=(),
        help="decision_log rows evicted by the ring buffer cap."),
    "repro_planner_planning_wall_seconds": dict(
        type="histogram", labels=("program",), buckets=_WALL_BUCKETS,
        help="plan_program wall time per declared program."),
    "repro_planner_search_combos_scored": dict(
        type="gauge", labels=("program",),
        help="Phase-search combinations scored by the last plan_program "
             "for this program."),
    "repro_planner_search_combos_pruned": dict(
        type="gauge", labels=("program",),
        help="Phase-search combinations pruned (product - scored) by the "
             "last plan_program for this program."),
    "repro_planner_search_product": dict(
        type="gauge", labels=("program",),
        help="Full candidate product of the last plan_program for this "
             "program (what the exhaustive oracle would sweep)."),
    # -- drift monitor -------------------------------------------------------
    "repro_drift_ratio": dict(
        type="gauge", labels=("op", "fabric"),
        help="Median |measured-predicted|/predicted over the monitor's "
             "observation window, per op (1.0 = 100% drift)."),
    "repro_drift_checks_total": dict(
        type="counter", labels=("fabric",),
        help="Drift checks performed by the monitor."),
    "repro_probe_observations_total": dict(
        type="counter", labels=("op", "fabric"),
        help="Probe records fed into the drift monitor."),
    "repro_recalibrations_total": dict(
        type="counter", labels=("fabric",),
        help="Fit + refresh_hardware + replan events."),
    "repro_recalibration_seconds": dict(
        type="histogram", labels=("fabric",), buckets=_WALL_BUCKETS,
        help="Wall time of one recalibration (fit + hardware swap + "
             "program replans)."),
    "repro_fit_rejected_total": dict(
        type="counter", labels=("fabric",),
        help="Per-class link fits rejected by the confidence floor "
             "(untrusted: too few points, low R^2, ...) during "
             "recalibration."),
    # -- plan lifecycle ------------------------------------------------------
    "repro_plan_bind_total": dict(
        type="counter", labels=("program", "fingerprint"),
        help="ExecutionPlan binds (pctx.bind) by program and plan "
             "fingerprint."),
    "repro_plan_replan_total": dict(
        type="counter", labels=("program", "changed"),
        help="Program replans after recalibration; changed=\"true\" "
             "when the fresh fingerprint differs."),
    "repro_plan_stale_total": dict(
        type="counter", labels=("program", "fingerprint"),
        help="Stale-bound-plan warnings (one-shot per drift event): the "
             "bound fingerprint was superseded by a replan."),
    # -- runtime (serve/train) ----------------------------------------------
    "repro_step_wall_seconds": dict(
        type="histogram", labels=("phase",), buckets=_WALL_BUCKETS,
        help="Wall time per executed step: train steps, serve prefill, "
             "serve decode (whole decode loop)."),
    "repro_phase_budget_ok": dict(
        type="gauge", labels=("phase", "fingerprint"),
        help="1 when the phase's contended score meets its declared "
             "latency budget, else 0 (phases without budgets absent)."),
    "repro_phase_predicted_seconds": dict(
        type="gauge", labels=("phase", "fingerprint"),
        help="Planner-predicted contention-aware score of each phase of "
             "the bound/reported ExecutionPlan."),
    # -- SLO classification --------------------------------------------------
    "repro_slo_class_total": dict(
        type="counter",
        labels=("op", "payload_bucket", "fabric", "slo"),
        help="Probe measurements classified against the planner's own "
             "predicted latency: good (<= 1.2x), acceptable (<= 2x), "
             "poor (> 2x), unknown (no usable prediction)."),
    "repro_slo_ratio": dict(
        type="gauge", labels=("op", "payload_bucket", "fabric"),
        help="Latest measured/predicted latency ratio per op x payload "
             "cell (the quantity the SLO bands cut)."),
    # -- fault tolerance -----------------------------------------------------
    "repro_probe_failures_total": dict(
        type="counter", labels=("reason", "fabric"),
        help="Probe attempts that failed after exhausting the retry "
             "policy (reason: timeout, error); failed probes produce no "
             "calibration record instead of crashing the cycle."),
    "repro_plan_infeasible_total": dict(
        type="counter", labels=("op", "fabric"),
        help="Plan candidates masked as infeasible under the topology's "
             "FailureState (ledger charges a dead link, or the plan's "
             "relay engine is dead) during a planner sweep."),
    "repro_failures_detected_total": dict(
        type="counter", labels=("fabric", "kind"),
        help="Fault declarations by the failure detector (kind: link) "
             "after K consecutive probe timeouts on the same target."),
    "repro_failures_recovered_total": dict(
        type="counter", labels=("fabric", "kind"),
        help="Fault revivals by the failure detector: a previously-dead "
             "target answered a probe again."),
    "repro_failed_links": dict(
        type="gauge", labels=("fabric",),
        help="Directed links currently declared dead by the failure "
             "detector."),
    "repro_plan_rebind_total": dict(
        type="counter", labels=("program", "fingerprint"),
        help="Hot plan re-binds: a staged ExecutionPlan swapped in at a "
             "step boundary by the double-buffered binder."),
    "repro_rebind_cold_retrace_total": dict(
        type="counter", labels=("program",),
        help="Re-bind swaps that had to build their traced lowering AT "
             "the swap point (the pending artifact was missing) — the "
             "cold retrace the double-buffered binder exists to avoid; "
             "should stay 0."),
    "repro_lowering_cache_hits_total": dict(
        type="counter", labels=("program",),
        help="Traced-lowering cache hits keyed on plan fingerprint: a "
             "staged plan reused an existing lowering (e.g. recovery "
             "flipping back to the pre-failure plan) with no retrace."),
    "repro_lowering_cache_misses_total": dict(
        type="counter", labels=("program",),
        help="Traced-lowering cache misses: a staged plan's lowering was "
             "built fresh, off the step path (double-buffered, not a "
             "cold retrace)."),
    # -- serving tier (continuous batching) ----------------------------------
    "repro_request_ttft_seconds": dict(
        type="histogram", labels=(), buckets=_WALL_BUCKETS,
        help="Per-request time to first token (virtual serving clock), "
             "queue wait included."),
    "repro_request_tpot_seconds": dict(
        type="histogram", labels=(), buckets=_WALL_BUCKETS,
        help="Per-request time per output token over the decode tail "
             "(excludes the prefill-produced first token)."),
    "repro_request_queue_wait_seconds": dict(
        type="histogram", labels=(), buckets=_WALL_BUCKETS,
        help="Per-request wait between arrival and admission into a "
             "decode cohort."),
    "repro_serving_queue_depth": dict(
        type="gauge", labels=(),
        help="Arrived-but-unadmitted requests after the last scheduling "
             "iteration."),
    "repro_serving_in_flight": dict(
        type="gauge", labels=(),
        help="Live (admitted, unfinished) sequences after the last "
             "scheduling iteration — the decode batch the planner's "
             "crossovers are cut against."),
    "repro_requests_total": dict(
        type="counter", labels=("outcome",),
        help="Request lifecycle events by outcome (admitted, "
             "completed)."),
    "repro_admission_rejects_total": dict(
        type="counter", labels=("reason",),
        help="Ready requests NOT admitted this iteration, by reason: "
             "capacity (slots full) or tpot_slo (the planner predicts "
             "the grown decode bucket would blow the TPOT SLO — the "
             "crossover-aware hold)."),
    "repro_request_slo_class_total": dict(
        type="counter", labels=("metric", "slo"),
        help="Per-request SLO classes cut against the planner's own "
             "predicted service times (metric: ttft, tpot), using the "
             "standard good/acceptable/poor bands times the request's "
             "deadline-class slack."),
    "repro_plan_prefetch_total": dict(
        type="counter", labels=("program",),
        help="Batch-bucket plan prefetches: a neighboring bucket's "
             "ExecutionPlan staged through PlanBinder ahead of "
             "admission, so batch growth across the bucket swaps on a "
             "warm lowering (pointer flip, never a cold retrace)."),
}


def _build(registry: MetricsRegistry) -> MetricsRegistry:
    for name, spec in METRIC_SPECS.items():
        kind = spec["type"]
        if kind == "counter":
            registry.counter(name, spec["help"], spec["labels"])
        elif kind == "gauge":
            registry.gauge(name, spec["help"], spec["labels"])
        else:
            registry.histogram(name, spec["help"], spec["labels"],
                               spec.get("buckets", DEFAULT_BUCKETS))
    return registry


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    """Process-wide registry with every :data:`METRIC_SPECS` metric
    pre-registered — what the instrumented seams and the exporter share."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = _build(MetricsRegistry())
    return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Zero every series of the process-wide registry (tests / the
    stress harness start each run from a clean plane)."""
    reg = default_registry()
    reg.reset()
    return reg
