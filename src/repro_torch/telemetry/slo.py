"""SLO classification of measured collective latencies.

The bands are derived from the planner's OWN predicted latency, not a
hand-pinned threshold table: a cell is "good" when the fabric delivers
what the fitted HardwareModel promised, "poor" when reality has drifted
past the point where the planner's decisions can be trusted.  That
makes the SLO self-updating — a recalibration that swaps in a truer
model moves the bands with it.

    good        measured <= GOOD_RATIO   x predicted   (default 1.2x)
    acceptable  measured <= ACCEPT_RATIO x predicted   (default 2.0x)
    poor        measured >  ACCEPT_RATIO x predicted
    unknown     no usable prediction (missing / zero / negative)

Boundaries are inclusive on the cheaper side: measured == 1.2x is still
"good", == 2.0x is still "acceptable" (a measurement exactly on a band
edge never flaps to the worse class from float formatting).

Consumed by DriftMonitor.observe (every probe record is classified into
``repro_slo_class_total`` / ``repro_slo_ratio``) and by the stress
harness, which asserts good -> poor -> good across an injected
degradation window.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

GOOD_RATIO = 1.2
ACCEPT_RATIO = 2.0

CLASSES = ("good", "acceptable", "poor", "unknown")


def classify(measured_s: Optional[float], predicted_s: Optional[float],
             *, good: float = GOOD_RATIO,
             acceptable: float = ACCEPT_RATIO) -> str:
    """Band a single measurement against its prediction."""
    if predicted_s is None or measured_s is None:
        return "unknown"
    p = float(predicted_s)
    m = float(measured_s)
    if not (p > 0.0) or m != m or p != p:  # non-positive or NaN
        return "unknown"
    if m <= good * p:
        return "good"
    if m <= acceptable * p:
        return "acceptable"
    return "poor"


def classify_record(record: Mapping, *, good: float = GOOD_RATIO,
                    acceptable: float = ACCEPT_RATIO) -> str:
    """Band one probe/store record (``measured_s`` vs ``predicted_s``)."""
    return classify(record.get("measured_s"), record.get("predicted_s"),
                    good=good, acceptable=acceptable)


def classify_records(records: Iterable[Mapping], *,
                     good: float = GOOD_RATIO,
                     acceptable: float = ACCEPT_RATIO) -> dict:
    """Per-cell worst-case banding over a batch of records.

    Returns ``{(op, payload_bucket): class}`` where each cell takes the
    WORST class observed in the batch (a cell with one poor probe among
    nine good ones is poor — SLOs report the tail, not the mode).
    """
    rank = {c: i for i, c in enumerate(("good", "acceptable", "poor"))}
    cells: dict = {}
    for rec in records:
        cls = classify_record(rec, good=good, acceptable=acceptable)
        if cls == "unknown":
            continue
        key = (rec.get("op"), rec.get("bucket"))
        prev = cells.get(key)
        if prev is None or rank[cls] > rank[prev]:
            cells[key] = cls
    return cells


REQUEST_METRICS = ("ttft", "tpot")


def classify_request(measured: Mapping, predicted: Mapping, *,
                     slack: float = 1.0, good: float = GOOD_RATIO,
                     acceptable: float = ACCEPT_RATIO) -> dict:
    """Band one serving request's TTFT/TPOT against the planner's
    predicted service times (the serving tier's per-request SLO).

    ``measured``/``predicted`` map ``"ttft"``/``"tpot"`` to seconds;
    ``slack`` multiplies the prediction before banding — the deadline
    class's tolerance (interactive 1x, batch traffic much looser).
    Returns per-metric classes plus ``"overall"`` (the worst, matching
    the worst-per-cell convention of :func:`classify_records`)."""
    rank = {c: i for i, c in enumerate(("good", "acceptable", "poor"))}
    out = {}
    worst = None
    for m in REQUEST_METRICS:
        p = predicted.get(m)
        scaled = p * slack if p is not None else None
        cls = classify(measured.get(m), scaled,
                       good=good, acceptable=acceptable)
        out[m] = cls
        if cls != "unknown" and (worst is None or
                                 rank[cls] > rank[worst]):
            worst = cls
    out["overall"] = worst if worst is not None else "unknown"
    return out


def observe_request(measured: Mapping, predicted: Mapping, *,
                    slack: float = 1.0, registry=None,
                    good: float = GOOD_RATIO,
                    acceptable: float = ACCEPT_RATIO) -> dict:
    """Classify one request (:func:`classify_request`) and emit the
    per-metric classes into ``repro_request_slo_class_total``."""
    from . import metrics as _m
    reg = registry if registry is not None else _m.default_registry()
    cls = classify_request(measured, predicted, slack=slack,
                           good=good, acceptable=acceptable)
    for m in REQUEST_METRICS:
        reg["repro_request_slo_class_total"].inc(metric=m, slo=cls[m])
    return cls


def observe_record(record: Mapping, *, registry=None,
                   good: float = GOOD_RATIO,
                   acceptable: float = ACCEPT_RATIO) -> str:
    """Classify one record and emit it into the metrics plane."""
    from . import metrics as _m
    reg = registry if registry is not None else _m.default_registry()
    cls = classify_record(record, good=good, acceptable=acceptable)
    labels = dict(op=str(record.get("op", "")),
                  payload_bucket=str(record.get("bucket", "")),
                  fabric=str(record.get("fabric_name", "")))
    reg["repro_slo_class_total"].inc(slo=cls, **labels)
    p = record.get("predicted_s")
    m = record.get("measured_s")
    if p and m is not None and float(p) > 0.0:
        reg["repro_slo_ratio"].set(float(m) / float(p), **labels)
    return cls
