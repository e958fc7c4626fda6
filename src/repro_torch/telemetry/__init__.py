"""Telemetry and online calibration: measured collectives close the
planner's feedback loop.  Port of ``src/repro/telemetry``.

    probe.py    timed execution of registered plans: LiveProbe over a
                RankMesh and torch.distributed (rewritten), or the
                pure-simulation SimProbe with injectable ground truth
    store.py    append-only JSONL CalibrationStore (schema-versioned,
                keyed by fabric fingerprint / op / payload bucket); the
                port's default file is under results/calibration_torch/
    fit.py      per-link-class alpha/beta regression -> the measurements
                dict HardwareModel.recalibrated accepts
    monitor.py  drift watchdog: predicted-vs-measured divergence
                triggers re-fit + planner.refresh_hardware
    failover.py rail failure detection from probe timeouts
    metrics.py  dependency-free counter/gauge/histogram registry with
                Prometheus text exposition (METRIC_SPECS is the schema)
    exporter.py stdlib /metrics HTTP endpoint + snapshot-to-file
    slo.py      good/acceptable/poor banding of measured latency
                against the planner's own prediction

Every module but ``probe.py``'s ``LiveProbe`` is the reference's text with
``repro.`` read as ``repro_torch.`` (the store's default directory aside).
Consumed by: ParallelContext(calibration=...), ServeEngine(calibration=,
monitor=), ``launch/serve.py --calibrate`` and ``launch/stress.py``.
"""

from .exporter import MetricsExporter, scrape, write_snapshot
from .failover import FailureDetector, rail_probe_ledger
from .fit import (FitResult, calibrated_hw, fit_link_class,
                  fit_link_classes, fit_link_roles, fit_measurements,
                  fit_overlap_eff)
from .metrics import (METRIC_SPECS, Counter, Gauge, Histogram,
                      MetricsRegistry, default_registry, parse_text,
                      reset_default_registry)
from .monitor import DriftMonitor, StepAttribution, startup_calibration
from .probe import (GroundTruth, LiveProbe, ProbePolicy, ProbeTimeout,
                    SimProbe, attributed_bottleneck, default_payloads,
                    ledger_class_bytes, ledger_role_bytes, link_class,
                    link_role, measure_safely, probe_link_directions,
                    probe_record, probe_sweep)
from .slo import classify, classify_record, classify_records
from .store import (SCHEMA_VERSION, CalibrationStore, resolve_store,
                    topo_key)

__all__ = [
    "CalibrationStore", "Counter", "DriftMonitor", "FailureDetector",
    "FitResult", "Gauge", "GroundTruth", "Histogram", "LiveProbe",
    "METRIC_SPECS", "MetricsExporter", "MetricsRegistry", "ProbePolicy",
    "ProbeTimeout", "SCHEMA_VERSION", "SimProbe", "StepAttribution",
    "attributed_bottleneck", "calibrated_hw", "classify",
    "classify_record", "classify_records", "default_payloads",
    "default_registry", "fit_link_class", "fit_link_classes",
    "fit_link_roles", "fit_measurements", "fit_overlap_eff",
    "ledger_class_bytes", "ledger_role_bytes", "link_class", "link_role",
    "measure_safely", "parse_text", "probe_link_directions",
    "probe_record", "probe_sweep", "rail_probe_ledger",
    "reset_default_registry", "resolve_store", "scrape",
    "startup_calibration", "topo_key", "write_snapshot",
]
