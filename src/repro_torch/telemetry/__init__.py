"""Telemetry: the metrics registry that the planner and
``ParallelContext.bind`` count into.

``metrics.py`` and ``slo.py`` (the per-request SLO bands the serving
scheduler counts into) are verbatim copies of the reference's
``src/repro/telemetry/{metrics,slo}.py`` (``repro.`` read as
``repro_torch.``).  The rest of the reference's telemetry (probes,
calibration store, fit, monitor, exporter) is queue 1 item 7 of the port.
"""

from .metrics import (METRIC_SPECS, Counter, Gauge, Histogram,
                      MetricsRegistry, default_registry, parse_text,
                      reset_default_registry)
