"""Telemetry: the metrics registry that the planner and
``ParallelContext.bind`` count into.

``metrics.py`` is a verbatim copy of ``src/repro/telemetry/metrics.py``
(``repro.`` read as ``repro_torch.``).  The rest of the reference's
telemetry (probes, calibration store, fit, monitor, exporter, SLO bands)
is queue 1 item 7 of the port.
"""

from .metrics import (METRIC_SPECS, Counter, Gauge, Histogram,
                      MetricsRegistry, default_registry, parse_text,
                      reset_default_registry)
