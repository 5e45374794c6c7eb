"""Observability: query-lifecycle tracing, process-local metrics, and
exporters (JSONL spans, Chrome-trace JSON, Prometheus text) — the port's
copy of ``repro.obs``, pure Python, with the same names and output
formats, so the same operations give the same bytes.

* ``trace``   — hierarchical spans with a context-var trace context,
  wall-clock + virtual-clock dual timestamps, per-span attributes.
  Disabled by default: every instrumentation site goes through
  ``trace.span(...)``, a single context-var read returning a shared
  no-op handle when no tracer is active (no clock read, no device
  synchronize).
* ``metrics`` — process-local registry of counters / gauges /
  histograms with label sets.
* ``export``  — JSONL span dump, Chrome-trace/Perfetto JSON rendered
  from virtual-clock spans, and Prometheus text exposition.

The key derived signal is ``fatrq_model_drift_ratio{stage=...}``: every
traced stage records both its measured wall time and its
``QueryCost``-modeled time, so the histogram shows where the Table-I
tier model diverges from the card.
"""

from repro_torch.obs import export, metrics, trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import NOOP_SPAN, Span, Tracer

__all__ = ["export", "metrics", "trace",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NOOP_SPAN", "Span", "Tracer"]
