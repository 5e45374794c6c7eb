"""Process-local metrics registry: counters, gauges, histograms with
label sets.

Prometheus-shaped but dependency-free: a ``MetricsRegistry`` owns named
metrics; each metric fans out into labeled children (``labels(**kv)``)
that hold the actual values.  ``export.prometheus_text`` renders a
registry in the text exposition format; ``flat()`` returns one flat
``{"name{label=\"v\"}": value}`` dict for tests and quick printing.

Two registries matter in practice:

* the **default registry** (``active()`` with nothing else activated) —
  streaming-index mutation counters and ad-hoc instrumentation land
  here;
* a **per-engine registry** — ``ServingEngine`` owns one and activates
  it (``use``) for the duration of ``run()``, so datapath metrics
  recorded deep in the executor (e.g. ``fatrq_model_drift_ratio``)
  aggregate with the engine's own queue-wait / occupancy / cache series
  and export as one coherent scrape.

``add_collector(fn)`` registers a callback run at export time
(``collect()``) — used to mirror snapshot-style stats objects
(``ServingStats``, ``CacheStats``) into gauges without touching their
hot paths.
"""

from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "active", "use", "default_registry"]

DEFAULT_BUCKETS = (1.0, 10.0, 100.0, 1_000.0, 10_000.0, 100_000.0,
                   1_000_000.0)


def _label_key(labelnames: tuple, kv: dict) -> tuple:
    if set(kv) != set(labelnames):
        raise ValueError(f"labels {sorted(kv)} != declared "
                         f"{sorted(labelnames)}")
    return tuple(str(kv[n]) for n in labelnames)


def label_str(labelnames: tuple, values: tuple) -> str:
    """``{a="x",b="y"}`` suffix (empty string for unlabeled)."""
    if not labelnames:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(labelnames, values))
    return "{" + inner + "}"


class _Metric:
    """Base: named metric fanning out into per-label-set children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, object] = {}

    def labels(self, **kv):
        key = _label_key(self.labelnames, kv)
        child = self._children.get(key)
        if child is None:
            child = self._fresh_child()
            self._children[key] = child
        return child

    def _default_child(self):
        """The unlabeled child (only valid when labelnames is empty)."""
        if self.labelnames:
            raise ValueError(f"metric {self.name} requires labels "
                             f"{self.labelnames}")
        return self.labels()

    def children(self):
        """Deterministic iteration: (label-values tuple, child)."""
        return sorted(self._children.items())


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v


class Counter(_Metric):
    kind = "counter"

    def _fresh_child(self):
        return _CounterChild()

    def inc(self, v: float = 1.0) -> None:
        self._default_child().inc(v)


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge(_Metric):
    kind = "gauge"

    def _fresh_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._default_child().set(v)


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple):
        self.buckets = buckets
        # per-bucket (non-cumulative) counts; exporters cumulate
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                break
        # v beyond the last bucket lands only in +Inf (the implicit
        # overflow bucket derived from ``count`` at export time)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: tuple,
                 buckets: tuple = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or any(math.isinf(b) for b in bs):
            raise ValueError("buckets must be finite and non-empty "
                             "(+Inf is implicit)")
        self.buckets = bs

    def _fresh_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self._default_child().observe(v)


class MetricsRegistry:
    """Named metrics + export-time collectors.  Getter methods are
    idempotent: re-declaring a metric with the same kind/labels returns
    the existing one; a conflicting redeclaration raises."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list = []

    def _get(self, cls, name: str, help: str, labelnames: tuple, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} with "
                    f"labels {m.labelnames}")
            return m
        m = cls(name, help, tuple(labelnames), **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def add_collector(self, fn) -> None:
        """Register ``fn()`` to run before every export/flatten — mirror
        snapshot stats into gauges here, not on the hot path."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    def metrics(self) -> list[_Metric]:
        """Deterministic (name-sorted) metric list; runs collectors."""
        self.collect()
        return [self._metrics[n] for n in sorted(self._metrics)]

    def flat(self) -> dict[str, float]:
        """One flat ``{"name{labels}": value}`` dict.  Histograms expose
        ``name_count`` / ``name_sum`` (buckets stay in the Prometheus
        exposition)."""
        out: dict[str, float] = {}
        for m in self.metrics():
            for values, child in m.children():
                suffix = label_str(m.labelnames, values)
                if m.kind == "histogram":
                    out[f"{m.name}_count{suffix}"] = child.count
                    out[f"{m.name}_sum{suffix}"] = child.sum
                else:
                    out[f"{m.name}{suffix}"] = child.value
        return out


_DEFAULT = MetricsRegistry()
_ACTIVE: ContextVar[MetricsRegistry | None] = ContextVar(
    "fatrq_active_registry", default=None)


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def active() -> MetricsRegistry:
    """The registry activated by ``use`` (the process default when none
    is active — metrics are always recordable, unlike spans)."""
    reg = _ACTIVE.get()
    return _DEFAULT if reg is None else reg


@contextlib.contextmanager
def use(registry: MetricsRegistry):
    """Route ``active()`` to ``registry`` for the block's extent (the
    serving engine wraps ``run()`` in this so executor-level metrics land
    in the engine's registry)."""
    token = _ACTIVE.set(registry)
    try:
        yield registry
    finally:
        _ACTIVE.reset(token)
