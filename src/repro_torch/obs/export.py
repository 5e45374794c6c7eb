"""Exporters: JSONL span dumps, Chrome-trace JSON, Prometheus text.

* ``write_jsonl`` — one JSON object per span, creation order, sorted
  keys.  With ``include_wall=False`` every wall-clock timestamp and
  every attribute whose key starts with ``"wall"`` is stripped, so a
  seeded virtual-clock trace exports BYTE-IDENTICALLY across runs
  (pinned in ``tests/test_obs.py``).
* ``chrome_trace`` — the Chrome trace-event format (loadable in
  ``chrome://tracing`` / Perfetto), rendered from VIRTUAL-clock
  timestamps only: each span track becomes a named thread, spans with a
  virtual interval become complete (``"X"``) events, zero-duration /
  point spans become instant (``"i"``) events.  This is how the serving
  engine's overlapped front/refine pipeline is visualized.
* ``prometheus_text`` — the text exposition format (``# HELP`` /
  ``# TYPE`` + samples; histograms emit cumulative ``_bucket{le=...}``
  series plus ``_sum`` / ``_count``).
"""

from __future__ import annotations

import json

from repro_torch.obs.metrics import MetricsRegistry, label_str
from repro_torch.obs.trace import Span

__all__ = ["span_records", "write_jsonl", "chrome_trace",
           "write_chrome_trace", "prometheus_text", "write_prometheus"]


# ------------------------------------------------------------------- JSONL


def span_records(spans: list[Span], *, include_wall: bool = True
                 ) -> list[dict]:
    return [s.to_record(include_wall=include_wall) for s in spans]


def write_jsonl(spans: list[Span], path: str, *,
                include_wall: bool = True) -> str:
    with open(path, "w") as f:
        for rec in span_records(spans, include_wall=include_wall):
            f.write(json.dumps(rec, sort_keys=True))
            f.write("\n")
    return path


# ------------------------------------------------------------ Chrome trace


def chrome_trace(spans: list[Span], *, process_name: str = "fatrq") -> dict:
    """Spans with virtual timestamps → Chrome trace-event JSON dict.

    Tracks map to thread ids in sorted-name order (deterministic);
    spans without any virtual timestamp are skipped (they never ran
    under a virtual clock, so there is no consistent timeline to place
    them on).
    """
    tracks = sorted({s.track for s in spans
                     if s.virtual_start_us is not None})
    tid_of = {t: i + 1 for i, t in enumerate(tracks)}
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": process_name}},
    ]
    for t in tracks:
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid_of[t], "args": {"name": t}})
    for s in spans:
        if s.virtual_start_us is None:
            continue
        args = {k: v for k, v in s.attrs.items()
                if not k.startswith("wall")}
        args["sid"] = s.sid
        base = {"name": s.name, "pid": 1, "tid": tid_of[s.track],
                "cat": s.track, "args": args}
        if s.virtual_end_us is not None \
                and s.virtual_end_us > s.virtual_start_us:
            events.append({**base, "ph": "X", "ts": s.virtual_start_us,
                           "dur": s.virtual_end_us - s.virtual_start_us})
        else:
            events.append({**base, "ph": "i", "ts": s.virtual_start_us,
                           "s": "t"})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: list[Span], path: str, **kw) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, **kw), f, sort_keys=True)
    return path


# -------------------------------------------------------------- Prometheus


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render ``registry`` in the Prometheus text exposition format."""
    lines: list[str] = []
    for m in registry.metrics():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for values, child in m.children():
            suffix = label_str(m.labelnames, values)
            if m.kind == "histogram":
                cum = 0
                for ub, c in zip(child.buckets, child.counts):
                    cum += c
                    le = label_str(m.labelnames + ("le",),
                                   values + (_fmt(ub),))
                    lines.append(f"{m.name}_bucket{le} {cum}")
                le = label_str(m.labelnames + ("le",), values + ("+Inf",))
                lines.append(f"{m.name}_bucket{le} {child.count}")
                lines.append(f"{m.name}_sum{suffix} {_fmt(child.sum)}")
                lines.append(f"{m.name}_count{suffix} {child.count}")
            else:
                lines.append(f"{m.name}{suffix} {_fmt(child.value)}")
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Compact sample formatting: integers render bare."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def write_prometheus(registry: MetricsRegistry, path: str) -> str:
    with open(path, "w") as f:
        f.write(prometheus_text(registry))
    return path
