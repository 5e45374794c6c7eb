"""Hierarchical query-lifecycle spans with a context-var trace context
(the port's copy of ``repro.obs.trace``: same names, same records).

A ``Tracer`` collects ``Span`` records: name, monotonic span id, parent
id (nesting follows the context-var current-span stack), a ``track``
(the logical execution unit the span ran on — ``"query"`` for datapath
stages, ``"unit:front"`` / ``"unit:refine"`` for the serving engine's
virtual pipeline units, ``"sched"`` for scheduler events, ``"index"``
for streaming mutations), free-form JSON-serializable attributes, and
DUAL timestamps:

* **wall clock** — ``time.perf_counter()`` seconds around the host-side
  stage call.  Instrumented stages synchronize their CUDA device before
  closing the span (the executor adds the synchronize only when tracing
  is active, and only for a CUDA device), so the wall time covers the
  device work, not just the asynchronous launches.
* **virtual clock** — microseconds from an attached clock source
  (``Tracer.virtual_clock``, wired to the serving engine's deterministic
  ``VirtualClock``).  Virtual timestamps are what make traces replayable
  and byte-identical in tests; spans created outside a virtual-clocked
  context carry ``None``.

Zero-cost when disabled: the module-level ``span()`` / ``event()``
helpers read one context var and return the shared ``NOOP_SPAN`` when no
tracer is active — no allocation, no clock reads and no device
synchronize (pinned in ``tests/test_torch_obs.py``).

Determinism: span ids are assigned in creation order, so the same
seeded serving trace produces the identical span tree; exporting with
wall times stripped (``export.write_jsonl(..., include_wall=False)``)
yields byte-identical files across runs.
"""

from __future__ import annotations

import contextlib
import time
from contextvars import ContextVar
from dataclasses import dataclass, field

__all__ = ["Span", "Tracer", "NOOP_SPAN", "active", "span", "event", "use"]

_ACTIVE: ContextVar["Tracer | None"] = ContextVar("fatrq_active_tracer",
                                                  default=None)


@dataclass
class Span:
    """One traced operation.  ``None`` timestamps mean the clock did not
    apply (no virtual clock attached / explicit-time span without wall
    times).  ``attrs`` keys starting with ``"wall"`` are treated as
    wall-derived by the exporters and stripped from deterministic
    exports alongside the wall timestamps."""

    sid: int
    parent: int | None
    name: str
    track: str = "main"
    wall_start_s: float | None = None
    wall_end_s: float | None = None
    virtual_start_us: float | None = None
    virtual_end_us: float | None = None
    attrs: dict = field(default_factory=dict)

    @property
    def wall_s(self) -> float | None:
        if self.wall_start_s is None or self.wall_end_s is None:
            return None
        return self.wall_end_s - self.wall_start_s

    @property
    def virtual_us(self) -> float | None:
        if self.virtual_start_us is None or self.virtual_end_us is None:
            return None
        return self.virtual_end_us - self.virtual_start_us

    def to_record(self, *, include_wall: bool = True) -> dict:
        rec = {"sid": self.sid, "parent": self.parent, "name": self.name,
               "track": self.track,
               "virtual_start_us": self.virtual_start_us,
               "virtual_end_us": self.virtual_end_us}
        if include_wall:
            rec["wall_start_s"] = self.wall_start_s
            rec["wall_end_s"] = self.wall_end_s
            rec["attrs"] = dict(self.attrs)
        else:
            rec["attrs"] = {k: v for k, v in self.attrs.items()
                            if not k.startswith("wall")}
        return rec


class _SpanHandle:
    """Context manager returned by ``Tracer.span``: enters by pushing the
    span onto the current-span context var, exits by stamping end times
    and popping.  ``set_attr`` works before and after exit (stage
    instrumentation attaches modeled times post-fold)."""

    __slots__ = ("_tracer", "span", "_token")

    def __init__(self, tracer: "Tracer", sp: Span):
        self._tracer = tracer
        self.span = sp
        self._token = None

    def set_attr(self, key: str, value) -> None:
        self.span.attrs[key] = value

    def set_attrs(self, **kv) -> None:
        self.span.attrs.update(kv)

    def __enter__(self) -> "_SpanHandle":
        self._token = self._tracer._current.set(self.span.sid)
        return self

    def __exit__(self, *exc) -> bool:
        sp = self.span
        sp.wall_end_s = time.perf_counter()
        clock = self._tracer.virtual_clock
        if clock is not None:
            sp.virtual_end_us = float(clock())
        self._tracer._current.reset(self._token)
        return False


class _NoopSpan:
    """Shared do-nothing handle for the disabled fast path."""

    __slots__ = ()
    span = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attr(self, key: str, value) -> None:
        pass

    def set_attrs(self, **kv) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Span collector.  ``virtual_clock`` is an optional zero-arg callable
    returning the current virtual time in microseconds (the serving
    engine wires its ``VirtualClock`` in); spans stamp it on entry/exit
    alongside the wall clock."""

    def __init__(self, virtual_clock=None):
        self.spans: list[Span] = []
        self.virtual_clock = virtual_clock
        self._next_sid = 0
        self._current: ContextVar[int | None] = ContextVar(
            "fatrq_current_span", default=None)

    # -- creation ---------------------------------------------------------

    def _fresh(self, name: str, track: str, parent: int | None,
               attrs: dict) -> Span:
        sp = Span(sid=self._next_sid, parent=parent, name=name, track=track,
                  attrs=attrs)
        self._next_sid += 1
        self.spans.append(sp)
        return sp

    def span(self, name: str, *, track: str = "main", **attrs) -> _SpanHandle:
        """Open a timed span nested under the current one (context
        manager).  Wall start stamps immediately; virtual start stamps
        when a virtual clock is attached."""
        sp = self._fresh(name, track, self._current.get(), attrs)
        sp.wall_start_s = time.perf_counter()
        if self.virtual_clock is not None:
            sp.virtual_start_us = float(self.virtual_clock())
        return _SpanHandle(self, sp)

    def event(self, name: str, *, track: str = "main",
              parent: int | None = None, virtual_us: float | None = None,
              **attrs) -> Span:
        """Zero-duration annotation span (throttle fired, cache hit,
        compile-cache probe, per-level refine stats).  ``parent`` defaults
        to the current span; ``virtual_us`` overrides the attached
        clock's reading (the scheduler back-stamps event times)."""
        parent = parent if parent is not None else self._current.get()
        sp = self._fresh(name, track, parent, attrs)
        sp.wall_start_s = sp.wall_end_s = time.perf_counter()
        if virtual_us is None and self.virtual_clock is not None:
            virtual_us = float(self.virtual_clock())
        if virtual_us is not None:
            sp.virtual_start_us = sp.virtual_end_us = float(virtual_us)
        return sp

    def add_span(self, name: str, *, track: str = "main",
                 virtual_start_us: float, virtual_end_us: float,
                 parent: int | None = None,
                 wall_start_s: float | None = None,
                 wall_end_s: float | None = None, **attrs) -> Span:
        """Explicit-interval span: the serving engine's virtual pipeline
        units compute their occupancy retroactively (a batch's front/
        refine interval is known only at completion), so their spans are
        recorded with explicit virtual times rather than enter/exit."""
        parent = parent if parent is not None else self._current.get()
        sp = self._fresh(name, track, parent, attrs)
        sp.virtual_start_us = float(virtual_start_us)
        sp.virtual_end_us = float(virtual_end_us)
        sp.wall_start_s = wall_start_s
        sp.wall_end_s = wall_end_s
        return sp

    # -- inspection -------------------------------------------------------

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, sid: int) -> list[Span]:
        return [s for s in self.spans if s.parent == sid]


# ---------------------------------------------------------- module helpers
# Instrumentation sites call these, not Tracer methods: one context-var
# read when disabled, nothing else.


def active() -> Tracer | None:
    """The tracer activated by ``use`` (None = tracing disabled)."""
    return _ACTIVE.get()


def span(name: str, *, track: str = "main", **attrs):
    """Open a span on the active tracer; the shared no-op handle when
    tracing is disabled (the zero-cost fast path)."""
    tr = _ACTIVE.get()
    if tr is None:
        return NOOP_SPAN
    return tr.span(name, track=track, **attrs)


def event(name: str, *, track: str = "main", **attrs) -> Span | None:
    """Record an event on the active tracer; no-op when disabled."""
    tr = _ACTIVE.get()
    if tr is None:
        return None
    return tr.event(name, track=track, **attrs)


@contextlib.contextmanager
def use(tracer: Tracer):
    """Activate ``tracer`` for the dynamic extent of the block."""
    token = _ACTIVE.set(tracer)
    try:
        yield tracer
    finally:
        _ACTIVE.reset(token)
