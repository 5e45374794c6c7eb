"""Capability registry: which fronts, refine backends and index layouts
the port runs.  ``validate_combo`` is the one plan-time check; anything
the JAX package offers that is not ported yet raises ``PlanError`` saying
so, never a mid-search error.

A front declares its layouts and a stage factory per layout, each
factory ``(index, **opts)`` giving a ``stages.FrontStage``, whose
``candidates(queries, qvalid=None)`` takes the per-query validity mask of
a bucket-padded micro-batch (``executor.pad_chunk``): padded rows yield
no candidates and no counter contributions.  A module
imported later attaches its own layout's factory with
``add_front_factory`` (``anns.streaming`` and ``anns.tiered`` do).  The
sharded layout builds no stage object, its front registers
``ShardedFrontHooks`` (``anns.sharding`` registers the IVF and graph
fronts').
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

#: the index layouts, as in the JAX package
LAYOUTS = ("static", "sharded", "streaming", "tiered")


class PlanError(ValueError):
    """A QueryPlan names an unsupported or unported combination."""


@dataclass(frozen=True)
class ShardedFrontHooks:
    """How a front runs on the sharded layout (see ``anns.sharding``):

    * ``partition(index, n_shards) -> (rows_per, rep, db, args)``: the
      per-shard global rows, the front's replicated (``rep``) and
      shard-stacked (``db``) tensors and a hashable tuple of static
      traversal args;
    * ``body(queries, rep, db, codebook, pq_codes, *, qvalid=None,
      **args) -> list[Candidates]``: one micro-batch's candidates on every
      shard, in shard order, with shard-local ids and 0-d counters each;
      ``qvalid`` is the per-query validity mask of a bucket-padded
      micro-batch: padded rows yield no candidates and no counter
      contributions on any shard;
    * ``fold(cost, counts, layout)``: the front's per-shard ledger fold.
    """

    partition: Callable
    body: Callable
    fold: Callable


@dataclass
class FrontSpec:
    name: str
    layouts: tuple[str, ...]
    factories: dict[str, Callable] = field(default_factory=dict)
    sharded: ShardedFrontHooks | None = None


@dataclass
class BackendSpec:
    name: str
    make: Callable

    @property
    def layouts(self) -> tuple[str, ...]:
        """Every backend runs on every layout."""
        return LAYOUTS


_FRONTS: dict[str, FrontSpec] = {}
_BACKENDS: dict[str, BackendSpec] = {}


def register_front(name: str, *, layouts: tuple[str, ...],
                   make: dict[str, Callable]) -> None:
    """Declare a front stage, the layouts it runs on and a stage factory
    per layout (the sharded layout takes hooks instead, below)."""
    for lay in layouts:
        if lay not in LAYOUTS:
            raise ValueError(f"unknown layout {lay!r}; expected one of "
                             f"{LAYOUTS}")
    _FRONTS[name] = FrontSpec(name=name, layouts=tuple(layouts),
                              factories=dict(make))


def add_front_factory(name: str, layout: str, factory: Callable) -> None:
    """Attach a layout's stage factory to a registered front that declares
    the layout."""
    spec = _FRONTS[name]
    if layout not in spec.layouts:
        raise ValueError(f"front {name!r} does not declare layout "
                         f"{layout!r} (declared: {spec.layouts})")
    spec.factories[layout] = factory


def register_sharded_front(name: str, hooks: ShardedFrontHooks) -> None:
    """Attach the sharded layout's hooks to a front declaring it."""
    spec = _FRONTS[name]
    if "sharded" not in spec.layouts:
        raise ValueError(f"front {name!r} does not declare layout "
                         f"'sharded' (declared: {spec.layouts})")
    spec.sharded = hooks


def sharded_front(name: str) -> ShardedFrontHooks:
    """The sharded layout's hooks for ``name``; a front that declares the
    layout without hooks is a wiring bug, not a plan error."""
    spec = front_spec(name)
    if spec.sharded is None:
        raise KeyError(f"front {name!r} has no sharded-front hooks "
                       f"registered (declared layouts: {spec.layouts})")
    return spec.sharded


def register_backend(name: str, *, make: Callable) -> None:
    """Declare a refine backend (every backend runs on every layout)."""
    _BACKENDS[name] = BackendSpec(name=name, make=make)


def front_names() -> tuple[str, ...]:
    return tuple(_FRONTS)


def backend_names() -> tuple[str, ...]:
    return tuple(_BACKENDS)


def front_spec(name: str) -> FrontSpec:
    """The registered front ``name``; ``PlanError`` if there is none."""
    if name not in _FRONTS:
        raise _not_ported("front", name, _FRONTS)
    return _FRONTS[name]


def backend_spec(name: str) -> BackendSpec:
    """The registered refine backend ``name``; ``PlanError`` if there is
    none."""
    if name not in _BACKENDS:
        raise _not_ported("backend", name, _BACKENDS)
    return _BACKENDS[name]


def _not_ported(kind: str, name: str, have) -> PlanError:
    return PlanError(f"{kind} {name!r} is not ported to repro_torch yet; "
                     f"the port has {kind}s {tuple(have)}")


def _pair_error(name: str, supported: tuple[str, ...],
                layout: str) -> PlanError:
    """A front that does not run on ``layout``: the error names the pair
    and the fronts that do run there (the JAX package's message)."""
    alts = sorted(n for n, s in _FRONTS.items() if layout in s.layouts)
    alt = "/".join(alts).upper() or "NO registered"
    return PlanError(
        f"unsupported plan: front {name!r} cannot run on the {layout!r} "
        f"index layout — front {name!r} supports layouts "
        f"[{', '.join(supported)}]; the {layout!r} layout supports the "
        f"{alt} front only (fronts: {alts})")


def _front(name: str, layout: str) -> FrontSpec:
    if layout not in LAYOUTS:
        raise _not_ported("layout", layout, LAYOUTS)
    spec = front_spec(name)
    if layout not in spec.layouts:
        raise _pair_error(name, spec.layouts, layout)
    return spec


def validate_combo(front: str, backend: str, layout: str) -> None:
    """Raise ``PlanError`` unless the port runs (front, backend, layout)."""
    _front(front, layout)
    backend_spec(backend)


def make_front(name: str, layout: str, index, **opts):
    return _front(name, layout).factories[layout](index, **opts)


def make_backend(name: str, **opts):
    return backend_spec(name).make(**opts)
