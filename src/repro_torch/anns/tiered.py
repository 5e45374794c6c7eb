"""Tiered layout: heat-driven hot/warm/cold placement over a static FaTRQ
index (the port of ``repro.anns.tiered``).

``TieredIndex`` wraps an immutable ``FaTRQIndex`` with a per-list
placement array driven by ``memory.placement``:

  hot   lists' rows live fully in HBM — the executor scores them exactly
        against the full-precision vectors and skips progressive
        refinement for them (billed ``hot:hbm``),
  warm  lists run the fused TRQ path unchanged (``refine:cxl``),
  cold  lists' residual stream — level 0 and every deeper level — is
        billed at SSD rates (``cold:ssd``).

The split happens per candidate slot: ``TieredFrontStage`` annotates the
inner front's candidates with per-row tier codes (one gather) and a
per-list access histogram (one integer ``index_add_``), and the executor
routes on the codes (``executor.SearchExecutor._refine_rerank``,
``fold_counts``).  With every list warm — the initial placement, and the
placement ``TieredConfig(enabled=False)`` forces — there is nothing to
route and the tiered layout gives the static layout's ids, distances and
ledger bit for bit.  Whether the placement has any hot list is a
host-side flag of the generation (``_dev()["any_hot"]``): without one the
executor never looks for hot slots, so an all-warm or cold-only placement
adds no host synchronize.

Heat flows back with the executor's one counter transfer per search
(``list_heat``), which ``TieredIndex.observe_heat`` folds into an EMA
``HeatTracker``.  Migration is explicit: ``rebalance_tiers()`` re-plans
placement against the occupancy budgets and, when the plan changed, bumps
the generation and fires the generation hooks, so executors cached per
generation (``executor.make_executor``, ``Database``) are rebuilt.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.anns import registry
from repro_torch.anns.pipeline import FaTRQIndex
from repro_torch.anns.stages import (Candidates, Counters, make_graph_front,
                                     make_ivf_front)
from repro_torch.memory import QueryCost, RecordLayout
from repro_torch.memory.placement import (TIER_COLD, TIER_HOT, TIER_NAMES,
                                          TIER_WARM, HeatTracker,
                                          TieredConfig, occupancy,
                                          plan_migration, plan_placement)
from repro_torch.obs import metrics as obs_metrics, trace


class TieredIndex:
    """A static FaTRQ index + per-list hot/warm/cold placement.

    Quacks like ``FaTRQIndex`` (``config``/``codebook``/``pq_codes``/
    ``ivf``/``trq``/``x``/``layout`` are the wrapped index's own tensors —
    placement never copies or re-encodes rows) and like ``StreamingIndex``
    for invalidation (``generation``, ``add_generation_hook``).  It lives
    on its inner index's device; placement and heat are host numpy.
    """

    def __init__(self, index: FaTRQIndex,
                 tiered: TieredConfig | None = None):
        self.inner = index
        self.tiered = tiered if tiered is not None else TieredConfig()
        self.config = index.config
        self.codebook = index.codebook
        self.pq_codes = index.pq_codes
        self.ivf = index.ivf
        self.trq = index.trq
        self.x = index.x
        self.layout: RecordLayout = index.layout

        nlist = int(self.config.nlist)
        lists = index.ivf.lists.cpu().numpy()
        # row → owning IVF list (vectorized inverse of the list table)
        rl = np.zeros(int(index.x.shape[0]), np.int32)
        li_idx = np.repeat(np.arange(nlist, dtype=np.int32), lists.shape[1])
        flat = lists.ravel()
        m = flat >= 0
        rl[flat[m]] = li_idx[m]
        self.row_list = rl
        self.list_rows = index.ivf.list_len.cpu().numpy().astype(np.int64)
        self.list_tier = np.full(nlist, TIER_WARM, np.int8)  # all-warm start
        self.heat = HeatTracker(nlist, decay=self.tiered.decay)
        self.generation = 0
        self._gen_hooks: list = []
        self._dev_cache: dict | None = None

    @property
    def device(self) -> torch.device:
        return self.inner.device

    @property
    def default_backend(self) -> str:
        return self.inner.default_backend

    # ----------------------------------------------------- heat + migration

    def observe_heat(self, counts) -> None:
        """Fold one search's per-list candidate counts (the ``list_heat``
        counter the executor pops out of its counters) into the EMA
        tracker.  Deterministic given the query trace."""
        self.heat.observe(np.asarray(counts))

    def rebalance_tiers(self, *, force: bool = False) -> dict:
        """Re-plan placement against the occupancy budgets and migrate.

        Returns ``{"changed", "moves", "occupancy", "generation"}``.  The
        generation bumps only when the placement changed; ``force``
        overrides the ``min_observations`` gate, not the no-change
        short-circuit.
        """
        if not force and self.heat.observations < self.tiered.min_observations:
            return {"changed": False, "moves": {},
                    "occupancy": occupancy(self.list_tier, self.list_rows),
                    "generation": self.generation}
        new = plan_placement(self.heat.heat, self.list_rows, self.tiered)
        moves = plan_migration(self.list_tier, new, self.list_rows)
        changed = bool(moves)
        if changed:
            self.list_tier = new
            self._invalidate()
        occ = occupancy(self.list_tier, self.list_rows)
        self._observe_rebalance(moves, occ)
        return {"changed": changed, "moves": moves, "occupancy": occ,
                "generation": self.generation}

    # ------------------------------------------------- generation surface

    def add_generation_hook(self, fn) -> None:
        """Call ``fn(index, generation)`` after every placement migration,
        as ``StreamingIndex.add_generation_hook`` does after a mutation."""
        self._gen_hooks.append(fn)

    def _invalidate(self) -> None:
        self.generation += 1
        self._dev_cache = None
        for fn in list(self._gen_hooks):
            fn(self, self.generation)

    def _observe_rebalance(self, moves: dict, occ: dict) -> None:
        """Per-tier row and list gauges, the heat-over-row-share
        histogram, the migration counter, and (while tracing) an
        ``index.rebalance_tiers`` event."""
        reg = obs_metrics.active()
        rows_total = max(int(self.list_rows.sum()), 1)
        heat_total = float(self.heat.heat.sum())
        for name, (nlists, nrows) in occ.items():
            reg.gauge("tiered_rows", "rows per placement tier",
                      labelnames=("tier",)).labels(tier=name).set(nrows)
            reg.gauge("tiered_lists", "IVF lists per placement tier",
                      labelnames=("tier",)).labels(tier=name).set(nlists)
            if heat_total > 0.0:
                share = float(self.heat.heat[
                    self.list_tier == TIER_NAMES.index(name)].sum()) \
                    / heat_total
                # heat share over row share: > 1 on the hot tier means the
                # placement concentrates traffic onto few rows
                row_share = occ[name][1] / rows_total
                reg.histogram(
                    "tiered_heat_row_ratio",
                    "per-tier EMA-heat share over row share",
                    labelnames=("tier",),
                    buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0),
                ).labels(tier=name).observe(
                    share / row_share if row_share > 0 else 0.0)
        for (src, dst), rows in moves.items():
            reg.counter("tiered_migrations_total",
                        "rows migrated between placement tiers",
                        labelnames=("transition",)).labels(
                            transition=f"{src}->{dst}").inc(rows)
        if trace.active() is not None:
            trace.event("index.rebalance_tiers", track="index",
                        generation=self.generation,
                        moved_rows=sum(moves.values()),
                        **{f"rows_{n}": r for n, (_, r) in occ.items()})

    # ----------------------------------------------------- device tensors

    def _dev(self) -> dict:
        """This generation's device copies of what the front wrapper
        gathers (each row's tier and first heat bin, each list's tier) and
        the host flags ``routed`` (some list is not warm) and ``any_hot``
        (some list is hot)."""
        if self._dev_cache is None or \
                self._dev_cache["gen"] != self.generation:
            dev = self.device
            self._dev_cache = {
                "gen": self.generation,
                "row_tier": torch.from_numpy(
                    self.list_tier[self.row_list]).to(dev),
                "row_bin": torch.from_numpy(
                    self.row_list * _SUB_BINS).to(dev),
                "list_tier": torch.from_numpy(self.list_tier).long().to(dev),
                "routed": bool((self.list_tier != TIER_WARM).any()),
                "any_hot": bool((self.list_tier == TIER_HOT).any()),
            }
        return self._dev_cache


# ------------------------------------------------------------- front stage


#: sub-bins per list, and spare bins for the invalid slots, of the heat
#: histogram: a slot adds into sub-bin (its position mod ``_SUB_BINS``) of
#: its list, an invalid slot (weight 0) into spare bin (position mod
#: ``_SPARE_BINS``), so no single address takes the atomics of a whole
#: list or of every invalid slot (all of which would otherwise hit row
#: 0's list, the clamped id)
_SUB_BINS, _SPARE_BINS = 32, 4096


def _tier_annotate(ids: torch.Tensor, valid: torch.Tensor,
                   row_tier: torch.Tensor, row_bin: torch.Tensor,
                   list_tier: torch.Tensor,
                   slot_bins: tuple[torch.Tensor, torch.Tensor], *,
                   nlist: int, routed: bool
                   ) -> tuple[torch.Tensor | None, Counters]:
    """Per-slot tier codes and the per-list access histogram (the heat
    signal): one gather and one integer ``index_add_`` for the histogram
    (integer adds are exact in any order), the tier counters from it (a
    list's slots share its tier), and the tier gather only when some list
    is not warm (``routed``; else None: every slot is warm).  ``row_bin``
    is each row's first heat bin (its list · ``_SUB_BINS``), ``slot_bins``
    each slot position's sub-bin and spare bin.  Invalid slots contribute
    nothing."""
    flat = ids.reshape(-1)
    slot_bin = torch.where(valid, row_bin.index_select(0, flat)
                           .view(ids.shape) + slot_bins[0], slot_bins[1])
    bins = torch.zeros(nlist * _SUB_BINS + _SPARE_BINS, dtype=torch.int32,
                       device=ids.device)
    bins.index_add_(0, slot_bin.reshape(-1), valid.reshape(-1).int())
    heat = bins[:nlist * _SUB_BINS].view(nlist, _SUB_BINS).sum(1)
    by_tier = torch.zeros(len(TIER_NAMES), dtype=torch.int64,
                          device=ids.device).index_add_(0, list_tier, heat)
    tier = row_tier.index_select(0, flat).view(ids.shape) if routed \
        else None
    return tier, {"hot_cand": by_tier[TIER_HOT],
                  "cold_cand": by_tier[TIER_COLD], "list_heat": heat}


@dataclass
class TieredFrontStage:
    """Wraps a front stage with placement annotation.

    The inner front's candidates, scoring and cost fold are untouched;
    this stage only gathers per-slot tier codes and emits the
    ``hot_cand``/``cold_cand``/``list_heat`` counters.  ``routed`` says
    whether some list is not warm (else the candidates carry no tier
    codes: nothing to route), ``any_hot`` whether some list is hot (the
    executor looks for hot slots only then)."""

    inner: object
    row_tier: torch.Tensor
    row_bin: torch.Tensor
    list_tier: torch.Tensor
    nlist: int
    routed: bool
    any_hot: bool
    name: str = field(init=False)
    _slot_bins: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        self.name = self.inner.name

    def slot_bins(self, c: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Each of ``c`` slot positions' heat sub-bin and spare bin (kept
        per slot count)."""
        got = self._slot_bins.get(c)
        if got is None:
            pos = torch.arange(c, dtype=torch.int32,
                               device=self.row_bin.device)
            got = self._slot_bins[c] = (
                pos % _SUB_BINS, self.nlist * _SUB_BINS + pos % _SPARE_BINS)
        return got

    def candidates(self, queries: torch.Tensor,
                   qvalid: torch.Tensor | None = None) -> Candidates:
        # a padded row has no valid slot: its slots land in the spare
        # bins with weight 0 (no heat), and none of them is hot
        cand = self.inner.candidates(queries, qvalid=qvalid)
        tier, counters = _tier_annotate(
            cand.ids, cand.valid, self.row_tier, self.row_bin,
            self.list_tier, self.slot_bins(cand.ids.shape[1]),
            nlist=self.nlist, routed=self.routed)
        return cand._replace(tier=tier,
                             counters={**cand.counters, **counters})

    def fold_cost(self, cost: QueryCost, counts: dict[str, int],
                  layout: RecordLayout) -> None:
        self.inner.fold_cost(cost, counts, layout)


# ----------------------------------------------------- registry integration
# The factories wrap the static stages of the inner index: the same
# tensors, and the graph front takes the inner index's cached kNN graph
# (``stages.graph_for``) instead of building a second one on the wrapper.


def _wrap_front(ti: TieredIndex, inner) -> TieredFrontStage:
    dev = ti._dev()
    return TieredFrontStage(inner=inner, row_tier=dev["row_tier"],
                            row_bin=dev["row_bin"],
                            list_tier=dev["list_tier"],
                            routed=dev["routed"],
                            nlist=int(ti.config.nlist),
                            any_hot=dev["any_hot"])


def make_tiered_ivf_front(ti: TieredIndex, **opts) -> TieredFrontStage:
    return _wrap_front(ti, make_ivf_front(ti.inner, **opts))


def make_tiered_graph_front(ti: TieredIndex, **opts) -> TieredFrontStage:
    return _wrap_front(ti, make_graph_front(ti.inner, **opts))


registry.add_front_factory("ivf", "tiered", make_tiered_ivf_front)
registry.add_front_factory("graph", "tiered", make_tiered_graph_front)
