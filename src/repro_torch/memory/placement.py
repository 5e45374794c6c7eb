"""Heat-driven hot/warm/cold placement for IVF lists (paper §V turned
adaptive).

FaTRQ's static assignment pins every list to the same tier trio: PQ codes
in device HBM, TRQ residuals in CXL, full vectors on SSD.  Real workloads
are skewed — a few hot lists absorb most probes — so this module derives a
per-list placement from observed traffic:

  hot   lists keep full-precision rows resident in HBM; the executor scores
        them exactly and skips progressive refinement entirely (billed to
        ``hot:hbm``),
  warm  lists stay on today's fused TRQ path (residuals in CXL),
  cold  lists demote to SSD-resident residuals: their level-0 stream and
        every deeper level are billed at SSD rates (``cold:ssd``).

Everything here is plain numpy and deterministic (the port's copy of
``repro.memory.placement``, so heat and placement match the JAX package's
bit for bit): the heat tracker is an EMA over the per-list access counters
the executor already folds, and the policy is a stable sort against
occupancy budgets.  The device side (``TieredIndex`` in
``anns/tiered.py``) owns device tensors, generations and migration; this
module owns the math.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Per-row tier codes, stored in the ``TieredIndex`` placement array and
# gathered per candidate on device.  WARM is the identity placement: an
# all-WARM tiered index is bit-identical to the static layout.
TIER_HOT = 0
TIER_WARM = 1
TIER_COLD = 2

TIER_NAMES = ("hot", "warm", "cold")


@dataclass(frozen=True)
class TieredConfig:
    """Placement policy knobs.

    ``hot_rows_frac`` / ``cold_rows_frac`` are occupancy budgets as a
    fraction of total rows: the policy promotes the hottest lists into HBM
    until the hot budget is full, and demotes the coldest lists to SSD up
    to the cold budget.  ``decay`` is the EMA coefficient (heat carried
    over per observation batch); ``min_observations`` gates rebalancing so
    one query can't thrash placement.  ``enabled=False`` forces all-WARM,
    the static-equivalent placement.
    """

    decay: float = 0.8
    hot_rows_frac: float = 0.1
    cold_rows_frac: float = 0.0
    min_observations: int = 1
    enabled: bool = True

    def __post_init__(self) -> None:
        if not (0.0 <= self.decay < 1.0):
            raise ValueError(f"decay must be in [0, 1), got {self.decay}")
        if self.hot_rows_frac < 0 or self.cold_rows_frac < 0:
            raise ValueError("tier occupancy fractions must be >= 0")
        if self.hot_rows_frac + self.cold_rows_frac > 1.0 + 1e-9:
            raise ValueError("hot_rows_frac + cold_rows_frac must be <= 1")


class HeatTracker:
    """EMA-decayed per-list access heat.

    ``observe`` folds one batch's per-list candidate counts (the
    ``list_heat`` counter the executor emits);  given the same query trace
    the heat vector is bit-for-bit reproducible — no wall clock anywhere.
    """

    def __init__(self, nlist: int, decay: float = 0.8) -> None:
        self.decay = float(decay)
        self.heat = np.zeros(int(nlist), dtype=np.float64)
        self.observations = 0

    def observe(self, counts: np.ndarray) -> None:
        counts = np.asarray(counts, dtype=np.float64)
        if counts.shape != self.heat.shape:
            raise ValueError(
                f"heat counts shape {counts.shape} != ({self.heat.shape[0]},)")
        self.heat = self.decay * self.heat + (1.0 - self.decay) * counts
        self.observations += 1

    def reset(self) -> None:
        self.heat[:] = 0.0
        self.observations = 0


def plan_placement(heat: np.ndarray, list_rows: np.ndarray,
                   cfg: TieredConfig) -> np.ndarray:
    """Classify every list hot/warm/cold against the occupancy budgets.

    Deterministic: lists are ranked by (heat desc, list id asc).  The
    hottest lists with nonzero heat are promoted while their rows fit the
    hot budget; the coldest non-hot lists are demoted while they fit the
    cold budget.  Returns an int8 ``(nlist,)`` tier-code array.
    """
    heat = np.asarray(heat, dtype=np.float64)
    list_rows = np.asarray(list_rows, dtype=np.int64)
    nlist = heat.shape[0]
    tiers = np.full(nlist, TIER_WARM, dtype=np.int8)
    if not cfg.enabled or nlist == 0:
        return tiers
    n_rows = int(list_rows.sum())
    order = np.lexsort((np.arange(nlist), -heat))  # heat desc, id asc

    hot_budget = int(cfg.hot_rows_frac * n_rows)
    used = 0
    for li in order:
        if heat[li] <= 0.0:
            break  # remaining lists are unobserved — never promote those
        rows = int(list_rows[li])
        if used + rows > hot_budget:
            continue
        tiers[li] = TIER_HOT
        used += rows

    cold_budget = int(cfg.cold_rows_frac * n_rows)
    used = 0
    for li in order[::-1]:  # heat asc, id desc
        if tiers[li] == TIER_HOT:
            continue
        rows = int(list_rows[li])
        if used + rows > cold_budget:
            continue
        tiers[li] = TIER_COLD
        used += rows
    return tiers


def plan_migration(old: np.ndarray, new: np.ndarray,
                   list_rows: np.ndarray) -> dict[tuple[str, str], int]:
    """Rows moved per (from_tier, to_tier) transition — the migration
    plan ``rebalance_tiers`` executes and the obs layer counts."""
    old = np.asarray(old)
    new = np.asarray(new)
    list_rows = np.asarray(list_rows, dtype=np.int64)
    moves: dict[tuple[str, str], int] = {}
    changed = np.nonzero(old != new)[0]
    for li in changed:
        key = (TIER_NAMES[int(old[li])], TIER_NAMES[int(new[li])])
        moves[key] = moves.get(key, 0) + int(list_rows[li])
    return moves


def occupancy(tiers: np.ndarray, list_rows: np.ndarray
              ) -> dict[str, tuple[int, int]]:
    """Per-tier (lists, rows) occupancy, for gauges and reports."""
    tiers = np.asarray(tiers)
    list_rows = np.asarray(list_rows, dtype=np.int64)
    out = {}
    for code, name in enumerate(TIER_NAMES):
        m = tiers == code
        out[name] = (int(m.sum()), int(list_rows[m].sum()))
    return out
