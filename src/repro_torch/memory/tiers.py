"""Tiered-memory cost model (paper Table I) + traffic accounting.

The container has no CXL device or SSD on the hot path, so end-to-end
throughput claims (Fig. 6) are reproduced through this calibrated analytical
model, exactly the constants the paper simulates with (Ramulator DDR5 +
Samsung 990 Pro + Marvell Structera):

  DRAM  : DDR5-4800 8ch — effective ~150 ns latency, 38.4 GB/s/ch
  CXL   : 271 ns load-to-use, 22 GB/s   (Type-2 device link)
  SSD   : 45 µs random read, 1.2M IOPS (4 KiB granularity)

Accounting is per query batch: every pipeline stage records (tier, bytes,
accesses); ``QueryCost.total_seconds`` folds them with the tier model,
assuming accesses within a stage pipeline/overlap up to the tier's queue
parallelism (SSD QD, CXL banks), which is how the paper's accelerator and
the baseline's io_uring path both behave.

Billing-key convention
----------------------
Ledger keys are ``"stage:tier"`` with the tier always last (split with
``key.rsplit(":", 1)``); ``record(stage, tier, ...)`` builds them, nothing
else should.  The stage names in use:

  ``front:hbm``    device-side coarse stage (PQ scan / graph walk)
  ``handoff:cxl``  candidate ids+d0 crossing from device to far memory
  ``refine:cxl``   TRQ residual levels streamed from CXL (warm lists)
  ``delta:cxl``    streaming-index delta-page share of refine traffic
  ``hot:hbm``      full-precision rows of HBM-resident hot lists (tiered
                   layout: exact scoring, refinement skipped)
  ``cold:ssd``     residual levels of SSD-demoted cold lists (tiered
                   layout: level-0 and deeper levels at SSD rates)
  ``rerank:ssd``   exact full-vector fetches for final rerank

Consumers should not string-parse keys — use ``QueryCost.by_tier()`` for
per-tier totals and ``breakdown()`` for per-tier seconds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum


class Tier(str, Enum):
    DRAM = "dram"
    CXL = "cxl"
    SSD = "ssd"
    HBM = "hbm"        # device-side (GPU/TPU front stage)


@dataclass(frozen=True)
class TierSpec:
    latency_s: float         # per-access load-to-use latency
    bandwidth_Bps: float     # sustained streaming bandwidth
    parallelism: float       # concurrent in-flight accesses (QD / banks)
    min_grain_B: int = 64    # minimum transfer granularity

    def seconds(self, accesses: int, nbytes: int) -> float:
        """Modeled time this tier spends serving ``accesses`` transfers
        totalling ``nbytes`` under the max(lat, bw) overlap model (see
        ``QueryCost.tier_seconds``).  Used both for ledger folding and
        for per-level span attribution in the observability layer."""
        lat = accesses * self.latency_s / self.parallelism
        return max(lat, nbytes / self.bandwidth_Bps)


TABLE_I = {
    Tier.DRAM: TierSpec(latency_s=150e-9, bandwidth_Bps=8 * 38.4e9,
                        parallelism=64, min_grain_B=64),
    Tier.CXL: TierSpec(latency_s=271e-9, bandwidth_Bps=22e9,
                       parallelism=32, min_grain_B=64),
    Tier.SSD: TierSpec(latency_s=45e-6, bandwidth_Bps=1_200_000 * 4096,
                       parallelism=256, min_grain_B=4096),
    Tier.HBM: TierSpec(latency_s=120e-9, bandwidth_Bps=600e9,
                       parallelism=128, min_grain_B=32),
}


@dataclass
class Traffic:
    """Accumulated traffic for one stage/tier."""

    accesses: int = 0
    bytes: int = 0

    def add(self, accesses: int, bytes_each: int, grain: int = 1) -> None:
        self.accesses += int(accesses)
        self.bytes += int(accesses) * max(int(bytes_each), grain)


@dataclass
class QueryCost:
    """Traffic ledger for a (batch of) queries against the tier model.

    ``parallel_s`` is set by ``merge_parallel`` when concurrent shard lanes
    have been folded in: per-tier times become explicit (the slowest lane)
    instead of being derived from the pooled traffic, which would read as
    if the lanes had run back-to-back.
    """

    model: dict[Tier, TierSpec] = field(default_factory=lambda: dict(TABLE_I))
    ledger: dict[str, Traffic] = field(default_factory=dict)
    compute_s: float = 0.0
    parallel_s: dict[str, float] = field(default_factory=dict)

    def record(self, stage: str, tier: Tier, accesses: int, bytes_each: int
               ) -> None:
        key = f"{stage}:{tier.value}"
        t = self.ledger.setdefault(key, Traffic())
        if self.parallel_s:
            # frozen ledger (post merge_parallel): keep time consistent by
            # adding this record's incremental key time to the tier's
            # frozen value — per-tier time is additive over keys.
            before = self._key_seconds(tier, t)
            t.add(accesses, bytes_each, self.model[tier].min_grain_B)
            self.parallel_s[tier.value] += self._key_seconds(tier, t) - before
        else:
            t.add(accesses, bytes_each, self.model[tier].min_grain_B)

    def _key_seconds(self, tier: Tier, t: "Traffic") -> float:
        """Time one stage key's traffic occupies a tier (see tier_seconds)."""
        return self.model[tier].seconds(t.accesses, t.bytes)

    def add_compute(self, seconds: float) -> None:
        self.compute_s += seconds

    def tier_seconds(self, tier: Tier) -> float:
        """Time a tier spends serving this ledger's traffic.

        Overlap model: within a stage, accesses pipeline up to the tier's
        queue parallelism (SSD QD, CXL banks), so the latency term amortizes
        to ``accesses · latency / parallelism`` while data streams at the
        sustained bandwidth.  Latency and transfer fully overlap — the stage
        is bound by whichever is larger, hence ``max(lat, bw)`` (not the
        sum): a deep-queued tier hides per-access latency behind streaming,
        and a latency-bound tier hides the (smaller) transfer time inside
        its access pipeline.
        """
        if tier.value in self.parallel_s:
            return self.parallel_s[tier.value]
        total = 0.0
        for key, t in self.ledger.items():
            # keys are "stage:tier" — parse the tier component instead of
            # suffix-matching, so a stage name can never alias a tier (e.g.
            # a stage literally called "overssd" must not match Tier.SSD).
            if key.rsplit(":", 1)[-1] != tier.value:
                continue
            total += self._key_seconds(tier, t)
        return total

    def total_seconds(self) -> float:
        """Stages on different tiers overlap poorly across the refinement
        dependency chain; we take the sum of per-tier times + compute (the
        paper's pipeline is serialized coarse → refine → SSD rerank)."""
        return sum(self.tier_seconds(t) for t in Tier) + self.compute_s

    def breakdown(self) -> dict[str, float]:
        out = {t.value: self.tier_seconds(t) for t in Tier}
        out["compute"] = self.compute_s
        return out

    def by_tier(self) -> dict[Tier, Traffic]:
        """Pooled traffic per tier (every tier present, zero if untouched),
        so consumers aggregate by tier without parsing ledger keys."""
        out = {t: Traffic() for t in Tier}
        for key, t in self.ledger.items():
            tier = Tier(key.rsplit(":", 1)[-1])
            out[tier].accesses += t.accesses
            out[tier].bytes += t.bytes
        return out

    def merge(self, other: "QueryCost") -> "QueryCost":
        """Fold another ledger's traffic + compute into this one (in place),
        with SERIAL semantics: the other batch ran after this one, so times
        add — as do traffic and compute.

        Used by serving to keep a running total across request batches.  If
        either side has been parallel-folded (``parallel_s`` set), per-tier
        times are re-frozen as the sum of both sides' times, since the
        pooled traffic can no longer reproduce them.
        """
        if self.parallel_s or other.parallel_s:
            frozen = {t.value: self.tier_seconds(t) + other.tier_seconds(t)
                      for t in Tier}
        else:
            frozen = None
        for key, t in other.ledger.items():
            mine = self.ledger.setdefault(key, Traffic())
            mine.accesses += t.accesses
            mine.bytes += t.bytes
        self.compute_s += other.compute_s
        if frozen is not None:
            self.parallel_s = frozen
        return self

    def merge_parallel(self, other: "QueryCost") -> "QueryCost":
        """Fold a CONCURRENT lane's ledger into this one (in place).

        Overlap model (documented like ``tier_seconds``'s ``max(lat, bw)``):
        parallel shards run at the same time on disjoint channel slices, so
        traffic (accesses + bytes) SUMS — the capacity-planning view: every
        lane really moved its bytes — while per-tier time and compute take
        the MAX across lanes: the batch completes when the slowest lane
        does.  Chaining ``a.merge_parallel(b).merge_parallel(c)`` folds any
        number of lanes (max is associative).

        After this call per-tier times are frozen in ``parallel_s``; later
        ``record``s (serial work after the parallel phase) and ``merge``s
        extend the frozen times additively.
        """
        frozen = {t.value: max(self.tier_seconds(t), other.tier_seconds(t))
                  for t in Tier}
        for key, t in other.ledger.items():
            mine = self.ledger.setdefault(key, Traffic())
            mine.accesses += t.accesses
            mine.bytes += t.bytes
        self.compute_s = max(self.compute_s, other.compute_s)
        self.parallel_s = frozen
        return self

    def copy(self) -> "QueryCost":
        c = QueryCost(model=dict(self.model))
        c.ledger = {k: dataclasses.replace(v) for k, v in self.ledger.items()}
        c.compute_s = self.compute_s
        c.parallel_s = dict(self.parallel_s)
        return c
