"""Staged search executor: front → refine → rerank over query micro-batches.

Stages emit 0-d device counters; the executor sums them on the device
across micro-batches and folds the totals into a Table-I ``QueryCost``
ledger with a single host transfer per search.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.anns import registry
from repro_torch.anns import stages as stages_mod
from repro_torch.anns.stages import Counters
from repro_torch.index.graph import GraphIndex
from repro_torch.memory import QueryCost, Tier

# modeled scale of ADC + ternary adds per candidate (the JAX package's)
_COMPUTE_S_PER_CAND = 1e-7


def _accumulate(total: Counters, new: Counters) -> Counters:
    for name, v in new.items():
        total[name] = total[name] + v if name in total else v
    return total


def search_budget(config, k: int, override: int | None = None) -> int:
    """SSD rerank budget: the plan's, else the config's, else max(4k, 32);
    never below k."""
    return max(override or config.refine_budget or max(4 * k, 32), k)


def iter_chunks(queries: torch.Tensor, micro_batch: int | None):
    """Split a query batch into micro-batches (None = all at once)."""
    if micro_batch is None or micro_batch >= queries.shape[0]:
        yield queries
        return
    for i in range(0, queries.shape[0], micro_batch):
        yield queries[i:i + micro_batch]


def _collect(counters: Counters) -> dict[str, int]:
    """The single device→host transfer of a search call."""
    if not counters:
        return {}
    vals = torch.stack([v.to(torch.int64) for v in counters.values()])
    return dict(zip(counters, vals.cpu().tolist()))


def _cat(parts: list[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


@dataclass
class SearchExecutor:
    """Batched staged search over a ``FaTRQIndex``."""

    index: "FaTRQIndex"               # noqa: F821 - import cycle via pipeline
    front: object
    backend: object
    micro_batch: int | None = None
    refine_budget: int | None = None

    @classmethod
    def from_index(cls, index, *, front: str = "ivf",
                   backend: str = "reference", micro_batch: int | None = None,
                   refine_budget: int | None = None,
                   graph_index: GraphIndex | None = None,
                   layout: str = "static",
                   **front_opts) -> "SearchExecutor":
        """``graph_index`` hands the graph front a graph of the caller's
        (else ``stages.graph_for`` builds and caches one)."""
        if graph_index is not None:
            front_opts["graph_index"] = graph_index
        return cls(index=index,
                   front=registry.make_front(front, layout, index,
                                             **front_opts),
                   backend=registry.make_backend(backend),
                   micro_batch=micro_batch, refine_budget=refine_budget)

    def execute(self, queries: torch.Tensor, *, k: int | None = None,
                cost: QueryCost | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, QueryCost]:
        """FaTRQ search: (Q, k) ids, their exact squared-L2 distances and
        the folded traffic ledger."""
        cfg = self.index.config
        k = k or cfg.final_k
        budget = search_budget(cfg, k, self.refine_budget)
        ids_parts, dist_parts = [], []
        counters: Counters = {}
        for chunk in iter_chunks(queries, self.micro_batch):
            cand = self.front.candidates(chunk)
            refined = self.backend.refine(chunk, cand, self.index.trq, k=k,
                                          bound=cfg.bound, z=cfg.z)
            topk, topk_d, n_ssd = stages_mod._rerank_survivors(
                self.index.x, chunk, cand.ids, refined.est, refined.alive,
                k=k, budget=budget)
            ids_parts.append(topk)
            dist_parts.append(topk_d)
            _accumulate(counters, cand.counters)
            _accumulate(counters, refined.counters)
            _accumulate(counters, {"ssd_fetch": n_ssd})
        cost = fold_counts(_collect(counters), cost=cost, config=cfg,
                           layout=self.index.layout,
                           front_fold=self.front.fold_cost)
        return _cat(ids_parts), _cat(dist_parts), cost

    def execute_baseline(self, queries: torch.Tensor, *,
                         k: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor, QueryCost]:
        """Baseline (cuVS/FAISS style): front stage, then exact rerank of
        the FULL candidate list from SSD — no far-memory refinement."""
        k = k or self.index.config.final_k
        ids_parts, dist_parts = [], []
        counters: Counters = {}
        for chunk in iter_chunks(queries, self.micro_batch):
            cand = self.front.candidates(chunk)
            topk, topk_d, n_valid = stages_mod._rerank_all(
                self.index.x, chunk, cand.ids, cand.valid, k=k)
            ids_parts.append(topk)
            dist_parts.append(topk_d)
            _accumulate(counters, cand.counters)
            _accumulate(counters, {"ssd_fetch": n_valid})
        counts = _collect(counters)
        cost = QueryCost()
        lay = self.index.layout
        self.front.fold_cost(cost, counts, lay)
        cost.record("rerank", Tier.SSD, counts["ssd_fetch"], lay.ssd_bytes)
        cost.add_compute(_COMPUTE_S_PER_CAND * counts["front_cand"])
        return _cat(ids_parts), _cat(dist_parts), cost


def fold_counts(counts: dict[str, int], *, cost: QueryCost | None, config,
                layout, front_fold) -> QueryCost:
    """Fold collected stage counters into a Table-I traffic ledger."""
    cost = cost or QueryCost()
    n_cand = counts["front_cand"]
    n_alive = counts["refine_alive"]
    front_fold(cost, counts, layout)
    # front → refine handoff: 4 B coarse distance per candidate (§IV)
    cost.record("handoff", Tier.CXL, n_cand, 4)
    # level-0 codes stream for ALL candidates, level ℓ ≥ 1 only for the
    # survivors of level ℓ−1; delta-page rows bill to their own entry
    n_delta = counts.get("delta_cand", 0)
    cost.record("refine", Tier.CXL, n_cand - n_delta, layout.far_bytes)
    if n_delta:
        cost.record("delta", Tier.CXL, n_delta, layout.far_bytes)
    for lv in range(1, config.trq_levels):
        n_lv = counts.get(f"refine_alive_l{lv}", n_alive)
        n_lv_delta = counts.get(f"refine_alive_l{lv}_delta", 0)
        cost.record("refine", Tier.CXL, n_lv - n_lv_delta, layout.far_bytes)
        if n_lv_delta:
            cost.record("delta", Tier.CXL, n_lv_delta, layout.far_bytes)
    # survivors (≤ budget per query) hit SSD
    cost.record("rerank", Tier.SSD, counts["ssd_fetch"], layout.ssd_bytes)
    cost.add_compute(_COMPUTE_S_PER_CAND * n_cand)
    return cost


def make_executor(index, *, front: str = "ivf", backend: str = "reference",
                  micro_batch: int | None = None,
                  refine_budget: int | None = None, layout: str = "static",
                  **front_opts) -> SearchExecutor:
    """Executor factory memoized on the index instance (its lifetime is the
    index's)."""
    key = (front, backend, micro_batch, refine_budget, layout,
           tuple(sorted(front_opts.items())))
    cache = index.__dict__.setdefault("_executor_cache", {})
    ex = cache.get(key)
    if ex is None:
        ex = SearchExecutor.from_index(index, front=front, backend=backend,
                                       micro_batch=micro_batch,
                                       refine_budget=refine_budget,
                                       layout=layout, **front_opts)
        cache[key] = ex
    return ex
