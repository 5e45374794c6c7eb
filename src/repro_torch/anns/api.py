"""``Database`` handle + ``QueryPlan``: the port's query API.

``Database.build(x, config)`` builds a static index (on the GPU unless a
device is given); ``Database.wrap(index)`` adopts one.  ``query`` resolves
a plan against the index config, validates it once against the
capability registry (``PlanError`` for anything not ported yet), fetches
or builds the executor and returns a ``SearchResult``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.anns import registry
from repro_torch.anns.executor import make_executor, search_budget
from repro_torch.anns.pipeline import FaTRQIndex, PipelineConfig
from repro_torch.anns.pipeline import build as _build_index
from repro_torch.anns.registry import PlanError
from repro_torch.memory import QueryCost

__all__ = ["Database", "QueryPlan", "SearchResult", "PlanError"]


@dataclass(frozen=True)
class QueryPlan:
    """How to run a search; ``None`` fields resolve from the index."""

    front: str | None = None          # "ivf"
    backend: str | None = None        # "reference" | "cuda"
    shards: int | None = None         # sharded search is not ported yet
    k: int | None = None
    refine_budget: int | None = None
    micro_batch: int | None = None
    mode: str = "fatrq"               # "fatrq" | "baseline"

    def resolve(self, index: FaTRQIndex) -> "QueryPlan":
        config = index.config
        k = self.k or config.final_k
        return dataclasses.replace(
            self, front=self.front or config.front,
            backend=self.backend or index.default_backend, k=k,
            refine_budget=search_budget(config, k, self.refine_budget),
            micro_batch=self.micro_batch if self.micro_batch is not None
            else config.micro_batch)


@dataclass(frozen=True)
class SearchResult:
    ids: torch.Tensor         # (Q, k) int32 database ids
    distances: torch.Tensor   # (Q, k) f32 exact squared L2 of ``ids``
    cost: QueryCost           # the Table-I traffic ledger
    plan: QueryPlan           # the resolved plan


class Database:
    """Query handle over one static ``FaTRQIndex``."""

    def __init__(self, index: FaTRQIndex):
        if not isinstance(index, FaTRQIndex):
            raise TypeError(f"cannot wrap {type(index).__name__}: the port "
                            f"has the static FaTRQIndex layout only")
        self.index = index

    @classmethod
    def build(cls, x, config: PipelineConfig, *, device=None,
              **draws) -> "Database":
        """Offline build (see ``pipeline.build`` for the draws)."""
        return cls.wrap(_build_index(x, config, device=device, **draws))

    @classmethod
    def wrap(cls, index) -> "Database":
        """Adopt an index; the handle is cached on it."""
        if isinstance(index, Database):
            return index
        db = index.__dict__.get("_db_handle")
        if db is None:
            db = index.__dict__["_db_handle"] = cls(index)
        return db

    @property
    def config(self) -> PipelineConfig:
        return self.index.config

    def __len__(self) -> int:
        return int(self.index.x.shape[0])

    def validate(self, plan: QueryPlan | None = None) -> QueryPlan:
        """Resolve and check a plan; raise ``PlanError`` before any work."""
        p = (plan or QueryPlan()).resolve(self.index)
        if p.shards is not None:
            raise PlanError(f"shards={p.shards}: the sharded layout is not "
                            f"ported to repro_torch yet")
        registry.validate_combo(p.front, p.backend, "static")
        if p.mode not in ("fatrq", "baseline"):
            raise PlanError(f"unknown search mode {p.mode!r}; expected "
                            f"'fatrq' or 'baseline'")
        return p

    def query(self, queries, *, plan: QueryPlan | None = None,
              k: int | None = None, micro_batch: int | None = None,
              refine_budget: int | None = None,
              cost: QueryCost | None = None) -> SearchResult:
        """Planned search → ``SearchResult``; ``k``, ``micro_batch`` and
        ``refine_budget`` override the plan for this call."""
        p = plan or QueryPlan()
        if k is not None:
            stale = p.k is not None and k != p.k and \
                p.refine_budget == search_budget(self.config, p.k)
            p = dataclasses.replace(
                p, k=k, refine_budget=None if stale else p.refine_budget)
        if refine_budget is not None:
            p = dataclasses.replace(p, refine_budget=refine_budget)
        if micro_batch is not None:
            p = dataclasses.replace(p, micro_batch=micro_batch)
        rp = self.validate(p)
        q = torch.as_tensor(queries, dtype=torch.float32) \
            .to(self.index.device).contiguous()
        ex = make_executor(self.index, front=rp.front, backend=rp.backend,
                           micro_batch=rp.micro_batch,
                           refine_budget=rp.refine_budget)
        if rp.mode == "baseline":
            ids, dists, out = ex.execute_baseline(q, k=rp.k)
            if cost is not None:
                out = cost.merge(out)
        else:
            ids, dists, out = ex.execute(q, k=rp.k, cost=cost)
        return SearchResult(ids=ids, distances=dists, cost=out, plan=rp)
