"""``Database`` handle + ``QueryPlan``: the port's query API.

``Database.build(x, config)`` builds a static index (on the GPU unless a
device is given); ``Database.wrap(index)`` adopts a static ``FaTRQIndex``,
a ``ShardedIndex``, a ``StreamingIndex`` or a ``TieredIndex``.  ``query``
resolves a plan against the index config, validates it once against the
capability registry (``PlanError`` for anything unsupported or not ported
yet), fetches or builds the executor (kept per (generation, resolved
plan)) and returns a ``SearchResult``.  A plan with ``shards`` on a static
index runs the sharded layout (``anns.sharding``) over a partition kept
on the index.

Both fronts run on both layouts: ``QueryPlan(front="graph")`` searches the
index's kNN graph (built on first use and kept on the index,
``stages.graph_for``) and ``QueryPlan(front="graph", shards=S)`` its
range + halo partition.  ``mode="baseline"`` runs on the static layout
only, and a wrapped ``ShardedIndex`` answers only the front it was
partitioned for.

A ``StreamingIndex`` (the streaming layout) runs both fronts and both
backends, ``shards=S`` over its ``rebuild_static`` snapshot, ids mapped to
global ids; a mutation bumps the generation and drops its executors.  A
``TieredIndex`` (the tiered layout) runs both fronts and both backends,
unsharded and in ``mode="fatrq"`` only; a placement migration bumps its
generation.

``Database.compiled(plan)`` validates once and returns a ``CompiledPlan``:
the executor of one index generation with its global-id map, the serving
engine's dispatch handle (``execute``, and ``run_front`` / ``run_finish``
where the layout has a front/refine boundary).  ``query(bucket=True)``
pads ragged micro-batches to power-of-two buckets
(``executor.bucket_for``), with the same answers and ledger.

Traced (``obs.trace``), a query opens a ``query`` span holding
``plan.resolve``, a ``plan.compile`` event (``cache_hit``) and, on a miss,
a ``plan.compile.build`` span, then the executor's spans.
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
from repro_torch.anns.sharding import ShardedIndex, make_sharded_executor
from repro_torch.anns.streaming import StreamingIndex
from repro_torch.anns.tiered import TieredIndex
from repro_torch.memory import QueryCost
from repro_torch.obs import trace

__all__ = ["CompiledPlan", "Database", "QueryPlan", "SearchResult",
           "PlanError"]


@dataclass(frozen=True)
class QueryPlan:
    """How to run a search; ``None`` fields resolve from the index."""

    front: str | None = None          # "ivf" | "graph"
    backend: str | None = None        # "reference" | "cuda"
    shards: int | None = None         # None = unsharded; S ≥ 1 shards
    k: int | None = None
    refine_budget: int | None = None
    micro_batch: int | None = None
    mode: str = "fatrq"               # "fatrq" | "baseline"

    def resolve(self, index) -> "QueryPlan":
        config = index.config
        k = self.k or config.final_k
        return dataclasses.replace(
            self, front=self.front or config.front,
            backend=self.backend or index.default_backend, k=k,
            refine_budget=search_budget(config, k, self.refine_budget),
            micro_batch=self.micro_batch if self.micro_batch is not None
            else config.micro_batch)

    def to_record(self) -> dict:
        """JSON-friendly dict (span attributes, logs)."""
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class SearchResult:
    ids: torch.Tensor         # (Q, k) database ids (int64 global ids on
                              # the streaming layout, else int32)
    distances: torch.Tensor   # (Q, k) f32 exact squared L2 of ``ids``
    cost: QueryCost           # the Table-I traffic ledger
    plan: QueryPlan           # the resolved plan


@dataclass
class CompiledPlan:
    """A validated plan bound to its executor at one index generation.

    ``supports_split`` says whether the executor has a front/refine
    boundary: ``run_front`` then ``run_finish`` on one micro-batch is
    exactly ``execute`` on it.  The sharded layout has none (its shards'
    stages run in one body); dispatch whole batches through ``execute``
    there.  Ids come back as global ids (mapped through ``_gid`` on the
    streaming layout)."""

    db: "Database"
    plan: QueryPlan                  # fully resolved
    generation: int                  # index generation at compile time
    _ex: object
    _gid: torch.Tensor | None        # row → global id (streaming)

    @property
    def supports_split(self) -> bool:
        return hasattr(self._ex, "run_front")

    def _result(self, ids, dists, cost) -> SearchResult:
        if self._gid is not None:
            ids = self._gid[ids.long()]
        return SearchResult(ids=ids, distances=dists, cost=cost,
                            plan=self.plan)

    def execute(self, queries, *, pad: bool = False,
                cost: QueryCost | None = None) -> SearchResult:
        """Whole-batch dispatch: front, refine, rerank and the fold."""
        q = self.db._queries(queries)
        if self.plan.mode == "baseline":
            ids, dists, out = self._ex.execute_baseline(q, k=self.plan.k,
                                                        pad=pad)
            if cost is not None:
                out = cost.merge(out)
        else:
            ids, dists, out = self._ex.execute(q, k=self.plan.k, cost=cost,
                                               pad=pad)
        return self._result(ids, dists, out)

    def run_front(self, chunk: torch.Tensor, *,
                  qvalid: torch.Tensor | None = None):
        """Stage 1 for ONE micro-batch (at most the plan's
        ``micro_batch`` rows, on the index's device): the ``Candidates``
        handle to pass to ``run_finish``."""
        return self._ex.run_front(chunk, qvalid=qvalid)

    def run_finish(self, chunk: torch.Tensor, cand, *,
                   cost: QueryCost | None = None) -> SearchResult:
        """Stage 2: refine, rerank and the ledger fold of a ``run_front``
        result, with global ids (padded rows included)."""
        return self._result(*self._ex.run_finish(chunk, cand, k=self.plan.k,
                                                 cost=cost))


class Database:
    """Query handle over one ``FaTRQIndex`` (static), ``ShardedIndex``,
    ``StreamingIndex`` or ``TieredIndex``."""

    def __init__(self, index: FaTRQIndex | ShardedIndex | StreamingIndex
                 | TieredIndex):
        if isinstance(index, TieredIndex):
            self.layout = "tiered"
        elif isinstance(index, StreamingIndex):
            self.layout = "streaming"
        elif isinstance(index, ShardedIndex):
            self.layout = "sharded"
        elif isinstance(index, FaTRQIndex):
            self.layout = "static"
        else:
            raise TypeError(f"cannot wrap {type(index).__name__}: expected "
                            f"FaTRQIndex, ShardedIndex, StreamingIndex or "
                            f"TieredIndex")
        self.index = index
        self._compiled: dict[tuple, tuple] = {}
        if self.layout in ("streaming", "tiered"):
            # a mutation or migration drops the executors of older
            # generations at once (their fronts and snapshots hold
            # superseded device tensors)
            index.add_generation_hook(lambda st, gen: self._compiled.clear())

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

    @property
    def generation(self) -> int:
        """0 for the immutable layouts; a ``StreamingIndex``'s mutation
        count; a ``TieredIndex``'s migration count."""
        return getattr(self.index, "generation", 0)

    def __len__(self) -> int:
        if self.layout == "streaming":
            return self.index.n_live
        if self.layout == "sharded":
            return int(self.index.shard_rows.sum())
        return int(self.index.x.shape[0])

    def _effective_layout(self, plan: QueryPlan) -> str:
        """A shard count on a static index routes through the sharded
        layout; a streaming index stays streaming (its ``shards`` search a
        snapshot, validated against the sharded layout too)."""
        if self.layout != "static":
            return self.layout
        return "sharded" if plan.shards is not None else "static"

    def validate(self, plan: QueryPlan | None = None) -> QueryPlan:
        """Resolve and check a plan; raise ``PlanError`` before any work."""
        p = (plan or QueryPlan()).resolve(self.index)
        layout = self._effective_layout(p)
        registry.validate_combo(p.front, p.backend, layout)
        if self.layout == "streaming" and p.shards is not None:
            registry.validate_combo(p.front, p.backend, "sharded")
        if p.mode == "baseline":
            if layout != "static":
                raise PlanError(
                    f"unsupported plan: mode 'baseline' cannot run on the "
                    f"{layout!r} index layout — the no-refinement baseline "
                    f"supports layouts [static] only")
        elif p.mode != "fatrq":
            raise PlanError(f"unknown search mode {p.mode!r}; expected "
                            f"'fatrq' or 'baseline'")
        if self.layout == "tiered" and p.shards is not None:
            raise PlanError(
                f"unsupported plan: shards={p.shards} cannot run on the "
                f"'tiered' index layout — heat-driven placement is "
                f"per-device; partition the wrapped static index "
                f"(Database.wrap(tiered.inner)) and re-apply tiering per "
                f"shard instead")
        if self.layout == "sharded":
            if p.shards not in (None, self.index.n_shards):
                raise PlanError(
                    f"plan asks for {p.shards} shards but the wrapped "
                    f"ShardedIndex is partitioned {self.index.n_shards} "
                    f"ways — re-partition the base index instead")
            if p.front != self.index.front:
                raise PlanError(
                    f"plan asks for the {p.front!r} front but the wrapped "
                    f"ShardedIndex was partitioned for the "
                    f"{self.index.front!r} front")
        return p

    def executor_for(self, plan: QueryPlan | None = None, *, mesh=None):
        """Validate and compile ``plan``; its executor (kept per
        (generation, resolved plan, mesh))."""
        return self._compile(self.validate(plan), mesh)[0]

    def compiled(self, plan: QueryPlan | None = None, *,
                 mesh=None) -> CompiledPlan:
        """Validate and compile ``plan`` into a ``CompiledPlan`` for this
        generation: O(1) when the executor is kept, rebuilt after a
        mutation or migration.  ``mesh`` (``launch.mesh.make_search_mesh``)
        runs a sharded plan with one shard per rank."""
        rp = self.validate(plan)
        ex, gid = self._compile(rp, mesh)
        return CompiledPlan(db=self, plan=rp, generation=self.generation,
                            _ex=ex, _gid=gid)

    def _queries(self, queries) -> torch.Tensor:
        """Queries as a contiguous float32 tensor on the index's device."""
        return torch.as_tensor(queries, dtype=torch.float32) \
            .to(self.index.device).contiguous()

    def query(self, queries, *, plan: QueryPlan | None = None,
              k: int | None = None, micro_batch: int | None = None,
              refine_budget: int | None = None, bucket: bool = False,
              cost: QueryCost | None = None, mesh=None) -> SearchResult:
        """Planned search → ``SearchResult``; ``k``, ``micro_batch`` and
        ``refine_budget`` override the plan for this call.  ``bucket=True``
        pads ragged micro-batches to power-of-two buckets
        (``executor.bucket_for``) under a validity mask: the same ids,
        distances and ledger, from a fixed set of batch shapes.

        ``mesh`` (``launch.mesh.make_search_mesh``) runs a sharded plan
        across processes, one shard per rank: every rank calls ``query``
        with the same queries and plan and gets the same answer, the
        stacked form's bit for bit.  Its size must be the plan's
        ``shards``."""
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
        # a bad plan raises PlanError before the queries are touched
        with trace.span("query", track="query", layout=self.layout) as sp_q:
            with trace.span("plan.resolve", track="query"):
                rp = self.validate(p)
            q = self._queries(queries)
            sp_q.set_attrs(plan=rp.to_record(), n_queries=int(q.shape[0]))
            ex, gid = self._compile(rp, mesh)
            return CompiledPlan(db=self, plan=rp, generation=self.generation,
                                _ex=ex, _gid=gid).execute(q, pad=bucket,
                                                          cost=cost)

    def _compile(self, rp: QueryPlan, mesh=None) -> tuple:
        """(executor, row → global id map or None) of a resolved plan, kept
        per (generation, plan, mesh); a miss drops the older generations'
        entries (their fronts hold superseded tensors)."""
        gen = self.generation
        key = (gen, rp, mesh)
        hit = self._compiled.get(key)
        trace.event("plan.compile", track="query", cache_hit=hit is not None,
                    generation=gen, layout=self.layout)
        if hit is not None:
            return hit
        self._compiled = {kk: v for kk, v in self._compiled.items()
                          if kk[0] == gen}
        with trace.span("plan.compile.build", track="query",
                        layout=self.layout, generation=gen):
            hit = self._compiled[key] = self._build(rp, mesh)
        return hit

    def _build(self, rp: QueryPlan, mesh=None) -> tuple:
        if self.layout == "streaming":
            st = self.index
            if rp.shards is None:
                return (st._executor(rp.front, rp.backend, rp.micro_batch,
                                     rp.refine_budget),
                        st._dev()["row_gid"])
            idx, gid = st.rebuild_static()
            return (make_sharded_executor(
                idx, shards=rp.shards, front=rp.front, backend=rp.backend,
                micro_batch=rp.micro_batch, refine_budget=rp.refine_budget,
                mesh=mesh), torch.from_numpy(gid).to(st.device))
        if self.layout == "tiered":
            return make_executor(self.index, front=rp.front,
                                 backend=rp.backend,
                                 micro_batch=rp.micro_batch,
                                 refine_budget=rp.refine_budget,
                                 layout="tiered"), None
        if self._effective_layout(rp) == "sharded":
            return make_sharded_executor(
                self.index, shards=self.index.n_shards
                if rp.shards is None else rp.shards,
                front=rp.front, backend=rp.backend,
                micro_batch=rp.micro_batch,
                refine_budget=rp.refine_budget, mesh=mesh), None
        return make_executor(self.index, front=rp.front, backend=rp.backend,
                             micro_batch=rp.micro_batch,
                             refine_budget=rp.refine_budget), None
