"""Staged search executor: front → refine → rerank over query micro-batches.

Stages emit device-side counters (0-d tensors, and the tiered layout's
per-list ``list_heat`` histogram); the executor sums them on the device
across micro-batches and folds the totals into a Table-I ``QueryCost``
ledger with a single host transfer per search.

On the tiered layout (``anns.tiered``) the executor routes every
candidate slot by its tier code: hot slots leave refinement and are
scored exactly, cold slots refine as ``is_delta`` rows whose residual
stream bills at SSD rates.

Fixed shapes: ``execute(pad=True)`` pads every ragged micro-batch to its
power-of-two bucket (``bucket_for``, ``pad_chunk``) with a per-query
validity mask ``qvalid``; padded rows add no candidates, no counters and
no heat, so the answers and the ledger are the unpadded ones bit for
bit, and the kernels see only the bucket shapes.  ``run_front`` and
``run_finish`` split one micro-batch at the front/refine boundary for the
serving engine's double buffer; together they are ``execute`` on that
micro-batch.

Spans (``obs.trace``): ``execute`` per search, ``front`` / ``refine`` /
``rerank`` per micro-batch (``front`` and ``finish`` per split call),
``refine.l{ℓ}`` events, and the modeled time and measured-to-modeled
drift per stage.  While a tracer is active each
stage synchronizes its CUDA device before its span closes and each
micro-batch's counters cross to the host once more; with no tracer, none
of that happens.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.anns import registry
from repro_torch.anns import stages as stages_mod
from repro_torch.anns.stages import Counters, FrontStage, RefineBackend
from repro_torch.index.graph import GraphIndex
from repro_torch.memory import QueryCost, Tier
from repro_torch.memory.placement import TIER_COLD, TIER_HOT
from repro_torch.obs import metrics, trace

# modeled scale of ADC + ternary adds per candidate (the JAX package's)
_COMPUTE_S_PER_CAND = 1e-7

# wall/modeled drift ratio buckets: < 1 means the tier model over-charges
_DRIFT_BUCKETS = (0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 100.0, 1_000.0,
                  10_000.0, 100_000.0)


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


def bucket_for(n: int, micro_batch: int | None = None) -> int:
    """Smallest batch bucket covering ``n`` queries: a power of two, capped
    at ``micro_batch`` (the full micro-batch's shape).  Padding ragged
    micro-batches up to their bucket keeps the query shapes the stages
    and kernels see at {1, 2, 4, ..., micro_batch} whatever batch sizes
    callers send."""
    b = 1
    while b < n:
        b <<= 1
    if micro_batch is not None and b > micro_batch >= n:
        b = micro_batch
    return b


def pad_chunk(chunk: torch.Tensor, bucket: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad an (n, D) micro-batch to ``bucket`` rows; returns the
    padded batch and the (bucket,) bool per-query validity mask, made on
    the batch's device (all true when n == bucket)."""
    n = chunk.shape[0]
    qvalid = torch.arange(bucket, device=chunk.device) < n
    if n == bucket:
        return chunk, qvalid
    pad = chunk.new_zeros((bucket - n,) + tuple(chunk.shape[1:]))
    return torch.cat([chunk, pad], dim=0), qvalid


def _padded(chunk: torch.Tensor, pad: bool, micro_batch: int | None
            ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The micro-batch the stages see, and its validity mask (None when
    not padding: every row is a real query)."""
    if not pad:
        return chunk, None
    return pad_chunk(chunk, bucket_for(chunk.shape[0], micro_batch))


def _collect(counters: Counters) -> dict:
    """The single device→host transfer of a search call: 0-d counters come
    back as Python ints, vector counters (``list_heat``) as numpy
    arrays."""
    if not counters:
        return {}
    flat = torch.cat([v.reshape(-1).to(torch.int64)
                      for v in counters.values()]).cpu().numpy()
    out, at = {}, 0
    for name, v in counters.items():
        n = v.numel()
        out[name] = int(flat[at]) if v.dim() == 0 else flat[at:at + n]
        at += n
    return out


def _cat(parts: list[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _sync(t: torch.Tensor) -> None:
    """Wait for ``t``'s device (tracing only: the span then covers the
    device work); nothing to wait for on the CPU."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass
class SearchExecutor:
    """Batched staged search over a ``FaTRQIndex`` (or a ``TieredIndex``,
    which quacks like one)."""

    index: "FaTRQIndex"               # noqa: F821 - import cycle via pipeline
    front: FrontStage
    backend: RefineBackend
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

    def _refine_rerank(self, chunk: torch.Tensor, cand, *, k: int,
                       budget: int, front_span=None
                       ) -> tuple[torch.Tensor, torch.Tensor, Counters]:
        """Refine + SSD rerank of one micro-batch's candidates, with the
        tiered layout's routing when the front annotated tiers: hot slots
        leave refinement (invalid, d0 = +inf) and take their exact
        distance as estimate, cold slots refine as ``is_delta`` rows.  The
        hot path runs only when the placement has a hot list
        (``front.any_hot``); with every list warm the front annotates no
        tiers and the answer is the static layout's bit for bit."""
        cfg = self.index.config
        tr = trace.active()
        hot = None
        rcand = cand
        if cand.tier is not None:
            cold = cand.valid & (cand.tier == TIER_COLD)
            valid, d0 = cand.valid, cand.d0
            if self.front.any_hot:
                hot = cand.valid & (cand.tier == TIER_HOT)
                valid = valid & ~hot
                d0 = torch.where(hot, torch.full_like(d0, float("inf")), d0)
            rcand = cand._replace(valid=valid, d0=d0, is_delta=cold,
                                  tier=None)
        with trace.span("refine", track="query",
                        backend=self.backend.name) as sp_refine:
            refined = self.backend.refine(chunk, rcand, self.index.trq, k=k,
                                          bound=cfg.bound, z=cfg.z)
            if tr is not None:
                _sync(refined.est)
        with trace.span("rerank", track="query", budget=budget) as sp_rerank:
            if hot is not None:
                d_hot = stages_mod._score_hot(self.index.x, chunk, cand.ids,
                                              hot)
                est = torch.where(hot, d_hot, refined.est)
                topk, topk_d, n_ssd, _ = stages_mod._rerank_survivors_tiered(
                    self.index.x, chunk, cand.ids, est, refined.alive | hot,
                    hot, k=k, budget=budget)
            else:
                topk, topk_d, n_ssd = stages_mod._rerank_survivors(
                    self.index.x, chunk, cand.ids, refined.est,
                    refined.alive, k=k, budget=budget)
            if tr is not None:
                _sync(topk)
        counters = dict(cand.counters)
        _accumulate(counters, refined.counters)
        _accumulate(counters, {"ssd_fetch": n_ssd})
        if tr is not None:
            self._attach_model(tr, {"front": front_span, "refine": sp_refine,
                                    "rerank": sp_rerank}, counters)
        return topk, topk_d, counters

    def _attach_model(self, tr, spans: dict, counters: Counters) -> None:
        """Tracing only: fold this micro-batch's counters into a throwaway
        ledger, attach each stage's modeled seconds (front → HBM, refine →
        CXL, rerank → SSD) and its measured-wall / modeled drift to its
        span, observe the drift into ``fatrq_model_drift_ratio{stage}``,
        and emit one ``refine.l{ℓ}`` event per TRQ level with that level's
        entering and delta counts and modeled CXL time."""
        counts = _collect(counters)
        cost = fold_counts(counts, cost=None, config=self.index.config,
                           layout=self.index.layout,
                           front_fold=self.front.fold_cost)
        model_s = {"front": cost.tier_seconds(Tier.HBM),
                   "refine": cost.tier_seconds(Tier.CXL),
                   "rerank": cost.tier_seconds(Tier.SSD)}
        for stage, handle in spans.items():
            if handle is not None and handle.span is not None:
                _attach_drift(handle, model_s[stage], stage)
        # per level, as fold_counts walks them: level 0 streams every
        # candidate, level ℓ ≥ 1 only the survivors of ℓ − 1
        sp_refine = spans.get("refine")
        parent = (sp_refine.span.sid
                  if sp_refine is not None and sp_refine.span is not None
                  else None)
        cxl = cost.model[Tier.CXL]
        far = self.index.layout.far_bytes
        n_alive = counts.get("refine_alive", 0)
        for lv in range(self.index.config.trq_levels):
            if lv == 0:
                n_lv = counts.get("front_cand", 0)
                n_lv_delta = counts.get("delta_cand", 0)
            else:
                n_lv = counts.get(f"refine_alive_l{lv}", n_alive)
                n_lv_delta = counts.get(f"refine_alive_l{lv}_delta", 0)
            tr.event(f"refine.l{lv}", track="query", parent=parent,
                     level=lv, entering=int(n_lv), delta=int(n_lv_delta),
                     model_s=cxl.seconds(n_lv, n_lv * far))

    def execute(self, queries: torch.Tensor, *, k: int | None = None,
                cost: QueryCost | None = None, pad: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, QueryCost]:
        """FaTRQ search: (Q, k) ids, their exact squared-L2 distances and
        the folded traffic ledger.  ``pad=True`` pads each ragged
        micro-batch to its bucket (``bucket_for``) under a validity mask;
        the padded rows are sliced off before the concatenation."""
        cfg = self.index.config
        k = k or cfg.final_k
        budget = search_budget(cfg, k, self.refine_budget)
        tr = trace.active()
        with trace.span("execute", track="query", front=self.front.name,
                        backend=self.backend.name, k=k, budget=budget,
                        n_queries=int(queries.shape[0])) as sp_ex:
            ids_parts, dist_parts = [], []
            counters: Counters = {}
            for chunk in iter_chunks(queries, self.micro_batch):
                n = chunk.shape[0]
                chunk, qvalid = _padded(chunk, pad, self.micro_batch)
                with trace.span("front", track="query",
                                stage=self.front.name, n=n) as sp_front:
                    cand = self.front.candidates(chunk, qvalid=qvalid)
                    if tr is not None:
                        _sync(cand.d0)
                topk, topk_d, cnt = self._refine_rerank(
                    chunk, cand, k=k, budget=budget, front_span=sp_front)
                ids_parts.append(topk[:n])
                dist_parts.append(topk_d[:n])
                _accumulate(counters, cnt)
            cost = self._fold(counters, cost)
            if tr is not None:
                _attach_ledger(sp_ex, cost)
        return _cat(ids_parts), _cat(dist_parts), cost

    def run_front(self, chunk: torch.Tensor, *,
                  qvalid: torch.Tensor | None = None):
        """The front stage alone for ONE micro-batch (no chunking): the
        ``Candidates`` handle to pass to ``run_finish``.  The serving
        engine issues it for batch N+1 before it retires batch N's
        ``run_finish``.  Traced, the span synchronizes the device before
        it closes and carries the front's modeled time and drift, from
        the front counters alone (``run_finish`` folds the rest)."""
        tr = trace.active()
        with trace.span("front", track="query", stage=self.front.name,
                        n=int(chunk.shape[0]), split=True) as sp:
            cand = self.front.candidates(chunk, qvalid=qvalid)
            if tr is not None:
                _sync(cand.d0)
        if tr is not None:
            cost = QueryCost()
            self.front.fold_cost(cost, _collect(dict(cand.counters)),
                                 self.index.layout)
            _attach_drift(sp, cost.tier_seconds(Tier.HBM), "front")
        return cand

    def run_finish(self, chunk: torch.Tensor, cand, *, k: int | None = None,
                   cost: QueryCost | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, QueryCost]:
        """Refine + rerank + ledger fold of a ``run_front`` result: with
        ``run_front``, exactly ``execute`` on that micro-batch (padded rows
        included: the caller slices them off)."""
        cfg = self.index.config
        k = k or cfg.final_k
        budget = search_budget(cfg, k, self.refine_budget)
        tr = trace.active()
        with trace.span("finish", track="query", backend=self.backend.name,
                        k=k, budget=budget) as sp_fin:
            topk, topk_d, counters = self._refine_rerank(chunk, cand, k=k,
                                                         budget=budget)
            cost = self._fold(counters, cost)
            if tr is not None:
                _attach_ledger(sp_fin, cost)
        return topk, topk_d, cost

    def search(self, queries: torch.Tensor, *, k: int | None = None,
               cost: QueryCost | None = None
               ) -> tuple[torch.Tensor, QueryCost]:
        """The legacy tuple: (Q, k) ids and the ledger (no distances)."""
        ids, _, cost = self.execute(queries, k=k, cost=cost)
        return ids, cost

    def recall_by_cut(self, queries: torch.Tensor, gt: torch.Tensor, *,
                      k: int | None = None) -> dict[str, float]:
        """Where ``execute`` loses true neighbours: the share of the first
        ``k`` ids of ``gt`` (Q, ≥k) still held after each cut, in order:
        ``candidates`` (the front's valid slots, which the baseline
        reranks whole, so its recall), ``survivors`` (alive after the last
        level's prune), ``fetched`` (the top-``budget`` survivors by
        estimate, which the rerank reads) and ``answer`` (the top-k).  The
        static layout only; a diagnostic, not on the query path."""
        cfg = self.index.config
        k = k or cfg.final_k
        budget = search_budget(cfg, k, self.refine_budget)
        held = dict.fromkeys(("candidates", "survivors", "fetched",
                              "answer"), 0)
        for chunk, want in zip(iter_chunks(queries, self.micro_batch),
                               iter_chunks(gt[:, :k], self.micro_batch)):
            cand = self.front.candidates(chunk)
            refined = self.backend.refine(chunk, cand, self.index.trq, k=k,
                                          bound=cfg.bound, z=cfg.z)
            topk, _, order, fetch_alive = stages_mod._rerank_fetch(
                self.index.x, chunk, cand.ids, refined.est, refined.alive,
                k=k, budget=budget)
            for name, ids, keep in (
                    ("candidates", cand.ids, cand.valid),
                    ("survivors", cand.ids, refined.alive),
                    ("fetched", torch.gather(cand.ids, 1, order),
                     fetch_alive),
                    ("answer", topk, torch.ones_like(topk, dtype=bool))):
                hit = (want[:, :, None] == ids[:, None, :]) & keep[:, None]
                held[name] += int(hit.any(-1).sum())
        return {name: n / (queries.shape[0] * k) for name, n in held.items()}

    def execute_baseline(self, queries: torch.Tensor, *,
                         k: int | None = None, pad: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor, QueryCost]:
        """Baseline (cuVS/FAISS style): front stage, then exact rerank of
        the FULL candidate list from SSD — no far-memory refinement.
        ``pad`` as in ``execute``."""
        k = k or self.index.config.final_k
        tr = trace.active()
        with trace.span("execute", track="query", front=self.front.name,
                        backend="baseline", k=k,
                        n_queries=int(queries.shape[0])) as sp_ex:
            ids_parts, dist_parts = [], []
            counters: Counters = {}
            for chunk in iter_chunks(queries, self.micro_batch):
                n = chunk.shape[0]
                chunk, qvalid = _padded(chunk, pad, self.micro_batch)
                with trace.span("front", track="query",
                                stage=self.front.name, n=n):
                    cand = self.front.candidates(chunk, qvalid=qvalid)
                    if tr is not None:
                        _sync(cand.d0)
                with trace.span("rerank", track="query", baseline=True):
                    topk, topk_d, n_valid = stages_mod._rerank_all(
                        self.index.x, chunk, cand.ids, cand.valid, k=k)
                    if tr is not None:
                        _sync(topk)
                ids_parts.append(topk[:n])
                dist_parts.append(topk_d[:n])
                _accumulate(counters, cand.counters)
                _accumulate(counters, {"ssd_fetch": n_valid})
            counts = _collect(counters)
            cost = QueryCost()
            lay = self.index.layout
            self.front.fold_cost(cost, counts, lay)
            cost.record("rerank", Tier.SSD, counts["ssd_fetch"],
                        lay.ssd_bytes)
            cost.add_compute(_COMPUTE_S_PER_CAND * counts["front_cand"])
            if tr is not None:
                _attach_ledger(sp_ex, cost)
        return _cat(ids_parts), _cat(dist_parts), cost

    def search_baseline(self, queries: torch.Tensor, *,
                        k: int | None = None
                        ) -> tuple[torch.Tensor, QueryCost]:
        """The legacy tuple over ``execute_baseline``."""
        ids, _, cost = self.execute_baseline(queries, k=k)
        return ids, cost

    def _fold(self, counters: Counters, cost: QueryCost | None) -> QueryCost:
        """One host transfer: device counters → Table-I ledger.  The tiered
        layout's per-list access histogram rides the same transfer into
        the index's heat tracker."""
        counts = _collect(counters)
        heat = counts.pop("list_heat", None)
        if heat is not None:
            self.index.observe_heat(heat)
        return fold_counts(counts, cost=cost, config=self.index.config,
                           layout=self.index.layout,
                           front_fold=self.front.fold_cost)


def _attach_drift(handle, model_s: float, stage: str) -> None:
    """Attach a stage's modeled seconds and its measured-wall / modeled
    drift to its span, and observe the drift into
    ``fatrq_model_drift_ratio{stage}`` of the active registry."""
    handle.set_attr("model_s", model_s)
    wall = handle.span.wall_s
    if wall is not None and model_s > 0:
        ratio = wall / model_s
        handle.set_attr("wall_model_drift", ratio)
        metrics.active().histogram(
            "fatrq_model_drift_ratio",
            "measured wall seconds / QueryCost-modeled seconds per stage",
            labelnames=("stage",), buckets=_DRIFT_BUCKETS) \
            .labels(stage=stage).observe(ratio)


def _attach_ledger(handle, cost: QueryCost) -> None:
    """Attach the folded Table-I ledger and modeled breakdown to a span
    (after the fold: a ``cost=`` threaded across calls shows its running
    total, as the caller receives it)."""
    handle.set_attrs(
        ledger={key: [t.accesses, t.bytes]
                for key, t in sorted(cost.ledger.items())},
        model_breakdown_s=cost.breakdown(),
        model_total_s=cost.total_seconds())


def fold_counts(counts: dict, *, cost: QueryCost | None, config, layout,
                front_fold) -> QueryCost:
    """Fold collected stage counters into a Table-I traffic ledger."""
    cost = cost or QueryCost()
    n_cand = counts["front_cand"]
    n_alive = counts["refine_alive"]
    # tiered layout: hot candidates are scored from HBM and never touch
    # far memory; cold candidates' residual stream bills at SSD rates.
    # Only the tiered front emits ``cold_cand`` (always, zero when all
    # warm), and no front marks both tiers and delta rows, so the marked
    # share of each level below is one or the other
    tiered = "cold_cand" in counts
    n_hot = counts.get("hot_cand", 0)
    n_cold = counts.get("cold_cand", 0)
    front_fold(cost, counts, layout)
    # front → refine handoff: 4 B coarse distance per candidate (§IV);
    # hot candidates stay on the device
    cost.record("handoff", Tier.CXL, n_cand - n_hot, 4)
    if n_hot:
        cost.record("hot", Tier.HBM, n_hot, layout.ssd_bytes)
    # level-0 codes stream for ALL candidates, level ℓ ≥ 1 only for the
    # survivors of ℓ−1; delta-page rows bill to their own entry, cold
    # rows to ``cold:ssd``
    n_delta = counts.get("delta_cand", 0)
    cost.record("refine", Tier.CXL, n_cand - n_delta - n_hot - n_cold,
                layout.far_bytes)
    if n_delta:
        cost.record("delta", Tier.CXL, n_delta, layout.far_bytes)
    if n_cold:
        cost.record("cold", Tier.SSD, n_cold, layout.far_bytes)
    for lv in range(1, config.trq_levels):
        n_lv = counts.get(f"refine_alive_l{lv}", n_alive)
        n_lv_mark = counts.get(f"refine_alive_l{lv}_delta", 0)
        cost.record("refine", Tier.CXL, n_lv - n_lv_mark, layout.far_bytes)
        if n_lv_mark:
            if tiered:
                cost.record("cold", Tier.SSD, n_lv_mark, layout.far_bytes)
            else:
                cost.record("delta", Tier.CXL, n_lv_mark, layout.far_bytes)
    # survivors (≤ budget per query) hit SSD
    cost.record("rerank", Tier.SSD, counts["ssd_fetch"], layout.ssd_bytes)
    cost.add_compute(_COMPUTE_S_PER_CAND * n_cand)
    return cost


def make_executor(index, *, front: str = "ivf", backend: str = "reference",
                  micro_batch: int | None = None,
                  refine_budget: int | None = None, layout: str = "static",
                  **front_opts) -> SearchExecutor:
    """Executor factory memoized on the index instance (its lifetime is the
    index's), per (generation, plan): after a ``TieredIndex`` migration the
    older generations' executors (their fronts hold superseded placement
    tensors) are dropped and a fresh one is built; a static index's
    generation is always 0."""
    gen = getattr(index, "generation", 0)
    key = (gen, front, backend, micro_batch, refine_budget, layout,
           tuple(sorted(front_opts.items())))
    cache = index.__dict__.setdefault("_executor_cache", {})
    ex = cache.get(key)
    if ex is None:
        ex = SearchExecutor.from_index(index, front=front, backend=backend,
                                       micro_batch=micro_batch,
                                       refine_budget=refine_budget,
                                       layout=layout, **front_opts)
        for stale in [kk for kk in cache if kk[0] != gen]:
            del cache[stale]
        cache[key] = ex
    return ex
