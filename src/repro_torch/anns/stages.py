"""Search stages of the executor (paper Fig. 5), over query micro-batches.

  front   : candidate generation + PQ-ADC coarse scoring (the ``pq_adc``
            kernel): ``IVFFrontStage`` (inverted lists, the paper's primary
            front) or ``GraphFrontStage`` (CAGRA-style beam search over PQ
            reconstructions, then the final beam ADC-scored).
  refine  : FaTRQ progressive estimation over every TRQ level.  Two
            backends with the same semantics: ``reference`` (plain PyTorch
            ``trq.progressive_search``) and ``cuda`` (the fused
            ``ternary_refine`` kernel).  On the sharded layout
            (``anns.sharding``) each backend's ``refine_sharded`` takes
            every level's interval per shard (``trq.level_bounds`` / the
            ``ternary_refine_fused_bounds`` kernel) and runs one alive
            chain over the stacked shards with pooled thresholds.
  rerank  : survivors fetch full-precision vectors ("SSD") for exact L2.
            On the tiered layout (``anns.tiered``) hot slots are scored
            exactly before the rerank (``_score_hot``), and their fetches
            are not SSD reads (``_rerank_survivors_tiered``).

Each stage returns device-side counters (0-d tensors) beside its tensors;
the executor folds them into a ``QueryCost`` ledger with one host
transfer per search.

Every top-k cut here that can tie uses a stable ascending sort, because
``jax.lax.top_k`` puts the lower index first on ties and the budget cut
depends on that order; ``torch.topk`` on CUDA promises no tie order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Protocol

import torch

from repro_torch.anns import registry
from repro_torch.core import trq as trq_mod
from repro_torch.core.estimator import alive_chain
from repro_torch.core.trq import TRQCodes
from repro_torch.device import row_sum
from repro_torch.index import graph as graph_mod
from repro_torch.index import ivf as ivf_mod
from repro_torch.index.ivf import rank_centroid_lists
from repro_torch.kernels.pq_adc import pq_adc
from repro_torch.kernels.ternary_refine import RefineStores, \
    ternary_refine_fused, ternary_refine_fused_bounds
from repro_torch.memory import QueryCost, RecordLayout, Tier
from repro_torch.quant import pq as pq_mod

Counters = dict[str, torch.Tensor]     # name → 0-d device counter

#: bytes of gathered full-precision rows per exact-L2 step
_RERANK_BYTES = 1 << 30


class Candidates(NamedTuple):
    """Front-stage output for a query micro-batch."""

    ids: torch.Tensor        # (Q, C) int32, clamped ≥ 0
    valid: torch.Tensor      # (Q, C) bool
    d0: torch.Tensor         # (Q, C) f32 coarse ADC distance, +inf if invalid
    counters: Counters
    is_delta: torch.Tensor | None = None   # (Q, C) bool delta-page rows
    # (Q, pl) on the sharded layout: each gathered list's probe rank in
    # the unsharded front (nprobe where no query chose it), so slot
    # (j, pos) is the unsharded slot list_rank[j]·cap + pos, the order the
    # unsharded cuts break exact ties by; the graph front's zeros (Q, 1)
    # say that a shard's slot c is the unsharded beam slot c
    list_rank: torch.Tensor | None = None
    # (Q, C) int8 ``memory.placement`` TIER_* codes on the tiered layout
    # (``anns.tiered``) where some list is not warm, else None; the
    # executor routes on them: hot slots are scored exactly and skip
    # refinement, cold slots' residual stream bills at SSD rates through
    # ``is_delta``
    tier: torch.Tensor | None = None


class Refined(NamedTuple):
    """Refine-stage output: calibrated estimates + survivor mask (with a
    leading shard axis S on the sharded layout, and (S,) counters)."""

    est: torch.Tensor        # (Q, C) f32
    alive: torch.Tensor      # (Q, C) bool (already ∧ valid)
    counters: Counters


class FrontStage(Protocol):
    """Candidate generation: a query micro-batch in, ``Candidates`` out.

    ``qvalid`` is the (Q,) bool per-query validity mask of a bucket-padded
    micro-batch (``executor.pad_chunk``): a padded row must have no valid
    slot and add nothing to any counter (nor to the tiered layout's heat),
    so a padded batch's answers and ledger are the unpadded ones bit for
    bit.  ``None`` means every row is a real query."""

    name: str

    def candidates(self, queries: torch.Tensor,
                   qvalid: torch.Tensor | None = None) -> Candidates: ...

    def fold_cost(self, cost: QueryCost, counts: dict[str, int],
                  layout: RecordLayout) -> None: ...


class RefineBackend(Protocol):
    """FaTRQ refinement over a candidate batch: ``refine`` on one index,
    ``bounds`` (every level's est and interval, no pruning) and
    ``refine_sharded`` (one alive chain over the stacked shards this
    process holds, with thresholds pooled across them and across the
    ``mesh``'s ranks; ``anns.sharding``)."""

    name: str

    def refine(self, queries: torch.Tensor, cand: Candidates, trq: TRQCodes,
               *, k: int, bound: str, z: float) -> Refined: ...

    def bounds(self, queries: torch.Tensor, cand: Candidates, trq: TRQCodes,
               *, bound: str, z: float): ...

    def refine_sharded(self, queries: torch.Tensor,
                       cands: list[Candidates], trqs, *, k: int, bound: str,
                       z: float, mesh=None) -> Refined: ...


def _smallest(v: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest per row, lower position first on ties."""
    return torch.sort(v, dim=-1, stable=True).indices[..., :k]


# ------------------------------------------------------------- front stage


def fold_ivf_front_cost(cost: QueryCost, counts: dict[str, int],
                        layout: RecordLayout) -> None:
    """IVF front traffic: PQ codes + LUT live in fast memory (HBM)."""
    cost.record("coarse", Tier.HBM, counts["front_cand"], layout.fast_bytes)


def adc_score(codebook: pq_mod.PQCodebook, pq_codes: torch.Tensor,
              ids: torch.Tensor, queries: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """PQ-ADC distances of candidates ``ids`` (Q, C), +inf outside
    ``valid``: the per-query LUTs, then the ``pq_adc`` kernel."""
    return pq_adc(pq_codes, ids, valid, pq_mod.adc_table(codebook, queries))


@dataclass
class IVFFrontStage:
    """Inverted-file probe + PQ-ADC scoring (the paper's primary front)."""

    ivf: ivf_mod.IVFIndex
    codebook: pq_mod.PQCodebook
    pq_codes: torch.Tensor
    nprobe: int = 8
    name: str = field(default="ivf", init=False)

    def candidates(self, queries: torch.Tensor,
                   qvalid: torch.Tensor | None = None) -> Candidates:
        _, top_lists = rank_centroid_lists(self.ivf.centroids, queries,
                                           nprobe=self.nprobe)
        ids = self.ivf.lists[top_lists].reshape(queries.shape[0], -1)
        valid = ids >= 0
        if qvalid is not None:                # padded rows: no candidates
            valid &= qvalid[:, None]
        safe = torch.clamp(ids, min=0).contiguous()
        d0 = adc_score(self.codebook, self.pq_codes, safe, queries, valid)
        return Candidates(ids=safe, valid=valid, d0=d0,
                          counters={"front_cand": valid.sum()})

    def fold_cost(self, cost: QueryCost, counts: dict[str, int],
                  layout: RecordLayout) -> None:
        fold_ivf_front_cost(cost, counts, layout)


def graph_hops(front, queries: torch.Tensor,
               qvalid: torch.Tensor | None) -> torch.Tensor:
    """``front_hops`` of a graph front: the traversal's work is the same
    for every real query (``iters · expand · degree``), none for a padded
    row."""
    per_q = front.iters * front.expand * front.graph.degree
    if qvalid is None:
        return torch.full((), queries.shape[0] * per_q,
                          device=queries.device)
    return qvalid.sum() * per_q


def fold_graph_front_cost(cost: QueryCost, counts: dict[str, int],
                          layout: RecordLayout) -> None:
    """Graph front traffic: the traversal decodes the PQ codes of the
    visited neighborhoods (``front_hops``), then the final beam is
    ADC-scored (``front_cand``), all in fast memory.  Shared with the
    per-shard fold of ``anns.sharding``."""
    cost.record("front", Tier.HBM, counts["front_hops"], layout.fast_bytes)
    cost.record("coarse", Tier.HBM, counts["front_cand"], layout.fast_bytes)


@dataclass
class GraphFrontStage:
    """CAGRA-style beam search scored on PQ reconstructions.

    Traversal distances use the fast-memory PQ decode ``x_score``, held on
    the device (no SSD touches); the final beam is ADC-scored with the
    ``pq_adc`` kernel and handed to refinement like an IVF candidate list.
    ``front_hops`` counts the adjacency PQ fetches of the traversal."""

    graph: graph_mod.GraphIndex
    codebook: pq_mod.PQCodebook
    pq_codes: torch.Tensor
    beam: int = 64
    iters: int = 32
    expand: int = 4
    name: str = field(default="graph", init=False)
    x_score: torch.Tensor = field(init=False)

    def __post_init__(self):
        self.x_score = pq_mod.decode(self.codebook, self.pq_codes)

    def candidates(self, queries: torch.Tensor,
                   qvalid: torch.Tensor | None = None) -> Candidates:
        ids = graph_mod.search(self.graph, self.x_score, queries,
                               iters=self.iters, beam=self.beam,
                               expand=self.expand)            # (Q, beam)
        valid = torch.ones(ids.shape, dtype=torch.bool, device=ids.device) \
            if qvalid is None else qvalid[:, None].expand(ids.shape) \
            .contiguous()
        d0 = adc_score(self.codebook, self.pq_codes, ids, queries, valid)
        return Candidates(ids=ids, valid=valid, d0=d0,
                          counters={"front_cand": valid.sum(),
                                    "front_hops": graph_hops(
                                        self, queries, qvalid)})

    def fold_cost(self, cost: QueryCost, counts: dict[str, int],
                  layout: RecordLayout) -> None:
        fold_graph_front_cost(cost, counts, layout)


# ---------------------------------------------------------- refine backends


def _level_counters(level_alive: tuple[torch.Tensor, ...],
                    is_delta: torch.Tensor | None = None, *,
                    dims: tuple[int, ...] | None = None) -> Counters:
    """``refine_alive``: final survivors; ``refine_alive_l{ℓ}``: candidates
    entering level ℓ ≥ 1 (survivors of ℓ−1), whose level-ℓ codes stream
    from far memory; ``_delta``: their delta-page share.  ``dims`` sums
    over those dimensions only (one counter per shard on the sharded
    layout) instead of over everything."""
    def total(m: torch.Tensor) -> torch.Tensor:
        return m.sum() if dims is None else m.sum(dims)

    counters: Counters = {"refine_alive": total(level_alive[-1])}
    for lv in range(1, len(level_alive)):
        counters[f"refine_alive_l{lv}"] = total(level_alive[lv - 1])
        if is_delta is not None:
            counters[f"refine_alive_l{lv}_delta"] = total(
                level_alive[lv - 1] & is_delta)
    return counters


def _stack_bounds(backend, queries: torch.Tensor, cands: list[Candidates],
                  trqs, *, bound: str, z: float):
    """Each shard's (est, lo, hi) from ``backend.bounds``, stacked on a
    leading shard axis: est (S, Q, C_s), lo/hi (S, Q, L, C_s)."""
    parts = [backend.bounds(queries, c, t, bound=bound, z=z)
             for c, t in zip(cands, trqs)]
    return tuple(torch.stack(p) for p in zip(*parts))


@dataclass
class ReferenceRefineBackend:
    """Plain PyTorch estimator path (``trq.progressive_search``)."""

    name: str = field(default="reference", init=False)

    def refine(self, queries: torch.Tensor, cand: Candidates, trq: TRQCodes,
               *, k: int, bound: str, z: float) -> Refined:
        state, level_alive = trq_mod.progressive_search(
            queries, cand.d0, trq, cand.ids.long(), k=k, bound=bound, z=z)
        level_alive = tuple(a & cand.valid for a in level_alive)
        return Refined(est=state.est, alive=level_alive[-1],
                       counters=_level_counters(level_alive, cand.is_delta))

    def bounds(self, queries: torch.Tensor, cand: Candidates, trq: TRQCodes,
               *, bound: str, z: float):
        return trq_mod.level_bounds(queries, cand.d0, trq, cand.ids.long(),
                                    bound=bound, z=z)

    def refine_sharded(self, queries: torch.Tensor,
                       cands: list[Candidates], trqs, *, k: int, bound: str,
                       z: float, mesh=None) -> Refined:
        """One alive chain over the stacked shards, as the JAX reference
        runs it: the chain starts from every slot, thresholds pooled
        across shards (and the ``mesh``'s ranks), and ``valid`` is ANDed
        afterwards."""
        est, lo, hi = _stack_bounds(self, queries, cands, trqs, bound=bound,
                                    z=z)
        valid = torch.stack([c.valid for c in cands])
        level_alive, _ = alive_chain(lo, hi, torch.ones_like(valid), k,
                                     shard_dim=0, mesh=mesh)
        level_alive = tuple(a & valid for a in level_alive)
        return Refined(est=est, alive=level_alive[-1],
                       counters=_level_counters(level_alive, dims=(1, 2)))


@dataclass
class CudaRefineBackend:
    """The fused refinement kernel (``kernels.ternary_refine``): every TRQ
    level, the certified bounds, the pruning chain and the per-level
    survivor counts; on the sharded layout the bounds kernel per shard.
    The per-index stores it gathers from are built on first use and kept
    for the TRQ codes they came from (one per shard when sharded)."""

    name: str = field(default="cuda", init=False)
    _stores: list[tuple[TRQCodes, RefineStores]] = field(
        default_factory=list, init=False, repr=False)

    def stores(self, trq: TRQCodes) -> RefineStores:
        for codes, stores in self._stores:
            if codes is trq:
                return stores
        stores = RefineStores.from_trq(trq)
        self._stores.append((trq, stores))
        return stores

    def bounds(self, queries: torch.Tensor, cand: Candidates, trq: TRQCodes,
               *, bound: str, z: float):
        return ternary_refine_fused_bounds(
            self.stores(trq), queries, cand.ids, cand.d0, cand.valid,
            trq.model, bound=bound, z=z)

    def refine_sharded(self, queries: torch.Tensor,
                       cands: list[Candidates], trqs, *, k: int, bound: str,
                       z: float, mesh=None) -> Refined:
        """One alive chain over the stacked shards, as the JAX kernel path
        runs it: the chain starts from ``valid`` (the bounds kernel writes
        +inf on invalid slots), thresholds pooled across shards (and the
        ``mesh``'s ranks).  The bounds kernel runs on the shards this
        process holds."""
        est, lo, hi = _stack_bounds(self, queries, cands, trqs, bound=bound,
                                    z=z)
        valid = torch.stack([c.valid for c in cands])
        level_alive, _ = alive_chain(lo, hi, valid, k, shard_dim=0,
                                     mesh=mesh)
        return Refined(est=est, alive=level_alive[-1],
                       counters=_level_counters(level_alive, dims=(1, 2)))

    def refine(self, queries: torch.Tensor, cand: Candidates, trq: TRQCodes,
               *, k: int, bound: str, z: float) -> Refined:
        est, alive, counts = ternary_refine_fused(
            self.stores(trq), queries, cand.ids, cand.d0, cand.valid,
            cand.is_delta, trq.model, k=k, bound=bound, z=z)
        nl = trq.num_levels
        counters: Counters = {"refine_alive": counts[:, nl - 1].sum()}
        for lv in range(1, nl):
            counters[f"refine_alive_l{lv}"] = counts[:, lv - 1].sum()
            if cand.is_delta is not None:
                counters[f"refine_alive_l{lv}_delta"] = \
                    counts[:, nl + lv - 1].sum()
        return Refined(est=est, alive=alive, counters=counters)


# ----------------------------------------------------------------- rerank


def _exact_sq(x: torch.Tensor, queries: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """||x[ids] − q||² (Q, C), gathered a few queries at a time so the
    (q, C, D) rows stay under ``_RERANK_BYTES``; each row's sum in an order
    of its own (``device.row_sum``), so a query gets the same bits alone
    and in a batch."""
    nq, c = ids.shape
    step = max(1, _RERANK_BYTES // max(1, c * x.shape[1] * 4))
    out = torch.empty((nq, c), dtype=x.dtype, device=x.device)
    for a in range(0, nq, step):
        rows = x[ids[a:a + step].long()]
        out[a:a + step] = row_sum((rows - queries[a:a + step, None, :]) ** 2)
    return out


def _rerank_fetch(x, queries, ids, est, alive, *, k: int, budget: int):
    """The top-``budget`` survivors by estimate fetch full vectors; exact
    L2; top-k.  Returns (ids, distances, the fetched slots (Q, budget) and
    which of them were alive)."""
    est_m = torch.where(alive, est, torch.full_like(est, float("inf")))
    order = _smallest(est_m, budget)
    fetch_ids = torch.gather(ids, 1, order)
    fetch_alive = torch.gather(alive, 1, order)
    d = _exact_sq(x, queries, fetch_ids)
    d = torch.where(fetch_alive, d, torch.full_like(d, float("inf")))
    best = _smallest(d, k)
    return (torch.gather(fetch_ids, 1, best), torch.gather(d, 1, best),
            order, fetch_alive)


def _rerank_survivors(x, queries, ids, est, alive, *, k: int, budget: int):
    """Exact rerank of the top-``budget`` survivors (``_rerank_fetch``).
    Returns (ids, distances, n_ssd)."""
    topk, topk_d, _, fetch_alive = _rerank_fetch(x, queries, ids, est, alive,
                                                 k=k, budget=budget)
    return topk, topk_d, fetch_alive.sum()


def _score_hot(x, queries, ids, hot):
    """Exact squared L2 of the hot slots (Q, C), +inf elsewhere: the
    tiered layout's direct scoring of rows that live in HBM.  Only the hot
    slots' rows are gathered (not every slot's), under ``_RERANK_BYTES`` a
    step, with ``_exact_sq``'s row formula.  Finding the hot slots
    synchronizes the host once."""
    out = torch.full(ids.shape, float("inf"), dtype=x.dtype,
                     device=x.device)
    slots = hot.reshape(-1).nonzero().squeeze(1)
    qi = torch.div(slots, ids.shape[1], rounding_mode="floor")
    rows = ids.reshape(-1)[slots].long()
    step = max(1, _RERANK_BYTES // (x.shape[1] * 4))
    flat = out.view(-1)
    for a in range(0, slots.numel(), step):
        d = x[rows[a:a + step]]                     # a fresh gather
        flat[slots[a:a + step]] = row_sum(
            d.sub_(queries[qi[a:a + step]]).square_())
    return out


def _rerank_survivors_tiered(x, queries, ids, est, alive, hot, *, k: int,
                             budget: int):
    """``_rerank_survivors`` for the tiered layout: the same ids and
    distances, but the fetches of hot rows (already in HBM) do not count
    as SSD reads.  Returns (ids, distances, n_ssd, n_hot_fetch)."""
    topk, topk_d, order, fetch_alive = _rerank_fetch(
        x, queries, ids, est, alive, k=k, budget=budget)
    fetch_hot = torch.gather(hot, 1, order) & fetch_alive
    return (topk, topk_d, (fetch_alive & ~fetch_hot).sum(),
            fetch_hot.sum())


def _rerank_all(x, queries, ids, valid, *, k: int):
    """Baseline rerank: exact L2 over the whole candidate list."""
    d = _exact_sq(x, queries, ids)
    d = torch.where(valid, d, torch.full_like(d, float("inf")))
    best = _smallest(d, k)
    return torch.gather(ids, 1, best), torch.gather(d, 1, best), valid.sum()


# ----------------------------------------------------------------- registry


def keep_graph(index, graph: graph_mod.GraphIndex) -> None:
    """Keep ``graph`` on the index as its graph of that degree (how
    ``interop.index_from_numpy`` hands over a JAX-built graph)."""
    index.__dict__.setdefault("_graph_cache", {})[graph.degree] = graph


def graph_for(index, *, degree: int = 16) -> graph_mod.GraphIndex:
    """The kNN graph of an index's database, built once per degree (start
    nodes from a seed-0 generator on the index's device) and kept on the
    index, so its lifetime is the index's."""
    g = index.__dict__.get("_graph_cache", {}).get(degree)
    if g is None:
        g = graph_mod.build(
            index.x, degree=degree,
            generator=torch.Generator(device=index.device).manual_seed(0))
        keep_graph(index, g)
    return g


def make_ivf_front(index, **opts) -> IVFFrontStage:
    nprobe = opts.pop("nprobe", index.config.nprobe)
    if opts:
        raise TypeError(f"unknown IVF front options: {sorted(opts)}")
    return IVFFrontStage(ivf=index.ivf, codebook=index.codebook,
                         pq_codes=index.pq_codes, nprobe=nprobe)


def make_graph_front(index, *, graph_index: graph_mod.GraphIndex | None = None,
                     degree: int = 16, **opts) -> GraphFrontStage:
    g = graph_index if graph_index is not None \
        else graph_for(index, degree=degree)
    return GraphFrontStage(graph=g, codebook=index.codebook,
                           pq_codes=index.pq_codes, **opts)


# the streaming and tiered layouts' factories are attached by
# ``anns.streaming`` and ``anns.tiered``
registry.register_front("ivf", layouts=registry.LAYOUTS,
                        make={"static": make_ivf_front})
registry.register_front("graph", layouts=registry.LAYOUTS,
                        make={"static": make_graph_front})
registry.register_backend("reference", make=ReferenceRefineBackend)
registry.register_backend("cuda", make=CudaRefineBackend)
