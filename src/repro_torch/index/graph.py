"""CAGRA-style fixed-degree graph index (the port of ``repro.index.graph``).

Build: the exact kNN graph (blocked brute force on the device), then the
JAX package's reverse-edge scatter, forward-edge padding and two random
shortcuts per node, in numpy exactly as it runs them, so the same vectors
give the same adjacency.  Search: greedy best-first beam search with a
fixed iteration count, batched over queries, every iteration expanding the
``expand`` best unexpanded beam entries.

The beam step is split into ``pick_frontier`` and ``beam_merge`` so the
sharded traversal (``anns.sharding``) can put its frontier exchange between
them and stay bit-identical to ``search``.  Every cut that can tie is a
stable ascending sort: ``jax.lax.top_k`` puts the lower index first on
ties and ``jnp.argsort`` is stable, while ``torch.topk`` on CUDA promises
no tie order.

The JAX search draws its start nodes from ``PRNGKey(seed)`` inside
``search``; here they are an input, drawn once at build time from a
``torch.Generator`` and kept on the graph (``GraphIndex.start``), which a
parity test replaces with the JAX draw.

The streaming layout's ``insert_nodes`` and ``compact_graph`` are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data.synthetic import brute_force_topk

#: rows per kNN step of the build (bounds the (rows, N) f32 distance block:
#: 4 GB at N = 1M)
_KNN_ROWS = 1024


@dataclass(frozen=True, eq=False)
class GraphIndex:
    neighbors: torch.Tensor   # (N, degree) int32
    start: torch.Tensor       # (beam,) int32 start nodes of every search

    @property
    def degree(self) -> int:
        return self.neighbors.shape[1]


def build(x: torch.Tensor, degree: int = 16, *,
          generator: torch.Generator, beam: int = 64) -> GraphIndex:
    """kNN graph + reverse-edge augmentation on ``x``'s device, with
    ``beam`` start nodes drawn from ``generator`` (CAGRA's rank-based
    reordering keeps forward kNN edges; reverse edges restore the
    reachability of hub-adjacent points that plain kNN graphs lose)."""
    n = x.shape[0]
    fwd = int(degree * 3 / 4)
    knn = brute_force_topk(x, x, degree + 1, block=_KNN_ROWS).cpu().numpy()
    ids = np.arange(n)[:, None]
    mask = knn != ids
    order = np.argsort(~mask, axis=1, kind="stable")
    pruned = np.take_along_axis(knn, order, axis=1)[:, :degree]

    neighbors = np.full((n, degree), -1, np.int32)
    neighbors[:, :fwd] = pruned[:, :fwd]
    # reverse edges: j joins i's reverse list if i ∈ knn(j), in (j, rank)
    # order, at most degree − fwd per target; a stable argsort over the
    # flattened edge list groups the edges by target in that order
    targets = pruned[:, :fwd].reshape(-1)
    sources = np.repeat(np.arange(n), fwd).astype(np.int32)
    by_tgt = np.argsort(targets, kind="stable")
    t_sorted, s_sorted = targets[by_tgt], sources[by_tgt]
    first = np.r_[True, t_sorted[1:] != t_sorted[:-1]]
    grp_start = np.maximum.accumulate(
        np.where(first, np.arange(t_sorted.size), 0))
    rank = np.arange(t_sorted.size) - grp_start
    take = rank < degree - fwd
    neighbors[t_sorted[take], fwd + rank[take]] = s_sorted[take]
    fill = fwd + np.minimum(np.bincount(targets, minlength=n), degree - fwd)
    # pad any remaining -1 with forward edges
    cols = np.arange(degree)[None, :]
    src = np.clip(fwd + cols - fill[:, None], 0, degree - 1)
    pad = np.take_along_axis(pruned, src, axis=1)
    neighbors = np.where(cols >= fill[:, None], pad, neighbors)
    # long-range shortcuts: two random edges per node make the per-cluster
    # kNN components an expander, so a beam can leave a wrong cluster
    rng = np.random.default_rng(7)
    neighbors[:, degree - 2:] = rng.integers(0, n, size=(n, 2))
    return GraphIndex(
        neighbors=torch.from_numpy(neighbors.astype(np.int32)).to(x.device),
        start=draw_start(n, generator, beam=beam).to(x.device))


def draw_start(n: int, generator: torch.Generator, *,
               beam: int = 64) -> torch.Tensor:
    """``beam`` start nodes in [0, n) drawn from ``generator`` (on its
    device), where the JAX search draws ``randint(PRNGKey(seed), (beam,),
    0, n)``."""
    return torch.randint(0, n, (beam,), generator=generator,
                         device=generator.device, dtype=torch.int32)


# ------------------------------------------------------- beam-step helpers


def sq_dist(rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Squared L2 of gathered rows (Q, C, D) to their queries (Q, D).  The
    sharded traversal calls it on the same (Q, C, D) shapes as ``search``:
    a CUDA reduction may round otherwise for another leading shape."""
    return ((rows - queries[:, None, :]) ** 2).sum(-1)


def pick_frontier(ds: torch.Tensor, expanded: torch.Tensor, *, expand: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``expand`` best unexpanded slots of each beam (Q, beam), lower
    slot first on ties: (picked slots (Q, expand), updated expanded)."""
    cand = torch.where(expanded, float("inf"), ds)
    picks = torch.sort(cand, dim=1, stable=True).indices[:, :expand]
    return picks, expanded.scatter(1, picks, True)


def beam_merge(ids: torch.Tensor, ds: torch.Tensor, expanded: torch.Tensor,
               new_ids: torch.Tensor, new_d: torch.Tensor, *, beam: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge expansion results into each beam: concatenate [beam, new],
    give every repeat of an id +inf so its first occurrence (the beam copy,
    with its ``expanded`` flag) survives, keep the ``beam`` smallest.

    The bit-level beam-update contract of ``repro.index.graph.beam_merge``:
    the sharded frontier exchange calls it on the summed neighbor lists,
    so its dedup order and tie-breaking match ``search`` exactly."""
    all_ids = torch.cat([ids, new_ids], dim=1)
    all_d = torch.cat([ds, new_d], dim=1)
    all_exp = torch.cat(
        [expanded, torch.zeros_like(new_ids, dtype=torch.bool)], dim=1)
    sorted_ids, sort_ids = torch.sort(all_ids, dim=1, stable=True)
    dup = torch.zeros_like(all_exp)
    dup[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    dup_in_orig = torch.zeros_like(dup).scatter_(1, sort_ids, dup)
    all_d = torch.where(dup_in_orig, float("inf"), all_d)
    keep = torch.sort(all_d, dim=1, stable=True).indices[:, :beam]
    return (torch.gather(all_ids, 1, keep), torch.gather(all_d, 1, keep),
            torch.gather(all_exp, 1, keep))


def search(index: GraphIndex, x: torch.Tensor, queries: torch.Tensor, *,
           iters: int = 24, beam: int = 64, expand: int = 4) -> torch.Tensor:
    """Greedy beam search of queries (Q, D) over rows ``x`` (N, D) from the
    graph's start nodes; returns each final beam (Q, beam) int32, nearest
    first.  Repeated ids keep +inf and stay in the beam, as in JAX."""
    if index.start.shape[0] != beam:
        raise ValueError(f"the graph holds {index.start.shape[0]} start "
                         f"nodes but the search asks for a beam of {beam}")
    nq = queries.shape[0]
    ids = index.start.expand(nq, beam)
    ds = sq_dist(x[ids.long()], queries)
    expanded = torch.zeros((nq, beam), dtype=torch.bool,
                           device=queries.device)
    for _ in range(iters):
        picks, expanded = pick_frontier(ds, expanded, expand=expand)
        neigh = index.neighbors[torch.gather(ids, 1, picks).long()] \
            .reshape(nq, -1).clamp(min=0)                 # (Q, E·degree)
        ids, ds, expanded = beam_merge(ids, ds, expanded, neigh,
                                       sq_dist(x[neigh.long()], queries),
                                       beam=beam)
    order = torch.sort(ds, dim=1, stable=True).indices
    return torch.gather(ids, 1, order).contiguous()
