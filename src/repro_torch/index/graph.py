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

Online maintenance for the streaming layout: ``insert_nodes`` wires new
rows into the adjacency and ``compact_graph`` drops dead rows.  Both edit
the adjacency in numpy with the JAX package's float32 distances, on
host copies of only the rows their edits read (``HostRows``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data.synthetic import brute_force_topk
from repro_torch.device import chunks

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


def search_batch(index: GraphIndex, x: torch.Tensor, qs: torch.Tensor, *,
                 iters: int = 24, beam: int = 64) -> torch.Tensor:
    """``search`` of every query (the reference's per-query ``vmap``):
    each beam (Q, beam), nearest first."""
    return search(index, x, qs, iters=iters, beam=beam)


# ----------------------------------------------------- online maintenance

#: queries per beam search of ``insert_nodes`` (bounds the per-hop
#: (queries, expand·degree, D) row gather)
_INSERT_QUERIES = 1024
#: source rows per distance step of graph maintenance (bounds the
#: (rows, degree, D) float32 row gather on the host: 200 MB at D = 768)
_DIST_ROWS = 4096


class HostRows:
    """Float32 host copies of the rows ``rows`` of ``x`` (on any device),
    looked up by row id: the one device → host copy of graph
    maintenance."""

    def __init__(self, x: torch.Tensor, rows: np.ndarray):
        rows = np.unique(rows)
        self.loc = np.full(x.shape[0], -1, np.int64)
        self.loc[rows] = np.arange(rows.size)
        self.data = x[torch.from_numpy(rows).to(x.device)].float().cpu() \
            .numpy()

    def sq_dist(self, ids: np.ndarray, src: np.ndarray) -> np.ndarray:
        """``np.sum((x[ids] - x[src][:, None]) ** 2, axis=-1)`` for row
        ids (P, K) and src (P,), to the bit: the difference and its square
        (exactly rounded either way) in threaded torch, numpy's own
        pairwise sum over the last axis."""
        data = torch.from_numpy(self.data)
        rows = torch.index_select(
            data, 0, torch.from_numpy(self.loc[ids].ravel()))
        diff = rows.view(*ids.shape, -1).sub_(
            torch.index_select(data, 0, torch.from_numpy(self.loc[src]))
            [:, None])
        return np.sum(diff.square_().numpy(), axis=-1)


def insert_nodes(neighbors: np.ndarray, x: torch.Tensor, n_old: int,
                 start: torch.Tensor, *, iters: int = 32, beam: int = 64,
                 expand: int = 4) -> np.ndarray:
    """Wire rows ``n_old:`` of ``x`` into the adjacency ``neighbors``
    (n_old, degree) of rows ``:n_old`` (FreshDiskANN's RobustInsert on the
    fixed-degree layout); returns the grown (n, degree) int32 adjacency.

    Each new row beam-searches the pre-batch graph from ``start`` over the
    full vectors ``x[:n_old]`` (on ``x``'s device) and takes its ``degree``
    nearest beam entries as forward edges.  A reverse edge replaces the
    target's farthest edge when the new row is closer, and the nearest
    target always takes one, so every new row is reachable at once.  Rows
    are wired one after another in row order (row t + 1 sees row t's
    evictions), with the JAX package's numpy float32 distances."""
    nb = np.asarray(neighbors)
    n, degree = x.shape[0], nb.shape[1]
    b = n - n_old
    if b <= 0:
        return nb.astype(np.int32)
    if nb.shape[0] != n_old:
        raise ValueError(f"adjacency covers {nb.shape[0]} rows but "
                         f"n_old={n_old}")
    g = GraphIndex(neighbors=torch.from_numpy(nb).to(x.device),
                   start=start.to(x.device))
    beams = np.concatenate([
        search(g, x[:n_old], x[n_old + a:n_old + e], iters=iters, beam=beam,
               expand=expand).cpu().numpy()
        for a, e in chunks(b, _INSERT_QUERIES)])
    fwd_all = beams[:, :degree].astype(np.int32)
    targets = np.unique(fwd_all)
    new_rows = np.arange(n_old, n)
    xs = HostRows(x, np.concatenate([new_rows, targets,
                                      nb[targets].ravel()]))
    # every distance the loop reads, computed once: the new rows' to their
    # targets, and each target's to its edges, kept up to date on every
    # eviction with the new edge's distance (the same bits either way
    # round: a − b and b − a round to negatives)
    d_new = _sq_dists(xs, fwd_all, new_rows)
    cur_d = _sq_dists(xs, nb[targets], targets)
    slot = np.full(n_old, -1, np.int64)
    slot[targets] = np.arange(targets.size)

    out = np.concatenate([nb, np.zeros((b, degree), np.int32)])
    for t in range(b):
        row = n_old + t
        fwd = fwd_all[t]
        out[row] = fwd
        for j, tgt in enumerate(fwd.tolist()):
            if row in out[tgt]:
                continue
            cd = cur_d[slot[tgt]]
            worst = int(np.argmax(cd))
            if j == 0 or d_new[t, j] < cd[worst]:
                out[tgt, worst] = row
                cd[worst] = d_new[t, j]
    return out.astype(np.int32)


def _sq_dists(xs: HostRows, ids: np.ndarray, src: np.ndarray) -> np.ndarray:
    """``xs.sq_dist`` a step of ``_DIST_ROWS`` sources at a time."""
    out = np.empty(ids.shape, np.float32)
    for a, e in chunks(src.size, _DIST_ROWS):
        out[a:e] = xs.sq_dist(ids[a:e], src[a:e])
    return out


def compact_graph(neighbors: np.ndarray, x: torch.Tensor,
                  live_rows: np.ndarray) -> np.ndarray:
    """Drop dead rows and patch the edges into them; returns the
    (n_live, degree) int32 adjacency over the live rows renumbered in
    ascending order (``live_rows``, old row ids).

    A live edge is remapped.  An edge into a dead row takes that row's
    nearest live neighbor (by float32 distance to the edge's source, in
    numpy, lower position first on ties) that the source does not already
    link to and is not the source itself; failing that, the source's first
    live edge, or ``(r + 1) % n_live`` where it has none.

    The JAX package loops row by row.  Within a row the links already
    held are exactly the row's non-negative entries, and rows do not
    interact, so here every row's c-th dead edge is patched at once,
    column after column: the same picks in the same order."""
    nb = np.asarray(neighbors)
    live_rows = np.asarray(live_rows)
    n_live = live_rows.size
    if n_live == 0:
        raise ValueError("cannot compact a graph to zero live rows")
    degree = nb.shape[1]
    new_of = np.full(nb.shape[0], -1, np.int32)
    new_of[live_rows] = np.arange(n_live, dtype=np.int32)
    out = new_of[nb[live_rows]]                    # -1 marks dead targets
    pr, pc = np.nonzero(out < 0)                   # every dead edge
    if pr.size == 0:
        return out.astype(np.int32)
    src_old = live_rows[pr]
    cand = new_of[nb[nb[src_old, pc]]]             # (P, degree) new ids
    ok = (cand >= 0) & (cand != pr[:, None])
    # (a masked-out candidate reads its source's row: a distance of 0,
    # sorted after every live candidate)
    cand_old = np.where(ok, live_rows[np.maximum(cand, 0)], src_old[:, None])
    xs = HostRows(x, np.concatenate([src_old, cand_old[ok]]))
    dist = _sq_dists(xs, cand_old, src_old)
    # each edge's candidates: the live ones first, by distance, stable
    order = np.lexsort((dist, ~ok), axis=-1)
    cand = np.take_along_axis(cand, order, axis=-1)
    ok = np.take_along_axis(ok, order, axis=-1)
    for c in range(degree):
        sel = pc == c
        rows = pr[sel]
        cur = out[rows]
        good = ok[sel] & ~(cand[sel][:, :, None] == cur[:, None, :]).any(-1)
        live = cur >= 0
        first = cur[np.arange(rows.size), np.argmax(live, axis=1)]
        fallback = np.where(live.any(axis=1), first, (rows + 1) % n_live)
        pick = cand[sel][np.arange(rows.size), np.argmax(good, axis=1)]
        out[rows, c] = np.where(good.any(axis=1), pick, fallback)
    return out.astype(np.int32)
