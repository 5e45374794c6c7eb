"""Streaming layout: online inserts and deletes over a FaTRQ index (the
port of ``repro.anns.streaming``).

* **Row store.** Every per-record tensor (PQ codes, TRQ levels and
  scalars, full vectors) lives on the device in a capacity-padded tensor
  that the index owns.  An insert encodes only the new rows against the
  frozen quantizers (``trq.encode_rows``) and writes them in place past the
  last row (``trq.write_rows``); no earlier row changes, so a front or
  snapshot of an earlier generation sees the rows it saw.  A full store
  doubles.
* **Delta pages.** Per-list pages of the row ids inserted since the last
  compaction, -1 padded, growing by whole pages of ``delta_page`` slots.
  The IVF front probes the base lists and then the delta pages of the
  same ``nprobe`` lists; delta candidates count apart (``delta_cand``)
  and their far-memory traffic bills its own ``delta:cxl`` ledger entry
  (``executor.fold_counts``).
* **Tombstones.** ``delete`` clears a row's alive flag, and the fronts
  mask dead rows out of the candidates.  Returned ids are global ids
  (``row_gid``), stable for the index's lifetime.
* **Graph front.** The adjacency is built on the first graph search (or
  taken from the wrapped index's cached graph before any mutation) and
  then maintained: ``insert`` wires new rows in (``graph.insert_nodes``),
  the traversal routes through dead rows and the front masks them out of
  the final beam, and ``compact`` drops them (``graph.compact_graph``).
  Rows appended since the last compaction are delta candidates.  The
  traversal's start nodes come from one function of the row count,
  ``start``, at every site (the front, ``insert_nodes``, and a static
  search over the same adjacency).
* **Compaction and rebalancing.** ``compact`` reassigns the live rows to
  fresh base lists, drops tombstones and repacks the row store with one
  gather; ``rebalance(shards)`` then re-partitions the lists across shards
  with the sharded layout's ``lpt_assign``.

``rebuild_static`` assigns every live row from scratch against the frozen
quantizers and returns a plain ``FaTRQIndex`` and its row → global id map.
A streaming search returns that snapshot's top-k: the same probed lists,
the same candidate set in another slot order, every pruning threshold a
k-th smallest of the same values, the same survivors.  Only an exact
float32 tie of two rows' estimates at the SSD budget (or of their exact
distances at the k-th place) could break that, since the two break ties
by slot order, which differs.
``shards=S`` searches the snapshot through the sharded layout.

Host bookkeeping (lists, pages, alive flags, id maps) is numpy, as in the
JAX package, and copied to the device once per generation; a query never
leaves the device.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.anns import registry
from repro_torch.anns.executor import SearchExecutor
from repro_torch.anns.pipeline import FaTRQIndex, PipelineConfig
from repro_torch.anns.sharding import lpt_assign, make_sharded_executor
from repro_torch.anns.stages import (Candidates, adc_score,
                                     fold_graph_front_cost,
                                     fold_ivf_front_cost, graph_hops,
                                     rank_centroid_lists)
from repro_torch.core import trq as trq_mod
from repro_torch.device import chunks
from repro_torch.index import graph as graph_mod
from repro_torch.index import ivf as ivf_mod
from repro_torch.memory import QueryCost
from repro_torch.obs import metrics as obs_metrics, trace
from repro_torch.quant import pq as pq_mod
from repro_torch.quant.kmeans import assign

#: rows per step of a row-store gather or an assignment (bounds the
#: (rows, D) float32 temporary: 805 MB at D = 768)
_ROWS = 1 << 18


@dataclass(frozen=True)
class StreamingConfig:
    """Knobs of the mutable layer (the search knobs stay in
    ``PipelineConfig``)."""

    delta_page: int = 64           # slots per per-list delta spill page
    row_headroom: float = 0.25     # spare row capacity after grow/compact
    max_tombstone_frac: float = 0.3    # drift trigger: dead / (live+dead)
    max_delta_frac: float = 0.5        # drift trigger: delta rows / live
    auto_compact: bool = True      # fold automatically when drift trips


def _pad_rows(t: torch.Tensor, cap: int) -> torch.Tensor:
    """A new zero-padded tensor of ``cap`` leading rows holding ``t``
    (never ``t`` itself: the row store is written in place)."""
    out = t.new_zeros((max(cap, t.shape[0]),) + tuple(t.shape[1:]))
    out[:t.shape[0]] = t
    return out


def _take_rows(t: torch.Tensor, perm: torch.Tensor, cap: int) -> torch.Tensor:
    """Rows ``perm`` of ``t`` in a new zero-padded tensor of ``cap`` rows,
    gathered a step at a time."""
    out = t.new_zeros((max(cap, perm.numel()),) + tuple(t.shape[1:]))
    for a, b in chunks(perm.numel(), _ROWS):
        out[a:b] = t[perm[a:b]]
    return out


@dataclass
class StreamingFrontStage:
    """IVF front over one generation: the base lists and then the delta
    pages of each query's ``nprobe`` nearest lists, dead rows masked out.
    Its ids are row ids (the caller maps them through ``row_gid``)."""

    centroids: torch.Tensor
    codebook: pq_mod.PQCodebook
    pq_codes: torch.Tensor       # (cap_rows, M)
    base_lists: torch.Tensor     # (nlist, cap) int32, -1 padded
    delta_lists: torch.Tensor    # (nlist, dcap) int32, -1 padded
    alive: torch.Tensor          # (cap_rows,) bool
    nprobe: int = 8
    name: str = field(default="streaming", init=False)

    def candidates(self, queries: torch.Tensor,
                   qvalid: torch.Tensor | None = None) -> Candidates:
        _, top = rank_centroid_lists(self.centroids, queries,
                                     nprobe=self.nprobe)
        nq = queries.shape[0]
        ids_b = self.base_lists[top].reshape(nq, -1)
        ids = torch.cat([ids_b, self.delta_lists[top].reshape(nq, -1)], 1)
        safe = ids.clamp(min=0)
        valid = (ids >= 0) & self.alive[safe.long()]
        if qvalid is not None:                # padded rows: no candidates
            valid &= qvalid[:, None]
        d0 = adc_score(self.codebook, self.pq_codes, safe, queries, valid)
        is_delta = (torch.arange(ids.shape[1], device=ids.device)
                    >= ids_b.shape[1]).expand(nq, -1).contiguous()
        return Candidates(ids=safe, valid=valid, d0=d0,
                          counters={"front_cand": valid.sum(),
                                    "delta_cand": (valid & is_delta).sum()},
                          is_delta=is_delta)

    def fold_cost(self, cost: QueryCost, counts: dict[str, int],
                  layout) -> None:
        fold_ivf_front_cost(cost, counts, layout)


@dataclass
class GraphStreamingFrontStage:
    """Graph front over one generation: the beam search of the maintained
    adjacency (which routes through dead rows), dead rows masked out of
    the final beam, rows at or past ``n_base`` counted as delta rows.
    With no dead and no delta row it is ``stages.GraphFrontStage`` over
    the same adjacency and start nodes.  ``x_score``, the PQ decode the
    traversal scores, is decoded here unless given (the streaming index
    shares one per generation)."""

    graph: graph_mod.GraphIndex
    codebook: pq_mod.PQCodebook
    pq_codes: torch.Tensor       # (n_rows, M)
    alive: torch.Tensor          # (n_rows,) bool
    n_base: int                  # rows ≥ n_base were inserted since compact
    beam: int = 64
    iters: int = 32
    expand: int = 4
    name: str = field(default="graph", init=False)
    x_score: torch.Tensor | None = None

    def __post_init__(self):
        if self.x_score is None:
            self.x_score = pq_mod.decode(self.codebook, self.pq_codes)

    def candidates(self, queries: torch.Tensor,
                   qvalid: torch.Tensor | None = None) -> Candidates:
        ids = graph_mod.search(self.graph, self.x_score, queries,
                               iters=self.iters, beam=self.beam,
                               expand=self.expand)            # (Q, beam)
        valid = self.alive[ids.long()]
        if qvalid is not None:                # padded rows: no candidates
            valid &= qvalid[:, None]
        d0 = adc_score(self.codebook, self.pq_codes, ids, queries, valid)
        is_delta = ids >= self.n_base
        return Candidates(ids=ids, valid=valid, d0=d0,
                          counters={"front_cand": valid.sum(),
                                    "front_hops": graph_hops(
                                        self, queries, qvalid),
                                    "delta_cand": (valid & is_delta).sum()},
                          is_delta=is_delta)

    def fold_cost(self, cost: QueryCost, counts: dict[str, int],
                  layout) -> None:
        fold_graph_front_cost(cost, counts, layout)


class StreamingIndex:
    """Mutable FaTRQ index: online inserts and deletes, drift-triggered
    compaction, searched through the static layout's executor and refine
    backends.  It has what the executor reads of a ``FaTRQIndex``
    (``config``, ``layout``, ``trq``, ``x``, ``device``,
    ``default_backend``).

    ``start(n)`` gives the graph traversal's (beam,) int32 start nodes over
    ``n`` rows; by default ``graph.draw_start`` from a seed-0 generator on
    the index's device, as ``stages.graph_for`` draws them.
    """

    def __init__(self, index: FaTRQIndex,
                 streaming: StreamingConfig | None = None, *,
                 start: Callable[[int], torch.Tensor] | None = None):
        scfg = streaming or StreamingConfig()
        n = int(index.x.shape[0])
        cap_rows = int(n * (1.0 + scfg.row_headroom)) + 1
        dev = index.device

        self.config: PipelineConfig = index.config
        self.scfg = scfg
        self.layout = index.layout
        self.codebook = index.codebook
        self.centroids = index.ivf.centroids
        self.nlist = index.ivf.nlist
        self.start = start or (lambda m: graph_mod.draw_start(
            m, torch.Generator(device=dev).manual_seed(0)))

        # device row store, capacity-padded, owned by this index
        self.pq_codes = _pad_rows(index.pq_codes, cap_rows)
        self.trq = trq_mod.map_rows(index.trq,
                                    lambda t: _pad_rows(t, cap_rows))
        self.x = _pad_rows(index.x, cap_rows)

        # host index structures
        self.base_lists = index.ivf.lists.cpu().numpy().copy()
        self.base_len = index.ivf.list_len.cpu().numpy().copy()
        self.delta_lists = np.full((self.nlist, scfg.delta_page), -1,
                                   np.int32)
        self.delta_len = np.zeros((self.nlist,), np.int32)
        self.row_gid = np.full((cap_rows,), -1, np.int64)
        self.row_gid[:n] = np.arange(n)
        self.alive = np.zeros((cap_rows,), bool)
        self.alive[:n] = True
        self._gid_row = np.arange(n, dtype=np.int64)   # gid → row, -1 dead

        self.n_rows = n                 # row-store high-water mark
        self.next_gid = n
        self.n_tombstones = 0
        self._n_live = n
        self.generation = 0             # bumped on every mutation
        self._n_base = n                # rows ≥ _n_base are delta (graph)
        self._graph: np.ndarray | None = None   # maintained adjacency
        self._graph_degree = 16
        # the wrapped index's kNN graphs (``stages.graph_for``): its rows
        # are this index's until the first mutation
        self._index_graphs = index.__dict__.setdefault("_graph_cache", {})
        self._assignment: np.ndarray | None = None   # list → shard
        self._n_shards: int | None = None
        self._dev_cache: dict | None = None
        self._snap_cache: tuple | None = None
        self._ex_cache: dict = {}
        self._gen_hooks: list = []

    # ------------------------------------------------------------ stats

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def default_backend(self) -> str:
        if self.config.backend is not None:
            return self.config.backend
        return "cuda" if self.device.type == "cuda" else "reference"

    @property
    def cap_rows(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_live(self) -> int:
        return self._n_live

    @property
    def n_delta_rows(self) -> int:
        return int(self.delta_len.sum())

    def __len__(self) -> int:
        return self.n_live

    def live_gids(self) -> np.ndarray:
        """The live global ids, ascending."""
        return np.nonzero(self._gid_row >= 0)[0]

    def stats(self) -> dict:
        return {"n_live": self.n_live, "n_rows": self.n_rows,
                "cap_rows": self.cap_rows, "n_delta_rows": self.n_delta_rows,
                "n_tombstones": self.n_tombstones,
                "generation": self.generation, **self.drift()}

    def drift(self) -> dict:
        """The compaction triggers' metrics (``needs_compaction``).

        ``shard_imbalance`` is the current assignment's heaviest shard load
        over the heaviest load a fresh ``lpt_assign`` of the current list
        lengths gives: the factor ``rebalance`` could shrink it by.
        """
        live, tomb = self.n_live, self.n_tombstones
        d = {"tombstone_frac": tomb / max(live + tomb, 1),
             "delta_frac": self.n_delta_rows / max(live, 1)}
        if self._assignment is not None:
            s = self._n_shards
            lens_eff = (self.base_len + self.delta_len).astype(np.int64)
            loads = np.bincount(self._assignment, weights=lens_eff,
                                minlength=s)
            _, fresh = lpt_assign(lens_eff, s)
            d["shard_imbalance"] = float(loads.max()) / max(
                float(fresh.max()), 1.0)
            d["lpt_bound"] = 4.0 / 3.0 - 1.0 / (3.0 * s)
        return d

    def needs_compaction(self) -> bool:
        """True once a drift metric crosses its threshold: the tombstone
        fraction, the delta fraction, or (with a shard assignment) the
        heaviest shard beyond the LPT (4/3 − 1/3S) factor of a fresh
        partition's."""
        if self.n_live == 0:
            return False                    # nothing to fold or balance
        d = self.drift()
        return (d["tombstone_frac"] > self.scfg.max_tombstone_frac
                or d["delta_frac"] > self.scfg.max_delta_frac
                or d.get("shard_imbalance", 0.0) > d.get("lpt_bound",
                                                         np.inf))

    # ---------------------------------------------------------- mutation

    def add_generation_hook(self, fn) -> None:
        """Call ``fn(index, generation)`` after every mutation that bumps
        the generation (insert, delete, compact, rebalance), so that state
        keyed on the generation (a result cache) can be dropped at once."""
        self._gen_hooks.append(fn)

    def _invalidate(self) -> None:
        self.generation += 1
        stale_snapshot = self._snap_cache is not None
        self._dev_cache = None
        self._snap_cache = None
        self._ex_cache = {}       # stale fronts hold superseded tensors
        self._index_graphs = {}
        for fn in list(self._gen_hooks):
            fn(self, self.generation)
        if stale_snapshot:
            # a snapshot and the executors and partitions cached on it
            # refer to each other, so only the cycle collector frees its
            # device memory (GBs at 1M rows) once it is dropped
            gc.collect()

    def _observe_mutation(self, op: str, **attrs) -> None:
        """Mutation observability: always the mutation counter by op and
        the tombstone and delta-fraction gauges; while tracing, an
        ``index.<op>`` event with the whole ``drift()`` (which reruns
        ``lpt_assign`` under a shard assignment, too dear untraced)."""
        reg = obs_metrics.active()
        reg.counter("streaming_mutations_total", "index mutations by op",
                    labelnames=("op",)).labels(op=op).inc()
        live, tomb = self.n_live, self.n_tombstones
        reg.gauge("streaming_tombstone_frac",
                  "tombstoned fraction of tracked rows").set(
                      tomb / max(live + tomb, 1))
        reg.gauge("streaming_delta_frac",
                  "delta-page rows over live rows").set(
                      self.n_delta_rows / max(live, 1))
        if trace.active() is not None:
            payload = {"generation": self.generation, "n_live": live,
                       **self.drift()}
            payload.update(attrs)
            trace.event(f"index.{op}", track="index", **payload)

    def _grow_rows(self, need: int) -> None:
        new_cap = max(need, 2 * self.cap_rows)
        self.pq_codes = _pad_rows(self.pq_codes, new_cap)
        self.trq = trq_mod.map_rows(self.trq,
                                    lambda t: _pad_rows(t, new_cap))
        self.x = _pad_rows(self.x, new_cap)
        grow = new_cap - self.row_gid.size
        self.row_gid = np.concatenate([self.row_gid,
                                       np.full(grow, -1, np.int64)])
        self.alive = np.concatenate([self.alive, np.zeros(grow, bool)])

    def insert(self, x_new) -> np.ndarray:
        """Append vectors ``x_new`` (B, D) and return their global ids.

        The new rows are assigned to their nearest (frozen) centroid, PQ-
        and TRQ-encoded alone, written past the last row, wired into the
        graph if it is materialized, and pushed onto their lists' delta
        pages (which grow by whole pages)."""
        x_new = torch.as_tensor(x_new, dtype=torch.float32).to(self.device)
        if x_new.ndim == 1:
            x_new = x_new[None]
        b = int(x_new.shape[0])
        if b == 0:
            return np.zeros((0,), np.int64)
        if self.n_rows + b > self.cap_rows:
            self._grow_rows(self.n_rows + b)

        list_ids = assign(x_new, self.centroids).cpu().numpy()
        pq = pq_mod.encode(self.codebook, x_new)
        new_trq = trq_mod.encode_rows(x_new, pq_mod.decode(self.codebook, pq),
                                      num_levels=self.config.trq_levels,
                                      model=self.trq.model)
        row0 = self.n_rows
        self.pq_codes[row0:row0 + b] = pq
        trq_mod.write_rows(self.trq, new_trq, row0)
        self.x[row0:row0 + b] = x_new

        rows = np.arange(row0, row0 + b)
        gids = np.arange(self.next_gid, self.next_gid + b)
        self.row_gid[rows] = gids
        self.alive[rows] = True
        self._gid_row = np.concatenate([self._gid_row, rows])
        self.n_rows += b
        self.next_gid += b
        self._n_live += b

        if self._graph is not None:
            self._graph = graph_mod.insert_nodes(
                self._graph, self.x[:self.n_rows], row0, self.start(row0))

        # delta append: bucket the batch by list, grow the pages if needed
        counts = np.bincount(list_ids, minlength=self.nlist).astype(np.int32)
        need = int((self.delta_len + counts).max())
        dcap = self.delta_lists.shape[1]
        if need > dcap:
            page = self.scfg.delta_page
            new_dcap = ((need + page - 1) // page) * page
            self.delta_lists = np.concatenate(
                [self.delta_lists,
                 np.full((self.nlist, new_dcap - dcap), -1, np.int32)],
                axis=1)
        order = np.argsort(list_ids, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = (np.arange(b) - starts[list_ids[order]]
               + self.delta_len[list_ids[order]])
        self.delta_lists[list_ids[order], pos] = rows[order]
        self.delta_len += counts

        self._invalidate()
        self._observe_mutation("insert", n=b)
        if self.scfg.auto_compact:
            self.maybe_compact()
        return gids

    def delete(self, gids) -> int:
        """Tombstone global ids ``gids``; returns how many.  An unknown,
        already deleted or repeated id raises ``KeyError`` before anything
        changes."""
        if isinstance(gids, torch.Tensor):
            gids = gids.cpu().numpy()
        gids = np.atleast_1d(np.asarray(gids, np.int64))
        if np.unique(gids).size != gids.size:
            raise KeyError(f"duplicate ids in delete batch of {gids.size}")
        known = (gids >= 0) & (gids < self.next_gid)
        rows = np.full(gids.shape, -1, np.int64)
        rows[known] = self._gid_row[gids[known]]
        if (rows < 0).any():
            raise KeyError(int(gids[rows < 0][0]))
        self._gid_row[gids] = -1
        self.alive[rows] = False
        self.n_tombstones += gids.size
        self._n_live -= gids.size
        self._invalidate()
        self._observe_mutation("delete", n=int(gids.size))
        if self.scfg.auto_compact:
            self.maybe_compact()
        return int(gids.size)

    # ------------------------------------------------- compact / rebalance

    def _live_assignment(self) -> tuple[np.ndarray, np.ndarray]:
        """(live rows ascending, their nearest list): the assignment from
        scratch that a static rebuild on the live rows makes."""
        live_rows = np.nonzero(self.alive[:self.n_rows])[0]
        if live_rows.size == 0:
            raise ValueError("empty index: nothing to compact/search")
        rows = torch.from_numpy(live_rows).to(self.device)
        list_ids = np.concatenate([
            assign(self.x[rows[a:b]], self.centroids).cpu().numpy()
            for a, b in chunks(live_rows.size, _ROWS)])
        return live_rows, list_ids

    def compact(self) -> dict:
        """Fold the delta pages into fresh base lists and drop tombstones:
        the live rows, in row order (global ids stay ascending), are
        gathered into a new row store, and dead rows leave the graph with
        their edges patched.  No row is re-encoded."""
        folded, dropped = self.n_delta_rows, self.n_tombstones
        live_rows, list_ids = self._live_assignment()
        n_live = live_rows.size
        cap = int(3.0 * n_live / self.nlist) + 1
        lists, lens, _ = ivf_mod.fill_lists(list_ids, self.nlist, cap)

        perm = torch.from_numpy(live_rows).to(self.device)
        new_cap = int(n_live * (1.0 + self.scfg.row_headroom)) + 1
        old_x = self.x
        self.pq_codes = _take_rows(self.pq_codes, perm, new_cap)
        self.trq = trq_mod.map_rows(self.trq,
                                    lambda t: _take_rows(t, perm, new_cap))
        self.x = _take_rows(old_x, perm, new_cap)
        if self._graph is not None:
            self._graph = graph_mod.compact_graph(
                self._graph, old_x[:self.n_rows], live_rows)
        del old_x

        gids = self.row_gid[live_rows]
        self.row_gid = np.full((new_cap,), -1, np.int64)
        self.row_gid[:n_live] = gids
        self.alive = np.zeros((new_cap,), bool)
        self.alive[:n_live] = True
        self._gid_row = np.full((self.next_gid,), -1, np.int64)
        self._gid_row[gids] = np.arange(n_live)

        self.base_lists, self.base_len = lists, lens
        self.delta_lists = np.full((self.nlist, self.scfg.delta_page), -1,
                                   np.int32)
        self.delta_len = np.zeros((self.nlist,), np.int32)
        self.n_rows = n_live
        self.n_tombstones = 0
        self._n_base = n_live
        self._invalidate()
        self._observe_mutation("compact", folded_delta_rows=folded,
                               dropped_tombstones=dropped)
        return {"folded_delta_rows": folded, "dropped_tombstones": dropped,
                "n_live": n_live}

    def rebalance(self, n_shards: int) -> dict:
        """Compact, then re-partition the lists across ``n_shards`` with the
        sharded layout's LPT greedy; reports the rows that moved shard
        against the previous assignment (a move is a gather of encoded
        rows, never a re-encode)."""
        prev = self._assignment
        stats = self.compact()
        members, _ = lpt_assign(self.base_len, n_shards)
        assignment = np.empty((self.nlist,), np.int32)
        for s, m in enumerate(members):
            assignment[m] = s
        if prev is not None and self._n_shards == n_shards:
            moved = np.nonzero(assignment != prev)[0]
            stats["moved_rows"] = int(self.base_len[moved].sum())
        else:
            stats["moved_rows"] = int(self.base_len.sum())
        self._assignment = assignment
        self._n_shards = n_shards
        stats["shard_loads"] = [int(self.base_len[m].sum()) for m in members]
        self._invalidate()
        self._observe_mutation("rebalance", moved_rows=stats["moved_rows"],
                               shard_loads=stats["shard_loads"])
        return stats

    def maybe_compact(self) -> dict | None:
        """``rebalance`` (with a shard assignment) or ``compact`` once a
        drift metric trips; None below the thresholds."""
        if not self.needs_compaction():
            return None
        if self._n_shards is not None:
            return self.rebalance(self._n_shards)
        return self.compact()

    # ----------------------------------------------------------- snapshot

    def rebuild_static(self) -> tuple[FaTRQIndex, np.ndarray]:
        """A static index built from scratch on the live rows: fresh lists
        against the trained quantizers (retraining them is a model update,
        not index maintenance) and a dense row store.  Returns (index,
        gid), ``gid[i]`` the global id of its row ``i``; kept per
        generation (also the snapshot behind ``shards=S``)."""
        if self._snap_cache is not None \
                and self._snap_cache[0] == self.generation:
            return self._snap_cache[1], self._snap_cache[2]
        live_rows, list_ids = self._live_assignment()
        cap = int(3.0 * live_rows.size / self.nlist) + 1
        lists, lens, _ = ivf_mod.fill_lists(list_ids, self.nlist, cap)
        dev = self.device
        perm = torch.from_numpy(live_rows).to(dev)
        idx = FaTRQIndex(
            config=self.config, codebook=self.codebook,
            pq_codes=self.pq_codes[perm],
            ivf=ivf_mod.IVFIndex(centroids=self.centroids,
                                 lists=torch.from_numpy(lists).to(dev),
                                 list_len=torch.from_numpy(lens).to(dev)),
            trq=trq_mod.gather_rows(self.trq, perm), x=self.x[perm])
        gid = self.row_gid[live_rows].copy()
        self._snap_cache = (self.generation, idx, gid)
        return idx, gid

    # ------------------------------------------------------------- search

    def _graph_host(self) -> np.ndarray:
        """The maintained adjacency over rows 0..n_rows, dead rows
        included: built on first use (or the wrapped index's graph before
        any mutation, which is the same build of the same rows), then
        edited by ``insert`` and ``compact``, never rebuilt."""
        if self._graph is None:
            g = self._index_graphs.get(self._graph_degree)
            if g is None:
                g = graph_mod.build(
                    self.x[:self.n_rows], degree=self._graph_degree,
                    generator=torch.Generator(device=self.device)
                    .manual_seed(0))
            self._graph = g.neighbors.cpu().numpy()
        return self._graph

    def graph_index(self) -> graph_mod.GraphIndex:
        """The maintained adjacency on the device, with the start nodes
        ``start(n_rows)``."""
        return graph_mod.GraphIndex(
            neighbors=torch.from_numpy(self._graph_host()).to(self.device),
            start=self.start(self.n_rows).to(self.device))

    def _x_score(self) -> torch.Tensor:
        """The PQ decode of rows 0..n_rows that graph traversals score,
        one per generation for all its graph fronts (3.1 GB at 1M × 768)."""
        dev = self._dev()
        if "x_score" not in dev:
            dev["x_score"] = pq_mod.decode(self.codebook,
                                           self.pq_codes[:self.n_rows])
        return dev["x_score"]

    def _dev(self) -> dict:
        if self._dev_cache is None or \
                self._dev_cache["gen"] != self.generation:
            dev = self.device
            self._dev_cache = {
                "gen": self.generation,
                **{name: torch.from_numpy(getattr(self, name)).to(dev)
                   for name in ("base_lists", "delta_lists", "alive",
                                "row_gid")}}
        return self._dev_cache

    def execute(self, queries, *, k: int | None = None,
                front: str | None = None, backend: str | None = None,
                micro_batch: int | None = None,
                refine_budget: int | None = None,
                cost: QueryCost | None = None, shards: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, QueryCost]:
        """Search this generation: (Q, k) global ids, their exact squared
        L2 distances, and the traffic ledger.  ``shards`` searches the
        ``rebuild_static`` snapshot through the sharded layout."""
        cfg = self.config
        k = k or cfg.final_k
        front = front or "ivf"
        backend = backend or self.default_backend
        micro_batch = micro_batch if micro_batch is not None \
            else cfg.micro_batch
        queries = torch.as_tensor(queries, dtype=torch.float32) \
            .to(self.device).contiguous()
        if shards is not None:
            idx, gid = self.rebuild_static()
            sx = make_sharded_executor(idx, shards=shards, front=front,
                                       backend=backend,
                                       micro_batch=micro_batch,
                                       refine_budget=refine_budget)
            ids, dists, out = sx.execute(queries, k=k, cost=cost)
            return torch.from_numpy(gid).to(self.device)[ids.long()], \
                dists, out
        ex = self._executor(front, backend, micro_batch, refine_budget)
        rows, dists, out = ex.execute(queries, k=k, cost=cost)
        return self._dev()["row_gid"][rows.long()], dists, out

    def search(self, queries, *, k: int | None = None,
               front: str | None = None, backend: str | None = None,
               micro_batch: int | None = None,
               cost: QueryCost | None = None, shards: int | None = None
               ) -> tuple[torch.Tensor, QueryCost]:
        """``execute`` without the distances (the legacy tuple)."""
        ids, _, out = self.execute(queries, k=k, front=front,
                                   backend=backend, micro_batch=micro_batch,
                                   cost=cost, shards=shards)
        return ids, out

    def _executor(self, front: str, backend: str, micro_batch: int | None,
                  refine_budget: int | None = None) -> SearchExecutor:
        """The static layout's ``SearchExecutor`` over this generation,
        with the front's streaming stage; kept per (generation, front,
        backend, micro_batch, refine_budget), each with its own backend
        (and so its own refine stores)."""
        key = (self.generation, front, backend, micro_batch, refine_budget)
        ex = self._ex_cache.get(key)
        if ex is None:
            ex = self._ex_cache[key] = SearchExecutor(
                index=self, front=registry.make_front(front, "streaming",
                                                      self),
                backend=registry.make_backend(backend),
                micro_batch=micro_batch, refine_budget=refine_budget)
        return ex


# ----------------------------------------------------- registry integration


def make_streaming_front(st: StreamingIndex, **opts) -> StreamingFrontStage:
    nprobe = opts.pop("nprobe", st.config.nprobe)
    if opts:
        raise TypeError(f"unknown streaming front options: {sorted(opts)}")
    dev = st._dev()
    return StreamingFrontStage(
        centroids=st.centroids, codebook=st.codebook, pq_codes=st.pq_codes,
        base_lists=dev["base_lists"], delta_lists=dev["delta_lists"],
        alive=dev["alive"], nprobe=nprobe)


def make_streaming_graph_front(st: StreamingIndex, *, degree: int = 16,
                               **opts) -> GraphStreamingFrontStage:
    """The maintained adjacency (materialized on first use) with this
    generation's alive flags and delta boundary."""
    if degree != st._graph_degree and st._graph is not None:
        raise ValueError(f"streaming graph was materialized at degree "
                         f"{st._graph_degree}, cannot serve degree {degree}")
    st._graph_degree = degree
    return GraphStreamingFrontStage(
        graph=st.graph_index(), codebook=st.codebook,
        pq_codes=st.pq_codes[:st.n_rows],
        alive=st._dev()["alive"][:st.n_rows], n_base=st._n_base,
        x_score=st._x_score(), **opts)


registry.add_front_factory("ivf", "streaming", make_streaming_front)
registry.add_front_factory("graph", "streaming", make_streaming_graph_front)
