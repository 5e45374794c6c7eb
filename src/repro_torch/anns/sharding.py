"""Sharded search: the database partitioned into S shards, searched front →
refine → rerank shard by shard with every data-dependent decision pooled
across shards (the port of ``repro.anns.sharding``).

* ``partition_database(index, S, front=...)`` dispatches to the front's
  partitioner:

  - **IVF** assigns WHOLE inverted lists to shards, balanced by list
    length with an LPT greedy (``lpt_assign``), so a candidate's codes,
    scalars and full vector co-reside with its list.
  - **graph** splits the VECTORS into contiguous row ranges and gives each
    shard its subgraph plus HALO state: the adjacency of its owned rows
    (global ids and local slots) and the PQ reconstructions of its owned
    rows followed by every off-shard neighbor of them, so a shard expands
    any node it owns from its own memory.

  Per-shard record arrays are gathered on the device into shard-local row
  order and stacked on a leading shard axis (zero-padded to the largest
  shard); ``gid`` maps local rows back to global database ids.
* ``ShardedIndex`` holds the stacked database; ``.to(device)`` moves it,
  ``.place(mesh)`` keeps one rank's block of it (below).
* ``ShardedExecutor`` runs the stages per shard.  The JAX package runs the
  body under ``shard_map`` across devices.  Here the body is a loop over
  the shards this process holds (one launch per kernel per shard, what a
  per-device body is) and the collectives go through one axis object:

  - the **stacked** form (no mesh) holds every shard on one device, and
    the pooled cuts are tensor ops over the stacked per-shard results;
  - the **mesh** form (``launch.mesh.make_search_mesh``, one process per
    shard, as ``torchrun`` starts them) holds one shard per rank, and the
    axis all-gathers the ranks' blocks in rank order or all-reduces the
    owner-masked parts.  Every rank makes the same calls with the same
    padded shapes, so the pools are the stacked form's and every rank
    returns the stacked form's ids, distances and ledger bit for bit.

  The pooled cuts:

    - IVF front: each shard ranks the replicated centroid table (computed
      once per micro-batch) and keeps the global top-``nprobe`` lists it
      owns, so the union across shards is exactly the unsharded probe set;
    - graph front: the beam state (global ids, distances, expanded flags)
      is replicated and advances in lockstep; each hop the owner of every
      picked node contributes its adjacency row and the neighbor distances
      from its halo copy, every other shard zeros, and a sum over the
      shard axis (the ``psum``) rebuilds the exact neighbor list of the
      unsharded search, so the shared ``graph.beam_merge`` keeps the
      unsharded beam bit for bit; each shard then scores the beam slots
      it owns;
    - refine: each level's pruning threshold pools every shard's k
      smallest upper bounds in shard order (the all-gather) and takes the
      kth smallest (``estimator.pooled_k_smallest``), so every survivor
      mask matches the unsharded run;
    - rerank: each shard's best estimates are pooled and the SSD budget
      taken from the pool by (estimate, unsharded slot), the unsharded
      candidate order (``Candidates.list_rank``), so exactly the unsharded
      fetch set; the per-shard (distance, global id) pairs are cut to the
      top k with ties broken as the unsharded cut breaks them
      (``_rerank_survivors_sharded``).

  Stage counters stay on the device, one per shard; one host transfer at
  the end (after one all-gather of the ranks' counters on a mesh) builds
  one ``QueryCost`` ledger per shard, folded with
  ``QueryCost.merge_parallel`` (shards run concurrently: per-tier time is
  the slowest shard's, bytes and accesses sum).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from repro_torch.anns import registry
from repro_torch.anns.executor import (_accumulate, _attach_ledger, _cat,
                                       _padded, fold_counts, iter_chunks,
                                       search_budget)
from repro_torch.anns.stages import (Candidates, Counters, _exact_sq,
                                     _smallest, fold_graph_front_cost,
                                     fold_ivf_front_cost, graph_for,
                                     rank_centroid_lists)
from repro_torch.core.trq import TRQCodes
from repro_torch.index import graph as graph_mod
from repro_torch.kernels.pq_adc import pq_adc
from repro_torch.launch.mesh import AXIS
from repro_torch.memory import QueryCost, RecordLayout, Tier
from repro_torch.obs import trace
from repro_torch.quant import pq as pq_mod


def _map_fields(obj, fn):
    """A copy of a dataclass of tensors with ``fn`` applied to each."""
    return type(obj)(**{f.name: fn(getattr(obj, f.name))
                        for f in dataclasses.fields(obj)})


class _StackedAxis:
    """The stacked form's axis: every shard is in this process, so a
    gather or a sum over the shards is the local stack or sum itself."""

    rank = 0

    @staticmethod
    def all_gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t

    @staticmethod
    def all_sum(t: torch.Tensor) -> torch.Tensor:
        return t


STACKED = _StackedAxis()


# ------------------------------------------------------------- partitioner


@dataclass(eq=False)
class ShardedIndex:
    """A FaTRQIndex partitioned into S shards, stacked on a leading axis.

    Replicated: ``codebook`` (PQ), the calibration model inside ``trq`` and
    ``front_rep`` (IVF: the coarse centroid table; graph: the search's
    start nodes).  Stacked on the shard axis: ``front_db`` (IVF: each
    shard's list ids and its lists with LOCAL row ids; graph: halo
    vectors, adjacency as global ids and as local slots, and the
    global → owned-local row map), per-record ``pq_codes``/``trq``/``x``
    and ``gid`` (local row → global id, -1 on padding).  ``front_args``
    holds the static traversal parameters captured at partition time.

    Stacked, the shard axis holds all ``n_shards`` shards (S_h = S);
    placed on a mesh (``place``), it holds this rank's one (S_h = 1).
    """

    config: "PipelineConfig"         # noqa: F821 - import cycle via pipeline
    layout: RecordLayout
    n_shards: int
    front: str                       # which front this partition serves
    codebook: pq_mod.PQCodebook      # replicated
    front_rep: tuple                 # replicated front tensors
    front_db: tuple                  # shard-stacked front tensors
    front_args: tuple                # static (name, value) traversal args
    pq_codes: torch.Tensor           # (S_h, n_max, M) uint8
    trq: TRQCodes                    # every per-record leaf (S_h, n_max, ...)
    x: torch.Tensor                  # (S_h, n_max, D) full precision ("SSD")
    gid: torch.Tensor                # (S_h, n_max) int32 global row id, -1 pad
    shard_rows: np.ndarray           # (S,) real rows per shard
    mesh: object = None              # launch.mesh.SearchMesh once placed

    @property
    def centroids(self) -> torch.Tensor:
        return self.front_rep[0]

    @property
    def list_gid(self) -> torch.Tensor:
        return self.front_db[0]

    @property
    def lists(self) -> torch.Tensor:
        return self.front_db[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def default_backend(self) -> str:
        if self.config.backend is not None:
            return self.config.backend
        return "cuda" if self.device.type == "cuda" else "reference"

    @property
    def axis(self):
        """The pooled cuts' axis: the mesh once placed, else the stacked
        form's local one."""
        return STACKED if self.mesh is None else self.mesh

    @cached_property
    def shard_trqs(self) -> tuple[TRQCodes, ...]:
        """Each held shard's TRQ codes (views of the stacked tensors),
        built once so a backend can key its per-shard stores on them."""
        trq = self.trq
        return tuple(
            TRQCodes(dim=trq.dim,
                     levels=tuple(_map_fields(lv, lambda t, s=s: t[s])
                                  for lv in trq.levels),
                     scalars=_map_fields(trq.scalars, lambda t, s=s: t[s]),
                     model=trq.model)
            for s in range(self.gid.shape[0]))

    def place(self, mesh) -> "ShardedIndex":
        """This rank's block of the partition on ``mesh`` (a
        ``launch.mesh.SearchMesh`` of ``n_shards`` ranks, one shard
        each): the shard-stacked tensors cut to the rank's block (shapes,
        padding and slot numbering those of the stacked form) and copied
        to the mesh's device, the replicated ones moved there.  The
        stacked tensors are not kept, so dropping this partition frees
        the other blocks.

        Every rank must hold the same partition: one small all-gather
        compares ``shard_rows`` and checksums of the row and list maps,
        the front's integer tensors and the codebook, and a mismatch
        raises on every rank."""
        if mesh.size != self.n_shards:
            raise ValueError(f"mesh axis {AXIS!r} has size {mesh.size} but "
                             f"the index has {self.n_shards} shards")
        if self.mesh is not None:
            raise ValueError("this partition is already placed on a mesh; "
                             "place the stacked partition")
        mine = _partition_digest(self).to(mesh.device)
        every = mesh.all_gather(mine[None], 0)
        bad = [r for r in range(mesh.size)
               if not torch.equal(every[r], mine)]
        if bad:
            raise ValueError(
                f"ranks {bad} hold another partition than rank {mesh.rank} "
                f"(shard_rows, row/list maps or codebook differ); build or "
                f"load the same index on every rank")
        dev, r = mesh.device, mesh.rank
        blk = lambda t: t[r:r + 1].to(dev, copy=True)         # noqa: E731
        mv = lambda t: t.to(dev)                              # noqa: E731
        trq = TRQCodes(dim=self.trq.dim,
                       levels=tuple(_map_fields(lv, blk)
                                    for lv in self.trq.levels),
                       scalars=_map_fields(self.trq.scalars, blk),
                       model=_map_fields(self.trq.model, mv))
        return dataclasses.replace(
            self, codebook=_map_fields(self.codebook, mv),
            front_rep=tuple(map(mv, self.front_rep)),
            front_db=tuple(map(blk, self.front_db)),
            pq_codes=blk(self.pq_codes), trq=trq, x=blk(self.x),
            gid=blk(self.gid), mesh=mesh)

    def to(self, device) -> "ShardedIndex":
        """The same partition with every tensor on ``device``."""
        mv = lambda t: t.to(device)                           # noqa: E731
        trq = TRQCodes(dim=self.trq.dim,
                       levels=tuple(_map_fields(lv, mv)
                                    for lv in self.trq.levels),
                       scalars=_map_fields(self.trq.scalars, mv),
                       model=_map_fields(self.trq.model, mv))
        return dataclasses.replace(
            self, codebook=_map_fields(self.codebook, mv),
            front_rep=tuple(map(mv, self.front_rep)),
            front_db=tuple(map(mv, self.front_db)),
            pq_codes=mv(self.pq_codes), trq=trq, x=mv(self.x),
            gid=mv(self.gid))


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """A position-weighted int64 sum of ``t``'s bits (wrapping), equal
    for equal tensors on any device."""
    v = t.reshape(-1).contiguous()
    if v.is_floating_point():
        v = v.view(torch.int32 if v.element_size() == 4 else torch.int64)
    w = torch.arange(1, v.numel() + 1, device=v.device)
    return (v.long() * w).sum()


def _partition_digest(si: "ShardedIndex") -> torch.Tensor:
    """(S + k,) int64 on the host: ``shard_rows``, then checksums of
    ``gid``, of each integer front tensor and of the codebook (the
    stacked partition's identity, compared across ranks by ``place``)."""
    sums = [_checksum(si.gid)]
    sums += [_checksum(t) for t in si.front_db if not t.is_floating_point()]
    sums.append(_checksum(si.codebook.codebooks))
    return torch.cat([torch.from_numpy(np.asarray(si.shard_rows, np.int64)),
                      torch.stack(sums).cpu()])


def lpt_assign(lens: np.ndarray, n_shards: int
               ) -> tuple[list[list[int]], np.ndarray]:
    """LPT greedy list→shard assignment: sort lists by member count
    descending, place each on the currently lightest shard.  Bounds the
    heaviest shard at (4/3 − 1/3S)× the optimum.  Returns (per-shard list
    ids, per-shard loads)."""
    order = np.argsort(-lens, kind="stable")
    loads = np.zeros(n_shards, np.int64)
    members: list[list[int]] = [[] for _ in range(n_shards)]
    for li in order:
        s = int(np.argmin(loads))
        members[s].append(int(li))
        loads[s] += int(lens[li])
    return members, loads


def _partition_ivf_front(index, n_shards: int):
    """IVF partitioner: whole inverted lists → shards via ``lpt_assign``.
    Returns (per-shard global rows, replicated tensors, shard-stacked
    front tensors, static front args)."""
    ivf = index.ivf
    lens = ivf.list_len.cpu().numpy()
    lists_np = ivf.lists.cpu().numpy()
    nlist, cap = lists_np.shape
    if not 1 <= n_shards <= nlist:
        raise ValueError(f"n_shards={n_shards} must be in [1, nlist={nlist}]"
                         f" — whole lists are the partitioning unit")

    members, _ = lpt_assign(lens, n_shards)

    lmax = max(len(m) for m in members)
    rows_per: list[np.ndarray] = []
    list_gid = np.full((n_shards, lmax), -1, np.int32)
    local_lists = np.full((n_shards, lmax, cap), -1, np.int32)
    for s, m in enumerate(members):
        off = 0
        rows: list[np.ndarray] = []
        for j, li in enumerate(m):
            n_li = int(lens[li])
            list_gid[s, j] = li
            local_lists[s, j, :n_li] = np.arange(off, off + n_li)
            rows.append(lists_np[li, :n_li])
            off += n_li
        rows_per.append(np.concatenate(rows) if rows
                        else np.zeros((0,), np.int32))
    dev = index.device
    fdb = (torch.from_numpy(list_gid).to(dev),
           torch.from_numpy(local_lists).to(dev))
    return rows_per, (ivf.centroids,), fdb, (("nprobe",
                                              index.config.nprobe),)


def _partition_graph_front(index, n_shards: int):
    """Graph partitioner: contiguous vector ranges → shards, each with its
    subgraph + halo.

    Per shard: the adjacency of its owned rows as GLOBAL ids (what the
    frontier exchange publishes) and as LOCAL slots into ``xs_loc``, the
    shard's copy of the PQ reconstructions of its owned rows FOLLOWED BY
    every off-shard neighbor of them (the halo).  ``loc_of`` maps a global
    row to its owned local row (-1 off-shard): it decides the exchange's
    ownership and maps the final beam onto the shard's record store.
    ``xs_loc`` is gathered on the device from one global decode, so halo
    copies are bit-identical to the owner's rows."""
    n = int(index.x.shape[0])
    if not 1 <= n_shards <= n:
        raise ValueError(f"n_shards={n_shards} must be in [1, n={n}] — "
                         f"vectors are the partitioning unit")
    graph = graph_for(index)
    g = graph.neighbors.cpu().numpy()
    degree = g.shape[1]
    rows_per = [r.astype(np.int32)
                for r in np.array_split(np.arange(n), n_shards)]
    ns_max = max(r.size for r in rows_per)

    loc_of = np.full((n_shards, n), -1, np.int32)
    halos: list[np.ndarray] = []
    for s, rows in enumerate(rows_per):
        loc_of[s, rows] = np.arange(rows.size, dtype=np.int32)
        nbr = g[rows]
        halos.append(np.unique(nbr[loc_of[s, nbr] < 0]))
    nloc_max = max(1, max(r.size + h.size for r, h in zip(rows_per, halos)))

    dev = index.device
    x_score = pq_mod.decode(index.codebook, index.pq_codes)
    xs_loc = torch.zeros((n_shards, nloc_max, x_score.shape[1]),
                         dtype=x_score.dtype, device=dev)
    adj_gid = np.zeros((n_shards, ns_max, degree), np.int32)
    adj_loc = np.zeros((n_shards, ns_max, degree), np.int32)
    for s, (rows, halo) in enumerate(zip(rows_per, halos)):
        local = torch.from_numpy(np.concatenate([rows, halo])).to(dev)
        xs_loc[s, :local.numel()] = x_score[local.long()]
        full_loc = loc_of[s].copy()
        full_loc[halo] = rows.size + np.arange(halo.size, dtype=np.int32)
        adj_gid[s, :rows.size] = g[rows]
        adj_loc[s, :rows.size] = full_loc[g[rows]]
    del x_score
    fdb = (xs_loc, torch.from_numpy(adj_gid).to(dev),
           torch.from_numpy(adj_loc).to(dev), torch.from_numpy(loc_of).to(dev))
    # static traversal args: GraphFrontStage's defaults, the unsharded
    # search the sharded one must reproduce
    args = (("beam", 64), ("iters", 32), ("expand", 4), ("degree", degree))
    return rows_per, (graph.start,), fdb, args


def partition_database(index, n_shards: int,
                       front: str = "ivf") -> ShardedIndex:
    """Partition ``index`` for ``front``'s sharded datapath.

    The front's registered partitioner chooses which global rows each shard
    owns; the per-record arrays (PQ codes, TRQ levels + scalars, full
    vectors) are then gathered on the device into shard-local row order
    and stacked, zero-padded to the largest shard.
    """
    hooks = registry.sharded_front(front)
    rows_per, front_rep, front_db, front_args = hooks.partition(
        index, n_shards)
    shard_rows = np.array([r.size for r in rows_per])
    n_max = max(int(shard_rows.max()), 1)

    gid_np = np.full((n_shards, n_max), -1, np.int32)
    for s, rows in enumerate(rows_per):
        gid_np[s, :rows.size] = rows
    gid = torch.from_numpy(gid_np).to(index.device)
    rows = gid.long().clamp(min=0)
    pad = gid < 0

    def stack(t: torch.Tensor) -> torch.Tensor:
        out = t[rows]
        out[pad] = 0
        return out

    trq = index.trq
    return ShardedIndex(
        config=index.config, layout=index.layout, n_shards=n_shards,
        front=front, codebook=index.codebook, front_rep=front_rep,
        front_db=front_db, front_args=front_args,
        pq_codes=stack(index.pq_codes),
        trq=TRQCodes(dim=trq.dim,
                     levels=tuple(_map_fields(lv, stack)
                                  for lv in trq.levels),
                     scalars=_map_fields(trq.scalars, stack),
                     model=trq.model),
        x=stack(index.x), gid=gid, shard_rows=shard_rows)


# ------------------------------------------------------- per-shard fronts


def _ivf_shard_front(queries, rep, fdb, codebook, pq_codes, *,
                     qvalid=None, axis=STACKED, nprobe: int
                     ) -> list[Candidates]:
    """The IVF front on every held shard of one micro-batch (no exchange:
    ``axis`` is unused).  The replicated
    centroid ranking and ADC tables are computed once; then per shard the
    chosen lists it owns are gathered, in probe order, and scored with one
    ``pq_adc`` launch.  The global top-``nprobe`` set has ``nprobe`` lists
    in all, so ``pl = min(nprobe, lmax)`` slots per shard always suffice.

    A shard's slot (j, pos) holds the list of probe rank r =
    ``list_rank[j]`` at position pos, the unsharded front's slot
    r·cap + pos: the partitioner keeps each list's rows in order at the
    same cap, so a shard's slots are the unsharded ones restricted to it,
    in the same order.  ``qvalid`` masks padded query rows out of every
    shard's slots and counters."""
    (centroids,) = rep
    list_gid, lists = fdb
    nq = queries.shape[0]
    n_shards, lmax, cap = lists.shape
    dev = queries.device
    _, top_lists = rank_centroid_lists(centroids, queries, nprobe=nprobe)
    lut = pq_mod.adc_table(codebook, queries)
    pl = min(nprobe, lmax)
    # each list's probe rank; nprobe for a list no query chose
    rank_of = torch.full((nq, centroids.shape[0]), nprobe, dtype=torch.int64,
                         device=dev)
    rank_of.scatter_(1, top_lists, torch.arange(nprobe, device=dev)
                     .expand(nq, nprobe))
    cands = []
    for s in range(n_shards):
        own = list_gid[s]
        r_own = torch.where((own >= 0)[None, :],
                            rank_of[:, own.clamp(min=0).long()], nprobe)
        slot = _smallest(r_own, pl)                           # (Q, pl)
        rank = torch.gather(r_own, 1, slot)
        ids_l = lists[s][slot]                                # (Q, pl, cap)
        valid = ((ids_l >= 0) & (rank < nprobe)[:, :, None]) \
            .reshape(nq, pl * cap)
        if qvalid is not None:                # padded rows: no candidates
            valid &= qvalid[:, None]
        ids = ids_l.clamp(min=0).reshape(nq, pl * cap).contiguous()
        d0 = pq_adc(pq_codes[s], ids, valid, lut)
        cands.append(Candidates(ids=ids, valid=valid, d0=d0,
                                counters={"front_cand": valid.sum()},
                                list_rank=rank))
    return cands


def _graph_shard_front(queries, rep, fdb, codebook, pq_codes, *,
                       qvalid=None, axis=STACKED, beam: int, iters: int,
                       expand: int, degree: int) -> list[Candidates]:
    """The graph front on every held shard of one micro-batch: one
    replicated beam, a frontier exchange per hop over the halo-partitioned
    subgraphs.

    The beam state (global ids, distances, expanded flags) is computed once
    and advances in lockstep, as it does identically on every shard of the
    JAX body.  Each hop the shared ``graph.pick_frontier`` picks; the OWNER
    of each picked node contributes its adjacency row (global ids) and the
    neighbor distances from its ``xs_loc`` copy, every other shard zeros,
    and a sum over the shard axis (the held shards', then ``axis``'s
    all-reduce across ranks) rebuilds the flattened neighbor list of the
    unsharded search exactly (x + 0 is exact, and each node has one
    owner).  Each shard's distances come from ``graph.sq_dist`` on the
    (Q, E·degree, D) shape ``graph.search`` gives it, so they are the
    unsharded values to the bit.  The shared ``graph.beam_merge`` then
    keeps the unsharded beam; each shard claims the slots it owns and
    ADC-scores them with one ``pq_adc`` launch on its record store.  A
    shard's slot c is the unsharded beam slot c (``list_rank`` zeros).
    ``qvalid`` masks padded query rows out of the owned slots and of each
    hop's ownership count (their beams still advance, unused)."""
    (start,) = rep
    xs_loc, adj_gid, adj_loc, loc_of = fdb
    n_shards = loc_of.shape[0]
    nq = queries.shape[0]
    dev = queries.device

    def owned(s: int, gids: torch.Tensor):
        """Shard s's (owned mask, clamped local rows) of global ids."""
        lrow = loc_of[s][gids.long()]
        return lrow >= 0, lrow.clamp(min=0).long()

    def exchange(parts: list[torch.Tensor]) -> torch.Tensor:
        """The psum: the owner-masked per-shard values summed over shards
        (in the dtype they came in)."""
        return axis.all_sum(torch.stack(parts).sum(0, dtype=parts[0].dtype))

    ids = start.expand(nq, beam)
    parts = []
    for s in range(n_shards):
        own, lrow = owned(s, ids)
        d = graph_mod.sq_dist(xs_loc[s][lrow], queries)
        parts.append(torch.where(own, d, 0.0))
    ds = exchange(parts)
    expanded = torch.zeros((nq, beam), dtype=torch.bool, device=dev)
    hops = [torch.zeros((), dtype=torch.int64, device=dev)
            for _ in range(n_shards)]
    for _ in range(iters):
        picks, expanded = graph_mod.pick_frontier(ds, expanded, expand=expand)
        pg = torch.gather(ids, 1, picks)                      # (Q, E)
        neigh, nd = [], []
        for s in range(n_shards):
            own, pl = owned(s, pg)
            own_e = own[:, :, None].expand(nq, expand, degree) \
                .reshape(nq, -1)                              # (Q, E·degree)
            neigh.append(torch.where(own_e, adj_gid[s][pl].reshape(nq, -1),
                                     0))
            # neighbor distances from the owner's adjacency-LOCAL slots
            # (its xs_loc covers owned rows + halo, so every edge resolves)
            rows = xs_loc[s][adj_loc[s][pl].reshape(nq, -1).long()]
            nd.append(torch.where(own_e, graph_mod.sq_dist(rows, queries),
                                  0.0))
            hops[s] = hops[s] + (own.sum() if qvalid is None
                                 else (own & qvalid[:, None]).sum())
        ids, ds, expanded = graph_mod.beam_merge(
            ids, ds, expanded, exchange(neigh), exchange(nd), beam=beam)
    order = torch.sort(ds, dim=1, stable=True).indices
    beam_ids = torch.gather(ids, 1, order)                    # (Q, beam)

    lut = pq_mod.adc_table(codebook, queries)
    rank = torch.zeros((nq, 1), dtype=torch.int64, device=dev)
    cands = []
    for s in range(n_shards):
        valid, lfin = owned(s, beam_ids)                      # owned slots
        if qvalid is not None:                # padded rows: no candidates
            valid &= qvalid[:, None]
        ids_local = lfin.int().contiguous()
        d0 = pq_adc(pq_codes[s], ids_local, valid, lut)
        cands.append(Candidates(ids=ids_local, valid=valid, d0=d0,
                                counters={"front_cand": valid.sum(),
                                          "front_hops": hops[s] * degree},
                                list_rank=rank))
    return cands


registry.register_sharded_front("ivf", registry.ShardedFrontHooks(
    partition=_partition_ivf_front, body=_ivf_shard_front,
    fold=fold_ivf_front_cost))
registry.register_sharded_front("graph", registry.ShardedFrontHooks(
    partition=_partition_graph_front, body=_graph_shard_front,
    fold=fold_graph_front_cost))


# ------------------------------------------------------ per-shard rerank


def _rerank_survivors_sharded(x, gid, queries, ids, list_rank, est, alive,
                              *, k: int, budget: int, axis=STACKED):
    """Shard-local exact rerank under a GLOBAL SSD budget, then the
    cross-shard top-k merge.  ids/est/alive (S_h, Q, C_s) of the S_h
    shards this process holds, list_rank (S_h, Q, pl) the probe rank of
    each shard slot's list, so slot c is the unsharded slot
    list_rank[c // cap]·cap + c % cap, cap = C_s / pl.

    The fetch set is the unsharded executor's exactly, as the reference's
    contract states (``repro.anns.sharding._rerank_survivors_sharded``):
    the unsharded cut takes the ``budget`` smallest estimates, lower slot
    first on ties.  Each shard takes its ``min(budget, C_s)`` best in slot
    order, which is unsharded order, so every member of the global cut is
    among them (the all-gather of the multi-device form); the pooled
    candidates are ordered by (estimate, unsharded slot), and the alive
    ones among the first ``budget`` fetch.  The merge of exact distances
    breaks ties by that fetch order, as the unsharded merge does.

    Across ranks ``axis`` all-gathers each shard's (Q, bl) best estimates,
    unsharded-slot keys and alive flags in rank order, so every rank
    computes the same fetch order; each rank scores only its own fetches,
    and the (distance, global id) pairs are all-gathered for the merge.
    Returns (top-k global ids, their exact distances, (S_h,) fetch
    counts).
    """
    held, nq, _ = est.shape
    bl = min(budget, est.shape[-1])
    inf = torch.tensor(float("inf"), device=est.device)
    est_m = torch.where(alive, est, inf)
    order = _smallest(est_m, bl)                              # (S_h, Q, bl)
    cap = est.shape[-1] // list_rank.shape[-1]
    key = axis.all_gather(
        torch.gather(list_rank, 2, order // cap) * cap + order % cap)
    best_est = axis.all_gather(torch.gather(est_m, 2, order))  # (S, Q, bl)
    best_alive = axis.all_gather(torch.gather(alive, 2, order))
    n_shards = key.shape[0]
    pool = lambda t: t.permute(1, 0, 2).reshape(nq, -1)      # noqa: E731
    # the pooled (Q, S·bl) candidates by estimate, then by unsharded slot
    by_slot = _smallest(pool(key), n_shards * bl)
    fetch_order = torch.gather(by_slot, 1, _smallest(torch.gather(
        pool(best_est), 1, by_slot), n_shards * bl))
    first = torch.zeros((nq, n_shards * bl), dtype=torch.bool,
                        device=est.device)
    first.scatter_(1, fetch_order[:, :budget], True)
    fetch_alive = (first.reshape(nq, n_shards, bl).transpose(0, 1)
                   & best_alive).narrow(0, axis.rank * held, held)
    fetch_ids = torch.gather(ids, 2, order)
    d_parts, g_parts = [], []
    for s in range(held):
        d = _exact_sq(x[s], queries, fetch_ids[s])
        d_parts.append(torch.where(fetch_alive[s], d, inf))
        g_parts.append(gid[s][fetch_ids[s].long()])
    d_all = axis.all_gather(torch.cat(d_parts, dim=1), 1)    # shard order
    g_all = axis.all_gather(torch.cat(g_parts, dim=1), 1)
    best = torch.gather(fetch_order, 1, _smallest(
        torch.gather(d_all, 1, fetch_order), k))
    return (torch.gather(g_all, 1, best), torch.gather(d_all, 1, best),
            fetch_alive.sum((1, 2)))


# ---------------------------------------------------------------- executor


def _collect_shards(counters: Counters, axis=STACKED
                    ) -> list[dict[str, int]]:
    """The single device→host transfer: (S_h,) counters, all-gathered
    across ``axis`` into (S,), → one dict per shard."""
    names = list(counters)
    vals = torch.stack([counters[n].to(torch.int64) for n in names])
    vals = axis.all_gather(vals, 1)
    return [dict(zip(names, col)) for col in vals.cpu().T.tolist()]


@dataclass
class ShardedExecutor:
    """Staged search over a ShardedIndex, with the same top-k as the
    unsharded ``SearchExecutor`` on the same database (see the module
    docstring for why) and per-shard ledgers folded under the
    parallel-shard overlap model.  On a mesh every rank runs it on its own
    shard with the same queries and returns the same answer and ledger."""

    sharded: ShardedIndex
    backend: object
    micro_batch: int | None = None
    refine_budget: int | None = None  # plan-level SSD budget override

    def execute(self, queries: torch.Tensor, *, k: int | None = None,
                cost: QueryCost | None = None, pad: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, QueryCost]:
        """Sharded FaTRQ search: (Q, k) GLOBAL ids, their exact squared-L2
        distances and the merged per-shard ledger.  ``pad=True`` pads each
        ragged micro-batch to its bucket under a validity mask, as
        ``SearchExecutor.execute`` does.  There is no front/finish split:
        the shards' stages run interleaved in one body.

        Traced, the ``execute`` span carries one ``front`` / ``refine`` /
        ``rerank`` event each with its stage's modeled time (``fused``:
        the shards' stages run interleaved, so there is no stage boundary
        to time apart) and the merged ledger."""
        si = self.sharded
        cfg = si.config
        k = k or cfg.final_k
        tr = trace.active()
        with trace.span("execute", track="query", front=si.front,
                        backend=self.backend.name, k=k,
                        budget=search_budget(cfg, k, self.refine_budget),
                        shards=si.n_shards, fused=True,
                        n_queries=int(queries.shape[0])) as sp_ex:
            ids, dists, shard_counts = self._search(queries, k=k, pad=pad)
            merged = self._fold(shard_counts)
            if tr is not None:
                for stage, tier in (("front", Tier.HBM),
                                    ("refine", Tier.CXL),
                                    ("rerank", Tier.SSD)):
                    tr.event(stage, track="query", parent=sp_ex.span.sid,
                             fused=True, model_s=merged.tier_seconds(tier))
                _attach_ledger(sp_ex, merged)
            if cost is not None:
                merged = cost.merge(merged)
        return ids, dists, merged

    def _search(self, queries: torch.Tensor, *, k: int | None = None,
                pad: bool = False):
        """(ids, distances, per-shard counts) of a search."""
        si = self.sharded
        cfg = si.config
        k = k or cfg.final_k
        budget = search_budget(cfg, k, self.refine_budget)
        body = registry.sharded_front(si.front).body
        axis = si.axis
        ids_parts, dist_parts = [], []
        counters: Counters = {}
        for chunk in iter_chunks(queries, self.micro_batch):
            n = chunk.shape[0]
            chunk, qvalid = _padded(chunk, pad, self.micro_batch)
            cands = body(chunk, si.front_rep, si.front_db, si.codebook,
                         si.pq_codes, qvalid=qvalid, axis=axis,
                         **dict(si.front_args))
            refined = self.backend.refine_sharded(
                chunk, cands, si.shard_trqs, k=k, bound=cfg.bound, z=cfg.z,
                mesh=axis)
            topk, topk_d, n_ssd = _rerank_survivors_sharded(
                si.x, si.gid, chunk, torch.stack([c.ids for c in cands]),
                torch.stack([c.list_rank for c in cands]), refined.est,
                refined.alive, k=k, budget=budget, axis=axis)
            ids_parts.append(topk[:n])
            dist_parts.append(topk_d[:n])
            _accumulate(counters, {n: torch.stack([c.counters[n]
                                                   for c in cands])
                                   for n in cands[0].counters})
            _accumulate(counters, refined.counters)
            _accumulate(counters, {"ssd_fetch": n_ssd})
        return (_cat(ids_parts), _cat(dist_parts),
                _collect_shards(counters, axis))

    def _fold(self, shard_counts: list[dict[str, int]]) -> QueryCost:
        """S Table-I ledgers, one per shard's counts, folded into one with
        ``merge_parallel`` (max time, summed bytes)."""
        si = self.sharded
        front_fold = registry.sharded_front(si.front).fold
        costs = [fold_counts(c, cost=None, config=si.config,
                             layout=si.layout, front_fold=front_fold)
                 for c in shard_counts]
        merged = costs[0]
        for c in costs[1:]:
            merged.merge_parallel(c)
        return merged


def make_sharded_executor(index, *, shards: int, front: str = "ivf",
                          backend: str = "reference",
                          micro_batch: int | None = None,
                          refine_budget: int | None = None, mesh=None
                          ) -> ShardedExecutor:
    """Memoized sharded-executor factory.

    A ``FaTRQIndex`` is partitioned once per (shards, front) and the
    partition kept on it; a ``ShardedIndex`` is used as it is.  With a
    ``mesh`` the stacked partition is placed on it
    (``ShardedIndex.place``) and the placement kept apart, per (shards,
    front, mesh): a stacked executor and a mesh executor never share a
    placement.  Executors are cached on the partition per (backend,
    micro_batch, refine_budget), so executors with another backend share
    one partition.
    """
    if isinstance(index, ShardedIndex):
        if (shards, front) != (index.n_shards, index.front):
            raise ValueError(f"the ShardedIndex has {index.n_shards} "
                             f"{index.front!r} shards, not {shards} "
                             f"{front!r} shards")
        if mesh is None or index.mesh is mesh:
            si = index
        elif index.mesh is not None:
            raise ValueError("the ShardedIndex is placed on another mesh")
        else:
            placed = index.__dict__.setdefault("_placed_cache", {})
            si = placed.get(mesh)
            if si is None:
                si = placed[mesh] = index.place(mesh)
    elif mesh is None:
        parts = index.__dict__.setdefault("_sharded_cache", {})
        si = parts.get((shards, front))
        if si is None:
            si = parts[(shards, front)] = partition_database(
                index, shards, front=front)
    else:
        placed = index.__dict__.setdefault("_placed_cache", {})
        si = placed.get((shards, front, mesh))
        if si is None:
            # a kept stacked partition is the placement's source; else a
            # fresh one, dropped once this rank's block is copied out
            stacked = index.__dict__.get("_sharded_cache", {}).get(
                (shards, front))
            if stacked is None:
                stacked = partition_database(index, shards, front=front)
            si = placed[(shards, front, mesh)] = stacked.place(mesh)
    cache = si.__dict__.setdefault("_executor_cache", {})
    key = (backend, micro_batch, refine_budget)
    ex = cache.get(key)
    if ex is None:
        ex = cache[key] = ShardedExecutor(
            sharded=si, backend=registry.make_backend(backend),
            micro_batch=micro_batch, refine_budget=refine_budget)
    return ex
