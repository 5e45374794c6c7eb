"""IVF index (inverted file): the paper's primary front.

Build: k-means centroids, nearest-centroid assignment, fixed-capacity
inverted lists padded with -1.  Query: rank lists by centroid distance and
gather the members of the nprobe nearest (``anns.stages``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.quant.kmeans import assign, kmeans


@dataclass(frozen=True)
class IVFIndex:
    centroids: torch.Tensor   # (nlist, D)
    lists: torch.Tensor       # (nlist, cap) int32, -1 padded
    list_len: torch.Tensor    # (nlist,) int32

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.lists.shape[1]


def fill_lists(ids: np.ndarray, nlist: int, cap: int
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """Bucketize ``ids`` (N,) into a (nlist, cap') id matrix (-1 padded)
    plus per-list lengths.  No record is dropped: a list longer than
    ``cap`` spills the capacity (``n_spilled`` counts the rows past it).
    Members keep ascending record order (stable argsort)."""
    n = ids.shape[0]
    counts = np.bincount(ids, minlength=nlist).astype(np.int32)
    n_spilled = int(np.maximum(counts - cap, 0).sum())
    cap = max(cap, int(counts.max()) if n else 1, 1)
    order = np.argsort(ids, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n) - starts[ids[order]]
    lists = np.full((nlist, cap), -1, np.int32)
    lists[ids[order], pos] = order
    return lists, counts, n_spilled


def build(x: torch.Tensor, nlist: int, *, init_idx: torch.Tensor,
          iters: int = 20, cap_factor: float = 3.0) -> IVFIndex:
    """Train centroids from rows ``init_idx`` and fill the lists (host-side
    fill; cap = cap_factor·N/nlist + 1, spilled past when a list is hotter)."""
    n = x.shape[0]
    centroids = kmeans(x, nlist, iters, init_idx=init_idx)
    ids = assign(x, centroids).cpu().numpy()
    lists, lens, _ = fill_lists(ids, nlist, int(cap_factor * n / nlist) + 1)
    return IVFIndex(centroids=centroids,
                    lists=torch.from_numpy(lists).to(x.device),
                    list_len=torch.from_numpy(lens).to(x.device))


def rank_centroid_lists(centroids: torch.Tensor, queries: torch.Tensor, *,
                        nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Squared-L2 centroid ranking → (distances (Q, nlist), the nprobe
    nearest list ids (Q, nprobe), the lower list first on ties as
    ``lax.top_k``: a stable sort)."""
    d = ((queries[:, None, :] - centroids[None]) ** 2).sum(-1)
    return d, torch.sort(d, dim=-1, stable=True).indices[..., :nprobe]


def probe_batch(index: IVFIndex, qs: torch.Tensor, *, nprobe: int
                ) -> torch.Tensor:
    """Candidate ids of queries qs (Q, D): the members of each query's
    ``nprobe`` nearest lists (``rank_centroid_lists``), (Q, nprobe·cap)
    int32 with -1 pads."""
    _, top = rank_centroid_lists(index.centroids, qs, nprobe=nprobe)
    return index.lists[top].reshape(qs.shape[0], -1)


def probe(index: IVFIndex, q: torch.Tensor, *, nprobe: int) -> torch.Tensor:
    """``probe_batch`` for one query q (D,) → (nprobe·cap,)."""
    return probe_batch(index, q[None], nprobe=nprobe)[0]


def assign_lists(index: IVFIndex, x: torch.Tensor) -> torch.Tensor:
    """Which inverted list each vector belongs to (nearest centroid)."""
    return assign(x, index.centroids)
