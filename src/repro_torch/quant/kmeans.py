"""Lloyd's k-means: the shared trainer for IVF centroids and PQ codebooks.

Assignment is ``argmin_c (||c||² − 2x·c)``, one product per row chunk.  The
batched form trains B independent problems at once (PQ trains all M
subspaces together).  The centroid update sorts the rows by cluster
(stable) and sums each cluster's run in row order with a segmented reduce,
so a CUDA build adds in one order every run and is repeatable
(``index_add_`` adds with float atomics there).  The initial draw is an
explicit ``init_idx`` so the same draws reproduce the JAX build.
"""

from __future__ import annotations

import torch

from repro_torch.device import chunks

#: bytes of (rows, K) score matrix held per assignment chunk
_SCORE_BYTES = 1 << 28


def random_init(n: int, k: int, generator: torch.Generator) -> torch.Tensor:
    """k distinct row indices in [0, n) (the JAX ``choice(replace=False)``
    draw, from a torch generator)."""
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:k]


def assign_batched(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids (B, N) for x (B, N, D) against (B, K, D)."""
    b, n, _ = x.shape
    kk = centroids.shape[1]
    c_sq = (centroids * centroids).sum(-1)[:, None, :]
    out = torch.empty((b, n), dtype=torch.int64, device=x.device)
    rows = max(1, _SCORE_BYTES // (4 * b * kk))
    ct = centroids.transpose(1, 2)
    for a, e in chunks(n, rows):
        scores = torch.bmm(x[:, a:e], ct)
        out[:, a:e] = torch.argmin(c_sq - 2.0 * scores, dim=-1)
    return out


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids for x (N, D) against centroids (K, D)."""
    return assign_batched(x[None], centroids[None])[0]


def _update(x: torch.Tensor, ids: torch.Tensor, k: int):
    """Per-problem member means (B, K, D) and counts (B, K).  Each
    cluster's rows, in row order, are summed by one segmented reduce: no
    float atomics, so the same inputs give the same bits on every run."""
    b = x.shape[0]
    flat = (ids + k * torch.arange(b, device=x.device)[:, None]).reshape(-1)
    counts = torch.bincount(flat, minlength=b * k).reshape(b, k)
    order = torch.sort(ids, dim=1, stable=True).indices
    rows = torch.take_along_dim(x, order[:, :, None], dim=1)
    sums = torch.segment_reduce(rows, "sum", lengths=counts, axis=1,
                                unsafe=True)
    counts = counts.to(x.dtype)
    return sums / torch.clamp(counts, min=1.0)[:, :, None], counts


def _worst_fit(x: torch.Tensor, cents: torch.Tensor, ids: torch.Tensor
               ) -> torch.Tensor:
    """Per problem, the point farthest from its centroid (B, D); the first
    such point on ties, as ``jnp.argmax`` picks."""
    b, n, d = x.shape
    best = torch.full((b,), -1.0, dtype=x.dtype, device=x.device)
    arg = torch.zeros((b,), dtype=torch.int64, device=x.device)
    rows = max(1, _SCORE_BYTES // (4 * b * d))
    for a, e in chunks(n, rows):
        near = torch.take_along_dim(cents, ids[:, a:e, None], dim=1)
        dist = ((x[:, a:e] - near) ** 2).sum(-1)
        v, i = dist.max(dim=1)
        better = v > best
        best = torch.where(better, v, best)
        arg = torch.where(better, i + a, arg)
    return x[torch.arange(b, device=x.device), arg]


def kmeans_batched(x: torch.Tensor, k: int, iters: int,
                   init_idx: torch.Tensor) -> torch.Tensor:
    """Train B problems x (B, N, D) from rows ``init_idx`` (B, k); `iters`
    Lloyd steps.  An empty cluster is re-seeded at the worst-fit point."""
    cents = torch.take_along_dim(x, init_idx.long()[:, :, None], dim=1)
    for _ in range(iters):
        ids = assign_batched(x, cents)
        means, counts = _update(x, ids, k)
        empty = counts == 0
        if bool(empty.any()):
            worst = _worst_fit(x, cents, ids)
            means = torch.where(empty[:, :, None], worst[:, None, :], means)
        cents = means
    return cents


def kmeans(x: torch.Tensor, k: int, iters: int = 25, *,
           init_idx: torch.Tensor) -> torch.Tensor:
    """Train k centroids on x (N, D) from rows ``init_idx`` (k,)."""
    return kmeans_batched(x[None], k, iters, init_idx[None])[0]


def quantization_error(x: torch.Tensor, centroids: torch.Tensor
                       ) -> torch.Tensor:
    """Mean squared L2 distortion of the codebook on x (N, D), 0-d."""
    return ((x - centroids[assign(x, centroids)]) ** 2).sum(-1).mean()
