"""Synthetic clustered embeddings standing in for Wiki-88M / LAION-100M.

Gaussian-mixture clusters with anisotropic spread (heavy leading
directions) and unit norms; queries are perturbed database points.  Made
from a ``torch.Generator`` on the target device, so a 1M × 768 set costs no
host time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

#: queries per brute-force step (bounds the (q, N) distance block)
_GT_QUERIES = 64
#: entries ``smallest_k`` selects beyond the k it returns, so that a tie
#: with the kth rarely reaches the selection's edge
_SELECT_MARGIN = 16


class Dataset(NamedTuple):
    x: torch.Tensor          # (N, D) database vectors
    queries: torch.Tensor    # (Q, D)
    gt: torch.Tensor         # (Q, k_gt) exact top-k ids


def make_embeddings(generator: torch.Generator, n: int, d: int, *,
                    clusters: int = 64, spread: float = 0.35,
                    decay: float = 0.7) -> torch.Tensor:
    """Clustered, anisotropic, unit-norm embeddings on the generator's
    device."""
    dev = generator.device
    centers = torch.randn((clusters, d), generator=generator, device=dev)
    centers = centers / torch.linalg.vector_norm(centers, dim=-1,
                                                 keepdim=True)
    ids = torch.randint(0, clusters, (n,), generator=generator, device=dev)
    scales = decay ** (torch.arange(d, device=dev) / max(d / 16.0, 1.0))
    x = torch.randn((n, d), generator=generator, device=dev)
    x.mul_(scales[None, :] * spread).add_(centers[ids])
    return x.div_(torch.linalg.vector_norm(x, dim=-1, keepdim=True))


def smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest entries of each row of ``d``, in the
    order a full stable sort gives them (lower position first on ties, as
    ``jax.lax.top_k``), without sorting whole rows: ``torch.topk`` selects
    k + ``_SELECT_MARGIN`` entries, which are ordered by (value,
    position).  Where the last selected value equals the kth, entries tied
    with the kth may lie outside the selection, so those rows take the
    full stable sort."""
    if k + _SELECT_MARGIN >= d.shape[-1]:
        return torch.sort(d, dim=-1, stable=True).indices[..., :k]
    vals, pos = torch.topk(d, k + _SELECT_MARGIN, dim=-1, largest=False,
                           sorted=False)
    pos, by_pos = torch.sort(pos, dim=-1)
    vals = torch.gather(vals, -1, by_pos)
    vals, by_val = torch.sort(vals, dim=-1, stable=True)
    out = torch.gather(pos, -1, by_val[..., :k])
    tied = vals[..., -1] == vals[..., k - 1]
    if bool(tied.any()):
        out[tied] = torch.sort(d[tied], dim=-1, stable=True).indices[..., :k]
    return out


def brute_force_topk(x: torch.Tensor, queries: torch.Tensor, k: int, *,
                     block: int = _GT_QUERIES) -> torch.Tensor:
    """Exact top-k ids under L2, blocked over queries, lower id first on
    ties as ``jax.lax.top_k`` (``smallest_k``).  Each block's distances are
    ||x||² − 2·q·x in float32, as the JAX package computes them (the
    product scaled in place: −2·p + ||x||² is x_sq − 2·p to the bit)."""
    x_sq = (x * x).sum(-1)
    out = []
    for i in range(0, queries.shape[0], block):
        d = queries[i:i + block] @ x.T
        d.mul_(-2.0).add_(x_sq)
        out.append(smallest_k(d, k))
    return torch.cat(out, dim=0)


def make_dataset(*, n: int = 20_000, d: int = 128, n_queries: int = 128,
                 k_gt: int = 100, clusters: int = 64,
                 query_noise: float = 0.25,
                 generator: torch.Generator | None = None,
                 device=None) -> Dataset:
    """Dataset with exact ground truth, on ``device`` (the GPU unless given;
    ``generator`` defaults to seed 0 there)."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)) \
            .manual_seed(0)
    dev = generator.device
    x = make_embeddings(generator, n, d, clusters=clusters)
    pick = torch.randint(0, n, (n_queries,), generator=generator, device=dev)
    noise = torch.randn((n_queries, d), generator=generator, device=dev)
    q = x[pick] + query_noise * noise / d ** 0.5
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return Dataset(x=x, queries=q, gt=brute_force_topk(x, q, k_gt))


def split_tokens(tokens: torch.Tensor) -> dict[str, torch.Tensor]:
    """A (B, S+1) token draw → ``{"tokens": (B, S), "labels": (B, S)}``,
    each label the next token."""
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def make_token_batch(generator: torch.Generator, batch: int, seq_len: int,
                     vocab: int, *, device=None) -> dict[str, torch.Tensor]:
    """A synthetic LM training batch (tokens + next-token labels) on
    ``device`` (the GPU unless given).  The (B, S+1) int64 draw is made on
    ``generator``, a CPU generator, and then moved, so a run on the CPU
    and one on the GPU see the same tokens."""
    toks = torch.randint(0, vocab, (batch, seq_len + 1), generator=generator,
                         dtype=torch.int64)
    return split_tokens(toks.to(resolve_device(device)))
