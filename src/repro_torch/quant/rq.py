"""Classic residual quantization, the baseline (Liu et al. / Yuan & Liu):
the port of ``repro.quant.rq``.

L stages of PQ, each encoding the residual of the stage before it;
decoding sums the stages' reconstructions (the non-progressive ADC of
§II-B that FaTRQ improves on: the baseline decodes every level for every
candidate).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.quant import pq


@dataclass(frozen=True)
class RQCodebook:
    stages: tuple[pq.PQCodebook, ...]


def train(x: torch.Tensor, m: int, k: int = 256, levels: int = 2,
          iters: int = 15, *, init_idx: torch.Tensor
          ) -> tuple[RQCodebook, torch.Tensor]:
    """Train ``levels`` stacked PQ stages on x (N, D); ``init_idx``
    (levels, M, k) holds each stage's initial rows (the reference draws
    each stage's from its own key).  Returns the codebook and the final
    residual."""
    if init_idx.shape[0] != levels:
        raise ValueError(f"{init_idx.shape[0]} levels of initial rows for "
                         f"{levels} levels")
    stages = []
    resid = x
    for lv in range(levels):
        cb = pq.train(resid, m, k, iters, init_idx=init_idx[lv])
        resid = resid - pq.decode(cb, pq.encode(cb, resid))
        stages.append(cb)
    return RQCodebook(stages=tuple(stages)), resid


def encode(rq: RQCodebook, x: torch.Tensor) -> torch.Tensor:
    """x (N, D) → codes (N, L, M) uint8."""
    out, resid = [], x
    for cb in rq.stages:
        c = pq.encode(cb, resid)
        resid = resid - pq.decode(cb, c)
        out.append(c)
    return torch.stack(out, dim=1)


def decode(rq: RQCodebook, codes: torch.Tensor, *,
           through_level: int | None = None) -> torch.Tensor:
    """The sum of the first ``through_level`` stages' reconstructions
    (every stage unless given)."""
    through = len(rq.stages) if through_level is None else through_level
    total = 0.0
    for lv in range(through):
        total = total + pq.decode(rq.stages[lv], codes[:, lv])
    return total


def adc_distances(rq: RQCodebook, q: torch.Tensor,
                  codes: torch.Tensor) -> torch.Tensor:
    """Full (all-level) ADC of one query q (D,): the baseline's
    always-decode path."""
    return ((decode(rq, codes) - q[None, :]) ** 2).sum(-1)
