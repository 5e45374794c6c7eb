"""FaTRQ index build, the legacy ``search`` / ``baseline_search`` tuple
surfaces and ``recall_at_k``.

``build`` is the offline build (PQ → IVF → TRQ encode → index-driven
calibration).  The JAX build splits one PRNG key into its random draws;
here each draw is an explicit input (so a test can feed the JAX draws in)
and defaults to draws from one ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core import trq as trq_mod
from repro_torch.core.trq import TRQCodes
from repro_torch.device import resolve_device
from repro_torch.index import ivf as ivf_mod
from repro_torch.memory import QueryCost, RecordLayout
from repro_torch.quant import pq as pq_mod
from repro_torch.quant.kmeans import random_init


@dataclass(frozen=True)
class PipelineConfig:
    dim: int = 128
    pq_m: int = 16
    pq_k: int = 256
    nlist: int = 64
    nprobe: int = 8
    trq_levels: int = 1
    final_k: int = 10
    refine_budget: int | None = None   # max SSD fetches; None → max(4k, 32)
    bound: str = "cauchy"              # "cauchy" | "quantile"
    z: float = 3.0
    calib_fraction: float = 0.003      # §III-E: ~0.3%
    calib_pairs_per_sample: int = 8
    front: str = "ivf"
    backend: str | None = None         # None → "cuda" on a CUDA index,
                                       # "reference" on a CPU one
    micro_batch: int | None = None     # queries per device step; None = all


@dataclass(eq=False)
class FaTRQIndex:
    config: PipelineConfig
    codebook: pq_mod.PQCodebook
    pq_codes: torch.Tensor       # (N, M) uint8 — fast memory
    ivf: ivf_mod.IVFIndex
    trq: TRQCodes                # packed codes + scalars — far memory
    x: torch.Tensor              # (N, D) full precision — "SSD"
    layout: RecordLayout = field(init=False)

    def __post_init__(self):
        self.layout = RecordLayout(dim=self.config.dim, pq_m=self.config.pq_m,
                                   levels=self.config.trq_levels,
                                   store_rho=(self.config.bound == "cauchy"))

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def default_backend(self) -> str:
        if self.config.backend is not None:
            return self.config.backend
        return "cuda" if self.device.type == "cuda" else "reference"


def calibration_pairs(ivf: ivf_mod.IVFIndex, x: torch.Tensor,
                      samp: torch.Tensor, pairs_per_sample: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Pair each sampled record with members of its own inverted list (its
    local boundary, §III-E), drawn with ``np.random.default_rng(0)`` as the
    JAX build draws them, so the same samples give the same pairs."""
    list_ids = ivf_mod.assign_lists(ivf, x[samp]).cpu().numpy()
    lists_np = ivf.lists.cpu().numpy()
    lens_np = ivf.list_len.cpu().numpy()
    rng = np.random.default_rng(0)
    pairs_q, pairs_i = [], []
    for s, li in zip(samp.cpu().numpy(), list_ids):
        members = lists_np[li, :max(lens_np[li], 1)]
        members = members[(members >= 0) & (members != s)]  # no self-pairs
        if members.size == 0:
            continue
        take = rng.choice(members, size=min(pairs_per_sample, members.size),
                          replace=False)
        pairs_q.extend([s] * len(take))
        pairs_i.extend(take)
    return np.asarray(pairs_q, np.int64), np.asarray(pairs_i, np.int64)


def build(x, config: PipelineConfig, *, device=None,
          generator: torch.Generator | None = None,
          pq_init: torch.Tensor | None = None,
          ivf_init: torch.Tensor | None = None,
          calib_samples: torch.Tensor | None = None,
          calib_noise: Callable[[int, int], torch.Tensor] | None = None
          ) -> FaTRQIndex:
    """Offline build of ``x (N, D)`` on ``device`` (the GPU unless given).

    Draws: ``pq_init`` (M, pq_k) initial rows per PQ subspace, ``ivf_init``
    (nlist,) initial IVF centroid rows, ``calib_samples`` the sampled
    calibration records and ``calib_noise(P, D)`` the standard-normal
    perturbation of the P calibration queries (a function, since P is
    known only once the pairs are drawn).  Each one not given is drawn
    from ``generator`` (seed 0 on ``device`` by default).
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
    n = x.shape[0]
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    if pq_init is None:
        pq_init = torch.stack([random_init(n, config.pq_k, generator)
                               for _ in range(config.pq_m)])
    codebook = pq_mod.train(x, config.pq_m, config.pq_k,
                            init_idx=pq_init.to(dev))
    pq_codes = pq_mod.encode(codebook, x)
    x_c = pq_mod.decode(codebook, pq_codes)

    if ivf_init is None:
        ivf_init = random_init(n, config.nlist, generator)
    ivf = ivf_mod.build(x, config.nlist, init_idx=ivf_init.to(dev))
    trq = trq_mod.encode_database(x, x_c, num_levels=config.trq_levels)

    if calib_samples is None:
        n_samples = max(int(config.calib_fraction * n), 32)
        calib_samples = random_init(n, n_samples, generator)
    pair_q, pair_i = calibration_pairs(ivf, x, calib_samples.to(dev),
                                       config.calib_pairs_per_sample)
    pair_q = torch.from_numpy(pair_q).to(dev)
    pair_i = torch.from_numpy(pair_i).to(dev)
    if calib_noise is None:
        noise = torch.randn((len(pair_q), x.shape[1]), generator=generator,
                            device=generator.device)
    else:
        noise = calib_noise(len(pair_q), x.shape[1])
    # calibration queries: the sampled records, slightly perturbed so that
    # no pair has d = 0
    qs = x[pair_q] + 0.01 * noise.to(dev)
    trq = trq_mod.calibrate(trq, qs, x, x_c, pair_i)
    return FaTRQIndex(config=config, codebook=codebook, pq_codes=pq_codes,
                      ivf=ivf, trq=trq, x=x)


def search(index, queries, *, k: int | None = None,
           cost: QueryCost | None = None, front: str | None = None,
           backend: str | None = None, shards: int | None = None,
           micro_batch: int | None = None, mesh=None
           ) -> tuple[torch.Tensor, QueryCost]:
    """FaTRQ search → ((Q, k) ids, the traffic ledger): a shim over
    ``Database.wrap(index).query`` with the keywords as the plan (use
    ``Database`` for the distances too).  ``index`` may be any layout's
    index; it runs where its tensors lie.  ``mesh`` runs ``shards``
    across processes (``Database.query``)."""
    from repro_torch.anns.api import Database, QueryPlan
    res = Database.wrap(index).query(
        queries, plan=QueryPlan(front=front, backend=backend, shards=shards,
                                k=k, micro_batch=micro_batch), cost=cost,
        mesh=mesh)
    return res.ids, res.cost


def baseline_search(index, queries, *, k: int | None = None,
                    front: str | None = None
                    ) -> tuple[torch.Tensor, QueryCost]:
    """The no-refinement baseline (coarse ADC, then an exact rerank of the
    whole candidate list from SSD) → (ids, ledger): a shim over
    ``QueryPlan(mode="baseline")``."""
    from repro_torch.anns.api import Database, QueryPlan
    res = Database.wrap(index).query(
        queries, plan=QueryPlan(front=front, k=k, mode="baseline"))
    return res.ids, res.cost


def recall_at_k(pred, gt, k: int) -> float:
    """recall@k with gt (Q, ≥k); a repeated prediction counts once."""
    p = np.asarray(torch.as_tensor(pred).cpu())[:, :k]
    g = np.asarray(torch.as_tensor(gt).cpu())[:, :k]
    kk = p.shape[1]
    hit = (p[:, :, None] == g[:, None, :]).any(axis=2)
    first = ~((p[:, :, None] == p[:, None, :])
              & np.tril(np.ones((kk, kk), bool), -1)[None]).any(axis=2)
    return float((hit & first).sum()) / (p.shape[0] * k)
