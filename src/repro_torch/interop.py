"""Load an index built by the JAX package from its leaves as numpy arrays.

Keys are the JAX ``FaTRQIndex`` field paths: ``codebook.codebooks``,
``pq_codes``, ``ivf.centroids``, ``ivf.lists``, ``ivf.list_len``,
``trq.levels.{i}.packed`` / ``.proj`` / ``.norm`` / ``.rho``,
``trq.scalars.delta_sq`` / ``.cross`` / ``.rho`` / ``.norm``,
``trq.model.w`` / ``.bias`` / ``.resid_std`` and ``x``; optionally
``graph.neighbors`` (the JAX ``stages.graph_for(index).neighbors``) and
``graph.start`` (the JAX search's start draw,
``jax.random.randint(PRNGKey(0), (beam,), 0, n)``), which go into the
port's graph cache so that both packages traverse one graph.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.anns.pipeline import FaTRQIndex, PipelineConfig
from repro_torch.anns.stages import keep_graph
from repro_torch.core.calibration import CalibrationModel
from repro_torch.core.decomposition import RecordScalars
from repro_torch.core.trq import TRQCodes, TRQLevel
from repro_torch.device import resolve_device
from repro_torch.index.graph import GraphIndex, draw_start
from repro_torch.index.ivf import IVFIndex
from repro_torch.quant.pq import PQCodebook


def index_from_numpy(arrays: dict[str, np.ndarray], config: PipelineConfig,
                     *, device=None) -> FaTRQIndex:
    """The port's index from a JAX index's leaves (see module doc)."""
    dev = resolve_device(device)

    def t(key: str) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arrays[key])).to(dev)

    levels = tuple(
        TRQLevel(*(t(f"trq.levels.{i}.{f}")
                   for f in ("packed", "proj", "norm", "rho")))
        for i in range(config.trq_levels))
    x = t("x")
    trq = TRQCodes(
        dim=x.shape[1], levels=levels,
        scalars=RecordScalars(*(t(f"trq.scalars.{f}")
                                for f in ("delta_sq", "cross", "rho",
                                          "norm"))),
        model=CalibrationModel(*(t(f"trq.model.{f}")
                                 for f in ("w", "bias", "resid_std"))))
    index = FaTRQIndex(
        config=config, codebook=PQCodebook(t("codebook.codebooks")),
        pq_codes=t("pq_codes"),
        ivf=IVFIndex(t("ivf.centroids"), t("ivf.lists"), t("ivf.list_len")),
        trq=trq, x=x)
    if "graph.neighbors" in arrays:
        neighbors = t("graph.neighbors").int()
        start = t("graph.start").int() if "graph.start" in arrays else \
            draw_start(x.shape[0], torch.Generator(device=dev).manual_seed(0))
        keep_graph(index, GraphIndex(neighbors=neighbors, start=start))
    return index
