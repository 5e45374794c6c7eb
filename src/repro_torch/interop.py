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

``tiered_from_numpy`` carries a JAX ``TieredIndex`` across: the inner
index through ``index_from_numpy``, then its placement state as numpy.

``params_from_numpy`` carries a JAX transformer's parameter tree
(``jax.tree.map(np.asarray, api.init(key))``) into the port's
``models.transformer.Transformer``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.anns.pipeline import FaTRQIndex, PipelineConfig
from repro_torch.anns.stages import keep_graph
from repro_torch.anns.tiered import TieredIndex
from repro_torch.core.calibration import CalibrationModel
from repro_torch.core.decomposition import RecordScalars
from repro_torch.core.trq import TRQCodes, TRQLevel
from repro_torch.device import resolve_device
from repro_torch.index.graph import GraphIndex, draw_start
from repro_torch.index.ivf import IVFIndex
from repro_torch.memory.placement import TieredConfig
from repro_torch.models.transformer import Transformer
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


def tiered_from_numpy(arrays: dict[str, np.ndarray], placement: dict,
                      config: PipelineConfig, *, device=None,
                      tiered: TieredConfig | None = None) -> TieredIndex:
    """The port's ``TieredIndex`` in a JAX ``TieredIndex``'s state:
    ``arrays`` are its inner index's leaves (``index_from_numpy``);
    ``placement`` holds ``list_tier`` (JAX ``ti.list_tier``), ``heat``
    (``ti.heat.heat``), ``observations`` (``ti.heat.observations``) and
    ``generation``; ``tiered`` is the JAX index's ``TieredConfig``
    (default: the default config)."""
    ti = TieredIndex(index_from_numpy(arrays, config, device=device), tiered)
    tier = np.asarray(placement["list_tier"], np.int8)
    heat = np.asarray(placement["heat"], np.float64)
    if tier.shape != ti.list_tier.shape or heat.shape != ti.heat.heat.shape:
        raise ValueError(f"placement of {tier.shape[0]} lists and heat of "
                         f"{heat.shape[0]} for an index of "
                         f"{ti.list_tier.shape[0]} lists")
    ti.list_tier = tier.copy()
    ti.heat.heat = heat.copy()
    ti.heat.observations = int(placement["observations"])
    ti.generation = int(placement["generation"])
    return ti


def params_from_numpy(cfg, tree: dict, *, device=None,
                      dtype=torch.float32) -> Transformer:
    """The port's model of ``cfg`` with a JAX transformer's weights, on
    ``device`` (the GPU unless given).  ``tree`` is the JAX parameter tree
    as numpy: ``embed``, ``final_norm``, optional ``lm_head`` and
    ``blocks`` with a leading layer axis (``ln1``, ``ln2``,
    ``attn.wq/wk/wv/wo[/bq/bk/bv]``, ``ffn.wg/wu/wd`` or
    ``moe.router/wg/wu/wd``).  JAX stores a projection (in, out) and an
    ``nn.Linear`` (out, in), so those are transposed; the experts' weights
    keep JAX's layout."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev, dtype=dtype)

    def put(param: torch.Tensor, value, *, linear: bool = False) -> None:
        t = torch.from_numpy(np.array(value))
        if linear:
            t = t.T
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"a {tuple(t.shape)} weight for a "
                             f"{tuple(param.shape)} parameter")
        with torch.no_grad():
            param.copy_(t)

    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        put(model.lm_head.weight, tree["lm_head"], linear=True)
    blocks = tree["blocks"]
    for i, blk in enumerate(model.blocks):
        put(blk.ln1, blocks["ln1"][i])
        put(blk.ln2, blocks["ln2"][i])
        attn = blocks["attn"]
        for name in ("wq", "wk", "wv", "wo"):
            put(getattr(blk.attn, name).weight, attn[name][i], linear=True)
        if cfg.qkv_bias:
            for name in ("q", "k", "v"):
                put(getattr(blk.attn, f"w{name}").bias, attn[f"b{name}"][i])
        if cfg.is_moe:
            moe = blocks["moe"]
            put(blk.moe.router.weight, moe["router"][i], linear=True)
            for name in ("wg", "wu", "wd"):
                put(getattr(blk.moe, name), moe[name][i])
        else:
            for name in ("wg", "wu", "wd"):
                put(getattr(blk.ffn, name).weight, blocks["ffn"][name][i],
                    linear=True)
    return model
