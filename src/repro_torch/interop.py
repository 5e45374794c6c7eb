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

``params_from_numpy`` carries a JAX model's parameter tree
(``jax.tree.map(np.asarray, api.init(key))``) into the port's model of
the same family (``models.transformer.Transformer``,
``models.ssm_lm.XLSTM`` / ``Zamba`` or ``models.whisper.Whisper``), and
``adamw_from_numpy`` a JAX ``AdamWState`` into the port's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

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
from repro_torch.models.model_zoo import model_class
from repro_torch.models.transformer import Transformer
from repro_torch.quant.pq import PQCodebook
from repro_torch.train.optimizer import AdamWState


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


def _put(param: torch.Tensor, value, *, linear: bool = False) -> None:
    """Copy ``value`` into ``param``, transposed where it becomes an
    ``nn.Linear`` weight; a shape mismatch raises."""
    t = torch.from_numpy(np.array(value))
    if linear:
        t = t.T
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"a {tuple(t.shape)} weight for a "
                         f"{tuple(param.shape)} parameter")
    with torch.no_grad():
        param.copy_(t)


def _load(module: nn.Module, tree: dict, idx: tuple, done: set) -> None:
    """Each leaf of ``tree`` at the stacked index ``idx`` into the
    attribute of ``module`` of its name (recursing into sub-dicts); the
    parameters written are added to ``done``."""
    for name, value in tree.items():
        target = getattr(module, name, None)
        if target is None:
            raise ValueError(f"{type(module).__name__} has no {name!r}")
        if isinstance(value, dict):
            _load(target, value, idx, done)
            continue
        param = target.weight if isinstance(target, nn.Linear) else target
        _put(param, np.asarray(value)[idx],
             linear=isinstance(target, nn.Linear))
        done.add(id(param))


def _family_from_numpy(model: nn.Module, tree: dict) -> None:
    """The zamba2, xlstm and whisper trees: top-level leaves as they are,
    then each layer stack from its stacked subtree, (g, m, …) for a stack
    of groups and (n, …) for a stack of layers."""
    done: set = set()
    stacks = {name: value for name, value in tree.items()
              if isinstance(getattr(model, name, None), nn.ModuleList)}
    _load(model, {k: v for k, v in tree.items() if k not in stacks}, (),
          done)
    for name, sub in stacks.items():
        for i, item in enumerate(getattr(model, name)):
            layers = item if isinstance(item, nn.ModuleList) else [item]
            for j, layer in enumerate(layers):
                idx = (i, j) if isinstance(item, nn.ModuleList) else (i,)
                _load(layer, sub, idx, done)
    missing = [n for n, p in model.named_parameters() if id(p) not in done]
    if missing:
        raise ValueError(f"the tree has no value for {missing[:4]}")


def params_from_numpy(cfg, tree: dict, *, device=None,
                      dtype=torch.float32) -> nn.Module:
    """The port's model of ``cfg`` with a JAX parameter tree's weights,
    on ``device`` (the GPU unless given).  ``tree`` is the JAX tree as
    numpy, dispatched on ``cfg`` as ``models.build_model`` does.

    The transformer's: ``embed``, ``final_norm``, optional ``lm_head``
    and ``blocks`` with a leading layer axis (``ln1``, ``ln2``,
    ``attn.wq/wk/wv/wo[/bq/bk/bv]``, ``ffn.wg/wu/wd`` or
    ``moe.router/wg/wu/wd``).  zamba2's: ``groups`` stacked (g, per, …),
    ``shared_attn``, an optional ``tail`` stacked (tail, …).  xlstm's:
    ``mlstm_blocks`` stacked (g, m, …), ``slstm_blocks`` (g, …).
    whisper's: ``enc_blocks`` and ``dec_blocks`` stacked by layer,
    ``enc_pos``, ``dec_pos``.  JAX stores a projection (in, out) and an
    ``nn.Linear`` (out, in), so those are transposed; every other leaf
    (the experts' weights, ``conv``, ``r_gates``) keeps JAX's layout.  A
    shape mismatch, a leaf without a parameter and a parameter without a
    leaf raise."""
    dev = resolve_device(device)
    model = model_class(cfg)(cfg, device=dev, dtype=dtype)
    if not isinstance(model, Transformer):
        _family_from_numpy(model, tree)
        return model
    _put(model.embed, tree["embed"])
    _put(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        _put(model.lm_head.weight, tree["lm_head"], linear=True)
    blocks = tree["blocks"]
    for i, blk in enumerate(model.blocks):
        _put(blk.ln1, blocks["ln1"][i])
        _put(blk.ln2, blocks["ln2"][i])
        attn = blocks["attn"]
        for name in ("wq", "wk", "wv", "wo"):
            _put(getattr(blk.attn, name).weight, attn[name][i], linear=True)
        if cfg.qkv_bias:
            for name in ("q", "k", "v"):
                _put(getattr(blk.attn, f"w{name}").bias, attn[f"b{name}"][i])
        if cfg.is_moe:
            moe = blocks["moe"]
            _put(blk.moe.router.weight, moe["router"][i], linear=True)
            for name in ("wg", "wu", "wd"):
                _put(getattr(blk.moe, name), moe[name][i])
        else:
            for name in ("wg", "wu", "wd"):
                _put(getattr(blk.ffn, name).weight, blocks["ffn"][name][i],
                     linear=True)
    return model


def adamw_from_numpy(cfg, model: nn.Module, opt) -> AdamWState:
    """The port's ``AdamWState`` for ``model`` from a JAX one as numpy
    (``jax.tree.map(np.asarray, state)``): ``mu`` and ``nu`` are
    parameter-shaped trees, so each goes through ``params_from_numpy``
    into a shadow model on ``model``'s device and is read back by
    parameter name; ``step`` becomes a host int."""
    def moments(tree) -> dict:
        shadow = params_from_numpy(cfg, tree, device=model.embed.device,
                                   dtype=torch.float32)
        return {name: p.detach() for name, p in shadow.named_parameters()}

    mu, nu = moments(opt.mu), moments(opt.nu)
    names = [name for name, _ in model.named_parameters()]
    if list(mu) != names:
        raise ValueError("the optimizer state's parameters are not the "
                         "model's")
    return AdamWState(step=int(opt.step), mu=mu, nu=nu)
