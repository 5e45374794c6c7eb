"""One model API over the architecture families (the port of
``repro.models.model_zoo``, transformer families only so far).

    api = build_model(cfg)
    model = api.init(generator)                       # or device=
    logits, aux = api.forward(model, batch)           # prefill path
    cache = api.init_cache(model, batch_size, max_len)
    cache = api.prefill(model, batch, cache)
    logits, cache = api.decode_step(model, tokens, cache)

``batch`` is a dict: ``tokens`` for LMs, optionally ``embeds`` (VLM patch
embeddings) and ``positions`` (M-RoPE coordinates).  The model is an
``nn.Module`` (``transformer.Transformer``); the functions run where its
weights lie.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init: Callable                # (generator=None, dtype, device=) → model
    forward: Callable             # (model, batch) → (logits, aux)
    init_cache: Callable          # (model, batch_size, max_len, dtype)
    decode_step: Callable         # (model, tokens, cache) → (logits, cache)
    prefill: Callable | None = None   # (model, batch, cache) → cache


def _not_ported(cfg: ArchConfig, modules: str) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name} ({cfg.family}) needs {modules}, which the PyTorch "
        f"port does not have yet")


def build_model(cfg: ArchConfig) -> ModelApi:
    """The API of ``cfg``'s family: the transformer for dense, MoE and
    VLM architectures.  Encoder-decoder (whisper), ``ssm`` (xlstm) and
    ``hybrid`` (zamba2) raise ``NotImplementedError`` naming the modules
    still to port."""
    if cfg.enc_dec:
        raise _not_ported(cfg, "repro_torch.models.whisper")
    if cfg.family == "ssm":
        raise _not_ported(cfg, "repro_torch.models.ssm_lm and "
                          "repro_torch.models.xlstm")
    if cfg.family == "hybrid":
        raise _not_ported(cfg, "repro_torch.models.ssm_lm and "
                          "repro_torch.models.mamba2")

    def fwd(model, batch, **kw):
        return transformer.forward(model, batch.get("tokens"), cfg,
                                   embeds=batch.get("embeds"),
                                   positions=batch.get("positions"), **kw)

    def prefill(model, batch, cache):
        return transformer.prefill(model, batch.get("tokens"), cfg, cache,
                                   embeds=batch.get("embeds"))[1]

    return ModelApi(
        cfg=cfg,
        init=lambda generator=None, dtype=torch.float32, *, device=None:
            transformer.init(cfg, generator=generator, device=device,
                             dtype=dtype),
        forward=fwd,
        init_cache=lambda model, b, s, dtype=torch.float32:
            transformer.init_cache(cfg, b, s, dtype,
                                   device=model.embed.device),
        decode_step=lambda model, t, c: transformer.decode_step(model, t, c,
                                                                cfg),
        prefill=prefill,
    )
