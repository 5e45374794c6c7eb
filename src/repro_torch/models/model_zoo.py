"""One model API over the four architecture families (the port of
``repro.models.model_zoo``).

    api = build_model(cfg)
    model = api.init(generator)                       # or device=
    logits, aux = api.forward(model, batch)           # prefill path
    cache = api.init_cache(model, batch_size, max_len)
    cache = api.prefill(model, batch, cache)
    logits, cache = api.decode_step(model, tokens, cache)

``batch`` is a dict: ``tokens`` for LMs, optionally ``embeds`` (VLM patch
embeddings) and ``positions`` (M-RoPE coordinates), and ``frames``
(precomputed audio frame embeddings) for the encoder-decoder, whose
``prefill`` encodes them into the cache.  The model is an ``nn.Module``
(``transformer.Transformer``, ``ssm_lm.XLSTM``, ``ssm_lm.Zamba`` or
``whisper.Whisper``, each with ``embed`` and ``embed_tokens``); the
functions run where its weights lie.  ``forward`` takes ``remat=`` and
``last_only=`` as the reference's does: with ``remat`` (the default) each
layer's activations are recomputed in the backward pass, when autograd
records one.  ``loss_fn`` is the training loss over a batch with
``labels``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm_lm, transformer, whisper


@dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init: Callable                # (generator=None, dtype, device=) → model
    forward: Callable             # (model, batch) → (logits, aux)
    init_cache: Callable          # (model, batch_size, max_len, dtype)
    decode_step: Callable         # (model, tokens, cache) → (logits, cache)
    prefill: Callable | None = None   # (model, batch, cache) → cache


def model_class(cfg: ArchConfig) -> type:
    """The ``nn.Module`` class of ``cfg``'s family, dispatched as
    ``build_model`` dispatches."""
    if cfg.enc_dec:
        return whisper.Whisper
    if cfg.family == "ssm":
        return ssm_lm.XLSTM
    if cfg.family == "hybrid":
        return ssm_lm.Zamba
    return transformer.Transformer


def build_model(cfg: ArchConfig) -> ModelApi:
    """The API of ``cfg``'s family, dispatched as the reference does:
    encoder-decoder → whisper, ``ssm`` → xlstm, ``hybrid`` → zamba2, every
    other family (dense, MoE, VLM) → the transformer.  The SSM families
    have no prefill (``prefill=None``), as in the reference."""
    if cfg.enc_dec:
        return ModelApi(
            cfg=cfg,
            init=lambda generator=None, dtype=torch.float32, *, device=None:
                whisper.init(cfg, generator=generator, device=device,
                             dtype=dtype),
            forward=lambda model, batch, **kw: whisper.forward(
                model, batch["frames"], batch["tokens"], cfg, **kw),
            init_cache=lambda model, b, s, dtype=torch.float32:
                whisper.init_cache(cfg, b, s, dtype,
                                   device=model.embed.device),
            decode_step=lambda model, t, c: whisper.decode_step(model, t, c,
                                                                cfg),
            prefill=lambda model, batch, cache: whisper.prefill_encoder(
                model, batch["frames"], cfg, cache),
        )
    if cfg.family == "ssm":
        return ModelApi(
            cfg=cfg,
            init=lambda generator=None, dtype=torch.float32, *, device=None:
                ssm_lm.xlstm_init(cfg, generator=generator, device=device,
                                  dtype=dtype),
            forward=lambda model, batch, **kw: ssm_lm.xlstm_forward(
                model, batch.get("tokens"), cfg, **kw),
            init_cache=lambda model, b, s, dtype=torch.float32:
                ssm_lm.xlstm_init_cache(cfg, b, dtype,
                                        device=model.embed.device),
            decode_step=lambda model, t, c: ssm_lm.xlstm_decode_step(
                model, t, c, cfg),
        )
    if cfg.family == "hybrid":
        return ModelApi(
            cfg=cfg,
            init=lambda generator=None, dtype=torch.float32, *, device=None:
                ssm_lm.zamba_init(cfg, generator=generator, device=device,
                                  dtype=dtype),
            forward=lambda model, batch, **kw: ssm_lm.zamba_forward(
                model, batch.get("tokens"), cfg, **kw),
            init_cache=lambda model, b, s, dtype=torch.float32:
                ssm_lm.zamba_init_cache(cfg, b, s, dtype,
                                        device=model.embed.device),
            decode_step=lambda model, t, c: ssm_lm.zamba_decode_step(
                model, t, c, cfg),
        )

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


def loss_fn(api: ModelApi, model, batch: dict, *, aux_weight: float = 0.01,
            **kw) -> torch.Tensor:
    """Next-token cross-entropy (+ ``aux_weight`` · the MoE aux loss), a
    0-d float32 tensor.  The label logit is gathered, where the reference
    contracts a one-hot: the one-hot adds exact zeros to it, so the two
    are the same float sum, and no (B, S, V) one-hot is built."""
    logits, aux = api.forward(model, batch, **kw)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1,
                               batch["labels"].long()[..., None])[..., 0]
    return (lse - label_logit).mean() + aux_weight * aux
