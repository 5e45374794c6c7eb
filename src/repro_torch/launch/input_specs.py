"""Shape-and-dtype stand-ins for every (arch × shape) cell (the port of
``repro.launch.input_specs``): tensors on the ``meta`` device, which
carry a shape and a dtype and allocate nothing, where the JAX package
has ``ShapeDtypeStruct``s.  Shapes and dtypes are JAX's (bfloat16 ↔
``torch.bfloat16``, int32 tokens).

For [vlm]/[audio] archs the modality frontend is a stub: the specs hold
precomputed patch/frame embeddings.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.model_zoo import ModelApi, model_class


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      dtype=torch.bfloat16) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, s), torch.int32),
             "labels": sds((b, s), torch.int32)}
    if cfg.enc_dec:
        batch["frames"] = sds((b, cfg.enc_frames, cfg.d_model), dtype)
    if cfg.family == "vlm":
        # M-RoPE position triples (t, h, w) for mixed image-text batches
        batch["positions"] = sds((b, 3, s), torch.int32)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                        dtype=torch.bfloat16) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, s), torch.int32)}
    if cfg.enc_dec:
        batch["frames"] = sds((b, cfg.enc_frames, cfg.d_model), dtype)
    if cfg.family == "vlm":
        # dynamic-resolution patch embeddings (frontend stub): the prompt
        # is image patches + text, already embedded, at default positions
        batch["embeds"] = sds((b, s, cfg.d_model), dtype)
    return batch


def params_structs(api: ModelApi, dtype=torch.bfloat16) -> nn.Module:
    """The model of ``api``'s config on the meta device: its parameters'
    names, shapes and dtypes, nothing allocated."""
    return model_class(api.cfg)(api.cfg, device="meta", dtype=dtype)


def cache_structs(api: ModelApi, batch: int, max_len: int,
                  dtype=torch.bfloat16) -> dict:
    """The decode cache of ``batch`` rows and ``max_len`` positions, its
    tensors on the meta device (``len`` stays the host int 0)."""
    return api.init_cache(params_structs(api, dtype), batch, max_len, dtype)


def decode_token_specs(shape: ShapeConfig) -> torch.Tensor:
    return sds((shape.global_batch, 1), torch.int32)
