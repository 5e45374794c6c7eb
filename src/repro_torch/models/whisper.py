"""Whisper-style encoder-decoder (the whisper-medium backbone), the port of
``repro.models.whisper``.

The audio conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, T_frames, D) and adds learned positions.
The decoder: causal self-attention, cross-attention into the encoder
output, and a GELU MLP, with learned positions (MHA: n_kv_heads ==
n_heads).  ``jax.nn.gelu`` is the tanh approximation by default, so
``_mlp`` uses ``F.gelu(approximate="tanh")`` (the erf form differs by up
to ~5e-4 an activation).

The cache is ``{"k", "v": (L, B, max_len, KV, hd), "xk", "xv": (L, B,
enc_frames, KV, hd), "len": int}`` on the model's device:
``prefill_encoder`` fills the cross K/V, ``decode_step`` writes one
self-attention position in place and reads no device value on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import rms_norm


def max_dec(cfg) -> int:
    """Learned decoder positions: whisper stops at 448, the reference
    extends them to cover its 32k decode and prefill shapes."""
    return 32768 if cfg.vocab > 1000 else 128


class MLP(nn.Module):
    """``wi`` (D → F), ``wo`` (F → D)."""

    def __init__(self, d: int, f: int, kw: dict):
        super().__init__()
        self.wi = L.empty_linear(d, f, bias=False, **kw)
        self.wo = L.empty_linear(f, d, bias=False, **kw)


class EncBlock(nn.Module):
    def __init__(self, cfg, kw: dict):
        super().__init__()
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.attn = L.Attention(cfg, **kw)
        self.ln2 = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, kw)


class DecBlock(EncBlock):
    """An encoder block with ``lnx`` and ``xattn`` (cross-attention)."""

    def __init__(self, cfg, kw: dict):
        super().__init__(cfg, kw)
        self.lnx = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.xattn = L.Attention(cfg, **kw)


class Whisper(nn.Module):
    """``enc_pos`` (enc_frames, D), ``enc_blocks``, ``enc_norm``,
    ``embed`` (V, D), ``dec_pos`` (max_dec, D), ``dec_blocks``,
    ``final_norm`` and ``lm_head`` (D → V)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.d_model
        self.enc_pos = nn.Parameter(torch.empty((cfg.enc_frames, d), **kw))
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, kw)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_norm = nn.Parameter(torch.empty(d, **kw))
        self.embed = nn.Parameter(torch.empty((cfg.vocab, d), **kw))
        self.dec_pos = nn.Parameter(torch.empty((max_dec(cfg), d), **kw))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, kw)
                                        for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(d, **kw))
        self.lm_head = L.empty_linear(d, cfg.vocab, bias=False, **kw)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embed)


def init(cfg, *, generator: torch.Generator | None = None, device=None,
         dtype=torch.float32) -> Whisper:
    """Random weights on ``generator``'s device with the reference's
    distributions (positions and embeddings normal · 0.02); with no
    generator, one of seed 0 on ``device`` (the GPU unless given)."""
    generator = L.init_generator(generator, device)
    model = Whisper(cfg, device=generator.device, dtype=dtype)
    d, f = cfg.d_model, cfg.d_ff
    for pos in (model.enc_pos, model.dec_pos):
        L.dense_init(pos, generator, pos.shape[0], 0.02)
    L.dense_init(model.embed, generator, cfg.vocab, 0.02)
    for blk in list(model.enc_blocks) + list(model.dec_blocks):
        norms = [blk.ln1, blk.ln2]
        L.attn_params(blk.attn, cfg, generator)
        if isinstance(blk, DecBlock):
            norms.append(blk.lnx)
            L.attn_params(blk.xattn, cfg, generator)
        L.dense_init(blk.mlp.wi.weight, generator, d)
        L.dense_init(blk.mlp.wo.weight, generator, f)
        with torch.no_grad():
            for p in norms:
                p.fill_(1.0)
    with torch.no_grad():
        model.enc_norm.fill_(1.0)
        model.final_norm.fill_(1.0)
    L.dense_init(model.lm_head.weight, generator, d)
    return model


def _mlp(x: torch.Tensor, mlp: MLP) -> torch.Tensor:
    return mlp.wo(F.gelu(mlp.wi(x), approximate="tanh"))


def _enc_layer(blk, x, cfg):
    x = x + L.gqa_attention(rms_norm(x, blk.ln1, cfg.norm_eps), blk.attn,
                            cfg, sin=None, cos=None, causal=False)
    return x + _mlp(rms_norm(x, blk.ln2, cfg.norm_eps), blk.mlp)


def _dec_layer(blk, x, enc, cfg):
    x = x + L.gqa_attention(rms_norm(x, blk.ln1, cfg.norm_eps), blk.attn,
                            cfg, sin=None, cos=None, causal=True)
    kx, vx = L.project_kv(enc, blk.xattn, cfg)
    x = x + L.gqa_attention(rms_norm(x, blk.lnx, cfg.norm_eps), blk.xattn,
                            cfg, sin=None, cos=None, causal=False,
                            kv_override=(kx, vx))
    return x + _mlp(rms_norm(x, blk.ln2, cfg.norm_eps), blk.mlp)


def encode(model: Whisper, frames: torch.Tensor, cfg, *,
           remat: bool = True) -> torch.Tensor:
    """frames (B, T_f, D) precomputed frame embeddings (the frontend stub)
    → the normed encoder output (B, T_f, D); ``remat`` recomputes each
    layer in the backward pass."""
    x = frames + model.enc_pos[None, :frames.shape[1]]
    for blk in model.enc_blocks:
        x = L.remat_call(remat, _enc_layer, blk, x, cfg)
    return rms_norm(x, model.enc_norm, cfg.norm_eps)


def forward(model: Whisper, frames, tokens, cfg, *, remat: bool = True,
            last_only: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The teacher-forced pass → (logits (B, S, V), a zero aux loss).
    ``remat``: each encoder and decoder layer is recomputed in the
    backward pass, as the reference checkpoints them; it changes nothing
    where autograd records no graph."""
    enc = encode(model, frames, cfg, remat=remat)
    s = tokens.shape[1]
    x = model.embed_tokens(tokens) + model.dec_pos[None, :s]
    for blk in model.dec_blocks:
        x = L.remat_call(remat, _dec_layer, blk, x, enc, cfg)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return model.lm_head(x), torch.zeros((), dtype=torch.float32,
                                         device=x.device)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32, *,
               device=None) -> dict:
    """An empty cache on ``device`` (the GPU unless given)."""
    dev = resolve_device(device)
    lkv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    xkv = (cfg.n_layers, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(lkv, dtype=dtype, device=dev),
            "v": torch.zeros(lkv, dtype=dtype, device=dev),
            "xk": torch.zeros(xkv, dtype=dtype, device=dev),
            "xv": torch.zeros(xkv, dtype=dtype, device=dev), "len": 0}


@torch.no_grad()
def prefill_encoder(model: Whisper, frames, cfg, cache: dict) -> dict:
    """Encode the audio and write every decoder layer's cross-attention
    K/V into the caller's cache, which is returned (``len`` unchanged)."""
    xk, xv = cache["xk"], cache["xv"]
    if tuple(frames.shape[:2]) != tuple(xk.shape[1:3]):
        raise ValueError(f"frames of shape {tuple(frames.shape)} for a "
                         f"cache of {xk.shape[1]} x {xk.shape[2]} frames")
    enc = encode(model, frames, cfg, remat=False)
    for i, blk in enumerate(model.dec_blocks):
        xk[i], xv[i] = L.project_kv(enc, blk.xattn, cfg)
    return cache


@torch.no_grad()
def decode_step(model: Whisper, tokens, cache: dict, cfg
                ) -> tuple[torch.Tensor, dict]:
    """One decoder token at position ``cache["len"]`` against the
    self-attention cache and the fixed cross K/V → (logits (B, V), the
    caller's cache written in place, len + 1).  On a mesh the caches are
    this rank's shards: it writes its slot and KV heads of the new
    position (``layers.cache_offsets``)."""
    ck_all, cv_all = cache["k"], cache["v"]
    pos = cache["len"]
    seq0, head0, max_len = L.cache_offsets(cfg, ck_all.shape[3],
                                           ck_all.shape[2])
    if pos >= max_len:
        raise ValueError(f"the cache of {max_len} positions is full")
    slot = pos - seq0 if 0 <= pos - seq0 < ck_all.shape[2] else None
    heads = slice(head0, head0 + ck_all.shape[3])
    seq_axes, x_axes = L.cache_seq_axes(), L.cache_seq_axes("xk")
    x = model.embed_tokens(tokens) + model.dec_pos[None, pos:pos + 1]
    for i, blk in enumerate(model.dec_blocks):
        xn = rms_norm(x, blk.ln1, cfg.norm_eps)
        k_new, v_new = L.project_kv(xn, blk.attn, cfg)
        ck, cv = ck_all[i], cv_all[i]
        if slot is not None:
            ck[:, slot:slot + 1] = k_new[:, :, heads]
            cv[:, slot:slot + 1] = v_new[:, :, heads]
        x = x + L.gqa_attention(xn, blk.attn, cfg, sin=None, cos=None,
                                causal=True, offset=pos,
                                kv_len_valid=pos + 1, kv_override=(ck, cv),
                                seq_axes=seq_axes)
        x = x + L.gqa_attention(rms_norm(x, blk.lnx, cfg.norm_eps),
                                blk.xattn, cfg, sin=None, cos=None,
                                causal=False,
                                kv_override=(cache["xk"][i],
                                             cache["xv"][i]),
                                seq_axes=x_axes)
        x = x + _mlp(rms_norm(x, blk.ln2, cfg.norm_eps), blk.mlp)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    cache["len"] = pos + 1
    return model.lm_head(x[:, -1]), cache
