"""Decoder-only transformer LM for the dense, MoE and VLM architectures
(qwen2/2.5/1.5, qwen2-vl through M-RoPE and embedding inputs, gemma3's
local:global interleave, mixtral / phi3.5-moe through the MoE FFN): the
port of ``repro.models.transformer``.

One ``Block`` module per layer in an ``nn.ModuleList``, each with its
sliding window as a plain ``int`` (0 = full attention), where the
reference stacks the layers on a leading axis for ``lax.scan``.

The KV cache is a dict ``{"k", "v": (L, B, max_len, KV, hd), "len": int}``
whose length is a host ``int``: ``decode_step`` reads no device value, so
one step issues no host synchronize.  ``prefill`` and ``decode_step``
write the cache's tensors in place and return a dict with the new length.
On a mesh (``launch.steps``) the cache is this rank's shard, its chunk of
the sequence, its KV heads or both (``layers.cache_offsets``), and they
write only the positions and heads it holds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, moe_ffn, moe_params

# ------------------------------------------------------------------ flags


def layer_is_local(cfg, i: int) -> bool:
    """gemma3 pattern: ``ratio`` local layers then 1 global, repeating."""
    r = cfg.local_global_ratio
    if not r or not cfg.sliding_window:
        return bool(cfg.sliding_window)
    return (i % (r + 1)) != r


def layer_windows(cfg) -> list[int]:
    """The sliding window of each layer (0 = full attention)."""
    return [cfg.sliding_window if layer_is_local(cfg, i) else 0
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------- modules


class Block(nn.Module):
    def __init__(self, cfg, window: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.window = window
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.ln2 = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.attn = L.Attention(cfg, **kw)
        if cfg.is_moe:
            self.moe = MoE(cfg, **kw)
        else:
            self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, **kw)

    def ffn_out(self, z: torch.Tensor, cfg
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(FFN(z), MoE aux loss or None)."""
        if cfg.is_moe:
            return moe_ffn(z, self.moe, cfg)
        return L.swiglu(z, self.ffn), None


class Transformer(nn.Module):
    """The weights: ``embed`` (V, D), ``blocks``, ``final_norm`` (D,) and,
    unless the embeddings are tied, ``lm_head`` (D → V).  Allocated but not
    initialized: ``init`` draws them, ``interop.params_from_numpy`` copies
    the reference's."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model), **kw))
        self.blocks = nn.ModuleList(Block(cfg, w, **kw)
                                    for w in layer_windows(cfg))
        self.final_norm = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.lm_head = None if cfg.tie_embeddings else L.empty_linear(
            cfg.d_model, cfg.vocab, bias=False, **kw)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.lm_head is not None:
            return self.lm_head(x)
        return F.linear(x, self.embed)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embed)


# ------------------------------------------------------------------- init


def init(cfg, *, generator: torch.Generator | None = None, device=None,
         dtype=torch.float32) -> Transformer:
    """A model with random weights on ``generator``'s device, drawn from
    it: normal · fan_in^-0.5 for the projections, normal · 0.02 for the
    embeddings, ones for the norms, zeros for the biases, the reference's
    distributions.  With no generator, one of seed 0 on ``device`` (the
    GPU unless given)."""
    generator = L.init_generator(generator, device)
    model = Transformer(cfg, device=generator.device, dtype=dtype)
    L.dense_init(model.embed, generator, cfg.vocab, 0.02)
    for blk in model.blocks:
        with torch.no_grad():
            blk.ln1.fill_(1.0)
            blk.ln2.fill_(1.0)
        L.attn_params(blk.attn, cfg, generator)
        if cfg.is_moe:
            moe_params(blk.moe, cfg, generator)
        else:
            L.swiglu_params(blk.ffn, generator)
    with torch.no_grad():
        model.final_norm.fill_(1.0)
    if model.lm_head is not None:
        L.dense_init(model.lm_head.weight, generator, cfg.d_model)
    return model


# ---------------------------------------------------------------- forward


def _angles(cfg, positions, b: int, s: int, device):
    if cfg.rope_style == "none":
        return None, None
    if cfg.rope_style == "mrope":
        if positions is None:
            pos1 = torch.arange(s, device=device)[None].expand(b, s)
            positions = torch.stack([pos1] * 3, dim=1)          # (B, 3, S)
        return L.mrope_angles(positions, cfg.hd, cfg.rope_theta)
    if positions is None:
        positions = torch.arange(s, device=device)
    return L.rope_angles(positions, cfg.hd, cfg.rope_theta)


def _inputs(model: Transformer, tokens, embeds) -> torch.Tensor:
    return model.embed_tokens(tokens) if embeds is None else embeds


def forward(model: Transformer, tokens, cfg, *, embeds=None,
            positions=None, q_block: int = 0, remat: bool = True,
            last_only: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) int (or embeds (B, S, D) for stubbed frontends) →
    (logits (B, S, V), aux_loss).  last_only: the LM head on the final
    position only (B, 1, V).  ``remat``: each whole block is recomputed in
    the backward pass (only its input is kept), as the reference's
    ``jax.checkpoint`` of the block; it changes nothing where autograd
    records no graph."""
    x = _inputs(model, tokens, embeds)
    b, s = x.shape[0], x.shape[1]
    sin, cos = _angles(cfg, positions, b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(blk, x):
        h = L.gqa_attention(L.rms_norm(x, blk.ln1, cfg.norm_eps), blk.attn,
                            cfg, sin=sin, cos=cos, causal=True,
                            window=blk.window, q_block=q_block)
        x = x + h
        f, a = blk.ffn_out(L.rms_norm(x, blk.ln2, cfg.norm_eps), cfg)
        return x + f, a

    for blk in model.blocks:
        x, a = L.remat_call(remat, block, blk, x)
        if a is not None:
            aux = aux + a
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return model.logits(x), aux


# ----------------------------------------------------------------- decode


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32, *,
               device=None) -> dict:
    """An empty KV cache on ``device`` (the GPU unless given)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "len": 0}


@torch.no_grad()
def prefill(model: Transformer, tokens, cfg, cache: dict, *, embeds=None,
            q_block: int = 0) -> tuple[torch.Tensor, dict]:
    """Run the prompt, filling the cache from position 0 (positions past
    the prompt are zeroed); → (last position's logits (B, V), cache).
    The cache is the caller's dict, written in place (``k``, ``v`` and
    ``len``) and returned."""
    x = _inputs(model, tokens, embeds)
    b, s = x.shape[0], x.shape[1]
    ck, cv = cache["k"], cache["v"]
    seq0, head0, max_len = L.cache_offsets(cfg, ck.shape[3], ck.shape[2])
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{max_len}")
    # this rank's slots of the prompt (all of them off a mesh)
    lo, hi = min(max(s - seq0, 0), ck.shape[2]), min(s, seq0 + ck.shape[2])
    heads = slice(head0, head0 + ck.shape[3])
    sin, cos = _angles(cfg, None, b, s, x.device)
    for i, blk in enumerate(model.blocks):
        xn = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        k, v = L.project_kv(xn, blk.attn, cfg, sin, cos)
        h = L.gqa_attention(xn, blk.attn, cfg, sin=sin, cos=cos,
                            causal=True, window=blk.window,
                            kv_override=(k, v), q_block=q_block)
        x = x + h
        x = x + blk.ffn_out(L.rms_norm(x, blk.ln2, cfg.norm_eps), cfg)[0]
        ck[i, :, :lo] = k[:, seq0:hi, heads]
        cv[i, :, :lo] = v[:, seq0:hi, heads]
    ck[:, :, lo:] = 0
    cv[:, :, lo:] = 0
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    cache["len"] = s
    return model.logits(x[:, -1]), cache


@torch.no_grad()
def decode_step(model: Transformer, tokens, cache: dict, cfg
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode: tokens (B, 1) at position ``cache["len"]``
    against the filled cache → (logits (B, V), cache with len + 1).  The
    cache is the caller's dict, written in place and returned: unlike the
    reference's functional cache, no older copy stays valid."""
    x = model.embed_tokens(tokens)                      # (B, 1, D)
    b = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    pos = cache["len"]
    seq0, head0, max_len = L.cache_offsets(cfg, ck.shape[3], ck.shape[2])
    seq_axes = L.cache_seq_axes()
    if pos >= max_len:
        raise ValueError(f"the cache of {max_len} positions is full")
    # this rank's slot and KV heads of the new position, if it holds it
    slot = pos - seq0 if 0 <= pos - seq0 < ck.shape[2] else None
    heads = slice(head0, head0 + ck.shape[3])
    here = torch.arange(pos, pos + 1, device=x.device)
    if cfg.rope_style == "mrope":
        sin, cos = L.mrope_angles(here.expand(b, 3, 1), cfg.hd,
                                  cfg.rope_theta)
    else:
        sin, cos = _angles(cfg, here, b, 1, x.device)
    for i, blk in enumerate(model.blocks):
        xn = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        k_new, v_new = L.project_kv(xn, blk.attn, cfg, sin, cos)
        if slot is not None:
            ck[i, :, slot:slot + 1] = k_new[:, :, heads]
            cv[i, :, slot:slot + 1] = v_new[:, :, heads]
        h = L.gqa_attention(xn, blk.attn, cfg, sin=sin, cos=cos,
                            causal=True, window=blk.window, offset=pos,
                            kv_len_valid=pos + 1,
                            kv_override=(ck[i], cv[i]), seq_axes=seq_axes)
        x = x + h
        x = x + blk.ffn_out(L.rms_norm(x, blk.ln2, cfg.norm_eps), cfg)[0]
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    cache["len"] = pos + 1
    return model.logits(x[:, -1]), cache
