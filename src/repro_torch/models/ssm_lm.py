"""SSM and hybrid language models, the port of ``repro.models.ssm_lm``:
xlstm-1.3b (mLSTM blocks with a periodic sLSTM) and zamba2 (a Mamba-2
backbone with one shared attention + SwiGLU block applied after every
group).

The reference organizes each layer stack as groups for ``lax.scan``: a
group is ``m`` homogeneous inner layers and the special layer.  Here each
stack is an ``nn.ModuleList`` of groups, each an ``nn.ModuleList`` of its
inner layers, with the reference's names (``mlstm_blocks``,
``slstm_blocks``; ``groups``, ``tail``).  zamba2's attention block is
one module (``shared_attn``) used at every attention position.

The caches mirror the reference's trees with a host-``int`` ``"len"``:
xlstm ``{"m": mLSTM state (g, m, …), "s": sLSTM state (g, …)}``, zamba2
``{"ssm": Mamba state (g, per, …), "attn_k", "attn_v": (g, B, max_len,
KV, hd)[, "tail_ssm": (tail, …)]}``.  Their tensors lie on the model's
device and a decode step writes them in place and reads no device value
on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2, xlstm
from repro_torch.models.layers import rms_norm


class _LM(nn.Module):
    """``embed`` (V, D), ``final_norm`` (D,) and ``lm_head`` (D → V)."""

    def __init__(self, cfg, kw: dict):
        super().__init__()
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              **kw))
        self.final_norm = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.lm_head = L.empty_linear(cfg.d_model, cfg.vocab, bias=False,
                                      **kw)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embed)

    def head(self, x: torch.Tensor, cfg) -> torch.Tensor:
        return self.lm_head(rms_norm(x, self.final_norm, cfg.norm_eps))

    def draw_io(self, cfg, generator: torch.Generator) -> None:
        L.dense_init(self.embed, generator, cfg.vocab, 0.02)
        with torch.no_grad():
            self.final_norm.fill_(1.0)
        L.dense_init(self.lm_head.weight, generator, cfg.d_model)


class _Normed(nn.Module):
    """A pre-norm residual layer: ``ln`` (D,) and its block under
    ``name``."""

    def __init__(self, cfg, name: str, block: nn.Module, kw: dict):
        super().__init__()
        self.ln = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.add_module(name, block)


def _ones(*params) -> None:
    with torch.no_grad():
        for p in params:
            p.fill_(1.0)


# ------------------------------------------------------------------ xLSTM


def xlstm_groups(cfg) -> tuple[int, int]:
    """(n_groups, mlstm_per_group): layers = g·(m+1) with one sLSTM a
    group."""
    period = cfg.slstm_every or cfg.n_layers
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers are not groups of "
                         f"{period}")
    return cfg.n_layers // period, period - 1


class XLSTM(_LM):
    """``mlstm_blocks`` (g groups of m layers ``ln`` + ``mlstm``),
    ``slstm_blocks`` (g layers ``ln`` + ``slstm``)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        kw = dict(device=device, dtype=dtype)
        super().__init__(cfg, kw)
        g, m = xlstm_groups(cfg)
        self.mlstm_blocks = nn.ModuleList(
            nn.ModuleList(_Normed(cfg, "mlstm", xlstm.MLSTM(cfg, **kw), kw)
                          for _ in range(m)) for _ in range(g))
        self.slstm_blocks = nn.ModuleList(
            _Normed(cfg, "slstm", xlstm.SLSTM(cfg, **kw), kw)
            for _ in range(g))


def xlstm_init(cfg, *, generator: torch.Generator | None = None,
               device=None, dtype=torch.float32) -> XLSTM:
    """Random weights on ``generator``'s device with the reference's
    distributions (with no generator, one of seed 0 on ``device``, the
    GPU unless given)."""
    generator = L.init_generator(generator, device)
    model = XLSTM(cfg, device=generator.device, dtype=dtype)
    model.draw_io(cfg, generator)
    for group, slayer in zip(model.mlstm_blocks, model.slstm_blocks):
        for layer in group:
            _ones(layer.ln)
            xlstm.mlstm_params(layer.mlstm, cfg, generator)
        _ones(slayer.ln)
        xlstm.slstm_params(slayer.slstm, cfg, generator)
    return model


def xlstm_forward(model: XLSTM, tokens, cfg, *, embeds=None,
                  remat: bool = True, last_only: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) (or ``embeds`` (B, S, D)) → (logits (B, S, V), a zero
    aux loss).  ``remat``: each mLSTM layer is recomputed in the backward
    pass, as the reference checkpoints it (the sLSTM layers are not); it
    changes nothing where autograd records no graph."""
    x = model.embed_tokens(tokens) if embeds is None else embeds

    def m_layer(layer, x):
        return x + xlstm.mlstm_forward(rms_norm(x, layer.ln, cfg.norm_eps),
                                       layer.mlstm, cfg)

    for group, slayer in zip(model.mlstm_blocks, model.slstm_blocks):
        for layer in group:
            x = L.remat_call(remat, m_layer, layer, x)
        x = x + xlstm.slstm_forward(rms_norm(x, slayer.ln, cfg.norm_eps),
                                    slayer.slstm, cfg)
    if last_only:
        x = x[:, -1:]
    return model.head(x, cfg), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def xlstm_init_cache(cfg, batch: int, dtype=torch.float32, *,
                     device=None) -> dict:
    """The recurrent state of every layer on ``device`` (the GPU unless
    given); it does not grow with the sequence."""
    g, m = xlstm_groups(cfg)
    dev = resolve_device(device)
    return {"m": xlstm.mlstm_init_state(cfg, batch, dtype, device=dev,
                                        lead=(g, m)),
            "s": xlstm.slstm_init_state(cfg, batch, dtype, device=dev,
                                        lead=(g,)),
            "len": 0}


@torch.no_grad()
def xlstm_decode_step(model: XLSTM, tokens, cache: dict, cfg
                      ) -> tuple[torch.Tensor, dict]:
    """tokens (B, 1) → (logits (B, V), cache with len + 1); the cache is
    the caller's dict, written in place and returned.  Each layer's state
    goes through ``layers.layer_state`` (on a mesh: whole but for the
    batch rows while the layer runs)."""
    x = model.embed_tokens(tokens)                      # (B, 1, D)
    for gi, (group, slayer) in enumerate(zip(model.mlstm_blocks,
                                             model.slstm_blocks)):
        for mi, layer in enumerate(group):
            with L.layer_state(cache["m"], (gi, mi), "m") as state:
                y, _ = xlstm.mlstm_step(rms_norm(x, layer.ln, cfg.norm_eps),
                                        state, layer.mlstm, cfg)
            x = x + y
        with L.layer_state(cache["s"], (gi,), "s") as state:
            y, _ = xlstm.slstm_step(rms_norm(x, slayer.ln, cfg.norm_eps),
                                    state, slayer.slstm, cfg)
        x = x + y
    cache["len"] += 1
    return model.head(x[:, -1], cfg), cache


# ------------------------------------------------------------------ zamba2


def zamba_groups(cfg) -> tuple[int, int, int]:
    """(n_groups, mamba_per_group, tail_layers)."""
    per = cfg.attn_every
    g = cfg.n_layers // per
    return g, per, cfg.n_layers - g * per


class SharedAttention(nn.Module):
    """The one attention + SwiGLU block: ``ln1``, ``attn``, ``ln2``,
    ``ffn``."""

    def __init__(self, cfg, kw: dict):
        super().__init__()
        self.ln1 = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.attn = L.Attention(cfg, **kw)
        self.ln2 = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, **kw)


class Zamba(_LM):
    """``groups`` (g groups of ``per`` layers ``ln`` + ``mamba``),
    ``shared_attn`` and ``tail`` (the remaining Mamba layers, or None)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        kw = dict(device=device, dtype=dtype)
        super().__init__(cfg, kw)
        g, per, tail = zamba_groups(cfg)

        def layers(n):
            return nn.ModuleList(
                _Normed(cfg, "mamba", mamba2.Mamba(cfg, **kw), kw)
                for _ in range(n))

        self.groups = nn.ModuleList(layers(per) for _ in range(g))
        self.shared_attn = SharedAttention(cfg, kw)
        self.tail = layers(tail) if tail else None


def zamba_init(cfg, *, generator: torch.Generator | None = None,
               device=None, dtype=torch.float32) -> Zamba:
    """As ``xlstm_init``, for zamba2."""
    generator = L.init_generator(generator, device)
    model = Zamba(cfg, device=generator.device, dtype=dtype)
    model.draw_io(cfg, generator)
    for layer in [lay for group in model.groups for lay in group] \
            + list(model.tail or ()):
        _ones(layer.ln)
        mamba2.mamba_params(layer.mamba, cfg, generator)
    sp = model.shared_attn
    _ones(sp.ln1, sp.ln2)
    L.attn_params(sp.attn, cfg, generator)
    L.swiglu_params(sp.ffn, generator)
    return model


def _zamba_attn(x, sp: SharedAttention, cfg, *, sin, cos, q_block=0):
    h = L.gqa_attention(rms_norm(x, sp.ln1, cfg.norm_eps), sp.attn, cfg,
                        sin=sin, cos=cos, causal=True, q_block=q_block)
    x = x + h
    return x + L.swiglu(rms_norm(x, sp.ln2, cfg.norm_eps), sp.ffn)


def _mamba_layer(layer, x, cfg):
    return x + mamba2.mamba_forward(rms_norm(x, layer.ln, cfg.norm_eps),
                                    layer.mamba, cfg)


def _mamba_layers(x, layers, cfg, remat: bool):
    """Each Mamba-2 layer in turn, recomputed in the backward pass under
    ``remat`` (the reference checkpoints each one)."""
    for layer in layers:
        x = L.remat_call(remat, _mamba_layer, layer, x, cfg)
    return x


def zamba_forward(model: Zamba, tokens, cfg, *, embeds=None,
                  remat: bool = True, last_only: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """As ``xlstm_forward``, for zamba2 (RoPE over positions 0..S−1 in
    the shared attention); ``remat`` recomputes each Mamba-2 layer in the
    backward pass (not the shared attention block), as the reference."""
    x = model.embed_tokens(tokens) if embeds is None else embeds
    sin, cos = L.rope_angles(torch.arange(x.shape[1], device=x.device),
                             cfg.hd, cfg.rope_theta)
    for group in model.groups:
        x = _zamba_attn(_mamba_layers(x, group, cfg, remat),
                        model.shared_attn, cfg, sin=sin, cos=cos)
    if model.tail is not None:
        x = _mamba_layers(x, model.tail, cfg, remat)
    if last_only:
        x = x[:, -1:]
    return model.head(x, cfg), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def zamba_init_cache(cfg, batch: int, max_len: int, dtype=torch.float32, *,
                     device=None) -> dict:
    """Every Mamba layer's state and the shared attention's KV cache at
    each of its g positions, on ``device`` (the GPU unless given)."""
    g, per, tail = zamba_groups(cfg)
    dev = resolve_device(device)
    kv = (g, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache = {"ssm": mamba2.mamba_init_state(cfg, batch, dtype, device=dev,
                                            lead=(g, per)),
             "attn_k": torch.zeros(kv, dtype=dtype, device=dev),
             "attn_v": torch.zeros(kv, dtype=dtype, device=dev),
             "len": 0}
    if tail:
        cache["tail_ssm"] = mamba2.mamba_init_state(cfg, batch, dtype,
                                                    device=dev, lead=(tail,))
    return cache


def _mamba_steps(x, layers, state: dict, lead: tuple, key: str, cfg):
    for i, layer in enumerate(layers):
        with L.layer_state(state, lead + (i,), key) as st:
            y, _ = mamba2.mamba_step(rms_norm(x, layer.ln, cfg.norm_eps),
                                     st, layer.mamba, cfg)
        x = x + y
    return x


@torch.no_grad()
def zamba_decode_step(model: Zamba, tokens, cache: dict, cfg
                      ) -> tuple[torch.Tensor, dict]:
    """As ``xlstm_decode_step``, for zamba2: the shared attention reads
    and writes its KV cache at position ``cache["len"]`` (on a mesh, this
    rank's slot and KV heads of it, ``layers.cache_offsets``)."""
    x = model.embed_tokens(tokens)
    ck_all, cv_all = cache["attn_k"], cache["attn_v"]
    pos = cache["len"]
    seq0, head0, max_len = L.cache_offsets(cfg, ck_all.shape[3],
                                           ck_all.shape[2], "attn_k")
    if pos >= max_len:
        raise ValueError(f"the cache of {max_len} positions is full")
    slot = pos - seq0 if 0 <= pos - seq0 < ck_all.shape[2] else None
    heads = slice(head0, head0 + ck_all.shape[3])
    seq_axes = L.cache_seq_axes("attn_k")
    sin, cos = L.rope_angles(torch.arange(pos, pos + 1, device=x.device),
                             cfg.hd, cfg.rope_theta)
    sp = model.shared_attn
    for gi, group in enumerate(model.groups):
        x = _mamba_steps(x, group, cache["ssm"], (gi,), "ssm", cfg)
        xn = rms_norm(x, sp.ln1, cfg.norm_eps)
        k_new, v_new = L.project_kv(xn, sp.attn, cfg, sin, cos)
        ck, cv = ck_all[gi], cv_all[gi]
        if slot is not None:
            ck[:, slot:slot + 1] = k_new[:, :, heads]
            cv[:, slot:slot + 1] = v_new[:, :, heads]
        h = L.gqa_attention(xn, sp.attn, cfg, sin=sin, cos=cos, causal=True,
                            offset=pos, kv_len_valid=pos + 1,
                            kv_override=(ck, cv), seq_axes=seq_axes)
        x = x + h
        x = x + L.swiglu(rms_norm(x, sp.ln2, cfg.norm_eps), sp.ffn)
    if model.tail is not None:
        x = _mamba_steps(x, model.tail, cache["tail_ssm"], (), "tail_ssm",
                         cfg)
    cache["len"] = pos + 1
    return model.head(x[:, -1], cfg), cache
