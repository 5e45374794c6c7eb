"""Shared model layers: RMSNorm, RoPE / M-RoPE, GQA attention (full or
sliding window), SwiGLU, and the modules that hold their weights.

The functions mirror ``repro.models.layers``; the weights live in
``nn.Module``s: ``Attention`` (``wq``/``wk``/``wv``/``wo`` as
``nn.Linear``, which store (out, in), the bias of q/k/v in the
projections) and ``SwiGLU`` (``wg``/``wu``/``wd``).  Attention is the
plain form (einsum, mask, softmax in float32), the reference's order of
operations, so the logits agree with it within float32 rounding.

Every function here takes the positions and lengths it masks with as host
``int``s or device tensors and builds its masks with ``torch.arange`` on
the input's device: a decode step issues no host synchronize.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

# ------------------------------------------------- activation sharding

# Set by ``launch.steps`` while a step on a mesh runs; empty (the default)
# → the hooks below change nothing, so one-process code is unaffected.
# The reference pins activations' batch to the data axes with sharding
# constraints.  Here every tensor is this rank's local tensor, whose batch
# rows already are this rank's, so the constraints hold by construction;
# what the state still decides is the MoE router's groups over the whole
# batch (``row_split``), the decode attention over a sharded cache
# (``gqa_attention``, ``cache_offsets``) and a layer's recurrent state
# (``layer_state``).  ``_BATCH_AXES`` are the axes that split the step's
# batch rows (none where the batch is whole on every rank).
_BATCH_AXES: tuple[str, ...] = ()
_DP_SIZE: int = 1
_MODEL_SIZE: int = 1
_SEQ_PARALLEL: bool = False
_MESH = None
_FLASH_DECODE: bool = False
# the decode cache's specs (``launch.shardings.cache_specs``' tree) and the
# hook that gives one layer's state whole, both set by a decode step
_CACHE_SPECS: dict = {}
_LAYER_STATE = None


def set_mesh_axes(batch_axes: tuple[str, ...], dp_size: int,
                  model_size: int, *, seq_parallel: bool = False,
                  mesh=None, flash_decode: bool = False) -> None:
    """The reference's signature; ``mesh`` is a ``launch.mesh.LMMesh``."""
    global _BATCH_AXES, _DP_SIZE, _MODEL_SIZE, _SEQ_PARALLEL, _MESH, \
        _FLASH_DECODE
    _BATCH_AXES = tuple(batch_axes)
    _DP_SIZE = dp_size
    _MODEL_SIZE = model_size
    _SEQ_PARALLEL = seq_parallel
    _MESH = mesh
    _FLASH_DECODE = flash_decode


def clear_mesh_axes() -> None:
    set_mesh_axes((), 1, 1)
    set_cache_layout({}, None)


def set_cache_layout(specs: dict, layer_state) -> None:
    """The decode cache's specs (name → spec, nested as the cache) and
    the ``layer_state`` hook, ``layer_state(state, idx, key)`` → a context
    manager yielding one layer's state (None: views of the local
    tensors)."""
    global _CACHE_SPECS, _LAYER_STATE
    _CACHE_SPECS, _LAYER_STATE = specs, layer_state


def cache_layout() -> tuple:
    """What ``set_cache_layout`` set, as its arguments (to restore it)."""
    return _CACHE_SPECS, _LAYER_STATE


def row_split() -> tuple:
    """(mesh, axes, size) of the axes that split the step's batch rows:
    this rank holds rows ``[r·B_l, (r+1)·B_l)`` of the whole batch, r its
    row-major index over ``axes``; (None, (), 1) off a mesh."""
    if _MESH is None or _DP_SIZE == 1:
        return None, (), 1
    return _MESH, _BATCH_AXES, _DP_SIZE


def mesh_axes() -> tuple:
    """The state ``set_mesh_axes`` set, as its arguments (to restore it)."""
    return ((_BATCH_AXES, _DP_SIZE, _MODEL_SIZE),
            dict(seq_parallel=_SEQ_PARALLEL, mesh=_MESH,
                 flash_decode=_FLASH_DECODE))


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """The reference pins dim 0 (batch) to the data axes, and in
    seq-parallel mode dim 1 to ``model``.  A sharding constraint changes
    no value, and a local tensor's rows already are this rank's batch
    rows: this returns ``x`` after checking that it has a batch dim."""
    if _BATCH_AXES and x.dim() < 1:
        raise ValueError("constrain_batch needs a tensor with a batch dim")
    return x


def constrain_batch_vocab(x: torch.Tensor) -> torch.Tensor:
    """(B, ..., V) logits: batch→data, vocab→model in the reference.  The
    logits here are this rank's rows with the whole vocabulary (the
    ``model`` axis shards storage, not this product): ``x`` after
    checking that it has a batch and a vocabulary dim."""
    if _BATCH_AXES and x.dim() < 2:
        raise ValueError("constrain_batch_vocab needs (B, ..., V) logits")
    return x


def _split(entry) -> tuple:
    """A spec entry's mesh axes of size above 1, in mesh order."""
    names = () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)
    return tuple(a for a in _MESH.axes(names) if _MESH.axis_size(a) > 1)


def cache_seq_axes(key: str = "k") -> tuple:
    """The mesh axes that split the sequence of the decode cache's KV
    leaf ``key`` (dim 2 of its (L, B, S, KV, hd) spec, as
    ``set_cache_layout`` handed it in): ``model`` where flash decode runs,
    the data axes where the batch does not divide them; () off a mesh
    or with no such leaf."""
    spec = _CACHE_SPECS.get(key)
    return _split(spec[2]) if _MESH is not None and spec else ()


def cache_offsets(cfg, kv_local: int, s_local: int, key: str = "k"
                  ) -> tuple[int, int, int]:
    """Where this rank's shard of the KV cache leaf ``key``, of
    ``kv_local`` heads and ``s_local`` positions, lies in the whole cache:
    (the global position of its slot 0, the first KV head it holds, the
    whole cache's positions).  It holds this rank's KV heads where it has
    fewer than ``cfg.n_kv_heads`` (split over ``model``), and its chunk of
    the sequence where ``cache_seq_axes`` split it."""
    if _MESH is None:
        return 0, 0, s_local
    head0 = _MESH.index("model") * kv_local if kv_local < cfg.n_kv_heads \
        else 0
    seq = cache_seq_axes(key)
    if not seq:
        return 0, head0, s_local
    return (_MESH.index(seq) * s_local, head0,
            s_local * _MESH.axis_size(seq))


def layer_state(state: dict, idx: tuple, key: str):
    """A context manager yielding one layer's recurrent state (the
    layer at lead index ``idx`` of each stacked tensor of ``state``, the
    cache's subtree ``key``) for a step to write in place: views of the
    local tensors off a mesh; on one, the step's hook (``launch.steps``)
    gives this rank's batch rows whole on every other dim and cuts the
    written state back to this rank's shards when the block ends."""
    if _LAYER_STATE is None or key not in _CACHE_SPECS:
        return contextlib.nullcontext({k: v[idx] for k, v in state.items()})
    return _LAYER_STATE(state, idx, key)


# ------------------------------------------------------------------ remat


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``remat`` is set
    and autograd records the call: only ``args`` are kept for the backward
    pass, which runs ``fn`` again for the rest (where the reference wraps
    the layer in ``jax.checkpoint``).  Under ``no_grad`` or
    ``inference_mode`` it is the plain call."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------- modules


def empty_linear(d_in: int, d_out: int, *, bias: bool, device, dtype
                 ) -> nn.Linear:
    """An ``nn.Linear`` whose storage is allocated but not initialized
    (``init`` or ``interop.params_from_numpy`` fills it)."""
    return nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias,
                              device=device, dtype=dtype)


class Attention(nn.Module):
    """GQA projections: ``wq`` (D → H·hd), ``wk``/``wv`` (D → KV·hd), with
    a bias each where ``cfg.qkv_bias``, and ``wo`` (H·hd → D)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kw = dict(bias=cfg.qkv_bias, device=device, dtype=dtype)
        self.wq = empty_linear(d, h * hd, **kw)
        self.wk = empty_linear(d, kv * hd, **kw)
        self.wv = empty_linear(d, kv * hd, **kw)
        self.wo = empty_linear(h * hd, d, bias=False, device=device,
                               dtype=dtype)


class SwiGLU(nn.Module):
    """``wg``/``wu`` (D → F), ``wd`` (F → D)."""

    def __init__(self, d: int, f: int, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.wg = empty_linear(d, f, **kw)
        self.wu = empty_linear(d, f, **kw)
        self.wd = empty_linear(f, d, **kw)


# --------------------------------------------------------------- normalize


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE


def _freqs(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(half, dtype=torch.float32, device=device)
                     / half)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int → (sin, cos) of shape (..., S, head_dim//2)."""
    ang = positions[..., None].float() * _freqs(head_dim // 2, theta,
                                                positions.device)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, hd); sin/cos (B, S, hd//2) or (S, hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:
        sin, cos = sin[None], cos[None]
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections=(2, 1, 1)) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (Qwen2-VL): positions (B, 3, S) for (t, h, w); the rotary
    spectrum is split into ``sections`` (proportional chunks, the rounding
    remainder going to the last) so each band rotates by its own
    coordinate.  For text the three coordinates are equal and this is
    standard RoPE."""
    half = head_dim // 2
    total = sum(sections)
    bounds, start = [], 0
    for s in sections:
        size = half * s // total
        bounds.append((start, start + size))
        start += size
    bounds[-1] = (bounds[-1][0], half)
    freqs = _freqs(half, theta, positions.device)
    sins, coss = [], []
    for i, (lo, hi) in enumerate(bounds):
        ang = positions[:, i, :, None].float() * freqs[lo:hi]
        sins.append(torch.sin(ang))
        coss.append(torch.cos(ang))
    return torch.cat(sins, -1), torch.cat(coss, -1)      # (B, S, half)


# -------------------------------------------------------------- attention


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) → (B, S, KV·n_rep, hd) for GQA."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def _mask_logits(logits: torch.Tensor, *, causal: bool, window, offset,
                 kv_len_valid=None) -> torch.Tensor:
    """Causal / sliding-window masking of (B, H, Sq, Sk) logits: masked
    entries become −1e30.

    window: None/0 → full; w > 0 → sliding (kpos > qpos − w).
    offset: absolute position of query row 0 (decode: the cache length).
    kv_len_valid: keys at or beyond it are padding.
    """
    sq, sk = logits.shape[-2], logits.shape[-1]
    dev = logits.device
    qpos = torch.arange(sq, device=dev)[:, None] + offset
    kpos = torch.arange(sk, device=dev)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    if kv_len_valid is not None:
        m &= kpos < kv_len_valid
    return torch.where(m[None, None], logits, -1e30)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window=None, offset=0,
              kv_len_valid=None, q_block: int = 0) -> torch.Tensor:
    """Softmax attention.  q (B, Sq, H, hd), k/v (B, Sk, H, hd) (H already
    GQA-repeated).  q_block > 0 goes over query blocks of that many rows
    (peak activation (B, H, q_block, Sk) instead of (B, H, Sq, Sk))."""
    scale = q.shape[-1] ** -0.5

    def blk(qb, off):
        logits = torch.einsum("bqhd,bkhd->bhqk", qb, k).float() * scale
        logits = _mask_logits(logits, causal=causal, window=window,
                              offset=off, kv_len_valid=kv_len_valid)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    sq = q.shape[1]
    if not q_block or sq <= q_block:
        return blk(q, offset)
    if sq % q_block:
        raise ValueError(f"q_block {q_block} does not divide the {sq} "
                         f"query rows")
    return torch.cat([blk(q[:, i:i + q_block], offset + i)
                      for i in range(0, sq, q_block)], dim=1)


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def project_kv(x: torch.Tensor, attn: Attention, cfg, sin=None, cos=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V projections only (the cache fill), RoPE on K."""
    kv, hd = cfg.n_kv_heads, cfg.hd
    k = _heads(attn.wk(x), kv, hd)
    v = _heads(attn.wv(x), kv, hd)
    if sin is not None:
        k = apply_rope(k, sin, cos)
    return k, v


def gqa_attention(x: torch.Tensor, attn: Attention, cfg, *, sin, cos,
                  causal: bool = True, window=None, offset=0,
                  kv_len_valid=None,
                  kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
                  q_block: int = 0, seq_axes: tuple = ()) -> torch.Tensor:
    """GQA attention over x (B, S, D).  kv_override: precomputed (k, v),
    the KV cache in decode, or this rank's shard of it on a mesh: its KV
    heads where it has fewer than ``cfg.n_kv_heads`` (split over
    ``model``), and its chunk of the sequence where ``seq_axes``
    (``cache_seq_axes``) split it."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q = _heads(attn.wq(x), h, hd)
    if kv_override is None:
        k, v = project_kv(x, attn, cfg, sin, cos)
    else:
        k, v = kv_override
    if sin is not None:
        q_sin, q_cos = sin, cos
        if kv_override is not None and sin.shape[-2] != s:
            # rope for the last s positions only
            q_sin, q_cos = sin[..., -s:, :], cos[..., -s:, :]
        q = apply_rope(q, q_sin, q_cos)
    n_rep = h // cfg.n_kv_heads
    heads = kv_override is not None and k.shape[2] < cfg.n_kv_heads
    if heads:
        # the cache holds this rank's KV heads: attend with their query
        # heads, then gather every rank's head outputs in rank order
        h0 = _MESH.index("model") * k.shape[2] * n_rep
        q = q[:, :, h0:h0 + k.shape[2] * n_rep]
    if seq_axes and kv_override is not None and s == 1:
        # Flash-decoding: one query against this rank's chunk of a
        # sequence-sharded cache, partial softmaxes combined over the
        # chunks' axes (see flash_decode.py); a query that sees every
        # position (cross attention) takes the last one as its own
        from repro_torch.models.flash_decode import flash_decode
        last = k.shape[1] * _MESH.axis_size(seq_axes) - 1
        out = flash_decode(q, k, v, offset if causal else last, mesh=_MESH,
                           dp_axes=_BATCH_AXES, n_rep=n_rep, window=window,
                           shard_axis=seq_axes)
    else:
        k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
        out = attention(q, k, v, causal=causal, window=window,
                        offset=offset, kv_len_valid=kv_len_valid,
                        q_block=q_block)
    if heads:
        out = _MESH.all_gather(out, 2, "model")
    return attn.wo(out.reshape(b, s, h * hd))


# ------------------------------------------------------------------- FFN


def swiglu(x: torch.Tensor, ffn: SwiGLU) -> torch.Tensor:
    """(silu(x·wg) ⊙ (x·wu)) · wd."""
    return ffn.wd(F.silu(ffn.wg(x)) * ffn.wu(x))


# ------------------------------------------------------------------ init


def init_generator(generator: torch.Generator | None, device
                   ) -> torch.Generator:
    """``generator``, or with none one of seed 0 on ``device`` (the GPU
    unless given): where a model's ``init`` draws its weights."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)) \
            .manual_seed(0)
    return generator


def dense_init(t: torch.Tensor, generator: torch.Generator, fan_in: int,
               scale: float | None = None) -> None:
    """Fill ``t`` in place with normal · ``scale`` (fan_in^-0.5 unless
    given), drawn from ``generator``: the reference's distribution, not
    its bits."""
    with torch.no_grad():
        t.normal_(generator=generator).mul_(
            scale if scale is not None else fan_in ** -0.5)


def attn_params(attn: Attention, cfg, generator: torch.Generator) -> None:
    """Draw ``attn``'s weights (zero biases)."""
    d, hd = cfg.d_model, cfg.hd
    for lin, fan_in in ((attn.wq, d), (attn.wk, d), (attn.wv, d),
                        (attn.wo, cfg.n_heads * hd)):
        dense_init(lin.weight, generator, fan_in)
        if lin.bias is not None:
            with torch.no_grad():
                lin.bias.zero_()


def swiglu_params(ffn: SwiGLU, generator: torch.Generator) -> None:
    """Draw ``ffn``'s weights."""
    d, f = ffn.wg.in_features, ffn.wg.out_features
    for lin, fan_in in ((ffn.wg, d), (ffn.wu, d), (ffn.wd, f)):
        dense_init(lin.weight, generator, fan_in)
