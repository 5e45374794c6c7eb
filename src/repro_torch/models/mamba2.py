"""Mamba-2 (SSD, state-space duality) block: the chunked-parallel form of
the forward and the single-step decode form, the port of
``repro.models.mamba2``.

Recurrence per head (state S ∈ R^{hd×N}):
    S_t = a_t · S_{t-1} + (Δ_t x_t) ⊗ B_t ,   a_t = exp(A·Δ_t) ∈ (0,1)
    y_t = S_t C_t + D · x_t
The forward runs the chunkwise form: within a chunk a (Tc×Tc) masked-decay
product, across chunks the carried state, O(T·Tc) instead of O(T²).

The weights live in a ``Mamba`` module: ``in_proj`` and ``out_proj`` as
``nn.Linear``, ``conv`` in the reference's (K, C) layout.  The causal
convolution is the reference's sum of K shifted products in its order (a
grouped ``conv1d`` would sum in another).  ``jax.nn.softplus`` is
``logaddexp(x, 0)``; ``F.softplus`` turns linear above 20, where the two
differ by less than 2e-9.

``mamba_step`` writes the carried state (``ssm``, ``conv``) in place: the
state dict's tensors may be views into a model's stacked cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L


def ssm_dims(cfg) -> tuple[int, int, int]:
    """(d_inner, heads, state size N)."""
    d_inner = 2 * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


class Mamba(nn.Module):
    """``in_proj`` (D → 2·d_inner + 2N + H), ``conv`` (K, d_inner + 2N),
    ``A_log``, ``dt_bias`` (H,) float32, ``D`` (H,), ``gate_norm``
    (d_inner,), ``out_proj`` (d_inner → D)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        d_inner, h, n = ssm_dims(cfg)
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = L.empty_linear(d, 2 * d_inner + 2 * n + h,
                                      bias=False, **kw)
        self.conv = nn.Parameter(torch.empty((cfg.ssm_conv,
                                              d_inner + 2 * n), **kw))
        self.A_log = nn.Parameter(torch.empty(h, **f32))
        self.dt_bias = nn.Parameter(torch.empty(h, **f32))
        self.D = nn.Parameter(torch.empty(h, **kw))
        self.gate_norm = nn.Parameter(torch.empty(d_inner, **kw))
        self.out_proj = L.empty_linear(d_inner, d, bias=False, **kw)


def mamba_params(block: Mamba, cfg, generator: torch.Generator) -> None:
    """Draw ``block``'s weights with the reference's distributions: the
    projections normal · fan_in^-0.5, ``conv`` normal · 0.5, A = −e,
    ``dt_bias`` 0, ``D`` and ``gate_norm`` 1."""
    d_inner = ssm_dims(cfg)[0]
    L.dense_init(block.in_proj.weight, generator, cfg.d_model)
    L.dense_init(block.conv, generator, cfg.ssm_conv, 0.5)
    with torch.no_grad():
        block.A_log.copy_(torch.full_like(block.A_log, math.e).log())
        block.dt_bias.zero_()
        block.D.fill_(1.0)
        block.gate_norm.fill_(1.0)
    L.dense_init(block.out_proj.weight, generator, d_inner)


def _split_proj(z: torch.Tensor, cfg):
    d_inner, h, n = ssm_dims(cfg)
    return torch.split(z, [d_inner, d_inner, n, n, h], dim=-1)


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: u (B, T, C), w (K, C); the K shifted
    products summed in order, then SiLU."""
    k, t = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + t, :] * w[i][None, None] for i in range(k))
    return F.silu(out)


def _gate_out(y: torch.Tensor, zg: torch.Tensor, block: Mamba
              ) -> torch.Tensor:
    return block.out_proj(L.rms_norm(y * F.silu(zg), block.gate_norm))


def mamba_forward(x: torch.Tensor, block: Mamba, cfg, *, chunk: int = 256
                  ) -> torch.Tensor:
    """x (B, T, D) → (B, T, D).  T must divide by ``chunk`` (or be at most
    ``chunk``)."""
    b, t, _ = x.shape
    d_inner, h, n = ssm_dims(cfg)
    hd = cfg.ssm_head_dim

    zg, xs, bmat, cmat, dt = _split_proj(block.in_proj(x), cfg)
    conv_out = _causal_conv(torch.cat([xs, bmat, cmat], dim=-1), block.conv)
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)

    a_neg = -torch.exp(block.A_log)                               # (H,)
    dt = F.softplus(dt.float() + block.dt_bias)                   # (B,T,H)
    loga = dt * a_neg                                             # ≤ 0
    xh = xs.reshape(b, t, h, hd)
    xbar = xh * dt[..., None].to(x.dtype)                         # Δ_t x_t

    if t <= chunk:
        chunk = t
    if t % chunk:
        raise ValueError(f"chunk {chunk} does not divide the {t} positions")
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    state = x.new_zeros((b, h, hd, n))
    ys = []
    for lo in range(0, t, chunk):
        xb, la = xbar[:, lo:lo + chunk], loga[:, lo:lo + chunk]
        bm, cm = bmat[:, lo:lo + chunk], cmat[:, lo:lo + chunk]
        lcum = torch.cumsum(la, dim=1)                            # L_t
        # intra-chunk: M[t,s] = (C_t·B_s)·exp(L_t−L_s)·1[s≤t]
        g = torch.einsum("btn,bsn->bts", cm, bm).float()
        decay = lcum[:, :, None, :] - lcum[:, None, :, :]         # (B,t,s,H)
        # the mask goes in before exp: for s > t the exponent is positive
        decay = torch.where(tri[None, :, :, None], decay, -1e30)
        m = torch.exp(decay) * g[..., None]
        y_intra = torch.einsum("btsh,bshp->bthp", m.to(x.dtype), xb)
        # inter-chunk: y += exp(L_t)·C_t·S_prev
        y_inter = torch.einsum("btn,bhpn->bthp", cm, state) \
            * torch.exp(lcum)[..., None].to(x.dtype)
        # S = exp(L_Tc)·S_prev + Σ_s exp(L_Tc−L_s)·xb_s ⊗ B_s
        ltot = lcum[:, -1]                                        # (B,H)
        w = torch.exp(ltot[:, None] - lcum)                       # (B,Tc,H)
        state = state * torch.exp(ltot)[..., None, None].to(x.dtype) \
            + torch.einsum("bshp,bsn,bsh->bhpn", xb, bm, w.to(x.dtype))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    y = y + xh * block.D[None, None, :, None].to(x.dtype)
    return _gate_out(y.reshape(b, t, d_inner), zg, block)


def mamba_init_state(cfg, batch: int, dtype=torch.float32, *,
                     device=None, lead: tuple = ()) -> dict:
    """Zero ``ssm`` (*lead, B, H, hd, N) and ``conv`` (*lead, B, K−1, C)
    states; ``lead`` stacks them for a stack of layers."""
    d_inner, h, n = ssm_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    return {"ssm": torch.zeros(lead + (batch, h, cfg.ssm_head_dim, n), **kw),
            "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1,
                                        d_inner + 2 * n), **kw)}


def mamba_step(x: torch.Tensor, state: dict, block: Mamba, cfg
               ) -> tuple[torch.Tensor, dict]:
    """Single-token decode: x (B, 1, D) against the carried (``ssm``,
    ``conv``) state, which is written in place and returned."""
    b = x.shape[0]
    d_inner, h, n = ssm_dims(cfg)
    hd = cfg.ssm_head_dim

    zg, xs, bmat, cmat, dt = _split_proj(block.in_proj(x), cfg)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)                 # (B,1,C)
    window = torch.cat([state["conv"], conv_in], dim=1)           # (B,K,C)
    conv_out = F.silu(torch.sum(window * block.conv[None], dim=1,
                                keepdim=True))
    state["conv"].copy_(window[:, 1:])
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    bmat, cmat = bmat[:, 0], cmat[:, 0]                           # (B,N)

    a_neg = -torch.exp(block.A_log)
    dtv = F.softplus(dt[:, 0].float() + block.dt_bias)            # (B,H)
    a = torch.exp(dtv * a_neg)
    xh = xs.reshape(b, h, hd)
    xbar = xh * dtv[..., None].to(x.dtype)
    s = state["ssm"]
    s.mul_(a[..., None, None].to(x.dtype)).add_(
        torch.einsum("bhp,bn->bhpn", xbar, bmat))
    y = torch.einsum("bhpn,bn->bhp", s, cmat) \
        + xh * block.D[None, :, None].to(x.dtype)
    return _gate_out(y.reshape(b, 1, d_inner), zg, block), state
