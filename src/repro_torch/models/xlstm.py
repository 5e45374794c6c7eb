"""xLSTM blocks, the port of ``repro.models.xlstm``: the mLSTM (matrix
memory; a chunkwise-parallel forward and a recurrent step) and the sLSTM
(scalar memory, sequential by construction: a loop over time where the
reference runs ``lax.scan``).

mLSTM per head (state C ∈ R^{hd×hd}, n ∈ R^{hd}, stabilizer m):
    m_t = max(log f_t + m_{t-1}, log i_t)
    C_t = exp(log f_t + m_{t-1} − m_t)·C_{t-1} + exp(log i_t − m_t)·v_t k_tᵀ
    n_t likewise with k_t;  h_t = o_t ⊙ (C_t q_t) / max(|n_tᵀ q_t|, 1)

The stabilizers start at −1e30 in float32, as the reference's do.  The
``*_step`` functions write the carried state in place: the state dict's
tensors may be views into a model's stacked cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L

M_START = -1e30                  # the stabilizers' start, float32


def xlstm_dims(cfg) -> tuple[int, int, int]:
    """(d_inner, heads, head dim)."""
    h = cfg.n_heads
    d_inner = 2 * cfg.d_model
    return d_inner, h, d_inner // h


class MLSTM(nn.Module):
    """``up`` (D → 2·d_inner), ``wq``/``wk``/``wv`` (d_inner → d_inner),
    ``w_if`` (d_inner → 2H), ``out_norm`` (d_inner,), ``down``
    (d_inner → D)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        d_inner, h, _ = xlstm_dims(cfg)
        kw = dict(bias=False, device=device, dtype=dtype)
        self.up = L.empty_linear(d, 2 * d_inner, **kw)
        self.wq = L.empty_linear(d_inner, d_inner, **kw)
        self.wk = L.empty_linear(d_inner, d_inner, **kw)
        self.wv = L.empty_linear(d_inner, d_inner, **kw)
        self.w_if = L.empty_linear(d_inner, 2 * h, **kw)
        self.out_norm = nn.Parameter(torch.empty(d_inner, device=device,
                                                 dtype=dtype))
        self.down = L.empty_linear(d_inner, d, **kw)


class SLSTM(nn.Module):
    """``up`` (D → d_inner), ``w_gates`` (d_inner → 4·d_inner),
    ``r_gates`` (H, hd, 4·hd) in the reference's layout, ``out_norm``
    (d_inner,), ``down`` (d_inner → D)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        d_inner, h, hd = xlstm_dims(cfg)
        kw = dict(bias=False, device=device, dtype=dtype)
        self.up = L.empty_linear(d, d_inner, **kw)
        self.w_gates = L.empty_linear(d_inner, 4 * d_inner, **kw)
        self.r_gates = nn.Parameter(torch.empty((h, hd, 4 * hd),
                                                device=device, dtype=dtype))
        self.out_norm = nn.Parameter(torch.empty(d_inner, device=device,
                                                 dtype=dtype))
        self.down = L.empty_linear(d_inner, d, **kw)


def mlstm_params(block: MLSTM, cfg, generator: torch.Generator) -> None:
    """Normal · fan_in^-0.5 projections (``w_if`` · 0.01), ones for
    ``out_norm``: the reference's distributions."""
    d_inner = xlstm_dims(cfg)[0]
    L.dense_init(block.up.weight, generator, cfg.d_model)
    for lin in (block.wq, block.wk, block.wv):
        L.dense_init(lin.weight, generator, d_inner)
    L.dense_init(block.w_if.weight, generator, d_inner, 0.01)
    with torch.no_grad():
        block.out_norm.fill_(1.0)
    L.dense_init(block.down.weight, generator, d_inner)


def slstm_params(block: SLSTM, cfg, generator: torch.Generator) -> None:
    """As ``mlstm_params``; ``r_gates`` normal · 0.1."""
    d_inner, h, _ = xlstm_dims(cfg)
    L.dense_init(block.up.weight, generator, cfg.d_model)
    L.dense_init(block.w_gates.weight, generator, d_inner)
    L.dense_init(block.r_gates, generator, h, 0.1)
    with torch.no_grad():
        block.out_norm.fill_(1.0)
    L.dense_init(block.down.weight, generator, d_inner)


# ------------------------------------------------------------------ mLSTM


def _mlstm_qkv(u: torch.Tensor, block: MLSTM, cfg):
    """q, k, v (…, H, hd) and the float32 log input and forget gates."""
    _, h, hd = xlstm_dims(cfg)
    lead = u.shape[:-1]
    q = block.wq(u).reshape(*lead, h, hd) * hd ** -0.5
    k = block.wk(u).reshape(*lead, h, hd) * hd ** -0.5
    v = block.wv(u).reshape(*lead, h, hd)
    gif = block.w_if(u).float()
    return q, k, v, gif[..., :h], F.logsigmoid(gif[..., h:])


def mlstm_forward(x: torch.Tensor, block: MLSTM, cfg, *, chunk: int = 256
                  ) -> torch.Tensor:
    """x (B, T, D) → (B, T, D), the chunkwise-parallel form.

    With L_t = Σ_{τ≤t} log f_τ (within the chunk), u_s = log i_s − L_s,
    M_t = max(m_carry, cummax_{s≤t} u_s) and m_t = L_t + M_t:

        num_t = Σ_{s≤t} e^{u_s − M_t} (q_t·k_s) v_s + e^{m_c − M_t}(Ĉ q_t)
        n̂_t·q = the same weights with k_s;  y_t = num_t / max(|n̂_t·q_t|, 1)

    The carry update reuses the weights at t = Tc, and the CARRIED
    stabilizer is the absolute m_Tc = L_Tc + M_Tc: the next chunk restarts
    its L at 0, so m_c must absorb this chunk's decay.  T must divide by
    ``chunk`` (or be at most ``chunk``)."""
    b, t, _ = x.shape
    d_inner, h, hd = xlstm_dims(cfg)
    u, gate = block.up(x).split(d_inner, dim=-1)
    q, k, v, log_i, log_f = _mlstm_qkv(u, block, cfg)

    if t <= chunk:
        chunk = t
    if t % chunk:
        raise ValueError(f"chunk {chunk} does not divide the {t} positions")
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    c_hat = x.new_zeros((b, h, hd, hd))
    n_hat = x.new_zeros((b, h, hd))
    m_c = torch.full((b, h), M_START, dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, t, chunk):
        sl = slice(lo, lo + chunk)
        qc, kc, vc, li, lf = q[:, sl], k[:, sl], v[:, sl], log_i[:, sl], \
            log_f[:, sl]
        lcum = torch.cumsum(lf, dim=1)                     # L_t (B,Tc,H)
        us = li - lcum                                     # u_s
        m_run = torch.maximum(torch.cummax(us, dim=1).values, m_c[:, None])
        w_intra = torch.exp(us[:, None, :, :] - m_run[:, :, None, :])
        w_intra = torch.where(tri[None, :, :, None], w_intra, 0.0)
        attn = torch.einsum("bthp,bshp->btsh", qc, kc).float()
        aw = (attn * w_intra).to(x.dtype)
        num = torch.einsum("btsh,bshp->bthp", aw, vc)
        den_i = torch.einsum("btsh,bshp->bthp", aw, kc)
        w_carry = torch.exp(m_c[:, None] - m_run)          # (B,Tc,H)
        num = num + w_carry[..., None].to(x.dtype) \
            * torch.einsum("bhpq,bthq->bthp", c_hat, qc)
        den = torch.einsum("bthp,bthp->bth", den_i, qc) \
            + w_carry * torch.einsum("bhq,bthq->bth", n_hat, qc)
        ys.append(num / torch.clamp_min(den.abs(), 1.0)[..., None]
                  .to(x.dtype))
        m_big = m_run[:, -1]                               # M_Tc (B,H)
        w_end = torch.exp(us - m_big[:, None]).to(x.dtype)  # (B,Tc,H)
        carry = torch.exp(m_c - m_big).to(x.dtype)
        c_hat = carry[..., None, None] * c_hat + torch.einsum(
            "bthp,bthq,bth->bhpq", vc, kc, w_end)
        n_hat = carry[..., None] * n_hat + torch.einsum(
            "bthq,bth->bhq", kc, w_end)
        m_c = lcum[:, -1] + m_big                          # m_Tc
    y = torch.cat(ys, dim=1).reshape(b, t, d_inner)
    y = L.rms_norm(y, block.out_norm) * F.silu(gate)
    return block.down(y)


def mlstm_init_state(cfg, batch: int, dtype=torch.float32, *, device=None,
                     lead: tuple = ()) -> dict:
    """Zero ``c`` (*lead, B, H, hd, hd) and ``n`` (…, hd), ``m`` (*lead,
    B, H) at −1e30; ``lead`` stacks them for a stack of layers."""
    _, h, hd = xlstm_dims(cfg)
    s = lead + (batch, h)
    return {"c": torch.zeros(s + (hd, hd), dtype=dtype, device=device),
            "n": torch.zeros(s + (hd,), dtype=dtype, device=device),
            "m": torch.full(s, M_START, dtype=torch.float32, device=device)}


def mlstm_step(x: torch.Tensor, state: dict, block: MLSTM, cfg
               ) -> tuple[torch.Tensor, dict]:
    """x (B, 1, D) single-token decode; ``state`` is written in place and
    returned."""
    b = x.shape[0]
    d_inner = xlstm_dims(cfg)[0]
    u, gate = block.up(x[:, 0]).split(d_inner, dim=-1)
    q, k, v, li, lf = _mlstm_qkv(u, block, cfg)
    c, n, m = state["c"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)[..., None, None].to(x.dtype)
    iw = torch.exp(li - m_new)[..., None, None].to(x.dtype)
    c.mul_(fw).add_(iw * torch.einsum("bhp,bhq->bhpq", v, k))
    n.mul_(fw[..., 0]).add_(iw[..., 0] * k)
    m.copy_(m_new)
    num = torch.einsum("bhpq,bhq->bhp", c, q)
    den = torch.clamp_min(torch.einsum("bhq,bhq->bh", n, q).abs(),
                          1.0)[..., None]
    y = (num / den).reshape(b, 1, d_inner)
    y = L.rms_norm(y, block.out_norm) * F.silu(gate[:, None])
    return block.down(y), state


# ------------------------------------------------------------------ sLSTM


def _slstm_cell(wgt, c, n, h_prev, m, r_gates, dtype):
    """One sLSTM step from the input gates ``wgt`` (B, H, 4·hd) and the
    carried (c, n, h, m) → the new (c, n, h, m)."""
    rec = torch.einsum("bhp,hpq->bhq", h_prev, r_gates)
    zi, ii, fi, oi = (wgt + rec).float().chunk(4, dim=-1)
    zt = torch.tanh(zi)
    ot = torch.sigmoid(oi)
    log_f = F.logsigmoid(fi)
    m_new = torch.maximum(log_f + m, ii)
    fw = torch.exp(log_f + m - m_new)
    iw = torch.exp(ii - m_new)
    c_new = fw * c + iw * zt
    n_new = fw * n + iw
    h_new = (ot * c_new / torch.clamp_min(n_new, 1e-6)).to(dtype)
    return c_new, n_new, h_new, m_new


def _slstm_gates(x: torch.Tensor, block: SLSTM, cfg) -> torch.Tensor:
    """The input half of the gates, (…, H, 4·hd)."""
    _, h, hd = xlstm_dims(cfg)
    return block.w_gates(block.up(x)).reshape(*x.shape[:-1], h, 4 * hd)


def slstm_forward(x: torch.Tensor, block: SLSTM, cfg) -> torch.Tensor:
    """sLSTM with per-head recurrent mixing (block-diagonal R), one step
    at a time."""
    b, t, _ = x.shape
    d_inner, h, hd = xlstm_dims(cfg)
    wg = _slstm_gates(x, block, cfg)                      # (B,T,H,4·hd)
    c = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros_like(c)
    hs = torch.zeros((b, h, hd), dtype=x.dtype, device=x.device)
    m = torch.full_like(c, M_START)
    ys = []
    for i in range(t):
        c, n, hs, m = _slstm_cell(wg[:, i], c, n, hs, m, block.r_gates,
                                  x.dtype)
        ys.append(hs)
    y = torch.stack(ys, dim=1).reshape(b, t, d_inner)
    return block.down(L.rms_norm(y, block.out_norm))


def slstm_init_state(cfg, batch: int, dtype=torch.float32, *, device=None,
                     lead: tuple = ()) -> dict:
    """Zero ``c``, ``n`` (float32) and ``h`` (*lead, B, H, hd), ``m`` at
    −1e30."""
    _, h, hd = xlstm_dims(cfg)
    s = lead + (batch, h, hd)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(s, **f32), "n": torch.zeros(s, **f32),
            "h": torch.zeros(s, dtype=dtype, device=device),
            "m": torch.full(s, M_START, **f32)}


def slstm_step(x: torch.Tensor, state: dict, block: SLSTM, cfg
               ) -> tuple[torch.Tensor, dict]:
    """x (B, 1, D) single-token decode; ``state`` is written in place and
    returned."""
    b = x.shape[0]
    d_inner = xlstm_dims(cfg)[0]
    new = _slstm_cell(_slstm_gates(x[:, 0], block, cfg), state["c"],
                      state["n"], state["h"], state["m"], block.r_gates,
                      x.dtype)
    for key, value in zip(("c", "n", "h", "m"), new):
        state[key].copy_(value)
    y = L.rms_norm(state["h"].reshape(b, 1, d_inner), block.out_norm)
    return block.down(y), state
