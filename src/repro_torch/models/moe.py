"""Mixture-of-experts FFN (Mixtral / Phi-3.5-MoE): top-k routing with
GShard-style grouped capacity dispatch through one-hot products, as
``repro.models.moe`` computes it (fixed shapes, no sort of the tokens).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.layers import dense_init, empty_linear


class MoE(nn.Module):
    """``router`` (D → E, an ``nn.Linear``) and the experts' ``wg``/``wu``
    (E, D, F) and ``wd`` (E, F, D), in the reference's layout."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = empty_linear(d, e, bias=False, device=device,
                                   dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        self.wg = nn.Parameter(torch.empty((e, d, f), **kw))
        self.wu = nn.Parameter(torch.empty((e, d, f), **kw))
        self.wd = nn.Parameter(torch.empty((e, f, d), **kw))


def moe_params(moe: MoE, cfg, generator: torch.Generator) -> None:
    """Draw ``moe``'s weights: normal · fan_in^-0.5, fan_in the first dim
    of the reference's (D, E), (E, D, F) and (E, F, D) shapes (for the
    experts E, as the reference's ``dense_init`` takes it)."""
    e = cfg.n_experts
    dense_init(moe.router.weight, generator, cfg.d_model)
    for w in (moe.wg, moe.wu, moe.wd):
        dense_init(w, generator, e)


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The k largest of each row, lower index first on ties (as
    ``lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """The routing of T = G·Tg tokens in groups of Tg."""

    probs: torch.Tensor       # (G, Tg, E) router probabilities
    gate_vals: torch.Tensor   # (G, Tg, k) renormalised gates
    expert_ids: torch.Tensor  # (G, Tg, k) chosen experts
    onehot: torch.Tensor      # (G, Tg, k, E) int
    keep: torch.Tensor        # (G, Tg, k) within the expert's capacity
    slot: torch.Tensor        # (G, Tg, k) place in the expert's buffer
    cap: int                  # each expert's buffer per group


def route(x: torch.Tensor, moe: MoE, cfg, *, group_size: int = 512
          ) -> Routing:
    """Route x (B, S, D): top-k experts per token (lower index first on
    ties), and each (token, choice)'s buffer slot in its group's expert in
    token order; a pair past the expert's capacity is dropped.

    On a mesh whose batch axes split the rows (``layers.row_split``) the
    groups are the whole batch's, as the reference forms them: T is every
    rank's tokens, Tg = min(group_size, T) and the capacity Tg's.  Where
    Tg divides this rank's tokens its groups are its own; where a group
    spans several ranks, each expert's positions here start after that
    expert's pairs on the group's lower ranks (one all-gather of the
    per-expert counts).  Routing then has one group of this rank's
    tokens, with the whole group's capacity."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * s
    mesh, axes, n_dp = L.row_split()
    tg = min(group_size, t * n_dp)
    if (t * n_dp) % tg:
        raise ValueError(f"{t * n_dp} tokens do not split into groups of "
                         f"{tg}")
    if t % tg and tg % t:
        raise ValueError(f"groups of {tg} tokens straddle ranks of {t}")
    span = 1 if t % tg == 0 else tg // t      # ranks a group spans
    g, tl = (t // tg, tg) if span == 1 else (1, t)
    cap = max(int(cfg.capacity_factor * tg * k / e), 1)
    probs = torch.softmax(moe.router(x.reshape(g, tl, d)).float(), dim=-1)
    gate_vals, expert_ids = top_k_stable(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # buffer position of each (token, choice) within its group's expert
    onehot = F.one_hot(expert_ids, e).int()                  # (G, Tl, k, E)
    flat = onehot.reshape(g, tl * k, e)
    pos = torch.cumsum(flat, dim=1)
    if span > 1:
        counts = mesh.all_gather(flat.sum(1), 0, axes)       # (ranks, E)
        r = mesh.index(axes)
        pos = pos + counts[r - r % span:r].sum(0)
    pos = (pos * flat - 1).reshape(g, tl, k, e)
    within_cap = (pos >= 0) & (pos < cap)
    slot = (torch.where(within_cap, pos, 0) * onehot).sum(-1)
    keep = (within_cap & (onehot > 0)).any(-1)
    return Routing(probs, gate_vals, expert_ids, onehot, keep, slot, cap)


def moe_ffn(x: torch.Tensor, moe: MoE, cfg, *, group_size: int = 512
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out, aux_loss).  Tokens split into groups of
    ``group_size``; each group routes to per-group expert buffers of
    capacity C = cf·Tg·k/E, and a (token, choice) beyond its expert's
    capacity is dropped.  aux is the Switch load-balancing loss
    E · Σ_e f_e · P_e.

    On a mesh whose batch axes split the rows, ``f_e`` is the whole
    batch's (one all-reduce of the per-expert counts) and ``P_e`` this
    rank's: with equal rows per rank, the mean of the ranks' aux (what a
    train step's loss and gradients are) is the reference's, and ``f_e``
    carries no gradient."""
    b, s, d = x.shape
    e = cfg.n_experts
    probs, gate_vals, _, onehot, keep, slot, cap = route(
        x, moe, cfg, group_size=group_size)
    g, tg = probs.shape[:2]
    xt = x.reshape(g, tg, d)
    disp = F.one_hot(slot, cap).to(x.dtype) * keep[..., None].to(x.dtype)
    oh = onehot.to(x.dtype)
    dispatch = torch.einsum("gtke,gtkc->gtec", oh, disp)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", oh, disp,
                           gate_vals.to(x.dtype))
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xt)         # (G, E, C, D)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, moe.wg)) \
        * torch.einsum("gecd,edf->gecf", xe, moe.wu)
    ye = torch.einsum("gecf,efd->gecd", h, moe.wd)
    out = torch.einsum("gtec,gecd->gtd", combine, ye).reshape(b, s, d)
    me = probs.mean(dim=(0, 1))                               # (E,)
    mesh, axes, n_dp = L.row_split()
    if n_dp == 1:
        fe = onehot.sum(2).float().mean(dim=(0, 1))
    else:
        fe = mesh.all_reduce(onehot.sum(2).float().sum(dim=(0, 1)), axes) \
            / (g * tg * n_dp)
    return out, e * (me * fe).sum()
