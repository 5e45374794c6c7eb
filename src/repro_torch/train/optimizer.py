"""AdamW over a model's named parameters (the port of
``repro.train.optimizer``).

The state holds one float32 ``mu`` and ``nu`` per parameter, keyed by its
name in ``named_parameters()``.  ``update`` follows the reference's
arithmetic: the global-norm clip, then the moments, the bias corrections
from the float32 step, and the decoupled weight decay on the float32
parameter.  It works in place, one parameter at a time, so at the full
width of a 3B model it never holds a second copy of all the gradients or
parameters: the largest temporary is one parameter's size.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class AdamWState(NamedTuple):
    step: int               # updates applied (a host int: no device read)
    mu: dict                # name → float32 first moment
    nu: dict                # name → float32 second moment


def init(model: nn.Module) -> AdamWState:
    """Zero moments beside each parameter of ``model``, on its device."""
    def zeros():
        return {name: torch.zeros_like(p, dtype=torch.float32)
                for name, p in model.named_parameters()}
    return AdamWState(step=0, mu=zeros(), nu=zeros())


def _split_axes(mesh, spec) -> tuple:
    """The axes of size above 1 that ``spec`` splits, in mesh order."""
    named = [a for e in spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)]
    return tuple(a for a in mesh.axes(named) if mesh.axis_size(a) > 1)


def global_norm(grads: dict, *, mesh=None, specs: dict | None = None
                ) -> torch.Tensor:
    """sqrt(Σ g²) over every gradient, a 0-d float32 device tensor.

    On a mesh (``launch.mesh.LMMesh``) each gradient is this rank's shard
    of its leaf under ``specs[name]``, and every element counts once: a
    leaf's squares are summed over the axes it is split on, and an axis
    that holds copies of it adds nothing.  With no leaf split, this is
    the one-process norm."""
    groups: dict = {}
    for name, g in grads.items():
        axes = _split_axes(mesh, specs[name]) if mesh is not None else ()
        groups.setdefault(axes, []).append(g.float())
    if list(groups) == [()]:
        norms = torch._foreach_norm(groups[()])
        return torch.linalg.vector_norm(torch.stack(norms))
    total = None
    for axes, gs in groups.items():
        sq = torch.stack(torch._foreach_norm(gs)).square().sum()
        sq = mesh.all_reduce(sq, axes) if axes else sq
        total = sq if total is None else total + sq
    return total.sqrt()


@torch.no_grad()
def update(grads: dict, state: AdamWState, params: dict, *,
           lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.1,
           grad_clip: float = 1.0, mesh=None, specs: dict | None = None
           ) -> tuple[dict, AdamWState]:
    """One AdamW step on ``params`` (name → tensor) from ``grads`` (name →
    tensor, the same names).  ``params``, ``state.mu`` and ``state.nu``
    are written in place and the gradients are scaled in place by the
    clip; returns ``(params, state with step + 1)``, the reference's
    shape.  Reads no device value on the host.  On a mesh, every tensor
    is this rank's shard under ``specs`` and only the clip's norm needs
    the other ranks (``global_norm``); the rest is elementwise."""
    step = state.step + 1
    scale = torch.clamp(grad_clip / torch.clamp(
        global_norm(grads, mesh=mesh, specs=specs), min=1e-12), max=1.0)
    f32 = np.float32
    bc1 = float(f32(1) - f32(b1) ** f32(step))
    bc2 = float(f32(1) - f32(b2) ** f32(step))
    for name, p in params.items():
        g, m, v = grads[name].float(), state.mu[name], state.nu[name]
        g.mul_(scale)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        u = torch.div(m, bc1).div_(v.div(bc2).sqrt_().add_(eps))
        pf = p.float()                  # p itself when it is float32
        u.add_(pf, alpha=weight_decay)
        pf.sub_(u, alpha=lr)
        if pf is not p:
            p.copy_(pf)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
