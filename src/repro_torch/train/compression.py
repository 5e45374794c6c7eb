"""int8 gradient compression with error feedback (the port of
``repro.train.compression``).

Each tensor travels as int8 values and one float32 scale (≈4× fewer bytes
than float32), and the local quantization error is added to the next
step's gradient, so the compression noise telescopes instead of
accumulating.  ``compressed_all_reduce`` is the reference's
``compressed_psum`` over a ``torch.distributed`` group: the scale agreed
by an all-reduce MAX, the int8 payload summed in int32.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q, scale), scale a 0-d float32 tensor."""
    scale = x.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_leaf(g: torch.Tensor, err: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round for a gradient: (what the wire carries,
    dequantized; the new error residual)."""
    target = g.float() + err
    sent = dequantize_int8(*quantize_int8(target))
    return sent, target - sent


def compress_grads(grads: dict, err_state: dict | None
                   ) -> tuple[dict, dict]:
    """``compress_leaf`` over a dict of gradients; ``err_state=None``
    starts from zero errors."""
    if err_state is None:
        err_state = {k: torch.zeros_like(g, dtype=torch.float32)
                     for k, g in grads.items()}
    out = {k: compress_leaf(g, err_state[k]) for k, g in grads.items()}
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def compressed_all_reduce(x: torch.Tensor, err: torch.Tensor, group=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce over ``group``: (the sum over the group's ranks of
    each rank's dequantized payload, this rank's new error residual).
    With no process group initialised it is the one-rank case."""
    target = x.float() + err
    amax = target.abs().max()
    if _initialized():
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax / 127.0 + 1e-30
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int32)
    total = q.clone()
    if _initialized():
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale, target - q.float() * scale


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def wire_bytes(tree, *, compressed: bool) -> int:
    """Bytes a ring all-reduce moves per step for the tensors of ``tree``
    (nested dicts): 2 × the payload (per hop 2(n−1)/n ≈ 2×), int8 and one
    float32 scale a tensor compressed, float32 not."""
    total = 0
    for g in _leaves(tree):
        total += g.numel() * (1 if compressed else 4) + \
            (4 if compressed else 0)
    return 2 * total
