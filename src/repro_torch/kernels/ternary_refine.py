"""Fused multi-level FaTRQ refinement: the CUDA kernel and its plain
PyTorch version.

``ternary_refine_fused`` runs every TRQ level over a query micro-batch's
candidates: level 0 scores the calibrated estimate and the certified
(lo, hi) interval, deeper levels stack ``est −= 2·proj·align`` with the
remaining-residual margin, and after each level τ = kth-smallest ``hi``
among survivors prunes ``alive &= lo ≤ τ``.  It returns the final
estimates, the survivor mask and per-level survivor counts (total, then
the delta-page share), exactly what ``repro.kernels.ops.
fused_refine_scores_batch`` returns for the TPU kernel
``repro.kernels.ternary_refine.ternary_refine_fused``.

The kernel (``csrc/ternary_refine.cu``) reads packed codes and record
scalars by candidate id from per-index stores (``RefineStores``), so no
(Q, C, G) gathered copy of the codes is made.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.core.packing import POW3
from repro_torch.kernels import build, ops

#: launches of the CUDA kernel pair (one per TRQ level per call)
launches = 0

#: largest top-k the pruning step keeps per thread (kMaxK in the source)
MAX_K = 64

_ARGS = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
#: queries per step of the plain version (bounds its (Q, C, G) temporaries)
_PLAIN_QUERIES = 8


@dataclass(frozen=True)
class RefineStores:
    """What the kernel gathers by candidate id, built once per index."""

    packed: tuple[torch.Tensor, ...]   # per level (N, G) uint8
    records: torch.Tensor              # (N, 4) [||δ||², ⟨x_c,δ⟩, ||δ||, rho]
    levels: tuple[torch.Tensor, ...]   # per level (N, 4) [proj, norm, rho, 0]
    dim: int

    @classmethod
    def from_trq(cls, trq) -> "RefineStores":
        return cls(packed=tuple(lv.packed.contiguous() for lv in trq.levels),
                   records=ops.record_table(trq.scalars),
                   levels=tuple(ops.level_table(lv) for lv in trq.levels),
                   dim=trq.dim)

    @property
    def num_levels(self) -> int:
        return len(self.packed)


@dataclass(frozen=True)
class LevelTrace:
    """The plain version's per-level intermediates (for diagnosing a
    kernel/plain disagreement on near-ties)."""

    lo: tuple[torch.Tensor, ...]      # per level (Q, C)
    tau: tuple[torch.Tensor, ...]     # per level (Q,)
    alive: tuple[torch.Tensor, ...]   # per level (Q, C) bool


def _align(packed_rows: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Σ c·q / √k from packed bytes (Q, C, G) and digit planes (Q, 5, G),
    accumulated digit by digit as the TPU kernel does."""
    y = packed_rows.to(torch.int32)
    acc = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    kcnt = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
    for i, p in enumerate(POW3):
        digit = torch.div(y, p, rounding_mode="floor") % 3 - 1
        acc = acc + digit.float() * planes[:, i, None, :]
        kcnt += digit * digit
    k = kcnt.sum(-1).float()
    return acc.sum(-1) / torch.sqrt(torch.clamp(k, min=1.0))


def _kth_smallest(vals: torch.Tensor, k: int) -> torch.Tensor:
    """kth-smallest per row; +inf when a row has fewer than k entries (the
    kernel's lists start at +inf, as the TPU kernel's padded slots do)."""
    if vals.shape[-1] < k:
        return torch.full(vals.shape[:-1], float("inf"), device=vals.device)
    return torch.topk(vals, k, dim=-1, largest=False).values[..., -1]


def _plain_block(stores, planes, params, ids, d0, valid, is_delta, *, k,
                 bound):
    long_ids = ids.long()
    col = lambda j: params[:, j:j + 1]                        # noqa: E731
    qn, w0, w1, w2, w3, bias, zr, rs = (col(j) for j in range(8))
    inf = torch.tensor(float("inf"), device=ids.device)
    nl = stores.num_levels
    counts = torch.zeros((ids.shape[0], 2 * nl), dtype=torch.int32,
                         device=ids.device)
    alive = valid
    los, taus, alives = [], [], []
    est = None
    for lv in range(nl):
        align = _align(stores.packed[lv][long_ids], planes)
        if lv == 0:
            rec = stores.records[long_ids]
            dsq, cross, norm, rho = rec.unbind(-1)
            e_align = align / torch.clamp(qn, min=1e-30)
            d_ip = -2.0 * norm * rho * align
            est = w0 * d0 + w1 * d_ip + w2 * dsq + w3 * cross + bias
            if bound == "cauchy":
                raw = d0 + dsq + 2.0 * cross + d_ip
                margin = (2.0 * qn * norm
                          * torch.sqrt(torch.clamp(1.0 - e_align * e_align,
                                                   0.0, 1.0))
                          * torch.sqrt(torch.clamp(1.0 - rho * rho, 0.0,
                                                   1.0)))
                lo, hi = raw - margin, raw + margin
            elif bound == "quantile":
                lo, hi = est - zr, est + zr
            else:
                raise ValueError(f"unknown bound {bound!r}")
        else:
            proj, norm, rho, _ = stores.levels[lv][long_ids].unbind(-1)
            est = est - 2.0 * proj * align
            rem = norm * torch.sqrt(torch.clamp(1.0 - rho * rho, 0.0, 1.0))
            marg = 2.0 * qn * rem + rs
            lo, hi = est - marg, est + marg
        tau = _kth_smallest(torch.where(alive, hi, inf), k)
        alive = alive & (lo <= tau[:, None])
        counts[:, lv] = alive.sum(-1, dtype=torch.int32)
        if is_delta is not None:
            counts[:, nl + lv] = (alive & is_delta).sum(-1, dtype=torch.int32)
        los.append(lo)
        taus.append(tau)
        alives.append(alive)
    return est, alive, counts, (los, taus, alives)


def refine_plain(stores: RefineStores, q_planes: torch.Tensor,
                 params: torch.Tensor, ids: torch.Tensor, d0: torch.Tensor,
                 valid: torch.Tensor, is_delta: torch.Tensor | None, *,
                 k: int, bound: str):
    """The kernel's function in plain PyTorch, on its assembled inputs.
    Returns (est, alive, counts, LevelTrace)."""
    parts = []
    for a in range(0, ids.shape[0], _PLAIN_QUERIES):
        sl = slice(a, a + _PLAIN_QUERIES)
        parts.append(_plain_block(
            stores, q_planes[sl], params[sl], ids[sl], d0[sl], valid[sl],
            None if is_delta is None else is_delta[sl], k=k, bound=bound))
    cat = lambda xs: torch.cat(xs, dim=0)                     # noqa: E731
    trace = LevelTrace(*(tuple(cat([p[3][f][lv] for p in parts])
                               for lv in range(stores.num_levels))
                         for f in range(3)))
    return (cat([p[0] for p in parts]), cat([p[1] for p in parts]),
            cat([p[2] for p in parts]), trace)


def ternary_refine_fused(stores: RefineStores, q: torch.Tensor,
                         ids: torch.Tensor, d0: torch.Tensor,
                         valid: torch.Tensor, is_delta: torch.Tensor | None,
                         model, *, k: int, bound: str, z: float):
    """All TRQ levels over candidates ``ids (Q, C)`` of queries ``q (Q, D)``.

    d0 (Q, C) f32 coarse distances, valid/is_delta (Q, C) bool (is_delta
    may be None), ``model`` the calibration (w, bias, resid_std).  Returns
    (est (Q, C) f32, alive (Q, C) bool, counts (Q, 2L) int32).  CPU
    tensors take the plain version; a CUDA tensor launches the kernel or
    raises.
    """
    if bound not in ("cauchy", "quantile"):
        raise ValueError(f"unknown bound {bound!r}")
    g = stores.packed[0].shape[1]
    ops.check_smem_budget("ternary_refine_fused", ops.refine_smem_bytes(g))
    q_planes = ops.make_query_planes(q, g)
    params = ops.query_params(q, model.w, model.bias, model.resid_std, z)
    if ids.device.type == "cpu":
        est, alive, counts, _ = refine_plain(stores, q_planes, params, ids,
                                             d0, valid, is_delta, k=k,
                                             bound=bound)
        return est, alive, counts
    if not 1 <= k <= MAX_K:
        raise ValueError(f"ternary_refine_fused: k={k} outside [1, {MAX_K}]")
    nq, c = ids.shape
    nl = stores.num_levels
    dev = ids.device
    n = stores.records.shape[0]
    build.require("ids", ids, dtype=torch.int32, shape=(nq, c), device=dev)
    build.require("d0", d0, dtype=torch.float32, shape=(nq, c), device=dev)
    build.require("valid", valid, dtype=torch.bool, shape=(nq, c),
                  device=dev)
    if is_delta is not None:
        build.require("is_delta", is_delta, dtype=torch.bool, shape=(nq, c),
                      device=dev)
    build.require("records", stores.records, dtype=torch.float32,
                  shape=(n, 4), device=dev)
    for lv in range(nl):
        build.require(f"packed[{lv}]", stores.packed[lv], dtype=torch.uint8,
                      shape=(n, g), device=dev)
        build.require(f"levels[{lv}]", stores.levels[lv],
                      dtype=torch.float32, shape=(n, 4), device=dev)
    est = torch.empty((nq, c), dtype=torch.float32, device=dev)
    lo = torch.empty_like(est)
    hi = torch.empty_like(est)
    alive = torch.empty((nq, c), dtype=torch.bool, device=dev)
    counts = torch.zeros((nq, 2 * nl), dtype=torch.int32, device=dev)
    fn = build.entry("ternary_refine", "fatrq_refine_level", _ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    global launches
    for lv in range(nl):
        status = fn(build.ptr(stores.packed[lv]), build.ptr(ids),
                    build.ptr(d0), build.ptr(q_planes),
                    build.ptr(stores.records), build.ptr(stores.levels[lv]),
                    build.ptr(params), build.ptr(valid if lv == 0 else alive),
                    build.ptr(is_delta), build.ptr(est), build.ptr(lo),
                    build.ptr(hi), build.ptr(alive), build.ptr(counts),
                    nq, c, g, lv, nl, k, int(bound == "quantile"), stream)
        build.check("ternary_refine", status, "ternary_refine_fused")
        launches += 1
    return est, alive, counts
