"""FaTRQ refinement: the CUDA kernels and their plain PyTorch versions.

``ternary_refine_fused`` runs every TRQ level over a query micro-batch's
candidates: level 0 scores the calibrated estimate and the certified
(lo, hi) interval, deeper levels stack ``est −= 2·proj·align`` with the
remaining-residual margin, and after each level τ = kth-smallest ``hi``
among survivors prunes ``alive &= lo ≤ τ``.  It returns the final
estimates, the survivor mask and per-level survivor counts (total, then
the delta-page share), exactly what ``repro.kernels.ops.
fused_refine_scores_batch`` returns for the TPU kernel
``repro.kernels.ternary_refine.ternary_refine_fused``.

``ternary_refine_fused_bounds`` is its sharded form (the TPU kernel of the
same name): the same level stacking with no mask, returning every level's
(lo, hi) so the caller pools the thresholds across shards.

``ternary_refine_batch`` and ``ternary_refine`` score level 0 only, from
code rows already gathered per candidate, as the TPU kernels of the same
names do (``kernels.ops.refine_scores_batch`` / ``refine_scores``).

The multi-level kernels (``csrc/ternary_refine.cu``) read packed codes and
record scalars by candidate id from per-index stores (``RefineStores``),
so no (Q, C, G) gathered copy of the codes is made, and score only valid
slots: an invalid slot reads no code row and no scalar, and takes align
and every scalar as 0 (``_plain_levels`` applies the same rule).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.core.estimator import alive_chain
from repro_torch.core.packing import POW3, TRITS_PER_BYTE
from repro_torch.kernels import build, ops

#: launches of the fused kernel pair (one per TRQ level per call)
launches = 0
#: launches of the bounds kernel (one per call)
bounds_launches = 0
#: launches of the level-0 kernel by ``ternary_refine_batch`` and by
#: ``ternary_refine`` (one per call each)
batch_launches = 0
single_launches = 0

#: largest top-k the pruning step keeps per thread (kMaxK in the source)
MAX_K = 64

#: most TRQ levels the bounds kernel walks (kMaxLevels in the source)
MAX_LEVELS = 8

_ARGS = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_BOUNDS_ARGS = ([ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_void_p] * 9
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_LEVEL0_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
#: queries per step of the plain version (bounds its (Q, C, G) temporaries)
_PLAIN_QUERIES = 8


@dataclass(frozen=True)
class RefineStores:
    """What the kernel gathers by candidate id, built once per index."""

    packed: tuple[torch.Tensor, ...]   # per level (N, G) uint8
    records: torch.Tensor              # (N, 4) [||δ||², ⟨x_c,δ⟩, ||δ||, rho]
    # per level (N, 4) [proj, norm, rho, √max(k, 1)], k the code row's
    # nonzero trits (``ops.level_table``)
    levels: tuple[torch.Tensor, ...]
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


def _dot_count(packed_rows: torch.Tensor, planes: torch.Tensor):
    """(Σ c·q, k) from packed bytes (Q, C, G) and digit planes (Q, 5, G),
    k the nonzero trits, accumulated digit by digit as the TPU kernel
    does."""
    y = packed_rows.to(torch.int32)
    acc = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    kcnt = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
    for i, p in enumerate(POW3):
        digit = torch.div(y, p, rounding_mode="floor") % 3 - 1
        acc = acc + digit.float() * planes[:, i, None, :]
        kcnt += digit * digit
    return acc.sum(-1), kcnt.sum(-1)


def _align(packed_rows: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Σ c·q / √k (``_dot_count``)."""
    dot, k = _dot_count(packed_rows, planes)
    return dot / torch.sqrt(torch.clamp(k.float(), min=1.0))


def _score0(align, params, d0, dsq, cross, norm, rho):
    """Level-0 (est, est_raw, margin) of every slot (the TPU kernels'
    ``_score_block``); ``params`` rows [||q||, w0..w3, bias, ·, ·]."""
    qn, w0, w1, w2, w3, bias = (params[:, j:j + 1] for j in range(6))
    e_align = align / torch.clamp(qn, min=1e-30)
    d_ip = -2.0 * norm * rho * align
    est = w0 * d0 + w1 * d_ip + w2 * dsq + w3 * cross + bias
    raw = d0 + dsq + 2.0 * cross + d_ip
    margin = (2.0 * qn * norm
              * torch.sqrt(torch.clamp(1.0 - e_align * e_align, 0.0, 1.0))
              * torch.sqrt(torch.clamp(1.0 - rho * rho, 0.0, 1.0)))
    return est, raw, margin


def _plain_levels(stores, planes, params, ids, d0, valid, *, bound):
    """(est, lo, hi) of every TRQ level in turn, unpruned: level 0 scores
    the calibrated estimate and its certified interval, deeper levels stack
    ``est −= 2·proj·align`` with the remaining-residual margin.  Invalid
    slots take align and the record and level scalars as 0, as the kernels
    do: est = w0·d0 + bias, (lo, hi) = (d0, d0) (Cauchy) or est ∓ z·rs
    (quantile) at level 0; est carried, margin rs, deeper."""
    long_ids = ids.long()
    qn, zr, rs = params[:, 0:1], params[:, 6:7], params[:, 7:8]
    zero = torch.zeros((), dtype=torch.float32, device=ids.device)
    gather = lambda table: torch.where(                       # noqa: E731
        valid[..., None], table[long_ids], zero).unbind(-1)
    est = None
    for lv in range(stores.num_levels):
        align = torch.where(valid, _align(stores.packed[lv][long_ids],
                                          planes), zero)
        if lv == 0:
            dsq, cross, norm, rho = gather(stores.records)
            est, raw, margin = _score0(align, params, d0, dsq, cross, norm,
                                       rho)
            if bound == "cauchy":
                lo, hi = raw - margin, raw + margin
            elif bound == "quantile":
                lo, hi = est - zr, est + zr
            else:
                raise ValueError(f"unknown bound {bound!r}")
        else:
            proj, norm, rho, _ = gather(stores.levels[lv])
            est = est - 2.0 * proj * align
            rem = norm * torch.sqrt(torch.clamp(1.0 - rho * rho, 0.0, 1.0))
            marg = 2.0 * qn * rem + rs
            lo, hi = est - marg, est + marg
        yield est, lo, hi


def _plain_block(stores, planes, params, ids, d0, valid, is_delta, *, k,
                 bound):
    levels = list(_plain_levels(stores, planes, params, ids, d0, valid,
                                bound=bound))
    lo, hi = (torch.stack([lv[j] for lv in levels], dim=1) for j in (1, 2))
    alives, taus = alive_chain(lo, hi, valid, k)
    delta = torch.zeros_like(valid) if is_delta is None else is_delta
    counts = torch.stack([a.sum(-1, dtype=torch.int32) for a in alives]
                         + [(a & delta).sum(-1, dtype=torch.int32)
                            for a in alives], dim=1)
    return levels[-1][0], alives[-1], counts, (lo.unbind(1), taus, alives)


def _by_queries(fn, *args):
    """Run ``fn`` on ``_PLAIN_QUERIES`` queries at a time (the leading axis
    of every argument; None passes through) and return its parts."""
    nq = args[0].shape[0]
    return [fn(*(None if a is None else a[i:i + _PLAIN_QUERIES]
                 for a in args))
            for i in range(0, nq, _PLAIN_QUERIES)]


def refine_plain(stores: RefineStores, q_planes: torch.Tensor,
                 params: torch.Tensor, ids: torch.Tensor, d0: torch.Tensor,
                 valid: torch.Tensor, is_delta: torch.Tensor | None, *,
                 k: int, bound: str):
    """The fused kernel's function in plain PyTorch, on its assembled
    inputs.  Returns (est, alive, counts, LevelTrace)."""
    parts = _by_queries(
        lambda *a: _plain_block(stores, *a, k=k, bound=bound),
        q_planes, params, ids, d0, valid, is_delta)
    cat = lambda xs: torch.cat(xs, dim=0)                     # noqa: E731
    trace = LevelTrace(*(tuple(cat([p[3][f][lv] for p in parts])
                               for lv in range(stores.num_levels))
                         for f in range(3)))
    return (cat([p[0] for p in parts]), cat([p[1] for p in parts]),
            cat([p[2] for p in parts]), trace)


def _bounds_block(stores, planes, params, ids, d0, valid, *, bound):
    levels = list(_plain_levels(stores, planes, params, ids, d0, valid,
                                bound=bound))
    inf = torch.tensor(float("inf"), device=ids.device)
    est = torch.where(valid, levels[-1][0], inf)
    lo, hi = (torch.where(valid[:, None], torch.stack(
        [lv[j] for lv in levels], dim=1), inf) for j in (1, 2))
    return est, lo, hi


def refine_bounds_plain(stores: RefineStores, q_planes: torch.Tensor,
                        params: torch.Tensor, ids: torch.Tensor,
                        d0: torch.Tensor, valid: torch.Tensor, *,
                        bound: str):
    """The bounds kernel's function in plain PyTorch, on its assembled
    inputs: (est (Q, C), lo (Q, L, C), hi (Q, L, C)), +inf on invalid
    slots as the kernel writes them."""
    parts = _by_queries(
        lambda *a: _bounds_block(stores, *a, bound=bound),
        q_planes, params, ids, d0, valid)
    return tuple(torch.cat([p[j] for p in parts], dim=0) for j in range(3))


def _level0_block(packed, planes, scalars, params):
    d0, dsq, cross, norm, rho = scalars.unbind(-1)
    return torch.stack(_score0(_align(packed, planes), params, d0, dsq,
                               cross, norm, rho), dim=-1)


def refine_level0_plain(packed: torch.Tensor, q_planes: torch.Tensor,
                        scalars: torch.Tensor,
                        params: torch.Tensor) -> torch.Tensor:
    """The level-0 kernel's function in plain PyTorch: gathered rows
    packed (Q, C, G), planes (Q, 5, G), scalars (Q, C, 5) [d0, ||δ||²,
    ⟨x_c,δ⟩, ||δ||, rho], params (Q, 8) → (Q, C, 3) [est, est_raw,
    margin]."""
    return torch.cat(_by_queries(_level0_block, packed, q_planes, scalars,
                                 params), dim=0)


def _require_stores(stores: RefineStores, g: int, dev) -> None:
    n = stores.records.shape[0]
    build.require("records", stores.records, dtype=torch.float32,
                  shape=(n, 4), device=dev)
    for lv in range(stores.num_levels):
        build.require(f"packed[{lv}]", stores.packed[lv], dtype=torch.uint8,
                      shape=(n, g), device=dev)
        build.require(f"levels[{lv}]", stores.levels[lv],
                      dtype=torch.float32, shape=(n, 4), device=dev)


def _check_bound(bound: str) -> None:
    if bound not in ("cauchy", "quantile"):
        raise ValueError(f"unknown bound {bound!r}")


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

    Only valid slots are scored, at every level.  An invalid slot takes
    align and its scalars as 0, so its est is w0·d0 + bias at every
    level; with d0 = +inf there, as the IVF front gives, that is what the
    TPU kernel writes.
    """
    _check_bound(bound)
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
    build.require("ids", ids, dtype=torch.int32, shape=(nq, c), device=dev)
    build.require("d0", d0, dtype=torch.float32, shape=(nq, c), device=dev)
    build.require("valid", valid, dtype=torch.bool, shape=(nq, c),
                  device=dev)
    if is_delta is not None:
        build.require("is_delta", is_delta, dtype=torch.bool, shape=(nq, c),
                      device=dev)
    _require_stores(stores, g, dev)
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
                    build.ptr(d0), build.ptr(valid), build.ptr(q_planes),
                    build.ptr(stores.records), build.ptr(stores.levels[lv]),
                    build.ptr(params), build.ptr(valid if lv == 0 else alive),
                    build.ptr(is_delta), build.ptr(est), build.ptr(lo),
                    build.ptr(hi), build.ptr(alive), build.ptr(counts),
                    nq, c, g, lv, nl, k, int(bound == "quantile"), stream)
        build.check("ternary_refine", status, "ternary_refine_fused")
        launches += 1
    return est, alive, counts


def ternary_refine_fused_bounds(stores: RefineStores, q: torch.Tensor,
                                ids: torch.Tensor, d0: torch.Tensor,
                                valid: torch.Tensor, model, *, bound: str,
                                z: float):
    """Every TRQ level's certified interval over candidates ``ids (Q, C)``,
    with no pruning (the sharded layout pools its thresholds across
    shards).  Same inputs as ``ternary_refine_fused`` less k and the delta
    flags.  Returns (est (Q, C), lo (Q, L, C), hi (Q, L, C)) f32, +inf on
    invalid slots; on valid slots est is bit-identical to the fused
    kernel's.  CPU tensors take the plain version; a CUDA tensor launches
    the kernel or raises.
    """
    _check_bound(bound)
    g = stores.packed[0].shape[1]
    ops.check_smem_budget("ternary_refine_fused_bounds",
                          ops.refine_smem_bytes(g))
    q_planes = ops.make_query_planes(q, g)
    params = ops.query_params(q, model.w, model.bias, model.resid_std, z)
    if ids.device.type == "cpu":
        return refine_bounds_plain(stores, q_planes, params, ids, d0, valid,
                                   bound=bound)
    nq, c = ids.shape
    nl = stores.num_levels
    if nl > MAX_LEVELS:
        raise ValueError(f"ternary_refine_fused_bounds: {nl} levels, over "
                         f"the kernel's {MAX_LEVELS}")
    dev = ids.device
    build.require("ids", ids, dtype=torch.int32, shape=(nq, c), device=dev)
    build.require("d0", d0, dtype=torch.float32, shape=(nq, c), device=dev)
    build.require("valid", valid, dtype=torch.bool, shape=(nq, c),
                  device=dev)
    _require_stores(stores, g, dev)
    est = torch.empty((nq, c), dtype=torch.float32, device=dev)
    lo = torch.empty((nq, nl, c), dtype=torch.float32, device=dev)
    hi = torch.empty_like(lo)
    ptrs = ctypes.c_void_p * nl
    fn = build.entry("ternary_refine", "fatrq_refine_bounds", _BOUNDS_ARGS)
    status = fn(ptrs(*(build.ptr(p) for p in stores.packed)),
                ptrs(*(build.ptr(t) for t in stores.levels)),
                build.ptr(ids), build.ptr(d0), build.ptr(valid),
                build.ptr(q_planes), build.ptr(stores.records),
                build.ptr(params), build.ptr(est), build.ptr(lo),
                build.ptr(hi), nq, c, g, nl, int(bound == "quantile"),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check("ternary_refine", status, "ternary_refine_fused_bounds")
    global bounds_launches
    bounds_launches += 1
    return est, lo, hi


def _launch_level0(what: str, packed, q_planes, scalars, params, out,
                   nq: int, c: int, g: int) -> None:
    fn = build.entry("ternary_refine", "fatrq_refine_level0", _LEVEL0_ARGS)
    status = fn(build.ptr(packed), build.ptr(q_planes), build.ptr(scalars),
                build.ptr(params), build.ptr(out), nq, c, g,
                torch.cuda.current_stream(packed.device).cuda_stream)
    build.check("ternary_refine", status, what)


def ternary_refine_batch(packed: torch.Tensor, q_planes: torch.Tensor,
                         scalars: torch.Tensor,
                         params: torch.Tensor) -> torch.Tensor:
    """Level-0 scoring of gathered code rows ``packed (Q, C, G)`` uint8
    with planes (Q, 5, G), scalars (Q, C, 5) [d0, ||δ||², ⟨x_c,δ⟩, ||δ||,
    rho] and params (Q, 8) [||q||, w0..w3, bias, 0, 0] → (Q, C, 3)
    f32 [est, est_raw, margin].  CPU tensors take the plain version; a
    CUDA tensor launches the kernel or raises."""
    nq, c, g = packed.shape
    ops.check_smem_budget("ternary_refine_batch", ops.level0_smem_bytes(g))
    if packed.device.type == "cpu":
        return refine_level0_plain(packed, q_planes, scalars, params)
    dev = packed.device
    build.require("packed", packed, dtype=torch.uint8, shape=(nq, c, g),
                  device=dev)
    build.require("q_planes", q_planes, dtype=torch.float32,
                  shape=(nq, TRITS_PER_BYTE, g), device=dev)
    build.require("scalars", scalars, dtype=torch.float32, shape=(nq, c, 5),
                  device=dev)
    build.require("params", params, dtype=torch.float32, shape=(nq, 8),
                  device=dev)
    out = torch.empty((nq, c, 3), dtype=torch.float32, device=dev)
    _launch_level0("ternary_refine_batch", packed, q_planes, scalars, params,
                   out, nq, c, g)
    global batch_launches
    batch_launches += 1
    return out


def ternary_refine(packed: torch.Tensor, q_planes: torch.Tensor,
                   scalars: torch.Tensor, params: torch.Tensor
                   ) -> torch.Tensor:
    """``ternary_refine_batch`` for one query: packed (C, G), planes
    (5, G), scalars (C, 5), params (1, 8) → (C, 3).  CPU tensors take the
    plain version; a CUDA tensor launches the kernel (with Q = 1) or
    raises."""
    c, g = packed.shape
    ops.check_smem_budget("ternary_refine", ops.level0_smem_bytes(g))
    if packed.device.type == "cpu":
        return refine_level0_plain(packed[None], q_planes[None],
                                   scalars[None], params)[0]
    dev = packed.device
    build.require("packed", packed, dtype=torch.uint8, shape=(c, g),
                  device=dev)
    build.require("q_planes", q_planes, dtype=torch.float32,
                  shape=(TRITS_PER_BYTE, g), device=dev)
    build.require("scalars", scalars, dtype=torch.float32, shape=(c, 5),
                  device=dev)
    build.require("params", params, dtype=torch.float32, shape=(1, 8),
                  device=dev)
    out = torch.empty((c, 3), dtype=torch.float32, device=dev)
    _launch_level0("ternary_refine", packed, q_planes, scalars, params, out,
                   1, c, g)
    global single_launches
    single_launches += 1
    return out
