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

``ternary_refine_prune`` runs one pruning step alone on given bounds (the
fused kernel's prune launch, bound on its own for ``chip_smoke.py``);
``prune_plain`` is its plain version, and the plain fused version prunes
with it.

``ternary_refine_batch`` and ``ternary_refine`` score level 0 only, from
code rows already gathered per candidate, as the TPU kernels of the same
names do (``kernels.ops.refine_scores_batch`` / ``refine_scores``).

The multi-level kernels (``csrc/ternary_refine.cu``) read packed codes and
record scalars by candidate id from per-index stores (``RefineStores``),
so no (Q, C, G) gathered copy of the codes is made, and score only valid
slots: an invalid slot reads no code row and no scalar, and takes align
and every scalar as 0 (``_plain_levels`` applies the same rule).

Every kernel takes any G and C.  Where a query's tables (or the prune's
staged slice) do not fit a block's shared memory, the wrapper runs the
kernel's global form, which gives the same bits (``ops.refine_form``,
``prune_form``, ``level0_form``): the refine and level-0 kernels keep the
tables in a scratch buffer the wrapper allocates, and the fused kernel's
score launch and the bounds kernel stage them from there into shared
memory a column chunk at a time (``ops.refine_plan``,
``ops.bounds_plan``), the level-0 kernel its pair tables with each warp's
code rows by the same pass chunks (``ops.level0_plan``); the prune streams
each block's slice once and keeps only candidate keys in shared memory
(``ops.PRUNE_STREAM_SMEM``), with no scratch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.core.estimator import pooled_k_smallest
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
#: launches of the prune alone by ``ternary_refine_prune`` (the fused
#: kernel's own prune launches count in ``launches``)
prune_launches = 0
#: of those launches, the global forms': fused levels whose scoring read
#: scratch tables, bounds calls, level-0 calls (both entry points), and
#: streaming prune launches (the fused kernel's and the prune's alone)
global_launches = 0
bounds_global_launches = 0
level0_global_launches = 0
prune_global_launches = 0
#: launches of the global forms' table kernels: the refine tables (one per
#: fused or bounds call, for all of its levels) and the level-0 pair tables
#: (one per level-0 call)
tables_launches = 0
pair_tables_launches = 0
#: the chunk plan of the last global-form launch of the fused kernel's
#: score launch (``ops.RefinePlan``), of the bounds kernel
#: (``ops.BoundsPlan``) and of the level-0 kernel (``ops.Level0Plan``),
#: each checked against the shared bytes the launch asked for; None before
#: any
last_plan = None
bounds_last_plan = None
level0_last_plan = None

#: largest k the pruning step takes (kMaxK in the source)
MAX_K = 64

#: most TRQ levels the bounds kernel walks (kMaxLevels in the source)
MAX_LEVELS = 8

_ARGS = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 9
         + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
_BOUNDS_ARGS = ([ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_void_p] * 10
                + [ctypes.c_int] * 6
                + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
_LEVEL0_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
_PRUNE_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TABLES_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
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


def prune_plain(lo: torch.Tensor, hi: torch.Tensor, alive: torch.Tensor,
                is_delta: torch.Tensor | None, *, k: int):
    """One pruning step in plain PyTorch: τ = the kth-smallest ``hi`` among
    alive slots, a value over the multiset (so ties need no order), +inf
    when fewer than k slots are alive, then ``alive & (lo ≤ τ)``.  lo/hi
    (Q, C) f32, alive/is_delta (Q, C) bool (is_delta may be None).
    Returns (alive_out, survivors (Q,), their delta-page share (Q,), τ
    (Q,)), the counts int32."""
    masked = torch.where(alive, hi, torch.full_like(hi, float("inf")))
    if masked.shape[-1] < k:   # fewer than k slots: τ = +inf
        masked = torch.nn.functional.pad(masked, (0, k - masked.shape[-1]),
                                         value=float("inf"))
    tau = pooled_k_smallest(masked, k)
    out = alive & (lo <= tau[:, None])
    dcnt = out & is_delta if is_delta is not None else torch.zeros_like(out)
    return (out, out.sum(-1, dtype=torch.int32),
            dcnt.sum(-1, dtype=torch.int32), tau)


def _plain_block(stores, planes, params, ids, d0, valid, is_delta, *, k,
                 bound):
    steps, alive = [], valid
    for est, lo, hi in _plain_levels(stores, planes, params, ids, d0, valid,
                                     bound=bound):
        alive, cnt, dcnt, tau = prune_plain(lo, hi, alive, is_delta, k=k)
        steps.append((lo, tau, alive, cnt, dcnt))
    los, taus, alives, cnts, dcnts = zip(*steps)
    return est, alive, torch.stack(cnts + dcnts, dim=1), (los, taus, alives)


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


def _tables(q_planes: torch.Tensor, *, pairs: bool) -> torch.Tensor:
    """The global forms' per-query tables, built on the card from the
    planes (Q, 5, G) by ``fatrq_refine_tables``: (Q, 37, Gp) f32, or the
    level-0 kernel's (Q, 37, Gp, 2) pairs."""
    nq, _, g = q_planes.shape
    shape = (nq, 37, ops.table_width(g)) + ((2,) if pairs else ())
    tables = torch.empty(shape, dtype=torch.float32, device=q_planes.device)
    fn = build.entry("ternary_refine", "fatrq_refine_tables", _TABLES_ARGS)
    status = fn(build.ptr(q_planes), build.ptr(tables), nq, g, int(pairs),
                torch.cuda.current_stream(q_planes.device).cuda_stream)
    build.check("ternary_refine", status, "fatrq_refine_tables")
    global tables_launches, pair_tables_launches
    if pairs:
        pair_tables_launches += 1
    else:
        tables_launches += 1
    return tables


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
    return _fused(stores, q, ids, d0, valid, is_delta, model, k=k,
                  bound=bound, z=z)


def _fused(stores, q, ids, d0, valid, is_delta, model, *, k, bound, z,
           form: str | None = None):
    """``ternary_refine_fused``; ``form`` names the form of the scoring
    and the prune launches instead of the shapes (to hold the two forms
    against each other)."""
    _check_bound(bound)
    g = stores.packed[0].shape[1]
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
    # every entry is stored by one level's prune
    counts = torch.empty((nq, 2 * nl), dtype=torch.int32, device=dev)
    # the tables depend on the query alone: built once for every level
    glob = ops.pick_form("ternary_refine_fused", ops.refine_form(g),
                         form) == "global"
    tables = _tables(q_planes, pairs=False) if glob else None
    plan = ops.refine_plan(g) if glob else None
    p_glob = ops.pick_form("ternary_refine_fused (prune)",
                           ops.prune_form(c), form) == "global"
    fn = build.entry("ternary_refine", "fatrq_refine_level", _ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    smem = ctypes.c_int(0)
    global launches, global_launches, prune_global_launches, last_plan
    for lv in range(nl):
        status = fn(build.ptr(stores.packed[lv]), build.ptr(ids),
                    build.ptr(d0), build.ptr(valid), build.ptr(q_planes),
                    build.ptr(stores.records), build.ptr(stores.levels[lv]),
                    build.ptr(params), build.ptr(valid if lv == 0 else alive),
                    build.ptr(is_delta), build.ptr(est), build.ptr(lo),
                    build.ptr(hi), build.ptr(alive), build.ptr(counts),
                    build.ptr(tables), int(p_glob), nq, c, g, lv, nl, k,
                    int(bound == "quantile"), plan.passes if glob else 0,
                    ctypes.byref(smem), stream)
        build.check("ternary_refine", status, "ternary_refine_fused")
        launches += 1
        global_launches += int(glob)
        prune_global_launches += int(p_glob)
        if glob:
            last_plan = ops.launched_plan("ternary_refine_fused", plan,
                                          smem.value)
    return est, alive, counts


def ternary_refine_prune(lo: torch.Tensor, hi: torch.Tensor,
                         alive: torch.Tensor, is_delta: torch.Tensor | None,
                         counts: torch.Tensor, out: torch.Tensor, *, k: int,
                         level: int = 0) -> torch.Tensor:
    """One pruning step on given bounds, as the fused kernel runs it after
    scoring a level (``prune_plain``'s function): lo/hi (Q, C) f32,
    alive/is_delta (Q, C) bool (is_delta may be None), 1 ≤ k ≤ ``MAX_K``.
    Stores the survivor count and its delta-page share in
    ``counts[:, level]`` and ``counts[:, L + level]`` of ``counts (Q, 2L)``
    int32 and the survivor mask in ``out`` (Q, C) bool, which may be
    ``alive`` itself, as at the fused kernel's deeper levels.  Returns τ
    (Q,).  CPU tensors take the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    return _prune(lo, hi, alive, is_delta, counts, out, k=k, level=level)


def _prune(lo, hi, alive, is_delta, counts, out, *, k: int, level: int = 0,
           form: str | None = None):
    """``ternary_refine_prune``; ``form`` names the prune's form instead of
    the shapes."""
    nq, c = hi.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"ternary_refine_prune: k={k} outside [1, {MAX_K}]")
    nl = counts.shape[1] // 2
    if not 0 <= level < nl:
        raise ValueError(f"ternary_refine_prune: level {level} outside the "
                         f"{nl} levels of counts")
    dev = hi.device
    if dev.type == "cpu":
        mask, cnt, dcnt, tau = prune_plain(lo, hi, alive, is_delta, k=k)
        out.copy_(mask)
        counts[:, level] = cnt
        counts[:, nl + level] = dcnt
        return tau
    for name, t, dtype in (("lo", lo, torch.float32),
                           ("hi", hi, torch.float32),
                           ("alive", alive, torch.bool),
                           ("is_delta", is_delta, torch.bool),
                           ("out", out, torch.bool)):
        if t is not None:
            build.require(name, t, dtype=dtype, shape=(nq, c), device=dev)
    build.require("counts", counts, dtype=torch.int32, shape=(nq, 2 * nl),
                  device=dev)
    tau = torch.empty((nq,), dtype=torch.float32, device=dev)
    glob = ops.pick_form("ternary_refine_prune", ops.prune_form(c),
                         form) == "global"
    fn = build.entry("ternary_refine", "fatrq_refine_prune", _PRUNE_ARGS)
    status = fn(build.ptr(lo), build.ptr(hi), build.ptr(alive),
                build.ptr(out), build.ptr(is_delta), build.ptr(counts),
                build.ptr(tau), int(glob), nq, c, k, level, nl,
                torch.cuda.current_stream(dev).cuda_stream)
    build.check("ternary_refine", status, "ternary_refine_prune")
    global prune_launches, prune_global_launches
    prune_launches += 1
    prune_global_launches += int(glob)
    return tau


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
    return _bounds(stores, q, ids, d0, valid, model, bound=bound, z=z)


def _bounds(stores, q, ids, d0, valid, model, *, bound, z,
            form: str | None = None):
    """``ternary_refine_fused_bounds``; ``form`` names the kernel's form
    instead of the shapes."""
    _check_bound(bound)
    g = stores.packed[0].shape[1]
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
    glob = ops.pick_form("ternary_refine_fused_bounds", ops.refine_form(g),
                         form) == "global"
    tables = _tables(q_planes, pairs=False) if glob else None
    plan = ops.bounds_plan(g, nl) if glob else None
    ptrs = ctypes.c_void_p * nl
    smem = ctypes.c_int(0)
    fn = build.entry("ternary_refine", "fatrq_refine_bounds", _BOUNDS_ARGS)
    status = fn(ptrs(*(build.ptr(p) for p in stores.packed)),
                ptrs(*(build.ptr(t) for t in stores.levels)),
                build.ptr(ids), build.ptr(d0), build.ptr(valid),
                build.ptr(q_planes), build.ptr(stores.records),
                build.ptr(params), build.ptr(est), build.ptr(lo),
                build.ptr(hi), build.ptr(tables), nq, c, g, nl,
                int(bound == "quantile"), plan.passes if glob else 0,
                ctypes.byref(smem), torch.cuda.current_stream(dev).cuda_stream)
    build.check("ternary_refine", status, "ternary_refine_fused_bounds")
    global bounds_launches, bounds_global_launches, bounds_last_plan
    bounds_launches += 1
    bounds_global_launches += int(glob)
    if glob:
        bounds_last_plan = ops.launched_plan("ternary_refine_fused_bounds",
                                             plan, smem.value)
    return est, lo, hi


def _launch_level0(what: str, packed, q_planes, scalars, params, out,
                   nq: int, c: int, g: int, form: str | None) -> None:
    """The level-0 kernel in the form G selects (``ops.level0_form``) or
    in ``form``, the global form by ``ops.level0_plan``; q_planes
    (Q, 5, G)."""
    glob = ops.pick_form(what, ops.level0_form(g), form) == "global"
    tables = _tables(q_planes.reshape(nq, TRITS_PER_BYTE, g), pairs=True) \
        if glob else None
    plan = ops.level0_plan(g) if glob else None
    smem = ctypes.c_int(0)
    fn = build.entry("ternary_refine", "fatrq_refine_level0", _LEVEL0_ARGS)
    status = fn(build.ptr(packed), build.ptr(q_planes), build.ptr(scalars),
                build.ptr(params), build.ptr(out), build.ptr(tables), nq, c,
                g, plan.passes if glob else 0, plan.warps if glob else 0,
                ctypes.byref(smem),
                torch.cuda.current_stream(packed.device).cuda_stream)
    build.check("ternary_refine", status, what)
    global level0_global_launches, level0_last_plan
    level0_global_launches += int(glob)
    if glob:
        level0_last_plan = ops.launched_plan(what, plan, smem.value)


def ternary_refine_batch(packed: torch.Tensor, q_planes: torch.Tensor,
                         scalars: torch.Tensor,
                         params: torch.Tensor) -> torch.Tensor:
    """Level-0 scoring of gathered code rows ``packed (Q, C, G)`` uint8
    with planes (Q, 5, G), scalars (Q, C, 5) [d0, ||δ||², ⟨x_c,δ⟩, ||δ||,
    rho] and params (Q, 8) [||q||, w0..w3, bias, 0, 0] → (Q, C, 3)
    f32 [est, est_raw, margin].  CPU tensors take the plain version; a
    CUDA tensor launches the kernel or raises."""
    return _level0_batch(packed, q_planes, scalars, params)


def _level0_batch(packed, q_planes, scalars, params, *,
                  form: str | None = None):
    """``ternary_refine_batch``; ``form`` names the kernel's form instead
    of the shapes."""
    nq, c, g = packed.shape
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
                   out, nq, c, g, form)
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
    return _level0_single(packed, q_planes, scalars, params)


def _level0_single(packed, q_planes, scalars, params, *,
                   form: str | None = None):
    """``ternary_refine``; ``form`` names the kernel's form instead of the
    shapes."""
    c, g = packed.shape
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
                   1, c, g, form)
    global single_launches
    single_launches += 1
    return out
