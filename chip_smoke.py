#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FaTRQ on one NVIDIA GPU.

    python3 chip_smoke.py            # 1M x 768 index, 1000 queries, 4 shards

Phases, each of which raises on failure:

1. print the card (``nvidia-smi``), build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel) and
   print each kernel's registers and shared memory (``cuobjdump
   -res-usage``);
2. make a synthetic 1M x 768 dataset with exact ground truth, build the
   index (PQ M=96, K=256; IVF nlist=1024; one TRQ level) and partition it
   into ``--shards`` shards for the sharded layout;
3. edge-shape phase: the fused and bounds refine kernels against their
   plain versions, and the bounds est against the fused est bit for bit,
   on random code stores at G in {1, 13, 20, 154} and L in {1, 2, 3}, with
   C = 4133 slots (not a multiple of 32 or of a block's tile), one query
   with no valid slot and one with every slot valid;
   kernel phase: each kernel against its plain PyTorch version on the card
   at the shapes its path gives it (64 queries x nprobe 16 lists): the
   fused refine kernel also with two TRQ levels, both bounds and delta
   rows; the bounds kernel on one shard's candidates, both bounds, one and
   two levels, its estimates bit-identical to the fused kernel's and its
   intervals' alive chain giving the fused kernel's survivors; the
   level-0 kernels on the gathered code rows of those 64 queries, driven
   once through ``ops.refine_scores_batch`` / ``ops.refine_scores`` (the
   ops path); the fused call's score and prune launches timed apart
   (``torch.profiler``), and both multi-level kernels also with every slot
   scored;
4. search paths: ``Database.query`` with ``mode="fatrq"`` (``cuda``
   backend), ``mode="baseline"`` and ``QueryPlan(shards=S)`` (``cuda``)
   over all queries in 64-query micro-batches, each with every kernel's
   launch count reset just before its run and read just after; the
   sharded ids and per-tier bytes must equal fatrq's; then queries/s
   (median of 5 runs, the modes in turns) and, from one more profiled run
   of each mode, its device time by kernel and idle share
   (``torch.profiler`` and CUDA events);
5. the plain ``reference`` backend on the card over a subset of queries
   must give the same ids and ledger as the ``cuda`` backend, unsharded
   and sharded;
6. print one ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

It exits non-zero with no result when no GPU is present, or when the
``src/repro_torch`` package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_OPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
EST_TOL = 3e-5                  # rtol = atol, as tests/test_kernels.py uses
LEVEL0_TOL = 2e-5               # the level-0 kernels' tolerance there
ADC_ATOL, ADC_RTOL = 1e-4, 1e-5  # sums of M f32 LUT entries in other orders


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def print_resources(libs) -> None:
    """Registers and shared memory of every kernel in the built libraries
    ``libs``, as ``cuobjdump -res-usage`` reports them."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for lib in libs:
        out = subprocess.run([tool, "-res-usage", str(lib)],
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
        for name, usage in zip(out, out[1:]):
            kernel = re.search(r"(\w+_kernel)", name)
            if name.strip().startswith("Function") and kernel:
                print(f"{Path(lib).name.split('-')[0]} "
                      f"{kernel.group(1)}: {usage.strip()}")


def kernel_ms(torch, fn, reps: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name, over
    ``reps`` calls under ``torch.profiler`` after a warm-up; empty if the
    profiler recorded no device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def print_launches(torch, label: str, fn, reps: int) -> None:
    """Each launch of one call of ``fn`` apart (``kernel_ms``)."""
    split = kernel_ms(torch, fn, reps)
    if not split:
        print(f"{label} launches: not measured (the profiler recorded no "
              f"device events)")
    for name, ms in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"{label} launch: {ms:.4f} ms per call {name[:80]}")


def bound(label: str, nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the HBM rate or
    operations over the float32 rate, whichever is larger."""
    print(f"{label} bound: {nbytes / 1e6:.1f} MB moved, {ops / 1e9:.2f} G "
          f"float32 operations")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(a, b, atol: float, rtol: float):
    """(ok, max |a − b| over finite entries); non-finite entries must sit
    at the same places with the same value (NaN matches NaN)."""
    import torch
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    same_nonfinite = bool(torch.equal(fa, fb)) and bool(
        ((a[~fa] == b[~fb]) | (torch.isnan(a[~fa]) & torch.isnan(b[~fb])))
        .all())
    diff = (a[fa] - b[fa]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = same_nonfinite and bool((diff <= atol + rtol * b[fa].abs()).all())
    return ok, err


def device_breakdown(torch, label: str, fn, top: int = 6):
    """Device time by kernel over one more run of ``fn`` under
    ``torch.profiler``, and the device's idle share in that same run: one
    less the kernels' busy time over the CUDA-event span from before the
    run's first launch to after its last.  The profiler slows the host's
    launches, so this share is an upper bound on the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        print(f"{label} device time: not measured (the profiler recorded no "
              f"device events)")
        return
    print(f"{label} device time (profiled run): {busy_ms:.3f} ms busy of a "
          f"{span_ms:.3f} ms span, idle share {1 - busy_ms / span_ms:.3f}")
    for ms, count, name in rows[:top]:
        print(f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{count:<5d} {name[:90]}")


def check_adc(torch, pq_adc_mod, pq_mod, index, cand, q):
    lut = pq_mod.adc_table(index.codebook, q)
    args = (index.pq_codes, cand.ids, cand.valid, lut)
    got = pq_adc_mod.pq_adc(*args)
    want = pq_adc_mod.pq_adc_plain(*args)
    torch.cuda.synchronize()
    ok, err = close(got, want, ADC_ATOL, ADC_RTOL)
    if not ok:
        fail(f"pq_adc disagrees with its plain version (max err {err})")
    # bound: each distinct code row read once; per candidate its id, valid
    # flag and distance; each query's LUT; one add per lookup
    nq, c = cand.ids.shape
    m, k = lut.shape[1:]
    rows = int(torch.unique(cand.ids).numel())
    nbytes = rows * m + nq * c * (4 + 1 + 4) + nq * m * k * 4
    print(f"pq_adc: {rows} distinct code rows among {nq * c} candidates")
    b_ms, b_by = bound("pq_adc", nbytes, nq * c * m)
    return dict(max_abs_err=err, ms=time_ms(lambda: pq_adc_mod.pq_adc(*args),
                                            20),
                plain_ms=time_ms(lambda: pq_adc_mod.pq_adc_plain(*args), 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_refine(torch, tr, ops, stores, model, cand, q, is_delta, *, k,
                 bound_name, z, label):
    """Kernel vs plain version on one configuration; returns max est error
    and the number of alive mismatches explained by near-ties."""
    nl = stores.num_levels
    got = tr.ternary_refine_fused(stores, q, cand.ids, cand.d0, cand.valid,
                                  is_delta, model, k=k, bound=bound_name, z=z)
    planes = ops.make_query_planes(q, stores.packed[0].shape[1])
    params = ops.query_params(q, model.w, model.bias, model.resid_std, z)
    est, alive, counts, trace = tr.refine_plain(
        stores, planes, params, cand.ids, cand.d0, cand.valid, is_delta,
        k=k, bound=bound_name)
    torch.cuda.synchronize()
    ok, err = close(got[0], est, EST_TOL, EST_TOL)
    if not ok:
        fail(f"ternary_refine_fused {label}: est off (max err {err})")
    mism = got[1] != alive
    near = torch.zeros_like(mism)
    for lv in range(nl):
        tau = trace.tau[lv][:, None]
        near |= (trace.lo[lv] - tau).abs() <= EST_TOL * (1 + tau.abs())
    if bool((mism & ~near).any()):
        fail(f"ternary_refine_fused {label}: {int((mism & ~near).sum())} "
             f"alive mismatches away from the pruning threshold")
    rows_equal = ~mism.any(dim=1)
    if not torch.equal(got[2][rows_equal], counts[rows_equal]):
        fail(f"ternary_refine_fused {label}: counts differ")
    n_mism = int(mism.sum())
    print(f"refine {label}: L={nl} max est err {err:.3g}, alive mismatches "
          f"at near-ties {n_mism}, survivors "
          f"{int(got[2][:, nl - 1].sum())}")
    return err, n_mism


def refine_cost(torch, stores, cand, q) -> dict:
    """Bound of one level-0 refine call: each distinct valid code row and
    its 16 B of record scalars read once; per valid slot its id; per slot
    its d0, valid flag, est and alive; per query its digit planes,
    parameters and counts.  The operations are what the function needs,
    not what this kernel does: a per-query (G, 243) table of partial dot
    products scores each code byte in one lookup and add, a 243-entry table
    gives its nonzero count in another add, so 2·G adds per valid slot,
    plus ~20 per slot for its estimate, bounds and pruning test."""
    nq, c = cand.ids.shape
    g = stores.packed[0].shape[1]
    n_valid = int(cand.valid.sum())
    rows = int(torch.unique(cand.ids[cand.valid]).numel())
    nbytes = (rows * (g + 16) + n_valid * 4 + nq * c * (4 + 1 + 4 + 1)
              + nq * (5 * g + 8 + 2) * 4)
    return dict(zip(("bound_ms", "bound_by"),
                    bound("ternary_refine_fused", nbytes,
                          n_valid * 2 * g + nq * c * 20)))


def check_bounds(torch, tr, ops, alive_chain, stores, model, cand, q, *, k,
                 bound_name, z, label):
    """Bounds kernel vs its plain version and vs the fused kernel on the
    same candidates; returns the max error and the alive mismatches
    explained by near-ties."""
    nl = stores.num_levels
    args = (cand.ids, cand.d0, cand.valid)
    est, lo, hi = tr.ternary_refine_fused_bounds(stores, q, *args, model,
                                                 bound=bound_name, z=z)
    planes = ops.make_query_planes(q, stores.packed[0].shape[1])
    params = ops.query_params(q, model.w, model.bias, model.resid_std, z)
    want = tr.refine_bounds_plain(stores, planes, params, *args,
                                  bound=bound_name)
    f_est, f_alive, f_counts = tr.ternary_refine_fused(
        stores, q, *args, None, model, k=k, bound=bound_name, z=z)
    torch.cuda.synchronize()
    err = 0.0
    for name, got, ref in zip(("est", "lo", "hi"), (est, lo, hi), want):
        ok, e = close(got, ref, EST_TOL, EST_TOL)
        if not ok:
            fail(f"ternary_refine_fused_bounds {label}: {name} off (max err "
                 f"{e})")
        err = max(err, e)
    v = cand.valid
    if not torch.equal(est[v], f_est[v]):
        fail(f"ternary_refine_fused_bounds {label}: est is not bit-identical "
             f"to ternary_refine_fused's")
    level_alive, taus = alive_chain(lo, hi, v, k)
    mism = level_alive[-1] != f_alive
    near = torch.zeros_like(mism)
    for lv in range(nl):
        tau = taus[lv][:, None]
        near |= (lo[:, lv] - tau).abs() <= EST_TOL * (1 + tau.abs())
    if bool((mism & ~near).any()):
        fail(f"ternary_refine_fused_bounds {label}: "
             f"{int((mism & ~near).sum())} alive mismatches away from the "
             f"pruning threshold")
    rows_equal = ~mism.any(dim=1)
    counts = torch.stack([a.sum(-1, dtype=torch.int32)
                          for a in level_alive], dim=1)
    if not torch.equal(counts[rows_equal], f_counts[rows_equal, :nl]):
        fail(f"ternary_refine_fused_bounds {label}: counts differ")
    n_mism = int(mism.sum())
    print(f"bounds {label}: L={nl} {int(v.sum())} valid of {v.numel()} "
          f"slots, max err {err:.3g}, est bit-identical to the fused "
          f"kernel's, alive mismatches at near-ties {n_mism}")
    return err, n_mism


def bounds_cost(torch, stores, cand, q) -> dict:
    """Bound of one bounds-kernel call: each distinct valid row's G code
    bytes and 16 B of scalars per level read once; per slot its valid
    flag, est and L (lo, hi) written; per valid slot its id and d0; per
    query its planes and parameters.  Invalid slots need no scoring, so
    the operations are 2·G + 20 per valid slot and level."""
    nq, c = cand.ids.shape
    nl = stores.num_levels
    g = stores.packed[0].shape[1]
    n_valid = int(cand.valid.sum())
    rows = int(torch.unique(cand.ids[cand.valid]).numel())
    nbytes = (rows * nl * (g + 16) + nq * c * (1 + 4 + 8 * nl)
              + n_valid * 8 + nq * (5 * g + 8) * 4)
    return dict(zip(("bound_ms", "bound_by"),
                    bound("ternary_refine_fused_bounds", nbytes,
                          n_valid * nl * (2 * g + 20))))


def level0_cost(label: str, nq: int, c: int, g: int) -> dict:
    """Bound of one level-0 call over gathered rows: every gathered row's
    G bytes and its 5 scalars read, 3 floats written per slot, per query
    its planes and parameters; 2·G + 20 operations per slot."""
    nbytes = nq * c * (g + 5 * 4 + 3 * 4) + nq * (5 * g + 8) * 4
    return dict(zip(("bound_ms", "bound_by"),
                    bound(label, nbytes, nq * c * (2 * g + 20))))


def check_level0(torch, tr, ops, model, q, packed, cols, counted):
    """The ops path's level-0 outputs (``counted``: batch, then single
    query) against the plain version on the same gathered rows ``packed``
    (Q, C, G) and scalars ``cols``; returns the kernels' rows.  Kernel and
    plain version are timed alike, on the inputs already assembled (the
    ops entry points' stacking of the scalars is not part of either)."""
    nq, c, g = packed.shape
    print(f"level-0 kernels: {packed.numel() / 1e6:.1f} MB of gathered "
          f"codes ({nq} x {c} x {g})")
    planes, params, scalars = ops.level0_inputs(q, g, *cols, model.w,
                                                model.bias)
    batch = (packed, planes, scalars, params)
    single = tuple(t[:1] for t in batch)
    rows = {}
    for name, got, args, call in (
            ("ternary_refine_batch", counted[0], batch,
             lambda: tr.ternary_refine_batch(*batch)),
            ("ternary_refine", counted[1], single,
             lambda: tr.ternary_refine(packed[0], planes[0], scalars[0],
                                       params[:1]))):
        want = tr.refine_level0_plain(*args).reshape(got.shape)
        torch.cuda.synchronize()
        ok, err = close(got, want, LEVEL0_TOL, LEVEL0_TOL)
        if not ok:
            fail(f"{name} disagrees with its plain version (max err {err})")
        print(f"{name}: max err {err:.3g} over {got.shape[-2]} x "
              f"{got.numel() // got.shape[-2] // 3} slots")
        rows[name] = dict(
            max_abs_err=err, ms=time_ms(call, 20),
            plain_ms=time_ms(lambda: tr.refine_level0_plain(*args), 3),
            library_ms=None,
            **level0_cost(name, args[0].shape[0], c, g))
    return rows


EDGE_G = (1, 13, 20, 154)      # packed widths of the edge-shape phase
EDGE_Q, EDGE_C, EDGE_N = 5, 4133, 20_000


def edge_shapes(torch, tr, ops, alive_chain, trq_mod, cal, Candidates,
                gen) -> tuple[float, float]:
    """The fused and bounds kernels against their plain versions, and the
    bounds est against the fused est, on random code stores: each G of
    ``EDGE_G`` (rows at every byte alignment G allows) and L = 1, 2, 3,
    both bounds.  C = 4133 is not a multiple of 32 or of the 1024-slot
    tile; query 0 has no valid slot, query 1 only valid ones, the rest
    ~30%.  Invalid slots carry d0 = +inf (as the front gives), or a finite
    d0 at L = 2 so that the kernels' invalid-slot values are compared too.
    Returns the fused and the bounds kernel's max error."""
    dev = gen.device

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    model = cal.CalibrationModel(
        w=torch.tensor([1.0, 1.1, 0.95, 2.1], device=dev),
        bias=torch.tensor(0.3, device=dev),
        resid_std=torch.tensor(0.05, device=dev))
    valid = rand(EDGE_Q, EDGE_C) < 0.3
    valid[0], valid[1] = False, True
    ids = torch.randint(0, EDGE_N, (EDGE_Q, EDGE_C), generator=gen,
                        device=dev, dtype=torch.int32)
    is_delta = rand(EDGE_Q, EDGE_C) < 0.3
    errs, ties = [0.0, 0.0], 0
    for g in EDGE_G:
        q = torch.randn((EDGE_Q, 5 * g - (g > 1)), generator=gen,
                        device=dev)
        for nl in (1, 2, 3):
            levels = tuple(trq_mod.TRQLevel(
                packed=torch.randint(0, 243, (EDGE_N, g), generator=gen,
                                     device=dev, dtype=torch.uint8),
                proj=rand(EDGE_N) - 0.5, norm=rand(EDGE_N), rho=rand(EDGE_N))
                for _ in range(nl))
            stores = tr.RefineStores(
                packed=tuple(lv.packed for lv in levels),
                records=torch.stack([rand(EDGE_N) * 2, rand(EDGE_N) - 0.5,
                                     rand(EDGE_N), rand(EDGE_N)], 1)
                .contiguous(),
                levels=tuple(ops.level_table(lv) for lv in levels),
                dim=q.shape[1])
            d0 = rand(EDGE_Q, EDGE_C) * 4 + 0.1
            d0 = torch.where(valid | (nl == 2), d0, float("inf"))
            cand = Candidates(ids=ids, valid=valid, d0=d0, counters={})
            for bnd in ("cauchy", "quantile"):
                label = f"edge G={g} {bnd} L={nl}"
                err, n = check_refine(torch, tr, ops, stores, model, cand, q,
                                      is_delta, k=10, bound_name=bnd, z=3.0,
                                      label=label)
                b_err, b_n = check_bounds(torch, tr, ops, alive_chain, stores,
                                          model, cand, q, k=10,
                                          bound_name=bnd, z=3.0, label=label)
                errs = [max(errs[0], err), max(errs[1], b_err)]
                ties += n + b_n
    print(f"edge-shape phase: {len(EDGE_G) * 6} configurations, max err "
          f"{max(errs):.3g}, alive mismatches at near-ties {ties}")
    return errs[0], errs[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database rows (only N is ever cut)")
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=4,
                    help="shards of the sharded path (on one card)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run this "
              f"script from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.anns import Database, PipelineConfig, QueryPlan, \
        make_sharded_executor, recall_at_k
    from repro_torch.anns import registry
    from repro_torch.anns.stages import Candidates, make_ivf_front
    from repro_torch.core import calibration as cal
    from repro_torch.core import trq as trq_mod
    from repro_torch.core.estimator import alive_chain
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import pq_adc as pq_adc_mod
    from repro_torch.kernels import ternary_refine as tr
    from repro_torch.quant import pq as pq_mod

    def reset_launches():
        pq_adc_mod.launches = 0
        tr.launches = tr.bounds_launches = 0
        tr.batch_launches = tr.single_launches = 0

    def read_launches() -> dict:
        return {"pq_adc": pq_adc_mod.launches,
                "ternary_refine_fused": tr.launches,
                "ternary_refine_fused_bounds": tr.bounds_launches,
                "ternary_refine_batch": tr.batch_launches,
                "ternary_refine": tr.single_launches}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    t = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    print_resources(build._target(name) for name in build.SOURCES)
    edge_err, edge_bounds_err = edge_shapes(
        torch, tr, ops, alive_chain, trq_mod, cal, Candidates,
        torch.Generator(device="cuda").manual_seed(args.seed + 1))

    # ---- data + index build
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t = time.perf_counter()
    ds = make_dataset(n=args.n, d=768, n_queries=args.queries, k_gt=100,
                      generator=gen)
    torch.cuda.synchronize()
    print(f"dataset {args.n} x 768, {args.queries} queries, exact top-100: "
          f"{time.perf_counter() - t:.1f} s")
    cfg = PipelineConfig(dim=768, pq_m=96, pq_k=256, nlist=1024, nprobe=16,
                         trq_levels=1, final_k=10, refine_budget=40,
                         bound="cauchy", micro_batch=64)
    t = time.perf_counter()
    db = Database.build(ds.x, cfg, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    index = db.index
    print(f"index build: {build_s:.1f} s (IVF cap {index.ivf.cap})")
    t = time.perf_counter()
    si = make_sharded_executor(index, shards=args.shards).sharded
    torch.cuda.synchronize()
    print(f"partition into {args.shards} shards: "
          f"{time.perf_counter() - t:.2f} s (rows per shard "
          f"{si.shard_rows.tolist()}, up to {si.list_gid.shape[1]} lists "
          f"each)")

    # ---- kernel phase, at the main path's shapes
    q64 = ds.queries[:64].contiguous()
    cand = make_ivf_front(index).candidates(q64)
    print(f"kernel phase shapes: Q={cand.ids.shape[0]} C={cand.ids.shape[1]}"
          f" M={cfg.pq_m} K={cfg.pq_k} G={index.trq.levels[0].packed.shape[1]}")
    adc = check_adc(torch, pq_adc_mod, pq_mod, index, cand, q64)
    stores1 = tr.RefineStores.from_trq(index.trq)
    x_c = pq_mod.decode(index.codebook, index.pq_codes)
    trq2 = trq_mod.encode_database(index.x, x_c, num_levels=2)
    del x_c
    stores2 = tr.RefineStores.from_trq(trq2)
    del trq2
    model = index.trq.model
    delta = torch.rand(cand.ids.shape, generator=gen, device="cuda") < 0.3
    refine_err, near_ties = 0.0, 0
    for stores, bnd, is_delta in ((stores1, "cauchy", None),
                                  (stores1, "quantile", None),
                                  (stores2, "cauchy", delta),
                                  (stores2, "quantile", delta)):
        err, n = check_refine(torch, tr, ops, stores, model, cand, q64,
                              is_delta, k=cfg.final_k, bound_name=bnd,
                              z=cfg.z, label=f"{bnd} L={stores.num_levels}")
        refine_err, near_ties = max(refine_err, err), near_ties + n
    # the bounds kernel on shard 0's candidates (the sharded path's shapes),
    # read by global id so that the one- and two-level stores both serve
    sh = registry.sharded_front("ivf").body(
        q64, si.front_rep, si.front_db, si.codebook, si.pq_codes,
        **dict(si.front_args))[0]
    sh_cand = Candidates(ids=si.gid[0][sh.ids.long()].int().contiguous(),
                         valid=sh.valid, d0=sh.d0, counters={})
    bounds_err, bounds_ties = 0.0, 0
    for stores, bnd in ((stores1, "cauchy"), (stores1, "quantile"),
                        (stores2, "cauchy"), (stores2, "quantile")):
        err, n = check_bounds(torch, tr, ops, alive_chain, stores, model,
                              sh_cand, q64, k=cfg.final_k, bound_name=bnd,
                              z=cfg.z,
                              label=f"{bnd} L={stores.num_levels}")
        bounds_err, bounds_ties = max(bounds_err, err), bounds_ties + n
    del stores2
    b_args = (stores1, q64, sh_cand.ids, sh_cand.d0, sh_cand.valid)
    b_planes = ops.make_query_planes(q64, stores1.packed[0].shape[1])
    b_params = ops.query_params(q64, model.w, model.bias, model.resid_std,
                                cfg.z)
    bounds_row = dict(
        max_abs_err=max(bounds_err, edge_bounds_err),
        ms=time_ms(lambda: tr.ternary_refine_fused_bounds(
            *b_args, model, bound="cauchy", z=cfg.z), 20),
        plain_ms=time_ms(lambda: tr.refine_bounds_plain(
            stores1, b_planes, b_params, *b_args[2:], bound="cauchy"), 3),
        library_ms=None, **bounds_cost(torch, stores1, sh_cand, q64))
    # what the skip of invalid slots spares: the same call with every slot
    # scored
    every = torch.ones_like(sh_cand.valid)
    no_skip_ms = time_ms(lambda: tr.ternary_refine_fused_bounds(
        *b_args[:4], every, model, bound="cauchy", z=cfg.z), 20)
    print_launches(torch, "ternary_refine_fused_bounds",
                   lambda: tr.ternary_refine_fused_bounds(
                       *b_args, model, bound="cauchy", z=cfg.z), 20)
    print(f"ternary_refine_fused_bounds: {bounds_row['ms']:.3f} ms with "
          f"{int(sh_cand.valid.sum())} valid slots of {sh_cand.valid.numel()}"
          f", {no_skip_ms:.3f} ms with every slot scored")
    del sh, sh_cand, every

    # the ops path: the level-0 kernels through the JAX-signature entry
    # points, once each, with every count reset just before and read after
    ids64 = cand.ids.long()
    rec64 = stores1.records[ids64]
    packed64 = stores1.packed[0][ids64]
    cols = (cand.d0, rec64[..., 0], rec64[..., 1], rec64[..., 2],
            rec64[..., 3])
    reset_launches()
    counted = (ops.refine_scores_batch(packed64, q64, *cols, model.w,
                                       model.bias),
               ops.refine_scores(packed64[0], q64[0], *(t[0] for t in cols),
                                 model.w, model.bias))
    torch.cuda.synchronize()
    launches = {"ops": read_launches()}
    print(f"ops path launches: {launches['ops']}")
    for name in ("ternary_refine_batch", "ternary_refine"):
        if launches["ops"][name] == 0:
            fail(f"the ops path never launched {name}")
    level0_rows = check_level0(torch, tr, ops, model, q64, packed64, cols,
                               counted)
    del packed64, rec64, cols, counted
    refine_args = (stores1, q64, cand.ids, cand.d0, cand.valid, None, model)
    refine_kw = dict(k=cfg.final_k, bound="cauchy", z=cfg.z)
    planes = ops.make_query_planes(q64, stores1.packed[0].shape[1])
    params = ops.query_params(q64, model.w, model.bias, model.resid_std,
                              cfg.z)
    refine = dict(
        max_abs_err=max(refine_err, edge_err),
        ms=time_ms(lambda: tr.ternary_refine_fused(*refine_args,
                                                   **refine_kw), 20),
        plain_ms=time_ms(lambda: tr.refine_plain(
            stores1, planes, params, cand.ids, cand.d0, cand.valid, None,
            k=cfg.final_k, bound="cauchy"), 3),
        library_ms=None, **refine_cost(torch, stores1, cand, q64))
    # the fused call's launches apart: scoring, pruning, and the query's
    # planes and parameter row
    print_launches(torch, "ternary_refine_fused",
                   lambda: tr.ternary_refine_fused(*refine_args, **refine_kw),
                   20)
    every = torch.ones_like(cand.valid)
    no_skip_ms = time_ms(lambda: tr.ternary_refine_fused(
        *refine_args[:4], every, *refine_args[5:], **refine_kw), 20)
    print(f"ternary_refine_fused: {refine['ms']:.3f} ms with "
          f"{int(cand.valid.sum())} valid slots of {cand.valid.numel()}, "
          f"{no_skip_ms:.3f} ms with every slot scored")
    del cand, stores1, every

    # ---- main path
    queries = ds.queries
    plans = {"fatrq": QueryPlan(backend="cuda"),
             "baseline": QueryPlan(mode="baseline"),
             "sharded": QueryPlan(shards=args.shards, backend="cuda")}
    for plan in plans.values():                 # warm-up: load, allocate
        db.query(q64, plan=plan)
    torch.cuda.synchronize()
    # each path runs with every count set to 0 just before it and read just
    # after; pq_adc must launch in all three, the fused refine kernel in
    # fatrq, the bounds kernel (and not the fused one) in sharded
    needs = {"fatrq": ("pq_adc", "ternary_refine_fused"),
             "baseline": ("pq_adc",),
             "sharded": ("pq_adc", "ternary_refine_fused_bounds")}
    results = {}
    for mode, plan in plans.items():
        reset_launches()
        results[mode] = db.query(queries, plan=plan)
        torch.cuda.synchronize()
        launches[mode] = read_launches()
        for name in needs[mode]:
            if launches[mode][name] == 0:
                fail(f"the {mode} path never launched {name}")
        print(f"{mode} path launches over {queries.shape[0]} queries in "
              f"{cfg.micro_batch}-query micro-batches: {launches[mode]}")
    # the multi-level kernels are each path's only refine scoring
    for mode, others in (("fatrq", ("ternary_refine_fused_bounds",
                                    "ternary_refine_batch",
                                    "ternary_refine")),
                         ("sharded", ("ternary_refine_fused",
                                      "ternary_refine_batch",
                                      "ternary_refine"))):
        for name in others:
            if launches[mode][name]:
                fail(f"the {mode} path launched {name}")

    # queries/s: host clock around whole searches ended by a synchronize,
    # the two modes in turns, median of 5
    runs = {mode: [] for mode in plans}
    for _ in range(5):
        for mode, plan in plans.items():
            t = time.perf_counter()
            db.query(queries, plan=plan)
            torch.cuda.synchronize()
            runs[mode].append(time.perf_counter() - t)
    nq = queries.shape[0]
    for label, r in results.items():
        secs = sorted(runs[label])[len(runs[label]) // 2]
        if tuple(r.ids.shape) != (nq, cfg.final_k):
            fail(f"{label}: ids shape {tuple(r.ids.shape)}")
        if not bool(torch.isfinite(r.distances).all()):
            fail(f"{label}: non-finite distances")
        exact = ((index.x[r.ids.long()] - queries[:, None]) ** 2).sum(-1)
        ok, err = close(r.distances, exact, 1e-5, 1e-5)
        if not ok:
            fail(f"{label}: distances are not the ids' exact L2 ({err})")
        recall = recall_at_k(r.ids, ds.gt, cfg.final_k)
        ssd = r.cost.ledger["rerank:ssd"].accesses / nq
        print(f"{label}: recall@10 {recall:.4f}, {nq / secs:.1f} queries/s "
              f"(median of {[round(s, 6) for s in runs[label]]} s for {nq}),"
              f" SSD fetches/query {ssd:.1f}")
        if recall < 0.5:
            fail(f"{label}: recall@10 {recall:.4f} below 0.5")
        device_breakdown(torch, label, lambda: db.query(
            queries, plan=plans[label]))
    tier_bytes = lambda c: {t.value: v.bytes                  # noqa: E731
                            for t, v in c.by_tier().items()}
    if not torch.equal(results["sharded"].ids, results["fatrq"].ids):
        n_rows = int((results["sharded"].ids != results["fatrq"].ids)
                     .any(1).sum())
        fail(f"sharded ids differ from the unsharded fatrq ids in {n_rows} "
             f"queries")
    if tier_bytes(results["sharded"].cost) != tier_bytes(
            results["fatrq"].cost):
        fail(f"sharded per-tier bytes {tier_bytes(results['sharded'].cost)}"
             f" differ from fatrq's {tier_bytes(results['fatrq'].cost)}")
    print(f"sharded ({args.shards} shards): ids and per-tier bytes equal to "
          f"the unsharded fatrq path's")

    # ---- the plain reference backend on the card, over a subset
    sub = queries[:64]
    ref = db.query(sub, plan=QueryPlan(backend="reference", micro_batch=8))
    cud = db.query(sub, plan=QueryPlan(backend="cuda"))
    if not torch.equal(ref.ids, cud.ids):
        fail("reference and cuda backends return different ids")
    ledger = lambda c: {k: (v.accesses, v.bytes)              # noqa: E731
                        for k, v in c.ledger.items()}
    if ledger(ref.cost) != ledger(cud.cost):
        fail(f"ledgers differ: {ledger(ref.cost)} vs {ledger(cud.cost)}")
    print(f"reference backend on {sub.shape[0]} queries: ids and ledger "
          f"equal to the cuda backend's")
    sp = QueryPlan(shards=args.shards, backend="reference", micro_batch=8)
    ref = db.query(sub, plan=sp)
    cud = db.query(sub, plan=plans["sharded"])
    if not torch.equal(ref.ids, cud.ids):
        fail("sharded: reference and cuda backends return different ids")
    if ledger(ref.cost) != ledger(cud.cost):
        fail(f"sharded ledgers differ: {ledger(ref.cost)} vs "
             f"{ledger(cud.cost)}")
    print(f"sharded reference backend on {sub.shape[0]} queries: ids and "
          f"ledger equal to the cuda backend's")

    print("library_ms: null for every kernel; no single PyTorch call "
          "computes any of these functions")
    print("launches: each kernel's own path's run (fatrq for pq_adc and "
          "ternary_refine_fused, sharded for ternary_refine_fused_bounds, "
          "ops for ternary_refine_batch and ternary_refine); "
          "launches_by_path gives every path's own run")

    src = "src/repro_torch/kernels/csrc/ternary_refine.cu"
    rows = [("pq_adc", "src/repro_torch/kernels/csrc/pq_adc.cu",
             "src/repro/kernels/pq_adc.py:36", "fatrq", adc),
            ("ternary_refine_fused", src,
             "src/repro/kernels/ternary_refine.py:364", "fatrq", refine),
            ("ternary_refine_fused_bounds", src,
             "src/repro/kernels/ternary_refine.py:418", "sharded",
             bounds_row),
            ("ternary_refine_batch", src,
             "src/repro/kernels/ternary_refine.py:178", "ops",
             level0_rows["ternary_refine_batch"]),
            ("ternary_refine", src,
             "src/repro/kernels/ternary_refine.py:213", "ops",
             level0_rows["ternary_refine"])]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[path][name],
         "launches_by_path": {p: launches[p][name] for p in launches},
         **row}
        for name, source, replaces, path, row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
