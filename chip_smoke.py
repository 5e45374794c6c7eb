#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FaTRQ on one NVIDIA GPU.

    python3 chip_smoke.py            # 1M x 768 index, 1000 queries

Phases, each of which raises on failure:

1. print the card (``nvidia-smi``) and build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
2. make a synthetic 1M x 768 dataset with exact ground truth and build
   the index (PQ M=96, K=256; IVF nlist=1024; one TRQ level);
3. kernel phase: each kernel against its plain PyTorch version on the card
   at the main path's shapes (64 queries x nprobe 16 lists), the refine
   kernel also with two TRQ levels, both bounds and delta rows;
4. main path: ``Database.query`` with ``mode="fatrq"`` (``cuda`` backend)
   and ``mode="baseline"`` over all queries in 64-query micro-batches,
   each with every kernel's launch count reset just before its run and
   read just after; then queries/s (median of 5 runs, the modes in turns)
   and, from one more profiled run of each mode, its device time by
   kernel and idle share (``torch.profiler`` and CUDA events);
5. the plain ``reference`` backend on the card over a subset of queries
   must give the same ids and ledger as the ``cuda`` backend;
6. print one ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

It exits non-zero with no result when no GPU is present, or when the
``src/repro_torch`` package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_OPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
EST_TOL = 3e-5                  # rtol = atol, as tests/test_kernels.py uses
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
    """Bound of one level-0 refine call: each distinct code row and its
    16 B of record scalars read once; per candidate its id, d0, valid flag,
    est and alive; per query its digit planes, parameters and counts.  The
    operations are what the function needs, not what this kernel does: a
    per-query (G, 243) table of partial dot products scores each code byte
    in one lookup and add, a 243-entry table gives its nonzero count in
    another add, so 2·G adds per slot, plus ~20 for the slot's estimate,
    bounds and pruning test."""
    nq, c = cand.ids.shape
    g = stores.packed[0].shape[1]
    rows = int(torch.unique(cand.ids).numel())
    nbytes = (rows * (g + 16) + nq * c * (4 + 4 + 1 + 4 + 1)
              + nq * (5 * g + 8 + 2) * 4)
    return dict(zip(("bound_ms", "bound_by"),
                    bound("ternary_refine_fused", nbytes,
                          nq * c * (2 * g + 20))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database rows (only N is ever cut)")
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
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
        recall_at_k
    from repro_torch.anns.stages import make_ivf_front
    from repro_torch.core import trq as trq_mod
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import pq_adc as pq_adc_mod
    from repro_torch.kernels import ternary_refine as tr
    from repro_torch.quant import pq as pq_mod

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    t = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t:.1f} s")

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
    del stores2
    refine_args = (stores1, q64, cand.ids, cand.d0, cand.valid, None, model)
    refine_kw = dict(k=cfg.final_k, bound="cauchy", z=cfg.z)
    planes = ops.make_query_planes(q64, stores1.packed[0].shape[1])
    params = ops.query_params(q64, model.w, model.bias, model.resid_std,
                              cfg.z)
    refine = dict(
        max_abs_err=refine_err,
        ms=time_ms(lambda: tr.ternary_refine_fused(*refine_args,
                                                   **refine_kw), 20),
        plain_ms=time_ms(lambda: tr.refine_plain(
            stores1, planes, params, cand.ids, cand.d0, cand.valid, None,
            k=cfg.final_k, bound="cauchy"), 3),
        library_ms=None, **refine_cost(torch, stores1, cand, q64))
    del cand, stores1

    # ---- main path
    queries = ds.queries
    plans = {"fatrq": QueryPlan(backend="cuda"),
             "baseline": QueryPlan(mode="baseline")}
    for plan in plans.values():                 # warm-up: load, allocate
        db.query(q64, plan=plan)
    torch.cuda.synchronize()
    # each path runs with every count set to 0 just before it and read just
    # after; pq_adc must launch in both, the refine kernel in fatrq
    needs = {"fatrq": ("pq_adc", "ternary_refine_fused"),
             "baseline": ("pq_adc",)}
    results, launches = {}, {}
    for mode, plan in plans.items():
        pq_adc_mod.launches = 0
        tr.launches = 0
        results[mode] = db.query(queries, plan=plan)
        torch.cuda.synchronize()
        launches[mode] = {"pq_adc": pq_adc_mod.launches,
                          "ternary_refine_fused": tr.launches}
        for name in needs[mode]:
            if launches[mode][name] == 0:
                fail(f"the {mode} path never launched {name}")
        print(f"{mode} path launches over {queries.shape[0]} queries in "
              f"{cfg.micro_batch}-query micro-batches: {launches[mode]}")

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

    print("library_ms: null for both kernels; no single PyTorch call "
          "computes either function")
    print("launches: the fatrq (main) path's; launches_by_path gives each "
          "path's own run")

    def by_path(name):
        return {mode: launches[mode][name] for mode in plans}

    print(json.dumps({"kernels": [
        {"name": "pq_adc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pq_adc.cu",
         "replaces": "src/repro/kernels/pq_adc.py:36",
         "launches": launches["fatrq"]["pq_adc"],
         "launches_by_path": by_path("pq_adc"), **adc},
        {"name": "ternary_refine_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ternary_refine.cu",
         "replaces": "src/repro/kernels/ternary_refine.py:364",
         "launches": launches["fatrq"]["ternary_refine_fused"],
         "launches_by_path": by_path("ternary_refine_fused"), **refine},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
