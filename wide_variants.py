"""Times the chunked global forms at the wide cells' shapes against the
chunk plans they did not take, and ``pq_adc``'s global form against
timing-only copies of its source (GPU only, ~2 min).

At each (D, M) of ``chip_smoke.WIDE_SHAPES`` it builds the wide cell's
100,000-row index (``chip_smoke.wide_dataset``) and takes the IVF front's
candidates of 64 queries, then:

* ``pq_adc``: the plan ``ops.adc_plan`` picks (64 subspaces a chunk) and
  chunks of 32 and 48, each bit-equal to the picked plan's output, timed in
  turns; then copies of ``csrc/pq_adc.cu`` without its LUT-chunk copies
  after the first, without its rows' loads after the first pair, and
  without both (their sums are wrong: timed only), to show what sets the
  global form's pace.
* the fused kernel (D = 8192, its global form): chunks of 3 passes (the
  plan ``ops.refine_plan`` picks), 2 and 1, each bit-equal to the picked
  plan's est, alive and counts, with the score launch's device ms.
* the bounds kernel (D = 8192, its global form) on shard 0's candidates of
  the 64 queries at ``--shards`` shards (the wide_8192_sharded path's
  shape): chunks of 3 passes (``ops.bounds_plan``), 2 and 1, each
  bit-equal to the picked plan's est, lo and hi, with its device ms.
* the level-0 kernel (D = 8192, its global form) on the first 8 queries'
  gathered candidates (the wide_ops path's shape, ``ops.refine_scores_batch``
  and ``refine_scores``): 1 pass a chunk with 16 warps (``ops.level0_plan``),
  2 with 6 and 3 with 2 (the most warps each leaves room for), each
  bit-equal to the picked plan's outputs, with its device ms.

The plans are swapped in by replacing ``ops.adc_plan`` / ``ops.refine_plan``
/ ``ops.bounds_plan`` / ``ops.level0_plan`` in this process; the library
has no such option.  It fails loudly if a plan's output differs or the
source no longer matches its patches.

With ``--forms`` it only times the bounds and level-0 kernels at those two
shapes in the forms the shapes select; with ``--shared`` only the five
shared forms (``pq_adc``, the fused kernel's score and prune launches, the
bounds kernel on shard 0, both level-0 entry points) at chip_smoke.py's
fatrq shape (its 1M x 768 index, the first 64 queries' IVF candidates);
with ``--prune`` the prune alone at its global form's shapes (an edge
input at C = 1,048,576, Q = 6, the same with hi falling along the slots,
and the fatrq_nprobe256 path's level-0 bounds at Q = 64, C = 750,080),
then ``--shared``.  These go through calls that every version of the
package since its global forms has: copied beside another checkout's
``chip_smoke.py`` and ``src/``, the script times that checkout's kernels
on the same inputs (the data and the build are drawn from one seed).

    python3 wide_variants.py [--forms | --shared | --prune] [--shards 4]
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "src/repro_torch/kernels/_build/wide_variants"  # not committed

#: subspaces of a pq_adc LUT chunk, and passes of a refine, bounds or
#: level-0 chunk, to time
ADC_CHUNKS, REFINE_PASSES = (64, 32, 48), (3, 2, 1)
LEVEL0_PASSES = (1, 2, 3)
QUERIES, TURNS = 64, 2
#: queries of the level-0 ops path (chip_smoke.WIDE_OPS_QUERIES)
OPS_QUERIES = 8

COPY = """      copy_floats(s_ring + ((ch + 1) & 1) * ring, lq + (size_t)m1 * K,
                  nb1 * K);"""
ROWS = ("""          load_pair<kBytes>(next_a, next_b, codes, rid, pr + 1, mine, M, m0,
                            nb, wide);""",
        """          load_pair<kBytes>(next_a, next_b, codes, rid, 0, mine, M, m1, nb1,
                            wide);""")
ADC_VARIANTS = {"no later LUT copies": [COPY],
                "no row loads after the first pair": list(ROWS),
                "neither": [COPY, *ROWS]}


def adc_copies(build) -> dict:
    """Build the timing-only copies of csrc/pq_adc.cu at once: their
    libraries by name."""
    src = (build.CSRC / "pq_adc.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, cuts) in enumerate(ADC_VARIANTS.items()):
        text = src
        for cut in cuts:
            if text.count(cut) != 1:
                raise SystemExit(f"wide_variants: the source changed; cannot "
                                 f"find {cut[:60]!r}")
            text = text.replace(cut, "      ;")
        cu = OUT / f"adc{i}.cu"
        cu.write_text(text)
        lib = OUT / f"libadc{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]))
    for name, (lib, proc) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"wide_variants: {name} failed to build")
    return {name: lib for name, (lib, _) in jobs.items()}


def wide_index(torch, cs, dim: int, m: int):
    """The wide cell's index at (D, M), built from seed 0, and its data."""
    from repro_torch.anns import Database, PipelineConfig
    ds = cs.wide_dataset(torch, cs.WIDE_N, dim, QUERIES, 0)
    cfg = PipelineConfig(dim=dim, pq_m=m, pq_k=256, nlist=100, nprobe=16,
                         trq_levels=1, final_k=10, refine_budget=40,
                         bound="cauchy", micro_batch=QUERIES)
    db = Database.build(ds.x, cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    return ds, cfg, db


def path_calls(torch, db, cfg, q, shards: int):
    """The bounds kernel's call on shard 0's candidates of the queries
    ``q`` at ``shards`` shards (its own store, shard-local ids, as the
    sharded path launches it), and the level-0 ops path's two calls on the
    first ``OPS_QUERIES`` queries' gathered candidates, as closures."""
    from repro_torch.anns import make_sharded_executor, registry
    from repro_torch.anns.stages import make_ivf_front
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_refine as t
    si = make_sharded_executor(db.index, shards=shards).sharded
    sh = registry.sharded_front("ivf").body(
        q, si.front_rep, si.front_db, si.codebook, si.pq_codes,
        **dict(si.front_args))[0]
    stores0 = t.RefineStores.from_trq(si.shard_trqs[0])
    model = db.index.trq.model

    def bounds():
        return t.ternary_refine_fused_bounds(stores0, q, sh.ids, sh.d0,
                                             sh.valid, model, bound="cauchy",
                                             z=cfg.z)

    qo = q[:OPS_QUERIES].contiguous()
    cand = make_ivf_front(db.index).candidates(qo)
    stores = t.RefineStores.from_trq(db.index.trq)
    ids = cand.ids.long()
    rec, packed = stores.records[ids], stores.packed[0][ids]
    cols = (cand.d0, rec[..., 0], rec[..., 1], rec[..., 2], rec[..., 3])

    def level0():
        return (ops.refine_scores_batch(packed, qo, *cols, model.w,
                                        model.bias),
                ops.refine_scores(packed[0], qo[0], *(c[0] for c in cols),
                                  model.w, model.bias))

    shape = (f"bounds shard 0 of {shards}: Q={q.shape[0]} C={sh.ids.shape[1]}"
             f" ({int(sh.valid.sum())} valid); level 0: {OPS_QUERIES} x "
             f"{packed.shape[1]} x {packed.shape[2]}")
    return bounds, level0, shape


def device_ms(torch, cs, fn, kernel: str, reps: int = 10) -> str:
    """The device ms per call of the kernels whose name holds ``kernel``,
    summed, over ``reps`` calls of ``fn`` (``chip_smoke.kernel_ms``)."""
    ms = [t for name, t in cs.kernel_ms(torch, fn, reps).items()
          if kernel in name]
    return f"{sum(ms):.4f} ms" if ms else "not measured"


def forms(torch, cs, shards: int) -> None:
    """``--forms``: the bounds and level-0 kernels at the wide_8192 paths'
    shapes in the forms the shapes select, timed in turns."""
    dim, m = cs.WIDE_SHAPES[-1]
    ds, cfg, db = wide_index(torch, cs, dim, m)
    bounds, level0, shape = path_calls(torch, db, cfg,
                                       ds.queries.contiguous(), shards)
    print(f"wide_{dim} forms: {shape}")
    for turn in range(TURNS):
        for name, fn, kernel in (("bounds", bounds, "bounds_kernel"),
                                 ("level-0 (both calls)", level0,
                                  "level0_kernel")):
            print(f"{name} (turn {turn}): {cs.time_ms(fn, 10):.4f} ms per "
                  f"call, {kernel} device {device_ms(torch, cs, fn, kernel)}")


def fatrq_index(torch):
    """chip_smoke.py's 1M x 768 index (seed 0), its data and config."""
    from repro_torch.anns import Database, PipelineConfig
    from repro_torch.data import make_dataset
    gen = torch.Generator(device="cuda").manual_seed(0)
    ds = make_dataset(n=1_000_000, d=768, n_queries=1000, k_gt=100,
                      generator=gen)
    cfg = PipelineConfig(dim=768, pq_m=96, pq_k=256, nlist=1024, nprobe=16,
                         trq_levels=1, final_k=10, refine_budget=40,
                         bound="cauchy", micro_batch=64)
    index = Database.build(ds.x, cfg, generator=torch.Generator(
        device="cuda").manual_seed(0)).index
    return ds, cfg, index


def prune(torch, cs, shards: int) -> None:
    """``--prune``: the prune alone (``ternary_refine_prune``, k = 10) in
    the form its shapes select, on chip_smoke.py's edge-like input
    (C = 1,048,576, Q = 6: hi normal, lo below it, half the slots alive,
    query 0 all and query 1 none), on the same with every query's hi
    falling along the slots and every slot alive, and on the
    fatrq_nprobe256 path's shape (the 1M index's first 64 queries' IVF
    candidates at nprobe 256 and their level-0 bounds), each checked
    against ``prune_plain`` and timed in two turns (CUDA events and the
    profiler's device ms); then ``--shared`` on the same index."""
    from repro_torch.anns.executor import make_executor
    from repro_torch.kernels import ternary_refine as t
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, c, k = 6, 1_048_576, 10
    hi = torch.randn((q, c), generator=gen, device="cuda")
    lo = hi - torch.rand((q, c), generator=gen, device="cuda")
    alive = torch.rand((q, c), generator=gen, device="cuda") < 0.5
    alive[0], alive[1] = True, False
    falling = hi.sort(dim=1, descending=True).values
    ds, cfg, index = fatrq_index(torch)
    ex = make_executor(index, front="ivf", backend="cuda", nprobe=256)
    qs = ds.queries[:QUERIES].contiguous()
    cand = ex.front.candidates(qs)
    _, p_lo, p_hi = t.ternary_refine_fused_bounds(
        ex.backend.stores(index.trq), qs, cand.ids, cand.d0, cand.valid,
        index.trq.model, bound="cauchy", z=cfg.z)
    inputs = {
        f"edge C={c:,} Q={q}": (lo, hi, alive),
        f"edge C={c:,} Q={q}, hi falling": (falling - 1, falling,
                                            torch.ones_like(alive)),
        f"fatrq_nprobe256 Q={QUERIES} C={cand.ids.shape[1]:,} "
        f"({int(cand.valid.sum())} valid)": (
            p_lo[:, 0].contiguous(), p_hi[:, 0].contiguous(), cand.valid)}
    del cand, p_lo, p_hi
    for label, (lo_, hi_, al) in inputs.items():
        out = torch.empty_like(al)
        counts = torch.zeros((al.shape[0], 2), dtype=torch.int32,
                             device=al.device)

        def call():
            return t.ternary_refine_prune(lo_, hi_, al, None, counts, out,
                                          k=k)

        tau = call()
        want, _, _, want_tau = t.prune_plain(lo_, hi_, al, None, k=k)
        if not (torch.equal(out, want) and torch.equal(tau, want_tau)):
            raise SystemExit(f"wide_variants: the prune at {label} differs "
                             f"from prune_plain")
        for turn in range(TURNS):
            print(f"prune {label} (turn {turn}): {cs.time_ms(call, 20):.4f} "
                  f"ms per call, device "
                  f"{device_ms(torch, cs, call, 'prune_kernel', 20)}")
    del inputs, ex
    torch.cuda.empty_cache()
    shared(torch, cs, shards, (ds, cfg, index))


def shared(torch, cs, shards: int, built=None) -> None:
    """``--shared``: each kernel's shared form at the fatrq shape, its
    device ms per call by kernel, in two turns (on ``built``, the
    ``fatrq_index`` triple, where given)."""
    from repro_torch.anns import make_sharded_executor, registry
    from repro_torch.anns.stages import make_ivf_front
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_adc as p
    from repro_torch.kernels import ternary_refine as t
    from repro_torch.quant import pq as pq_mod
    ds, cfg, index = built or fatrq_index(torch)
    q = ds.queries[:QUERIES].contiguous()
    cand = make_ivf_front(index).candidates(q)
    lut = pq_mod.adc_table(index.codebook, q)
    stores, model = t.RefineStores.from_trq(index.trq), index.trq.model
    si = make_sharded_executor(index, shards=shards).sharded
    sh = registry.sharded_front("ivf").body(
        q, si.front_rep, si.front_db, si.codebook, si.pq_codes,
        **dict(si.front_args))[0]
    stores0 = t.RefineStores.from_trq(si.shard_trqs[0])
    ids = cand.ids.long()
    rec, packed = stores.records[ids], stores.packed[0][ids]
    cols = (cand.d0, rec[..., 0], rec[..., 1], rec[..., 2], rec[..., 3])
    planes, params, scal = ops.level0_inputs(q, packed.shape[-1], *cols,
                                             model.w, model.bias)
    calls = {
        "pq_adc": (lambda: p.pq_adc(index.pq_codes, cand.ids, cand.valid,
                                    lut), ("adc_kernel",)),
        "fused": (lambda: t.ternary_refine_fused(
            stores, q, cand.ids, cand.d0, cand.valid, None, model, k=10,
            bound="cauchy", z=cfg.z), ("score_kernel", "prune_kernel")),
        "bounds shard 0": (lambda: t.ternary_refine_fused_bounds(
            stores0, q, sh.ids, sh.d0, sh.valid, model, bound="cauchy",
            z=cfg.z), ("bounds_kernel",)),
        "level-0 batch": (lambda: t.ternary_refine_batch(
            packed, planes, scal, params), ("level0_kernel",)),
        "level-0 Q = 1": (lambda: t.ternary_refine(
            packed[0], planes[0], scal[0], params[:1]), ("level0_kernel",))}
    print(f"shared forms at the fatrq shape: Q={q.shape[0]} "
          f"C={cand.ids.shape[1]} ({int(cand.valid.sum())} valid), G="
          f"{packed.shape[-1]}; bounds on shard 0 of {shards}")
    for turn in range(TURNS):
        for name, (fn, kernels) in calls.items():
            split = cs.kernel_ms(torch, fn, 20)
            parts = ", ".join(
                f"{k} {sum(v for n, v in split.items() if k in n):.4f}"
                for k in kernels)
            print(f"{name} (turn {turn}): device ms per call {parts}")


def plan_choices(torch, cs, ops, t, db, cfg, q, shards: int) -> None:
    """The bounds kernel's and the level-0 kernel's chunk plans against
    the ones not taken, each bit-equal to the picked plan's outputs."""
    bounds, level0, shape = path_calls(torch, db, cfg, q, shards)
    print(f"plan choices: {shape}")
    picked_b, picked_l = ops.bounds_plan, ops.level0_plan
    want_b, want_l = bounds(), level0()
    for turn in range(TURNS):
        for passes in REFINE_PASSES:
            ops.bounds_plan = lambda g, L, n=passes: ops.BoundsPlan(
                n, -(-ops.row_passes(g) // n), ops.chunk_width(n),
                ops.refine_chunk_bytes(n), L)
            if not all(torch.equal(a, b) for a, b in zip(bounds(), want_b)):
                raise SystemExit(f"wide_variants: the bounds kernel at "
                                 f"{passes} passes a chunk differs")
            print(f"bounds_kernel<true> {passes} passes a chunk (turn "
                  f"{turn}): {cs.time_ms(bounds, 10):.4f} ms per call, "
                  f"device {device_ms(torch, cs, bounds, 'bounds_kernel')}")
        ops.bounds_plan = picked_b
        for passes in LEVEL0_PASSES:
            warps = max(w for w in range(1, 17) if ops.level0_chunk_bytes(
                passes, w) <= ops.SMEM_LIMIT_BYTES)
            ops.level0_plan = lambda g, n=passes, w=warps: ops.Level0Plan(
                n, -(-ops.row_passes(g) // n), ops.chunk_width(n), w,
                ops.level0_chunk_bytes(n, w))
            if not all(torch.equal(a, b) for a, b in zip(level0(), want_l)):
                raise SystemExit(f"wide_variants: the level-0 kernel at "
                                 f"{passes} passes a chunk differs")
            print(f"level0_kernel<…, true> {passes} passes a chunk, {warps} "
                  f"warps (turn {turn}): {cs.time_ms(level0, 10):.4f} ms "
                  f"per both calls, device "
                  f"{device_ms(torch, cs, level0, 'level0_kernel')}")
        ops.level0_plan = picked_l
    del want_b, want_l


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forms", action="store_true",
                    help="only the bounds and level-0 kernels' selected "
                         "forms at the wide_8192 paths' shapes")
    ap.add_argument("--shared", action="store_true",
                    help="only the five shared forms at the fatrq shape")
    ap.add_argument("--prune", action="store_true",
                    help="only the prune at its edge and fatrq_nprobe256 "
                         "shapes, then --shared")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wide_variants: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.anns import QueryPlan
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import pq_adc as p
    from repro_torch.kernels import ternary_refine as t
    from repro_torch.quant import pq as pq_mod

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build_all()
    if args.forms or args.shared or args.prune:
        mode = forms if args.forms else prune if args.prune else shared
        mode(torch, cs, args.shards)
        return 0
    copies = adc_copies(build)
    picked_adc, picked_refine = ops.adc_plan, ops.refine_plan
    for dim, m in cs.WIDE_SHAPES:
        ds, cfg, db = wide_index(torch, cs, dim, m)
        ex = db.executor_for(QueryPlan(backend="cuda"))
        q = ds.queries.contiguous()
        cand = ex.front.candidates(q)
        lut = pq_mod.adc_table(db.index.codebook, q)
        a_args = (db.index.pq_codes, cand.ids, cand.valid, lut)
        label = f"wide_{dim} (Q={QUERIES}, C={cand.ids.shape[1]}, M={m})"
        want = p.pq_adc(*a_args)

        def adc():
            return p.pq_adc(*a_args)

        plans = {}
        for mc in ADC_CHUNKS:
            plans[mc] = picked_adc(m, 256) if mc == 64 else ops.AdcPlan(
                mc, -(-m // mc), 2 * mc * 256 * 4 + 4096 * 2 + 16 * 4)
        for turn in range(TURNS):
            for mc, plan in plans.items():
                ops.adc_plan = lambda mm, k, plan=plan: plan
                if not torch.equal(adc(), want):
                    raise SystemExit(f"wide_variants: pq_adc {label} at {mc} "
                                     f"subspaces a chunk differs")
                print(f"pq_adc {label} {mc} subspaces a chunk (turn {turn}):"
                      f" {cs.time_ms(adc, 20):.4f} ms per call")
            ops.adc_plan = picked_adc
            for name, lib in [("the source", None), *copies.items()]:
                build._LIBS.pop("pq_adc", None)
                if lib is not None:
                    build._LIBS["pq_adc"] = ctypes.CDLL(str(lib))
                print(f"pq_adc {label} {name} (turn {turn}): "
                      f"{cs.time_ms(adc, 20):.4f} ms per call")
            build._LIBS.pop("pq_adc", None)
        g = db.index.trq.levels[0].packed.shape[1]
        if ops.refine_form(g) == "global":
            stores, model = ex.backend.stores(db.index.trq), db.index.trq.model
            fargs = (stores, q, cand.ids, cand.d0, cand.valid, None, model)

            def fused():
                return t.ternary_refine_fused(*fargs, k=10, bound="cauchy",
                                              z=cfg.z)

            want = fused()
            for turn in range(TURNS):
                for passes in REFINE_PASSES:
                    ops.refine_plan = lambda gg, n=passes: ops.RefinePlan(
                        n, -(-ops.row_passes(gg) // n), ops.chunk_width(n),
                        ops.refine_chunk_bytes(n))
                    if not all(torch.equal(a, b)
                               for a, b in zip(fused(), want)):
                        raise SystemExit(f"wide_variants: the fused kernel at"
                                         f" {passes} passes a chunk differs")
                    score = [ms for name, ms in cs.kernel_ms(
                        torch, fused, 10).items() if "score_kernel" in name]
                    print(f"ternary_refine_fused {label} G={g} {passes} "
                          f"passes a chunk (turn {turn}): "
                          f"{cs.time_ms(fused, 10):.4f} ms per call, "
                          f"score_kernel<true> device "
                          f"{f'{score[0]:.4f}' if score else 'not measured'}"
                          f" ms")
                ops.refine_plan = picked_refine
            plan_choices(torch, cs, ops, t, db, cfg, q, args.shards)
        del db, ex, cand, lut, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
