"""Times the two chunked global forms at the wide cells' shapes against the
chunk plans they did not take, and ``pq_adc``'s global form against
timing-only copies of its source (GPU only, ~1 min).

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

The plans are swapped in by replacing ``ops.adc_plan`` / ``ops.refine_plan``
in this process; the library has no such option.  It fails loudly if a
plan's output differs or the source no longer matches its patches.

    python3 wide_variants.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "src/repro_torch/kernels/_build/wide_variants"  # not committed

#: subspaces of a pq_adc LUT chunk, and passes of a refine chunk, to time
ADC_CHUNKS, REFINE_PASSES = (64, 32, 48), (3, 2, 1)
QUERIES, TURNS = 64, 2

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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wide_variants: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.anns import Database, PipelineConfig, QueryPlan
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import pq_adc as p
    from repro_torch.kernels import ternary_refine as t
    from repro_torch.quant import pq as pq_mod

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build_all()
    copies = adc_copies(build)
    picked_adc, picked_refine = ops.adc_plan, ops.refine_plan
    for dim, m in cs.WIDE_SHAPES:
        ds = cs.wide_dataset(torch, cs.WIDE_N, dim, QUERIES, 0)
        cfg = PipelineConfig(dim=dim, pq_m=m, pq_k=256, nlist=100,
                             nprobe=16, trq_levels=1, final_k=10,
                             refine_budget=40, bound="cauchy",
                             micro_batch=QUERIES)
        db = Database.build(ds.x, cfg, generator=torch.Generator(
            device="cuda").manual_seed(0))
        ex = db.executor_for(QueryPlan(backend="cuda"))
        q = ds.queries.contiguous()
        cand = ex.front.candidates(q)
        lut = pq_mod.adc_table(db.index.codebook, q)
        args = (db.index.pq_codes, cand.ids, cand.valid, lut)
        label = f"wide_{dim} (Q={QUERIES}, C={cand.ids.shape[1]}, M={m})"
        want = p.pq_adc(*args)

        def adc():
            return p.pq_adc(*args)

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
        del db, ex, cand, lut, args, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
