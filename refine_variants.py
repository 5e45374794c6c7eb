#!/usr/bin/env python3
"""Time variants of the multi-level refine kernels on one NVIDIA GPU.

    python3 refine_variants.py

Builds the kernels of ``src/repro_torch/kernels/csrc/ternary_refine.cu`` as
they are (split T27/T9 partial-dot tables, 1024-slot tiles) and copies of
that source with one change each: 2048- and 4096-slot tiles, and one
(G, 243) partial-dot table per query (one lookup per code byte instead of
two; built from the split tables, so its estimates are bit-identical; it
leaves one block per SM, so those blocks have 1024 threads and 23,552
slots).  Each variant runs the fused kernel (score and prune launches
apart) and the bounds kernel on three synthetic inputs of the main path's
shapes, 64 queries x 16 lists x 2930 slots at G = 154:

- fatrq-like: a 1M-row store, each list's rows scattered over it, ~32% of
  the slots valid (a prefix of each list);
- shard-like: a 250k-row store, list rows contiguous, a quarter of the
  lists holding a valid prefix (~8% valid);
- random: a 1M-row store, rows scattered, 8% of the slots valid at random.

Each variant's estimates are held against the unchanged source's (within
3e-5) and its bounds est against its fused est (bit for bit).  It prints
device ms per call (``torch.profiler``) and each kernel's registers
(``ptxas -v``).  It exits non-zero when no GPU is present.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "src/repro_torch/kernels/csrc/ternary_refine.cu"
OUT = ROOT / "src/repro_torch/kernels/_build/variants"  # not committed
G, Q, LISTS, CAP = 154, 64, 16, 2930


def patch(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"refine_variants: the source changed; cannot "
                             f"find {old[:60]!r}")
        src = src.replace(old, new)
    return src


def tile(n: int):
    return [("constexpr int kSlotTile = 1024;",
             f"constexpr int kSlotTile = {n};")]


# the (G, 243) table: rows y = 0..255 of T27[y % 27] + T9[y / 27] (zero
# from 243), ahead of the split tables it is built from
TABLE243 = [
    ("constexpr int kScoreThreads = 256;",
     "constexpr int kScoreThreads = 1024;"),
    ("__global__ void score_kernel(",
     "__global__ void __launch_bounds__(1024, 1) score_kernel("),
    ("__global__ void bounds_kernel(",
     "__global__ void __launch_bounds__(1024, 1) bounds_kernel("),
    ("""__device__ __forceinline__ void load_tables(float* s_t, const float* qplanes,
                                            int G, int gp) {
  float* t9 = s_t + 27 * gp;""",
     """__device__ __forceinline__ void load_tables(float* s_full,
                                            const float* qplanes,
                                            int G, int gp) {
  float* s_t = s_full + 256 * gp;
  float* t9 = s_t + 27 * gp;"""),
    ("""      t9[r * gp + col] = in && r < 9 ? v : 0.f;
    }
  }
  __syncthreads();
}""",
     """      t9[r * gp + col] = in && r < 9 ? v : 0.f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256 * gp; i += blockDim.x) {
    const int y = i / gp, col = i - y * gp;
    s_full[i] = y < 243 ? s_t[(y % 27) * gp + col] + t9[(y / 27) * gp + col]
                        : 0.f;
  }
  __syncthreads();
}"""),
    ("""        const uint32_t top = __umulhi(y, 159072863u);  // y / 27, y < 256
        const uint32_t col = pass + 16u * kGroup * s;
        acc += lds(s_b, y * gp4 - top * (27u * gp4) + c27[b] + col) +
               lds(s_b, top * gp4 + c9[b] + col);""",
     """        const uint32_t col = pass + 16u * kGroup * s;
        acc += lds(s_b, y * gp4 + c27[b] + col);"""),
    ("(size_t)(27 + kT9Rows) * table_width(G) * sizeof(float)",
     "(size_t)(256 + 27 + kT9Rows) * table_width(G) * sizeof(float)"),
]

VARIANTS = {"split, 1024-slot tiles (the source)": [],
            "split, 2048-slot tiles": tile(2048),
            "split, 4096-slot tiles": tile(4096),
            "(G, 243) table": TABLE243 + tile(23_552)}


def build_variants(build) -> dict:
    """Compile every variant at once; library path and ptxas registers."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    jobs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(patch(src, edits))
        lib = OUT / f"libv{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"refine_variants: {name} failed:\n{log}")
        regs, kernel = {}, None
        for line in log.splitlines():
            m = re.search(r"entry function '\S*?(score|bounds)_kernel", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                regs[kernel], kernel = int(m.group(1)), None
        built[name] = (lib, regs)
    return built


def inputs(torch, ops, tr, trq_mod, gen, *, n, pattern, scattered):
    """One synthetic problem: stores, ids, d0, valid."""
    dev = gen.device

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    level = trq_mod.TRQLevel(
        packed=torch.randint(0, 243, (n, G), generator=gen, device=dev,
                             dtype=torch.uint8),
        proj=rand(n) - 0.5, norm=rand(n), rho=rand(n))
    stores = tr.RefineStores(
        packed=(level.packed,),
        records=torch.stack([rand(n) * 2, rand(n) - 0.5, rand(n), rand(n)],
                            1).contiguous(),
        levels=(ops.level_table(level),), dim=5 * G - 2)
    start = torch.randint(0, n - CAP, (Q, LISTS), generator=gen, device=dev)
    ids = (start[..., None] + torch.arange(CAP, device=dev)).reshape(Q, -1)
    if scattered:
        ids = torch.randperm(n, generator=gen, device=dev)[ids]
    slot = torch.arange(CAP, device=dev)
    if pattern == "prefix":
        valid = slot < (rand(Q, LISTS) * 1860).long()[..., None]
    elif pattern == "quarter":
        owned = rand(Q, LISTS) < 0.25
        valid = slot < ((rand(Q, LISTS) * 1860).long() * owned)[..., None]
    else:
        valid = rand(Q, LISTS, CAP) < 0.08
    valid = valid.reshape(Q, -1).contiguous()
    d0 = torch.where(valid, rand(Q, LISTS * CAP) * 4, float("inf"))
    ids = torch.where(valid, ids, 0).int().contiguous()
    return stores, ids, d0.contiguous(), valid


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("refine_variants: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import calibration as cal
    from repro_torch.core import trq as trq_mod
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ternary_refine as tr

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    built = build_variants(build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    problems = {
        "fatrq-like": inputs(torch, ops, tr, trq_mod, gen, n=1_000_000,
                             pattern="prefix", scattered=True),
        "shard-like": inputs(torch, ops, tr, trq_mod, gen, n=250_000,
                             pattern="quarter", scattered=False),
        "random": inputs(torch, ops, tr, trq_mod, gen, n=1_000_000,
                         pattern="random", scattered=True)}
    model = cal.CalibrationModel(
        w=torch.tensor([1.0, 1.1, 0.95, 2.1], device="cuda"),
        bias=torch.tensor(0.3, device="cuda"),
        resid_std=torch.tensor(0.05, device="cuda"))
    q = torch.randn((Q, 5 * G - 2), generator=gen, device="cuda")
    want = {}
    for name, (lib, regs) in built.items():
        # the wrappers load csrc/ternary_refine.cu's library through this
        # cache; each variant takes its place in turn
        build._LIBS["ternary_refine"] = ctypes.CDLL(str(lib))
        print(f"{name}: registers {regs}")
        for label, (stores, ids, d0, valid) in problems.items():
            def fused():
                return tr.ternary_refine_fused(stores, q, ids, d0, valid,
                                               None, model, k=10,
                                               bound="cauchy", z=3.0)

            def bounds():
                return tr.ternary_refine_fused_bounds(
                    stores, q, ids, d0, valid, model, bound="cauchy", z=3.0)

            est, b_est = fused()[0], bounds()[0]
            want.setdefault(label, est)
            ok, err = chip_smoke.close(est, want[label], 3e-5, 3e-5)
            if not ok or not torch.equal(est[valid], b_est[valid]):
                raise SystemExit(f"refine_variants: {name} on {label}: est "
                                 f"off (max err {err}) or bounds est not "
                                 f"bit-identical")
            ms = {}
            for what, fn in (("fused", fused), ("bounds", bounds)):
                for kernel, t in chip_smoke.kernel_ms(torch, fn, 20).items():
                    for short in ("score", "prune", "bounds"):
                        if f"{short}_kernel" in kernel:
                            ms[short] = t
            times = ", ".join(f"{k} {ms[k]:.4f}" if k in ms else
                              f"{k} not measured"
                              for k in ("score", "prune", "bounds"))
            print(f"  {label} ({int(valid.sum())} valid of {valid.numel()}"
                  f"): ms per call {times}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
