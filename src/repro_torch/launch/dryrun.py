"""Dry run of every (arch × shape × mesh) cell on the meta device (the port
of ``repro.launch.dryrun``).

The JAX package lowers and compiles each cell for 256 or 512 fake XLA
devices and reads the roofline terms from the compiled artifact.  The
port's steps are Python functions that run one process per device, so
its dry run runs rank 0's step: on the meta device, where tensors carry
shapes and no data, over a ``roofline.RecordingMesh`` of the production
layout whose collectives move nothing and are counted.  It needs no GPU
and no process group.  A PyTorch loop is already unrolled, so one pass
gives both the peak memory and the roofline terms (JAX compiles a scan
form and an unrolled form).

A train step is counted one micro-batch at a time: the dealing of its
micro-batches once, the forward and backward of its first micro-batch,
multiplied by ``meta["cost_repeat"]``, then the update once.  Its peak
memory is that micro-batch's, in which the accumulated gradients are
live too.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k --mesh single          # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # all 80 cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --tables
Records land in experiments_torch/dryrun/<arch>__<shape>__<mesh>.json, or
under ``--out``.  Each ``ok`` record holds the report, the peak memory per
device and whether it fits one card (``fits``).

Statuses: ``ok``; ``skipped`` (``shape_applicable``'s reason);
``error`` where building or counting the step raised, the only status
that fails the run.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.launch import roofline, steps
from repro_torch.train import optimizer

OUT_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "experiments_torch")
DTYPE = torch.bfloat16
DEVICE_BYTES = 80e9             # one H100's memory: the "fits" gate
MESHES = ("single", "multipod")


def cell_mesh(mesh_name: str) -> roofline.RecordingMesh:
    """``make_production_mesh``'s layout: (data=16, model=16), 256 GPUs
    ("single"), or (pod=2, data=16, model=16), 512 ("multipod")."""
    if mesh_name == "multipod":
        return roofline.RecordingMesh(("pod", "data", "model"), (2, 16, 16))
    return roofline.RecordingMesh(("data", "model"), (16, 16))


def build(cfg, mesh, shape):
    """``make_step``'s five values in the dry run's dtype."""
    return steps.make_step(cfg, mesh, shape, dtype=DTYPE)


def place_inputs(structs, meta: dict, mesh):
    """Rank 0's arguments of a step from its ``structs`` (meta tensors at
    their global shapes): the model placed, then the optimizer state and
    batch (train), the batch and cache if any (prefill) or the tokens and
    cache (decode); → (model, args, argument bytes)."""
    specs = meta["specs"]
    model = steps.place_model(structs[0], specs["params"], mesh,
                              batch_axes=meta.get("batch_axes", ()))
    if "batch_axes" in meta:                        # train
        opt = optimizer.init(model)
        args = (opt, steps.place(structs[2], specs["batch"], mesh))
        tensors = (opt.mu, opt.nu, args[1])
    elif "tokens" in specs:                         # decode
        tokens = steps.place({"t": structs[1]}, {"t": specs["tokens"]},
                             mesh)["t"]
        args = (tokens, steps.place(structs[2], specs["cache"], mesh))
        tensors = args
    else:                                           # prefill
        args = (steps.place(structs[1], specs["batch"], mesh),)
        if "cache" in specs:
            args += (steps.place(structs[2], specs["cache"], mesh),)
        tensors = args
    nbytes = roofline.argument_bytes(dict(model.named_parameters()),
                                     *tensors)
    return model, args, nbytes


def count_step(fn, meta: dict, model, *args, mesh=None
               ) -> roofline.StepCounts:
    """``fn(model, *args)`` run once under a ``StepCounter``.  A train step
    (one with ``micro_step``) deals its micro-batches once, runs the
    first, counted ``meta["num_micro"]`` times, then its update once."""
    counter = roofline.StepCounter(mesh)
    if hasattr(fn, "micro_step"):
        opt, batch = args
        k = meta["num_micro"]
        model.zero_grad(set_to_none=True)
        with counter.count():
            part = fn.micro_batches(batch)[0]
        with counter.count(repeat=k):
            loss = fn.micro_step(model, part)
        with counter.count():
            fn.finish(model, opt, [loss] * k)
    else:
        with counter.count():
            fn(model, *args)
    return counter.counts


def _count_cell(arch_name: str, shape_name: str, mesh_name: str):
    """→ (the record's head with its status and meta or reason, the
    report or None where the cell did not run)."""
    cfg, shape = ARCHS[arch_name], SHAPES[shape_name]
    head = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {**head, "status": "skipped", "reason": why}, None
    mesh = cell_mesh(mesh_name)
    fn, structs, _, _, meta = build(cfg, mesh, shape)
    model, args, arg_bytes = place_inputs(structs, meta, mesh)
    counts = count_step(fn, meta, model, *args, mesh=mesh)
    report = roofline.analyze(counts, arch=arch_name, shape=shape,
                              mesh_name=mesh_name, chips=mesh.size,
                              cfg=cfg, argument_bytes=arg_bytes,
                              dtype=DTYPE)
    meta = {k: v for k, v in meta.items() if k != "specs"}
    return {**head, "status": "ok", "meta": meta}, report


def _record_path(out_root: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(out_root, "dryrun", f"{arch}__{shape}__{mesh}.json")


def run_cell(arch_name: str, shape_name: str, mesh_name: str,
             *, save: bool = True, verbose: bool = True,
             out_root: str = OUT_ROOT) -> dict:
    """One cell's record (see the module docstring), written to
    ``out_root``/dryrun/ where ``save``."""
    head = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name}
    t0 = time.time()
    try:
        out, report = _count_cell(arch_name, shape_name, mesh_name)
        if report is not None:
            out = {"status": "ok", "run_s": round(time.time() - t0, 1),
                   "meta": out["meta"],
                   "fits": report.peak_memory_bytes <= DEVICE_BYTES,
                   **report.to_dict()}
            if verbose:
                print(f"[{arch_name} × {shape_name} × {mesh_name}] OK "
                      f"compute={report.compute_s:.4f}s "
                      f"memory={report.memory_s:.4f}s "
                      f"collective={report.collective_s:.4f}s "
                      f"bottleneck={report.bottleneck} mfu={report.mfu:.3f}"
                      f" ({out['run_s']}s)")
                print(f"  peak-mem/device="
                      f"{report.peak_memory_bytes / 2**30:.2f}GiB"
                      f"  useful-flops={report.useful_flops_ratio:.3f}")
        elif verbose:
            print(f"[{arch_name} × {shape_name} × {mesh_name}] "
                  f"{out['status']}: {out['reason'][:200]}")
    except Exception as e:      # a cell's fault is recorded, the run goes on
        out = {**head, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
        if verbose:
            print(f"[{arch_name} × {shape_name} × {mesh_name}] FAIL: "
                  f"{type(e).__name__}: {str(e)[:300]}")
    if save:
        os.makedirs(os.path.join(out_root, "dryrun"), exist_ok=True)
        with open(_record_path(out_root, arch_name, shape_name, mesh_name),
                  "w") as f:
            json.dump(out, f, indent=1)
    return out


# ------------------------------------------------------------------ tables

def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}µs"


def fmt_b(x):
    for unit, div in [("TiB", 2**40), ("GiB", 2**30), ("MiB", 2**20),
                      ("KiB", 2**10)]:
        if x >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}B"


def tables(out_root: str = OUT_ROOT) -> str:
    """The gate and roofline tables of ``scripts/make_experiments_tables.py``
    from the port's records: each cell's status and peak memory per
    device, then the roofline terms of the ``ok`` cells.  Every time in
    them is modelled from H100 SXM5 data-sheet constants."""
    gate = {}
    for path in glob.glob(os.path.join(out_root, "dryrun", "*.json")):
        with open(path) as f:
            r = json.load(f)
        gate[r["arch"], r["shape"], r["mesh"]] = r
    lines = []
    n = {s: sum(r["status"] == s for r in gate.values())
         for s in ("ok", "skipped", "error")}
    lines += ["### Dry-run gate (all 80 cells)\n",
              f"**{n['ok']} ran OK, {n['skipped']} skipped per spec, "
              f"{n['error']} failed.**  Peak memory per device = argument "
              f"bytes + the step's live high-water mark on meta.\n",
              "| arch | shape | single: peak mem | multipod: peak mem | "
              "notes |", "|---|---|---|---|---|"]

    def cell(r):
        if r is None:
            return "—"
        if r["status"] != "ok":
            return "**ERR**"
        fits = "" if r["fits"] else " (over 80 GB)"
        return fmt_b(r["peak_memory_bytes"]) + fits

    for a in sorted(ARCHS):
        for s in SHAPES:
            rs, rm = gate.get((a, s, "single")), gate.get((a, s, "multipod"))
            if rs is None and rm is None:
                continue
            if rs and rs["status"] == "skipped":
                lines.append(f"| {a} | {s} | skipped | skipped | "
                             f"{rs['reason'][:70]} |")
                continue
            meta = (rs or rm).get("meta", {})
            bits = []
            if meta.get("num_micro", 1) > 1:
                bits.append(f"micro={meta['num_micro']}")
            if meta.get("flash_decode"):
                bits.append("flash-decode")
            lines.append(f"| {a} | {s} | {cell(rs)} | {cell(rm)} | "
                         f"{','.join(bits)} |")

    lines += ["\n### Roofline terms (modelled from H100 SXM5 data-sheet "
              "constants)\n",
              "| arch | shape | mesh | compute | memory(UB) | collective | "
              "bottleneck | useful-FLOPs | MFU | MFU(opt) |",
              "|---|---|---|---|---|---|---|---|---|---|"]
    for a in sorted(ARCHS):
        for s in SHAPES:
            for m in MESHES:
                r = gate.get((a, s, m))
                if not r or r["status"] != "ok":
                    continue
                lines.append(
                    f"| {a} | {s} | {m} | {fmt_s(r['compute_s'])} | "
                    f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
                    f"**{r['bottleneck']}** | "
                    f"{r['useful_flops_ratio']:.3f} | {r['mfu']:.4f} | "
                    f"{r['mfu_optimistic']:.4f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tables", action="store_true",
                    help="print the tables from the records and exit")
    ap.add_argument("--out", default=OUT_ROOT,
                    help="where the records go (default: experiments_torch)")
    args = ap.parse_args(argv)
    if args.tables:
        print(tables(args.out))
        return 0

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    if args.all:
        meshes = list(MESHES)

    t0 = time.time()
    results = []
    for a in archs:
        for s in shapes:
            for m in meshes:
                path = _record_path(args.out, a, s, m)
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[{a} × {s} × {m}] cached ({prev['status']})")
                        results.append(prev)
                        continue
                results.append(run_cell(a, s, m, out_root=args.out))
    n = {s: sum(r["status"] == s for r in results)
         for s in ("ok", "skipped", "error")}
    print(f"\n=== dry-run: {n['ok']} ok / {n['skipped']} skipped / "
          f"{n['error']} failed of {len(results)} cells in "
          f"{time.time() - t0:.1f} s ===")
    return 0 if n["error"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
