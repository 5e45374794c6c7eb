#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FaTRQ on one NVIDIA GPU.

    python3 chip_smoke.py            # 1M x 768 index, 1000 queries, 4 shards,
                                     # then 100,000-row indexes at D = 2048
                                     # and 8192 (pq_m = d / 8),
                                     # then qwen2.5-3b over a 1M x 2048 index,
                                     # then zamba2, xlstm and whisper, then
                                     # qwen2.5-3b training

Phases, each of which raises on failure:

1. print the card (``nvidia-smi``), build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel) and
   print each kernel's registers, stack and shared memory (``cuobjdump
   -res-usage``, each form of each kernel), and the prune kernel's cluster
   width (CUDA runtime, both forms);
2. make a synthetic 1M x 768 dataset with exact ground truth, build the
   index (PQ M=96, K=256; IVF nlist=1024; one TRQ level) twice from one
   seed, require the two builds' index arrays to be bit-equal, and
   partition it into ``--shards`` shards for the sharded layout; build the
   index's kNN graph (degree 16, timed), build the graph of the first
   100,000 rows twice and require the two adjacencies to be equal, and
   partition the graph into ``--shards`` range + halo shards (timed);
3. edge-shape phase: the fused and bounds refine kernels against their
   plain versions, and the bounds est against the fused est bit for bit,
   on random code stores at G in {1, 13, 20, 154, 410, 1437, 1438, 1639}
   (410: D = 2048, rows of three passes; 1438 and 1639 past the shared
   tables: the global forms, timed at 1639) and L in {1, 2, 3}, with
   C = 4133 slots (not a multiple of 32 or of a block's tile) and C = 64
   (the graph beam, every odd slot repeating the id and d0 of the slot
   before it), one query with no valid slot and one with every slot
   valid; ``pq_adc`` against its
   plain version with +inf on exactly the invalid slots, at M in {4, 6,
   16, 20, 96, 128, 220, 256, 1024} and K in {16, 256} on the same slots
   (M = 220, 256, 1024 at K = 256 past the shared LUT: the global form,
   timed at 1024 beside one ``embedding_bag``), the store read at offsets
   0, 4 and 1 (the 16-byte, word and byte row paths) giving the same
   bits; the prune alone
   (``ternary_refine_prune``) against ``prune_plain`` exactly (mask,
   counts, tau) at C in {1, 31, 48, 64, 4133, 46,880, 446,000 (near the
   shared form's capacity), 446,465, 1,048,576 (the global form, timed)}
   and k in {1, 10, 64}, three levels with the mask written
   over the alive buffer it reads, forced ties at tau, queries with every,
   no and fewer than k alive slots, one hi for every slot and hi falling
   along the slots (the global form's worst case, timed), with and
   without delta rows; both
   level-0 forms (``ternary_refine_batch``, ``ternary_refine``) against
   ``refine_level0_plain`` at each G and at G = 319, 503 and 504 (past
   the shared pair tables from 504), at Q = 5 and Q = 1 with C = 4133, on
   code bytes from 0..255 (243..255 decode as y - 243), on fresh tensors
   and on views whose code rows and scalars start at a base that is not
   16-byte aligned; at every shape where a kernel's shared form fits, its
   global form (``form="global"``) must give the same bits;
   kernel phase: each kernel against its plain PyTorch version on the card
   at the shapes its path gives it (64 queries x nprobe 16 lists):
   ``pq_adc`` at the fatrq shape and on shard 0's candidates (its own code
   store, shard-local ids; each valid slot's d0 bit-identical to the
   unsharded d0 of the same row), each also timed with every slot valid and
   on an all-zero code store (no bank conflicts), and one
   ``embedding_bag`` call over the same lookups as its library time; the
   fused refine kernel also with two TRQ levels, both bounds and delta
   rows; the bounds kernel on one shard's candidates, both bounds, one and
   two levels, its estimates bit-identical to the fused kernel's and its
   intervals' alive chain giving the fused kernel's survivors; the
   level-0 kernels on the gathered code rows of those 64 queries, driven
   once through ``ops.refine_scores_batch`` / ``ops.refine_scores`` (the
   ops path), each also timed on the device (``torch.profiler``), with the
   kernel's runtime attributes and its SASS instruction counts per code
   byte; the fused call's score and prune launches timed apart
   (``torch.profiler``), and both multi-level kernels also with every slot
   scored; the prune alone at the fatrq shape on those candidates' level-0
   bounds, exactly the fused call's survivors, timed beside its bound, its
   plain version and one ``torch.topk`` of the masked upper bounds (the
   select of tau only) as its library time; each of the six entry points
   also in its global form at these shapes, bit-equal to the shared form
   the shapes select and timed beside it in turns; then at the graph
   front's
   shapes (the final 64-slot beams of 64 queries): ``pq_adc``, the fused
   refine kernel (both bounds, one and two levels, delta rows) and the
   prune alone on those beams, the bounds kernel on graph shard 0's beam
   slots (the shard's beams and d0 bit-identical to the unsharded ones on
   the slots it owns), each against its plain version and timed beside
   its bound;
4. search paths: ``Database.query`` with ``mode="fatrq"`` (``cuda``
   backend), ``mode="baseline"`` and ``QueryPlan(shards=S)`` (``cuda``),
   and the same three on the graph front (``front="graph"``), over all
   queries in 64-query micro-batches, each with every kernel's launch
   count reset just before its run and read just after; the sharded ids
   and per-tier bytes must equal fatrq's, front by front; recall@10 must
   reach 0.5 on the IVF paths and 0.1 (a broken traversal's floor) on the
   graph paths; then queries/s (median of 3 runs, the paths in turns)
   and, from one more profiled run of each path (the graph paths' over
   their first ``PROFILE_GRAPH_QUERIES`` queries), its device time by
   kernel and idle share (``torch.profiler`` and CUDA events);
5. the plain ``reference`` backend on the card over a subset of queries
   must give the same ids and ledger as the ``cuda`` backend, unsharded
   and sharded, on both fronts;
   then the paper's storage and distortion comparators (§V-C, Fig. 7;
   ``baselines_phase``) on the index: bytes per record of FaTRQ (162),
   SQ-4 (392), SQ-3 (296), INT8 (776) and a 2-level RQ (M = 96: 192),
   which must be those; residual SQ's error falling from 3 to 4 to 8 bits
   and RQ's (trained on every row, 8 iterations a level) with each level;
   the normalized distortion against each query's exact top-100 of INT8,
   PQ + per-record 3-bit SQ residuals, PQ + FaTRQ and the 2-level RQ;
   then the serving path: each query-side op of the IVF and graph paths
   on one query alone and inside a 64-row bucket padded from 37, printed
   as bit-equal or not; ``pq_adc`` and the fused kernel on that padded
   bucket against their plain versions (+inf and no survivor or count in
   a padded row; est within tolerance on the valid slots, alive and
   counts exact); ``Retriever`` with the 1000 queries sent as calls of
   ragged sizes (37, 5, 64, 1, ...), ``bucket=True`` against
   ``bucket=False``: ids, distances and ledgers bit-equal call by call,
   and with buckets ``pq_adc`` sees only query counts 1, 2, 4, ... 64, on
   the static and the sharded (``--shards``) layouts here, on the
   rebalanced tiered index (Zipfian queries) at the end of phase 6 and
   on the streaming index mid-churn in phase 7's round 0; then
   ``ServingEngine`` on the static IVF fatrq plan (``max_batch=64``,
   ``max_wait_us=200``): 4096 requests every 10 us of virtual time drawn
   by a Zipf(1.1) rank over the queries, every 4th from a tenant
   throttled by a token bucket, with a result cache: every response
   (hits too) equal to a sequential ``db.query`` of its query under its
   class plan, ids and distances bit for bit, with the double buffer on
   and off, ``total_cost`` equal to the sum of the misses' sequential
   ledgers, and without the cache overlap on and off equal row by row on
   the same batches; hits, misses, batches and padded slots, the
   modelled (virtual-clock) latencies, requests/s to drain with overlap
   on, off and ``batching=False`` (host clock, median of 3, in turns),
   and one profiled overlap-on run: device busy, idle share and how long
   the fronts' stream and the refines' stream ran kernels at once;
6. the tiered layout: a never-rebalanced ``TieredIndex`` must give the
   static fatrq and graph paths' ids, distances and ledgers bit for bit;
   a cold-only placement (``TieredConfig(hot_rows_frac=0.0,
   cold_rows_frac=0.3)``, heat from one pass) the same ids and
   distances, with exactly the cold accesses moved from ``refine:cxl``
   to ``cold:ssd``, and no hot scoring run; on 1000 Zipfian queries
   (anchors ∝ rank^-1.3 of the rows nearest row 0, noise 0.02,
   ``--seed``) an all-warm pass, ``rebalance_tiers()`` with
   ``TieredConfig(decay=0.5, hot_rows_frac=0.1, cold_rows_frac=0.2)``
   (a second one must keep the generation, the executor must be
   rebuilt), then the hot pass: fewer ``rerank:ssd`` accesses than
   all-warm, a ``hot:hbm`` entry, a lower modelled time, recall@10 of
   0.5 on static, all-warm and hot, and the ``reference`` backend equal
   to ``cuda`` on 64 queries, both fronts.  ``pq_adc`` and the fused
   kernel (one and two levels) against their plain versions at the
   tiered shape with the real hot mask and cold flags (alive and counts
   exact), queries/s of static fatrq, all-warm, cold-only, static fatrq
   on the Zipfian trace and the hot pass (median of 3, in turns),
   profiled all-warm and hot passes, and one traced query batch and
   ``rebalance_tiers()``: bit-equal to untraced, the span tree, the
   ``index.rebalance_tiers`` event, ``tiered_rows`` summing to N, a
   Chrome trace that loads as JSON, and each stage's measured and
   modelled time;
7. the streaming layout: the static paths' partitions and executors are
   freed, the 1M index is wrapped in a ``StreamingIndex`` (its graph taken over, so
   ``insert_nodes`` runs in every round) and driven through
   ``STREAM_ROUNDS`` rounds of churn (one), each inserting 20,000
   perturbed copies of database rows and deleting 20,000 random live ids,
   then rebalanced over ``--shards`` shards; each insert, delete,
   rebalance, rebuild and
   compaction timed (encode, ``insert_nodes``, ``compact_graph``, the
   host copies and the cycle collection of a dropped snapshot apart);
   round 0's insert and delete traced (``index.insert`` and
   ``index.delete`` events, ``streaming_mutations_total`` of 1 each).
   Mid-churn, ``Database.query`` on the IVF front
   (``cuda``) must give the ids and per-tier bytes of the same plan over
   ``rebuild_static()`` mapped through its global ids, bill
   ``delta:cxl`` while delta rows remain, return no dead id and reach
   recall@10 0.5 against exact ground truth over the live rows; the graph
   front must return no dead id and reach 0.1; the ``reference`` backend
   must give ``cuda``'s ids and ledger on 64 queries, both fronts.  In
   round 0: ``pq_adc`` and the fused kernel (with the candidates' real
   delta flags) against their plain versions at the streaming IVF shape,
   queries/s of both fronts (median of 3, in turns) and one profiled IVF
   run.  After each ``compact()`` and after the rebalance: the graph
   front equal to a static search of the snapshot over the maintained
   adjacency with ``start(n_live)``, IVF equal to its rebuild, no dead
   id.  After the rebalance, ``shards=--shards``: IVF equal to the
   unsharded streaming answer, graph equal to the unsharded graph query
   over the snapshot.  The launches of
   ``pq_adc`` and the fused kernel on both streaming fronts and of the
   bounds kernel on the sharded ones must be non-zero.  Then the peak
   device memory, which must stay under 70 GB;
8. invalidation: one ``ServingEngine`` with a cache over a
   ``StreamingIndex`` of the 1M index runs 1024 requests, takes 20,000
   inserted near-copies of the queries' true neighbours, and runs them
   again; then over a ``TieredIndex`` on Zipfian queries around a
   ``rebalance_tiers()``.  Each mutation must purge the cache and every
   response after it equal a fresh sequential ``db.query``;
   then the high-recall IVF path (``nprobe_path``, ``fatrq_nprobe256``):
   nprobe 256 on the 1M index (C = 750,080, past the prune's shared
   form) through ``make_executor``, one fused call and one global-form
   prune launch per micro-batch, no scratch, 40 SSD fetches a query,
   recall@10 beside the IVF ceiling, queries/s, the prune on its level-0
   bounds against ``prune_plain``, and ``reference`` equal to ``cuda``
   on 128 queries;
   then the sharded search across processes (``mesh_phase``): a one-rank
   NCCL group (``make_search_mesh(1)``) whose ``QueryPlan(shards=1,
   backend="cuda")`` answers with ``mesh=`` must equal the stacked
   ``shards=1`` answers bit for bit (ids, distances, ledger, modelled
   breakdown) on both fronts, timed against them in turns, one 64-query
   batch blocking the host as often as the stacked form's
   (``host_syncs``); then
   ``--shards`` gloo ranks spawned on the one card, one shard each, the
   IVF front placed by ``Database.query(..., mesh=)`` itself over the
   index the parent saved and the graph front by ``ShardedIndex.place``
   from the parent's stacked partition (mapped from a file, so each rank
   reads only its block): every rank's answers must equal the stacked
   ``shards=--shards`` results of phase 4 bit for bit, with ``pq_adc``
   and the bounds kernel launched on every rank; each rank's launches,
   times and peak memory, and the phase's wall time (gloo on one card:
   not a multi-GPU throughput);
   then the wide phase (``wide_phase``), after the 1M x 768 tensors are
   freed: the port's own build of 100,000 rows at (D, pq_m) = (2048, 256)
   and (8192, 1024) (``make_embeddings`` rows, their spread scaled to keep
   the 768-wide rows' ratio of noise to centre), K 256, nlist 100, nprobe
   16, budget 40, one TRQ level, and 1000 queries through
   ``Database.query`` (``cuda``), every count reset just before and read
   just after: ``pq_adc`` (both widths) and the fused kernel (D = 8192,
   G = 1639) in their global forms, the refine tables once a fused call,
   no global form of the fused kernel at D = 2048; distances the
   ids' exact L2; the ``reference`` backend's ids and ledger on 64
   queries; recall@10 at least 0.5 and at least 0.9 of the IVF front's
   ceiling (the share of the true top-10 among the candidates); queries/s
   (median of 3), each kernel's device ms in one run of the path,
   ``pq_adc`` and the fused kernel against their plain
   versions at the path's shape with their bounds and ``embedding_bag``;
   at D = 8192 the level-0 ops path on 8 queries' candidates (its global
   form) and the sharded layout on the same index (``wide_sharded``,
   ``--shards`` shards on one card: the bounds kernel's global form once a
   shard and micro-batch, never its shared form; ids, distances and
   per-tier bytes equal to the unsharded answers, the ``reference``
   backend's ids and ledger, recall@10, queries/s, device ms, and the
   bounds kernel on shard 0's candidates against its plain version with
   its chunk plan);
9. the RAG round trip at the full width of qwen2.5-3b (36 layers,
   d_model 2048, 3,085,697,024 parameters in float32), after every
   earlier phase's tensors are freed: a 1M x 2048 index (``make_dataset``,
   PQ M=128, K=256, nlist 1024, nprobe 16, budget 40; its build timed)
   whose fatrq recall@10 over 1000 queries is at least 0.9 of the
   baseline mode's (the exact rerank of the same candidates: the IVF
   front's ceiling on these diffuse rows) with recall@1 of at least 0.99,
   and the ``reference`` backend equal to ``cuda`` on 64; ``pq_adc`` and the
   fused kernel against their plain versions at its shape (G = 410,
   alive and counts exact); the LM drawn on the card from ``--seed``, its
   matrix parameters equal to ``params_count()``; a prefill of 8 x 32
   tokens and 8 teacher-forced decode steps equal to one forward of the
   40 tokens within 2e-3; prefill and decode-step times beside their
   bounds; then ``rag_answer`` (8 prompts of 32 tokens, k=5, 16 decode
   steps, ``embed_fn`` the mean-pooled token embeddings) through a
   ``Retriever`` (``backend="cuda"``, ``micro_batch=8``) and through a
   ``ServingEngine``: ids equal to a direct ``db.query`` bit for bit, the
   two forms' ids and tokens equal, ``pq_adc`` and the fused kernel
   launched, every decode step run with host synchronizes raising
   (``torch.cuda.set_sync_debug_mode("error")``) and no host synchronize
   (``host_syncs``) and no synchronize or blocking copy among the CUDA
   runtime calls (``torch.profiler``) of two steps; recall@5, the ledger,
   tokens/s, the phase's time and its peak memory (under 70 GB);
10. the other model families at full width, after the LM is freed
   (``families_phase``): zamba2-1.2b (38 layers, d_model 2048),
   xlstm-1.3b (48 layers, d_model 2048) and whisper-medium (24 + 24
   layers, d_model 1024, 1500 frames), float32, random weights from
   ``--seed``, one at a time: each model's parameter count equal to the
   JAX package's init (``FAMILY_PARAMS``); 8 x 40 teacher-forced decode
   steps (whisper's after ``prefill_encoder`` on seeded frames) equal to
   one forward in float64 within 5e-3 (zamba2, xlstm) or 2e-3 (whisper),
   every step with host synchronizes raising (at these widths xlstm's
   float32 chunked forward is itself further than the bound from the
   float64 one); one decode step at batch 8 timed beside its bound and
   profiled; no blocking CUDA runtime call in
   two ``Engine`` steps; ``rag_answer`` for zamba2 and xlstm over the
   1M x 2048 index (8 requests of 32 tokens, k=5, 16 decode steps,
   through a ``Retriever``): ids equal to ``db.query``'s, ``pq_adc`` and
   the fused kernel launched; whisper's ``Engine.prefill`` and 16 decode
   steps; the phase's time and peak memory (under 70 GB);
11. training (``train_phase``), after the families' models and the RAG
   index are freed: qwen2.5-3b at its published configuration (36
   layers, d_model 2048, float32 with TF32 off, weights from ``--seed``)
   trained by ``train`` for 6 steps of 8 x 128 tokens on one fixed
   batch with remat: every loss finite, none skipped, the last two below
   the first two; the median step time beside its bound, tokens/s, peak
   memory and one profiled step's device busy and idle share; at 2
   layers one step's loss and gradients against a float64 copy (1e-5,
   1e-3), remat against none (1e-6) and ``compress_grads`` (within 1 ulp,
   ~4x fewer wire bytes); on the reduced model a run resumed from its
   step-2 checkpoint equal to the uninterrupted run within 1e-6, and
   ``restore`` putting every leaf on the card;
   then the LM across processes (``lm_mesh_phase``): on a one-rank NCCL
   group, ``make_host_mesh()``'s prefill, cache-filling prefill, 4
   decode and one train step of the full qwen2.5-3b bit-equal to the
   plain path (times beside it); then 4 gloo ranks on the card at full
   width and 4 layers: teacher-forced decode on the (1, 4) mesh (flash
   decode) within 2e-3 of the one-process decode, a ``"2d"`` train step
   on (2, 2) whose loss (1e-4) and gradients (1e-4 · max|leaf| + 1e-6)
   are the one-process step's, each rank's step times and peak memory;
   then (``lm_mesh_gaps``) 4 more gloo ranks at published widths and cut
   depth: zamba2, xlstm and whisper decode on (1, 4) and (2, 2) (caches
   and states split over ``model``), zamba2 at batch 1 over a
   32,768-position cache split over data on (4, 1), phi3.5-moe's
   prefill and decode (router groups spanning ranks) on (4, 1) and
   (2, 2), each within 2e-3 of one process with its cache shards, and
   its bfloat16 train step on both against the one-process step;
   then the dry run and the roofline (``dryrun_phase``): qwen2.5-3b at
   its published configuration in bfloat16 on ``make_host_mesh()``, its
   train (8 x 128), prefill (8 x 1024) and decode (batch 8, a 4096-position
   cache) steps each counted on the card and on the meta device by
   ``launch.roofline``'s counters: FLOPs equal, bytes within 1%, the
   meta live high-water mark within 0.5x-2x of the card's peak above
   what was allocated before, the median of 3 step times beside the
   modelled ``step_time_s``; then four production cells run on meta by
   ``launch.dryrun.run_cell`` with their expected statuses;
   then the four examples (``examples/*_torch.py``) at their defaults
   (``train_lm_torch`` at 60 steps),
   each timed: FaTRQ's recall@10 within 0.1 of the baseline's with fewer
   SSD fetches, a modelled saving after ``rebalance_tiers()``, the RAG
   ids equal to ``db.query``'s, and the training loss (mean of the last
   20 steps) below the first 20 steps' on the random tokens;
12. print one ``kernels`` JSON line (the three kernels of the graph paths
   with a ``graph`` entry: their numbers at the graph shapes; ``pq_adc``
   and the fused kernel with ``streaming`` and ``tiered`` entries at the
   streaming IVF and tiered shapes, and ``serving`` entries at the
   padded bucket with the engine's launches; ``pq_adc`` and the fused
   kernel with ``rag`` entries at the RAG index's shape with the round
   trip's launches; ``launches_by_path`` also has ``rag_zamba2`` and
   ``rag_xlstm``, and the mesh phase's runs, one a rank; ``pq_adc`` and
   the bounds kernel have a ``mesh`` entry with those launches; every
   kernel has a ``global`` entry: its global form at its widest run
   shape, with its global-form launches over the wide paths, beside the
   shared form at the fatrq shape (bit-equal) and at the edge shapes),
   then the result line
   ``{"ok": true,
   "device": {...}}`` last.

It exits non-zero with no result when no GPU is present, or when the
``src/repro_torch`` package is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_OPS_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
EST_TOL = 3e-5                  # rtol = atol, as tests/test_kernels.py uses
LEVEL0_TOL = 2e-5               # the level-0 kernels' tolerance there
ADC_ATOL, ADC_RTOL = 1e-4, 1e-5  # sums of M f32 LUT entries in other orders


# host-clock timings: runs of each path or mode, in turns; the median kept
TIMING_RUNS = 3
# the graph paths' profiled run covers their first queries (4 of the 16
# micro-batches): the profiler's cost grows with their ~27 ops a hop
PROFILE_GRAPH_QUERIES = 256


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(label: str, t0: float) -> float:
    """Print the wall seconds since ``t0`` as phase ``label``'s, on a line
    of its own; → now (the next phase's ``t0``)."""
    now = time.perf_counter()
    print(f"phase {label}: {now - t0:.1f} s", flush=True)
    return now


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
            kernel = re.search(r"\d((?:adc|score|bounds|prune|level0|"
                               r"pair_tables|tables)_kernel)"
                               r"(I((?:Lb[01]E)+)E)?", name)
            if name.strip().startswith("Function") and kernel:
                flags = re.findall(r"Lb([01])E", kernel.group(3) or "")
                args = ",".join("true" if f == "1" else "false"
                                for f in flags)
                print(f"{Path(lib).name.split('-')[0]} {kernel.group(1)}"
                      f"{f'<{args}>' if args else ''}: {usage.strip()}")


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
    """Each launch of one call of ``fn`` apart (``kernel_ms``, once more if
    the profiler recorded nothing: now and then a profiled run records no
    device event)."""
    split = kernel_ms(torch, fn, reps) or kernel_ms(torch, fn, reps)
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


def form_times(torch, label: str, shared, glob) -> dict:
    """One kernel call at one shape in its shared form (``shared()``) and
    its global form (``glob()``): their outputs (a tensor or a tuple of
    them) must be equal bit for bit; each is timed twice in turns (shared,
    global, global, shared; CUDA events, 20 calls a turn), and its own
    kernels' device ms per call (``kernel_ms``: the port's kernels, the
    global form's tables kernel included).  Returns the global form's ms
    and device ms and the shared form's (means of the two turns)."""
    a, b = shared(), glob()
    torch.cuda.synchronize()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{label}: the global form's output is not the shared form's "
             f"bit for bit")
    turns = [time_ms(f, 20) for f in (shared, glob, glob, shared)]
    device = [sum(ms for name, ms in kernel_ms(torch, f, 20).items()
                  if re.match(r"(void )?\(anonymous namespace\)::", name))
              for f in (shared, glob)]
    row = {"ms": (turns[1] + turns[2]) / 2,
           "shared_ms": (turns[0] + turns[3]) / 2,
           "device_ms": device[1], "shared_device_ms": device[0],
           "bit_equal": True}
    print(f"{label}: the global form bit-equal to the shared form; "
          f"{row['ms']:.4f} ms per call against the shared form's "
          f"{row['shared_ms']:.4f} (turns shared, global, global, shared: "
          f"{', '.join(f'{t:.4f}' for t in turns)}); device "
          f"{device[1]:.4f} ms against {device[0]:.4f}")
    return row


def device_breakdown(torch, label: str, fn, top: int = 6):
    """Device time by kernel over one more run of ``fn`` under
    ``torch.profiler``, and the device's idle share in that same run: one
    less the kernels' busy time over the CUDA-event span from before the
    run's first launch to after its last.  The profiler slows the host's
    launches, so this share is an upper bound on the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
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
          f"{span_ms:.3f} ms span, idle share {1 - busy_ms / span_ms:.3f} "
          f"(profiled and summed in {time.perf_counter() - t0:.1f} s)")
    # the top kernels, and every kernel of the port's own below them
    for i, (ms, count, name) in enumerate(rows):
        if i < top or name.startswith("(anonymous namespace)::"):
            print(f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{count:<5d} "
                  f"{name[:90]}")


def adc_cost(torch, label: str, ids, valid, m: int, k: int) -> dict:
    """Bound of one ``pq_adc`` call: each distinct code row among the valid
    slots read once (M bytes), per slot its valid flag and distance, per
    valid slot its id, each query's LUT; one add per valid lookup."""
    nq, c = ids.shape
    n_valid = int(valid.sum())
    rows = int(torch.unique(ids[valid]).numel())
    print(f"{label}: {rows} distinct code rows among {n_valid} valid slots "
          f"of {nq * c}")
    nbytes = rows * m + nq * c * (1 + 4) + n_valid * 4 + nq * m * k * 4
    return dict(zip(("bound_ms", "bound_by"),
                    bound(label, nbytes, n_valid * m)))


#: most indices one embedding_bag call takes (it counts them in int32)
EMBEDDING_BAG_MAX = 2**31 - 1


def adc_library(torch, codes, ids, lut, valid=None):
    """One ``embedding_bag(idx, lut.reshape(-1, 1), mode="sum")`` call over
    every slot, ``idx`` the int32 indices q·M·K + m·K + code built outside
    the timer (no +inf mask): its ms and its (Q, C) output.  Where every
    slot's M indices would pass ``EMBEDDING_BAG_MAX``, the call takes the
    ``valid`` slots only (the slots the kernel scores); the output then
    holds +inf on the others."""
    nq, c = ids.shape
    m, k = lut.shape[1:]
    dev = ids.device
    idx = codes[ids.long()].int()
    idx += torch.arange(m, device=dev, dtype=torch.int32) * k
    idx += (torch.arange(nq, device=dev, dtype=torch.int32)
            * (m * k))[:, None, None]
    some = valid is not None and nq * c * m > EMBEDDING_BAG_MAX
    idx = idx[valid] if some else idx.reshape(nq * c, m)
    weight = lut.reshape(-1, 1)
    call = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
        idx, weight, mode="sum")
    ms, out = time_ms(call, 5), call()
    if not some:
        return ms, out.reshape(nq, c)
    print(f"embedding_bag over the {idx.shape[0]} valid slots only: "
          f"{nq * c * m} indices for every slot pass its int32 count")
    full = torch.full((nq, c), float("inf"), device=dev)
    full[valid] = out[:, 0]
    return ms, full


def launched_plan(mod, fn, attr: str = "last_plan"):
    """``fn()``'s result and the chunk plan that ``mod``'s wrapper used at
    its launches there (its ``last_plan``, or ``attr``: the bounds and
    level-0 wrappers' ``bounds_last_plan`` / ``level0_last_plan``, set by a
    global-form launch from the shared bytes the launch asked for), as a
    dict; None where ``fn`` made no global-form launch of that wrapper."""
    setattr(mod, attr, None)
    out = fn()
    plan = getattr(mod, attr)
    return out, None if plan is None else dataclasses.asdict(plan)


def hold_adc(torch, pq_adc_mod, codes, ids, valid, lut, label: str):
    """``pq_adc`` against its plain version on one input, +inf on exactly
    the invalid slots: the kernel's output and the max error."""
    got = pq_adc_mod.pq_adc(codes, ids, valid, lut)
    want = pq_adc_mod.pq_adc_plain(codes, ids, valid, lut)
    torch.cuda.synchronize()
    ok, err = close(got, want, ADC_ATOL, ADC_RTOL)
    if not ok:
        fail(f"pq_adc {label} disagrees with its plain version (max err "
             f"{err})")
    if not (torch.equal(torch.isinf(got), ~valid)
            and bool((got[~valid] == float("inf")).all())):
        fail(f"pq_adc {label}: +inf is not on exactly the invalid slots")
    del want
    return got, err


def check_adc(torch, pq_adc_mod, codes, ids, valid, lut, label: str):
    """``pq_adc`` against its plain version on one input (``hold_adc``);
    its time, device time per launch, bound, plain time, and its time with
    every slot valid and on an all-zero code store (each lookup
    instruction of a warp then reads one address: no bank conflict).
    Returns the kernel's output and its row."""
    args = (codes, ids, valid, lut)
    got, err = hold_adc(torch, pq_adc_mod, *args, label)
    m, k = lut.shape[1:]
    ms, plan = launched_plan(pq_adc_mod, lambda: time_ms(
        lambda: pq_adc_mod.pq_adc(*args), 20))
    row = dict(max_abs_err=err, ms=ms,
               plain_ms=time_ms(lambda: pq_adc_mod.pq_adc_plain(*args), 3),
               **adc_cost(torch, f"pq_adc {label}", ids, valid, m, k))
    if plan is not None:
        row["plan"] = plan
    every = torch.ones_like(valid)
    every_ms = time_ms(lambda: pq_adc_mod.pq_adc(codes, ids, every, lut), 20)
    zeros = torch.zeros_like(codes)
    zero_ms = time_ms(lambda: pq_adc_mod.pq_adc(zeros, ids, valid, lut), 20)
    print_launches(torch, f"pq_adc {label}",
                   lambda: pq_adc_mod.pq_adc(*args), 20)
    print(f"pq_adc {label}: {row['ms']:.4f} ms with {int(valid.sum())} valid "
          f"slots of {valid.numel()} (bound {row['bound_ms']:.4f} ms), "
          f"{every_ms:.4f} ms with every slot valid, {zero_ms:.4f} ms on an "
          f"all-zero code store (no bank conflicts), max err {err:.3g}"
          + (f", chunk plan {plan}" if plan else ""))
    del every, zeros
    return got, row


# M = 128 rows are longer than the kernel's 96-byte register chunk; M = 6
# is read as bytes; at K = 256, M = 220, 256 and 1024 are past the shared
# LUT (the global form), while M = 1024 at K = 16 still fits it
EDGE_ADC_M, EDGE_ADC_K = (4, 6, 16, 20, 96, 128, 220, 256, 1024), (16, 256)
EDGE_ADC_WIDE = (1024, 256)     # the global form's timed edge shape


def edge_adc(torch, pq_adc_mod, ops, gen) -> tuple[float, dict]:
    """``pq_adc`` against its plain version on random code stores at each
    M of ``EDGE_ADC_M`` and K of ``EDGE_ADC_K``, C = 4133 slots (not a
    multiple of 32 or of the 4096-slot tile); query 0 has no valid slot,
    query 1 only valid ones, the rest ~30%.  The same store is also read
    at a 4-byte and a 1-byte offset (the word and the byte row paths) and
    must give the same bits, and where the shared LUT fits, the global
    form must too.  Returns the max error and the global form's row at
    ``EDGE_ADC_WIDE``."""
    dev = gen.device
    valid = torch.rand((EDGE_Q, EDGE_C), generator=gen, device=dev) < 0.3
    valid[0], valid[1] = False, True
    ids = torch.randint(0, EDGE_N, (EDGE_Q, EDGE_C), generator=gen,
                        device=dev, dtype=torch.int32)
    worst, row = 0.0, None
    for m in EDGE_ADC_M:
        for k in EDGE_ADC_K:
            codes = torch.randint(0, k, (EDGE_N, m), generator=gen,
                                  device=dev, dtype=torch.uint8)
            lut = torch.rand((EDGE_Q, m, k), generator=gen, device=dev)
            got = pq_adc_mod.pq_adc(codes, ids, valid, lut)
            want = pq_adc_mod.pq_adc_plain(codes, ids, valid, lut)
            torch.cuda.synchronize()
            ok, err = close(got, want, ADC_ATOL, ADC_RTOL)
            if not ok:
                fail(f"pq_adc edge M={m} K={k}: max err {err}")
            if not (torch.equal(torch.isinf(got), ~valid)
                    and bool((got[~valid] == float("inf")).all())):
                fail(f"pq_adc edge M={m} K={k}: +inf is not on exactly the "
                     f"invalid slots")
            paths = [pq_adc_mod.row_path(m, codes.data_ptr())]
            buf = torch.empty(EDGE_N * m + 16, dtype=torch.uint8, device=dev)
            for off in (4, 1):
                shifted = buf[off:off + EDGE_N * m].view(EDGE_N, m)
                shifted.copy_(codes)
                paths.append(pq_adc_mod.row_path(m, shifted.data_ptr()))
                if not torch.equal(
                        pq_adc_mod.pq_adc(shifted, ids, valid, lut), got):
                    fail(f"pq_adc edge M={m} K={k}: the {paths[-1]} row "
                         f"path differs from the {paths[0]} path")
            form = ops.adc_form(m, k)
            if form == "shared" and not torch.equal(pq_adc_mod._pq_adc(
                    codes, ids, valid, lut, form="global"), got):
                fail(f"pq_adc edge M={m} K={k}: the global form differs "
                     f"from the shared form")
            worst = max(worst, err)
            print(f"pq_adc edge M={m} K={k}: max err {err:.3g}, row paths "
                  f"{paths} (equal bits), {form} form"
                  + (", the global form bit-equal" if form == "shared"
                     else ""))
            if (m, k) == EDGE_ADC_WIDE:
                ms, plan = launched_plan(pq_adc_mod, lambda: time_ms(
                    lambda: pq_adc_mod.pq_adc(codes, ids, valid, lut), 20))
                row = dict(max_abs_err=err, ms=ms, plan=plan,
                           plain_ms=time_ms(lambda: pq_adc_mod.pq_adc_plain(
                               codes, ids, valid, lut), 3),
                           library_ms=adc_library(torch, codes, ids, lut)[0],
                           **adc_cost(torch, f"pq_adc edge M={m} K={k}", ids,
                                      valid, m, k))
                print(f"pq_adc edge M={m} K={k} (global form): "
                      f"{row['ms']:.4f} ms per call (bound "
                      f"{row['bound_ms']:.4f} ms), plain "
                      f"{row['plain_ms']:.3f} ms, embedding_bag "
                      f"{row['library_ms']:.4f} ms, chunk plan {plan}")
    return worst, row


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


def refine_cost(torch, stores, cand, q, *, delta: bool = False) -> dict:
    """Bound of one level-0 refine call: each distinct valid code row and
    its 16 B of record scalars read once; per valid slot its id; per slot
    its d0, valid flag, est and alive; per query its digit planes,
    parameters and counts.  The operations are what the function needs,
    not what this kernel does: a per-query (G, 243) table of partial dot
    products scores each code byte in one lookup and add, a 243-entry table
    gives its nonzero count in another add, so 2·G adds per valid slot,
    plus ~20 per slot for its estimate, bounds and pruning test.  With
    ``delta`` the per-slot delta flags are read too."""
    nq, c = cand.ids.shape
    g = stores.packed[0].shape[1]
    n_valid = int(cand.valid.sum())
    rows = int(torch.unique(cand.ids[cand.valid]).numel())
    nbytes = (rows * (g + 16) + n_valid * 4 + nq * c * (4 + 1 + 4 + 1)
              + nq * (5 * g + 8 + 2) * 4 + (nq * c if delta else 0))
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


def check_level0(torch, tr, ops, model, q, packed, cols, counted, edge_err,
                 attrs):
    """The ops path's level-0 outputs (``counted``: batch, then single
    query) against the plain version on the same gathered rows ``packed``
    (Q, C, G) and scalars ``cols``; returns the kernels' rows, with their
    device ms per call (``kernel_ms``), the edge phase's error folded into
    max_abs_err (``edge_err``: batch, single) and the kernel's runtime
    attributes ``attrs``.  Kernel and plain version are timed alike, on the
    inputs already assembled (the ops entry points' stacking of the scalars
    is not part of either)."""
    nq, c, g = packed.shape
    print(f"level-0 kernels: {packed.numel() / 1e6:.1f} MB of gathered "
          f"codes ({nq} x {c} x {g})")
    planes, params, scalars = ops.level0_inputs(q, g, *cols, model.w,
                                                model.bias)
    batch = (packed, planes, scalars, params)
    single = tuple(t[:1] for t in batch)
    rows = {}
    for name, got, args, call, e_err in (
            ("ternary_refine_batch", counted[0], batch,
             lambda: tr.ternary_refine_batch(*batch), edge_err[0]),
            ("ternary_refine", counted[1], single,
             lambda: tr.ternary_refine(packed[0], planes[0], scalars[0],
                                       params[:1]), edge_err[1])):
        want = tr.refine_level0_plain(*args).reshape(got.shape)
        torch.cuda.synchronize()
        ok, err = close(got, want, LEVEL0_TOL, LEVEL0_TOL)
        if not ok:
            fail(f"{name} disagrees with its plain version (max err {err})")
        print(f"{name}: max err {err:.3g} over {got.shape[-2]} x "
              f"{got.numel() // got.shape[-2] // 3} slots")
        rows[name] = dict(
            max_abs_err=max(err, e_err), ms=time_ms(call, 20),
            plain_ms=time_ms(lambda: tr.refine_level0_plain(*args), 3),
            library_ms=None,
            **level0_cost(name, args[0].shape[0], c, g), **attrs)
        rows[name]["device_ms"] = next(
            (ms for kernel, ms in kernel_ms(torch, call, 20).items()
             if "level0_kernel" in kernel), None)
        device = "not measured" if rows[name]["device_ms"] is None \
            else f"{rows[name]['device_ms']:.4f} ms"
        print(f"{name}: {rows[name]['ms']:.4f} ms per call, device {device} "
              f"(bound {rows[name]['bound_ms']:.4f} ms), plain "
              f"{rows[name]['plain_ms']:.3f} ms")
    return rows


def edge_level0(torch, tr, ops, gen) -> tuple[float, float, dict]:
    """Both level-0 entry points against ``refine_level0_plain`` at each G
    of ``EDGE_L0_G``, at Q = ``EDGE_Q`` with C = ``EDGE_C`` slots (not a
    multiple of a warp's 32-slot chunk) and at Q = 1, on code bytes drawn
    from 0..255 (every 7th from 243..255, which decode as y - 243): once on
    fresh tensors and once on views whose code rows start at slot 1 of a
    buffer (a base that is not 16-byte aligned) and whose scalars start one
    float in; where the shared form fits, the global form must give the
    same bits.  Returns the batch and the single-query entry point's max
    error and their global form's rows at G = ``EDGE_WIDE_G``."""
    dev = gen.device
    errs, rows = [0.0, 0.0], {}
    for g in EDGE_L0_G:
        form = ops.level0_form(g)
        for nq in (EDGE_Q, 1):
            c = EDGE_C
            packed = torch.randint(0, 256, (nq, c, g), generator=gen,
                                   device=dev, dtype=torch.uint8)
            packed.view(-1)[::7] = torch.randint(
                243, 256, packed.view(-1)[::7].shape, generator=gen,
                device=dev, dtype=torch.uint8)
            q = torch.randn((nq, 5 * g - (g > 1)), generator=gen, device=dev)
            cols = [torch.rand((nq, c), generator=gen, device=dev) * 4 + 0.1
                    for _ in range(5)]
            cols[2] -= 2.1                               # <x_c, d> of any sign
            cols[4] = cols[4] / 4.2                      # rho in [0, 1)
            w = torch.tensor([1.0, 1.1, 0.95, 2.1], device=dev)
            planes, params, scalars = ops.level0_inputs(
                q, g, *cols, w, torch.tensor(0.3, device=dev))
            # the same values at a misaligned base: code rows from slot 1 of
            # a buffer (byte offset g), scalars one float in
            p_buf = torch.empty(nq * c * g + g, dtype=torch.uint8, device=dev)
            s_buf = torch.empty(nq * c * 5 + 1, device=dev)
            p_off = p_buf[g:].view(nq, c, g)
            s_off = s_buf[1:].view(nq, c, 5)
            p_off.copy_(packed)
            s_off.copy_(scalars)
            want = tr.refine_level0_plain(packed, planes, scalars, params)
            for label, pk, sc in (("aligned", packed, scalars),
                                  ("misaligned", p_off, s_off)):
                got = (tr.ternary_refine_batch(pk, planes, sc, params),
                       tr.ternary_refine(pk[0], planes[0], sc[0], params[:1]))
                torch.cuda.synchronize()
                for i, (name, out, ref) in enumerate((
                        ("ternary_refine_batch", got[0], want),
                        ("ternary_refine", got[1], want[0]))):
                    ok, err = close(out, ref, LEVEL0_TOL, LEVEL0_TOL)
                    if not ok:
                        fail(f"level-0 edge {name} G={g} Q={nq} C={c} "
                             f"{label} (code base % 16 = "
                             f"{pk.data_ptr() % 16}): max err {err}")
                    errs[i] = max(errs[i], err)
                if form == "shared" and not (
                        torch.equal(tr._level0_batch(pk, planes, sc, params,
                                                     form="global"), got[0])
                        and torch.equal(tr._level0_single(
                            pk[0], planes[0], sc[0], params[:1],
                            form="global"), got[1])):
                    fail(f"level-0 edge G={g} Q={nq} {label}: the global "
                         f"form differs from the shared form")
            if g == EDGE_WIDE_G:
                name = "ternary_refine_batch" if nq > 1 else "ternary_refine"
                call = (lambda: tr.ternary_refine_batch(
                    packed, planes, scalars, params)) if nq > 1 else (
                    lambda: tr.ternary_refine(packed[0], planes[0],
                                              scalars[0], params[:1]))
                ms, plan = launched_plan(
                    tr, lambda: time_ms(call, 20), "level0_last_plan")
                rows[name] = dict(
                    max_abs_err=errs[nq == 1], ms=ms, plan=plan,
                    plain_ms=time_ms(lambda: tr.refine_level0_plain(
                        packed, planes, scalars, params), 3),
                    library_ms=None,
                    **level0_cost(f"{name} edge G={g}", nq, c, g))
                print(f"{name} edge G={g} Q={nq} (global form): "
                      f"{rows[name]['ms']:.4f} ms per call (bound "
                      f"{rows[name]['bound_ms']:.4f} ms), plain "
                      f"{rows[name]['plain_ms']:.3f} ms, chunk plan {plan}")
        print(f"level-0 edge G={g}: Q={EDGE_Q} and Q=1, C={EDGE_C}, bytes "
              f"0..255, aligned and misaligned bases: max err "
              f"{max(errs):.3g}; {form} form"
              + (", the global form bit-equal" if form == "shared" else ""))
    return errs[0], errs[1], rows


def level0_attributes(build, g: int, form: str = "shared") -> dict:
    """The level-0 kernel's registers, stack, warps per block, dynamic
    shared memory and resident blocks per SM at width ``g`` in ``form``
    (the global form by ``ops.level0_plan``), as the CUDA runtime reports
    them."""
    import ctypes
    from repro_torch.kernels import ops
    fn = build.entry("ternary_refine", "fatrq_level0_attributes",
                     [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 5)()
    plan = ops.level0_plan(g) if form == "global" else None
    build.check("ternary_refine",
                fn(g, int(plan is not None), plan.passes if plan else 0,
                   plan.warps if plan else 0, out),
                "fatrq_level0_attributes")
    attrs = dict(zip(("registers", "stack_bytes", "warps_per_block",
                      "smem_bytes", "blocks_per_sm"), out))
    print(f"level0_kernel ({form} form, runtime, G={g}): "
          f"{attrs['registers']} registers, "
          f"{attrs['stack_bytes']} B stack, {attrs['warps_per_block']} warps "
          f"per block, {attrs['smem_bytes']} B dynamic shared memory, "
          f"{attrs['blocks_per_sm']} block(s) per SM")
    return attrs


def sass_profile(lib, function: str) -> None:
    """Instruction counts of one kernel in the built library ``lib``
    (``cuobjdump -sass``): its total, and the straight-line block with the
    most shared-memory loads (in the level-0 kernel the unrolled scoring of
    a lane's 20 code bytes of a row), its instructions and loads, and both
    per byte."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    body = None
    for part in text.split("Function : ")[1:]:
        if function in part.split("\n", 1)[0]:
            body = part
    if body is None:
        print(f"sass {function}: not found")
        return
    insts, blocks, cur = [], [], []
    for line in body.splitlines():
        if line.lstrip().startswith(".L"):           # a label: a new block
            blocks.append(cur)
            cur = []
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if not m:
            continue
        op = m.group(1)
        insts.append(op)
        cur.append(op)
        if op.split(".")[0] in ("BRA", "EXIT", "RET", "BSYNC", "WARPSYNC",
                                "CALL", "BRX", "JMP"):
            blocks.append(cur)
            cur = []
    blocks.append(cur)
    big = max(blocks, key=lambda b: sum(op.startswith("LDS") for op in b))
    lds = sum(op.startswith("LDS") for op in big)
    print(f"sass {function}: {len(insts)} instructions; scoring block "
          f"{len(big)} instructions, {lds} LDS ({len(big) / 20:.1f} "
          f"instructions and {lds / 20:.2f} LDS per code byte of a lane's "
          f"20)")


# packed widths of the edge-shape phase; G = 410 (D = 2048, the RAG
# index) has rows of 3 passes; 1437 is the widest the shared tables hold,
# 1438 and 1639 (D = 8192) run the global form
EDGE_G = (1, 13, 20, 154, 410, 1437, 1438, 1639)
# and G = 319, 503 (the widest shared level-0 form) and 504 at level 0
EDGE_L0_G = EDGE_G + (319, 503, 504)
EDGE_WIDE_G = 1639             # the global forms' timed edge width
EDGE_Q, EDGE_C, EDGE_N = 5, 4133, 20_000
GRAPH_C = 64                   # the graph front's beam: its candidate slots


# C = 446,000 is near the prune's shared form's 446,464-slot capacity
# (ops.prune_smem_bytes), 446,465 and 1,048,576 run its global form; 1, 31,
# 4133 and 446,465 take its 1-byte path (C % 16 != 0), the rest 16-byte
# vectors; 64 is the graph beam
EDGE_PRUNE_C, EDGE_PRUNE_K = (1, 31, 48, GRAPH_C, 4133, 46_880, 446_000,
                              446_465, 1_048_576), (1, 10, 64)
EDGE_PRUNE_WIDE = 1_048_576    # the global form's timed edge shape
EDGE_PRUNE_Q = 6               # its queries (the first six of the edge's)


def edge_prune(torch, tr, ops, gen) -> dict:
    """The prune alone against ``prune_plain`` at each C of ``EDGE_PRUNE_C``
    and k of ``EDGE_PRUNE_K``, over three levels of random bounds with the
    mask written over the alive buffer it reads from level 1 on, as the
    fused kernel runs them.  Query 0 has every slot alive, query 1 none,
    query 2 hi and lo drawn from five values (ties at tau, lo on it),
    query 3 k − 1 alive slots, query 6 every slot alive with hi falling
    along the slots (every key passes the global form's filter), query 7
    one hi for every slot.  Masks and counts must be equal, tau equal as
    floats; where the shared form fits, the global form's chain must give
    the same masks, counts and tau.  Returns the global form's row at
    C = ``EDGE_PRUNE_WIDE``, k = 10 on the first ``EDGE_PRUNE_Q`` queries,
    with its time where every query's hi falls along the slots
    (``falling``)."""
    dev, nq, nl = gen.device, 8, 3
    row = None
    for c in EDGE_PRUNE_C:
        form = ops.prune_form(c)
        lo, hi = [], []
        for _ in range(nl):
            h = torch.randn((nq, c), generator=gen, device=dev)
            h[2] = torch.randint(0, 5, (c,), generator=gen, device=dev) / 4
            h[6] = h[6].sort(descending=True).values
            h[7] = 0.25
            step = torch.rand((nq, c), generator=gen, device=dev)
            step[2] = torch.randint(0, 3, (c,), generator=gen, device=dev) / 4
            lo.append(h - step)
            hi.append(h)
        for k in EDGE_PRUNE_K:
            alive = torch.rand((nq, c), generator=gen, device=dev) < 0.5
            alive[0], alive[1], alive[3], alive[6] = True, False, False, True
            alive[3, torch.randperm(c, generator=gen, device=dev)[:k - 1]] \
                = True
            is_delta = torch.rand((nq, c), generator=gen, device=dev) < 0.4
            for delta in (None, is_delta):
                counts = torch.full((nq, 2 * nl), -1, dtype=torch.int32,
                                    device=dev)
                buf = torch.empty_like(alive)
                g_counts, g_buf = counts.clone(), torch.empty_like(alive)
                want, cnts = alive, []
                for lv in range(nl):
                    tau = tr.ternary_refine_prune(
                        lo[lv], hi[lv], alive if lv == 0 else buf, delta,
                        counts, buf, k=k, level=lv)
                    if form == "shared":
                        g_tau = tr._prune(lo[lv], hi[lv],
                                          alive if lv == 0 else g_buf, delta,
                                          g_counts, g_buf, k=k, level=lv,
                                          form="global")
                        if not (torch.equal(g_buf, buf)
                                and torch.equal(g_tau, tau)):
                            fail(f"prune edge C={c} k={k} level {lv}: the "
                                 f"global form differs from the shared form")
                    want, cnt, dcnt, want_tau = tr.prune_plain(
                        lo[lv], hi[lv], want, delta, k=k)
                    cnts.append((cnt, dcnt))
                    torch.cuda.synchronize()
                    if not (torch.equal(buf, want)
                            and torch.equal(tau, want_tau)):
                        fail(f"prune edge C={c} k={k} level {lv} delta="
                             f"{delta is not None}: mask or tau differs from "
                             f"prune_plain")
                want_counts = torch.stack([x[0] for x in cnts]
                                          + [x[1] for x in cnts], dim=1)
                if not torch.equal(counts, want_counts) or (
                        form == "shared"
                        and not torch.equal(g_counts, counts)):
                    fail(f"prune edge C={c} k={k} delta={delta is not None}: "
                         f"counts {counts.tolist()} vs {want_counts.tolist()}"
                         f" (global form {g_counts.tolist()})")
            if c == EDGE_PRUNE_WIDE and k == 10:
                q = EDGE_PRUNE_Q
                row = prune_row(torch, tr, lo[0][:q], hi[0][:q], alive[:q],
                                k, f"prune edge C={c} Q={q}")
                falling = hi[0][6:7].expand(q, c).contiguous()
                row["falling"] = prune_row(
                    torch, tr, falling - 1, falling,
                    torch.ones_like(alive[:q]), k,
                    f"prune edge C={c} Q={q}, hi falling along the slots")
        print(f"prune edge C={c}: k {EDGE_PRUNE_K}, {nl} levels in place, "
              f"delta rows and none: masks, counts and tau equal to "
              f"prune_plain; {form} form"
              + (", the global form equal" if form == "shared" else ""))
    return row


def prune_row(torch, tr, lo, hi, alive, k: int, label: str) -> dict:
    """The prune alone's ms (CUDA events), device ms (the profiler's
    per-call reading), bound, plain ms and one ``torch.topk`` of the
    masked upper bounds (τ only) on one input, as ``check_prune`` times
    them; the prune's masks, counts and τ must be ``prune_plain``'s."""
    nq, c = hi.shape
    out = torch.empty_like(alive)
    counts = torch.zeros((nq, 2), dtype=torch.int32, device=alive.device)
    call = lambda: tr.ternary_refine_prune(  # noqa: E731
        lo, hi, alive, None, counts, out, k=k)
    tau = call()
    want, cnt, dcnt, want_tau = tr.prune_plain(lo, hi, alive, None, k=k)
    torch.cuda.synchronize()
    if not (torch.equal(out, want) and torch.equal(tau, want_tau)
            and torch.equal(counts, torch.stack([cnt, dcnt], 1))):
        fail(f"{label}: the prune differs from prune_plain")
    masked = torch.where(alive, hi, float("inf"))
    n_alive = int(alive.sum())
    row = dict(max_abs_err=0.0, ms=time_ms(call, 20),
               plain_ms=time_ms(lambda: tr.prune_plain(lo, hi, alive, None,
                                                       k=k), 3),
               library_ms=time_ms(lambda: torch.topk(masked, k,
                                                     largest=False), 20),
               **dict(zip(("bound_ms", "bound_by"), bound(
                   label, nq * c * 2 + n_alive * 8 + nq * 2 * 4,
                   2 * n_alive))))
    row["device_ms"] = next((ms for name, ms in kernel_ms(
        torch, call, 20).items() if "prune_kernel" in name), None)
    device = "not measured" if row["device_ms"] is None \
        else f"{row['device_ms']:.4f} ms"
    print(f"{label}: {row['ms']:.4f} ms per call, device {device} (bound "
          f"{row['bound_ms']:.4f} ms), plain {row['plain_ms']:.3f} ms, "
          f"torch.topk {row['library_ms']:.4f} ms; equal to prune_plain")
    return row


def prune_attributes(build, form: str = "shared", c: int = 46_880) -> str:
    """The prune kernel's registers, stack, static shared memory and
    cluster width in ``form`` as the CUDA runtime reports them, with its
    dynamic shared memory at C = ``c`` and the clusters of 8 the card
    holds at once with it.  The global form's dynamic shared memory must
    be ``ops.PRUNE_STREAM_SMEM``, the size the port states for it."""
    import ctypes
    from repro_torch.kernels import ops
    fn = build.entry("ternary_refine", "fatrq_prune_attributes",
                     [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 6)()
    build.check("ternary_refine", fn(int(form == "global"), c, out),
                "fatrq_prune_attributes")
    if form == "global" and out[4] != ops.PRUNE_STREAM_SMEM:
        fail(f"prune_kernel's global form takes {out[4]} B of dynamic "
             f"shared memory, not ops.PRUNE_STREAM_SMEM = "
             f"{ops.PRUNE_STREAM_SMEM}")
    return (f"prune_kernel ({form} form, runtime): {out[0]} registers, "
            f"{out[1]} B stack, {out[2]} B static shared memory, cluster "
            f"width {out[3]}; at C = {c:,} {out[4]} B dynamic shared "
            f"memory, {out[5]} clusters resident ({out[5] * 8} blocks)")


def check_prune(torch, tr, lo, hi, alive, fused, *, k,
                label: str = "the fatrq shape") -> dict:
    """The prune alone at ``label``'s shape: exactly ``prune_plain``'s mask,
    counts and tau, and the fused call's survivors and counts ``fused``
    (same level-0 bounds); its ms, device ms per launch, bound, plain ms
    and one ``torch.topk`` of the masked upper bounds (built outside the
    timer) as the library time of the select alone."""
    nq, c = hi.shape
    out = torch.empty_like(alive)
    counts = torch.zeros((nq, 2), dtype=torch.int32, device=alive.device)
    call = lambda: tr.ternary_refine_prune(  # noqa: E731
        lo, hi, alive, None, counts, out, k=k)
    tau = call()
    want, cnt, dcnt, want_tau = tr.prune_plain(lo, hi, alive, None, k=k)
    torch.cuda.synchronize()
    if not (torch.equal(out, want) and torch.equal(tau, want_tau)
            and torch.equal(counts, torch.stack([cnt, dcnt], 1))):
        fail(f"prune at {label} differs from prune_plain")
    if not (torch.equal(out, fused[1])
            and torch.equal(counts[:, 0], fused[2][:, 0])):
        fail(f"prune at {label}: not the fused call's survivors")
    masked = torch.where(alive, hi, float("inf"))
    select = lambda: torch.topk(masked, k, largest=False)  # noqa: E731
    if not torch.equal(select().values[:, -1], tau):
        fail("torch.topk's kth value is not the prune's tau")
    n_alive = int(alive.sum())
    print(f"prune bound: 1 B of alive_in and of alive_out per slot, 4 B of "
          f"hi and of lo per alive slot ({n_alive} of {nq * c}), the counts")
    row = dict(max_abs_err=0.0, ms=time_ms(call, 20),
               plain_ms=time_ms(lambda: tr.prune_plain(lo, hi, alive, None,
                                                       k=k), 3),
               library_ms=time_ms(select, 20),
               **dict(zip(("bound_ms", "bound_by"), bound(
                   "prune", nq * c * 2 + n_alive * 8 + nq * 2 * 4,
                   2 * n_alive))))
    split = kernel_ms(torch, call, 20)
    row["device_ms"] = next((ms for name, ms in split.items()
                             if "prune_kernel" in name), None)
    device = "not measured" if row["device_ms"] is None \
        else f"{row['device_ms']:.4f} ms"
    print(f"prune at {label}: {row['ms']:.4f} ms per call, device "
          f"{device} (bound {row['bound_ms']:.4f} ms), plain "
          f"{row['plain_ms']:.3f} ms, torch.topk select (tau only) "
          f"{row['library_ms']:.4f} ms; masks, counts and tau equal to "
          f"prune_plain and the fused call's")
    return row


def edge_shapes(torch, tr, ops, alive_chain, trq_mod, cal, Candidates,
                gen) -> tuple[float, float, dict]:
    """The fused and bounds kernels against their plain versions, and the
    bounds est against the fused est, on random code stores: each G of
    ``EDGE_G`` (rows at every byte alignment G allows) and L = 1, 2, 3,
    both bounds, at C = 4133 (not a multiple of 32 or of the 1024-slot
    tile) and at C = 64, the graph beam, where every odd slot repeats the
    id and d0 of the slot before it (a beam's repeated ids: exact ties in
    est, lo and hi).  Query 0 has no valid slot, query 1 only valid ones,
    the rest ~30%.  Invalid slots carry d0 = +inf (as the front gives), or
    a finite d0 at L = 2 so that the kernels' invalid-slot values are
    compared too.  Where the shared tables fit, each kernel's global form
    (its prune's too) must give the shared form's bits, with one launch of
    the refine tables for all L levels of a call.  Returns the fused
    and the bounds kernel's max error and their global form's rows at
    G = ``EDGE_WIDE_G``, C = 4133, L = 1, Cauchy."""
    dev = gen.device

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    model = cal.CalibrationModel(
        w=torch.tensor([1.0, 1.1, 0.95, 2.1], device=dev),
        bias=torch.tensor(0.3, device=dev),
        resid_std=torch.tensor(0.05, device=dev))
    errs, ties, rows = [0.0, 0.0], 0, {}
    for c in (EDGE_C, GRAPH_C):
        valid = rand(EDGE_Q, c) < 0.3
        valid[0], valid[1] = False, True
        ids = torch.randint(0, EDGE_N, (EDGE_Q, c), generator=gen,
                            device=dev, dtype=torch.int32)
        if c == GRAPH_C:
            ids[:, 1::2] = ids[:, ::2]
        is_delta = rand(EDGE_Q, c) < 0.3
        for g in EDGE_G:
            q = torch.randn((EDGE_Q, 5 * g - (g > 1)), generator=gen,
                            device=dev)
            for nl in (1, 2, 3):
                levels = tuple(trq_mod.TRQLevel(
                    packed=torch.randint(0, 243, (EDGE_N, g), generator=gen,
                                         device=dev, dtype=torch.uint8),
                    proj=rand(EDGE_N) - 0.5, norm=rand(EDGE_N),
                    rho=rand(EDGE_N))
                    for _ in range(nl))
                stores = tr.RefineStores(
                    packed=tuple(lv.packed for lv in levels),
                    records=torch.stack([rand(EDGE_N) * 2,
                                         rand(EDGE_N) - 0.5, rand(EDGE_N),
                                         rand(EDGE_N)], 1).contiguous(),
                    levels=tuple(ops.level_table(lv) for lv in levels),
                    dim=q.shape[1])
                d0 = rand(EDGE_Q, c) * 4 + 0.1
                if c == GRAPH_C:
                    d0[:, 1::2] = d0[:, ::2]
                d0 = torch.where(valid | (nl == 2), d0, float("inf"))
                cand = Candidates(ids=ids, valid=valid, d0=d0, counters={})
                for bnd in ("cauchy", "quantile"):
                    label = f"edge C={c} G={g} {bnd} L={nl}"
                    err, n = check_refine(torch, tr, ops, stores, model, cand,
                                          q, is_delta, k=10, bound_name=bnd,
                                          z=3.0, label=label)
                    b_err, b_n = check_bounds(torch, tr, ops, alive_chain,
                                              stores, model, cand, q, k=10,
                                              bound_name=bnd, z=3.0,
                                              label=label)
                    errs = [max(errs[0], err), max(errs[1], b_err)]
                    ties += n + b_n
                    args = (stores, q, ids, cand.d0, valid)
                    kw = dict(bound=bnd, z=3.0)
                    if ops.refine_form(g) == "shared":
                        for name, shared, glob, calls in (
                                ("ternary_refine_fused",
                                 lambda: tr.ternary_refine_fused(
                                     *args, is_delta, model, k=10, **kw),
                                 lambda: tr._fused(
                                     *args, is_delta, model, k=10,
                                     form="global", **kw),
                                 lambda: tr.global_launches),
                                ("ternary_refine_fused_bounds",
                                 lambda: tr.ternary_refine_fused_bounds(
                                     *args, model, **kw),
                                 lambda: tr._bounds(*args, model,
                                                    form="global", **kw),
                                 lambda: tr.bounds_global_launches * nl)):
                            before = (tr.tables_launches, calls())
                            pair = (shared(), glob())
                            built = (tr.tables_launches - before[0],
                                     calls() - before[1])
                            if not all(torch.equal(a, b)
                                       for a, b in zip(*pair)):
                                fail(f"{name} {label}: the global form "
                                     f"differs from the shared form")
                            if built != (1, nl):
                                fail(f"{name} {label}: {built[0]} refine "
                                     f"table launches for {built[1]} "
                                     f"global-form levels (1 and {nl} "
                                     f"expected)")
                    if (g, c, nl, bnd) == (EDGE_WIDE_G, EDGE_C, 1, "cauchy"):
                        rows = edge_refine_rows(torch, tr, ops, stores, model,
                                                cand, q, label, (err, b_err))
            print(f"edge G={g} C={c}: {ops.refine_form(g)} form"
                  + (", the global forms bit-equal (est, alive, counts; "
                     "est, lo, hi), their tables built once a call for "
                     "every level" if ops.refine_form(g) == "shared"
                     else ""))
    print(f"edge-shape phase: {2 * len(EDGE_G) * 6} configurations, max err "
          f"{max(errs):.3g}, alive mismatches at near-ties {ties}")
    return errs[0], errs[1], rows


def edge_refine_rows(torch, tr, ops, stores, model, cand, q, label,
                     errs) -> dict:
    """The fused and bounds kernels' ms, bound and plain ms at one edge
    shape (their global forms at G = ``EDGE_WIDE_G``)."""
    g = stores.packed[0].shape[1]
    planes = ops.make_query_planes(q, g)
    params = ops.query_params(q, model.w, model.bias, model.resid_std, 3.0)
    args = (stores, q, cand.ids, cand.d0, cand.valid)
    ms, plan = launched_plan(tr, lambda: time_ms(
        lambda: tr.ternary_refine_fused(*args, None, model, k=10,
                                        bound="cauchy", z=3.0), 20))
    b_ms, b_plan = launched_plan(tr, lambda: time_ms(
        lambda: tr.ternary_refine_fused_bounds(*args, model, bound="cauchy",
                                               z=3.0), 20),
        "bounds_last_plan")
    rows = {
        "ternary_refine_fused": dict(
            max_abs_err=errs[0], ms=ms, plan=plan,
            plain_ms=time_ms(lambda: tr.refine_plain(
                stores, planes, params, *args[2:], None, k=10,
                bound="cauchy"), 3),
            library_ms=None, **refine_cost(torch, stores, cand, q)),
        "ternary_refine_fused_bounds": dict(
            max_abs_err=errs[1], ms=b_ms, plan=b_plan,
            plain_ms=time_ms(lambda: tr.refine_bounds_plain(
                stores, planes, params, *args[2:], bound="cauchy"), 3),
            library_ms=None, **bounds_cost(torch, stores, cand, q))}
    for name, row in rows.items():
        print(f"{name} {label} ({ops.refine_form(g)} form): "
              f"{row['ms']:.4f} ms per call (bound {row['bound_ms']:.4f} ms),"
              f" plain {row['plain_ms']:.3f} ms"
              + (f", chunk plan {row['plan']}" if row.get("plan") else ""))
    return rows


def graph_kernels(torch, tr, ops, alive_chain, pq_adc_mod, Candidates,
                  gcand, gsh, gsh_gid, q64, lut64, index, all_stores, model,
                  cfg, gen) -> tuple[dict, dict, dict]:
    """The kernel phase at the graph front's shapes: ``gcand``, the final
    64-slot beams of the 64 queries ``q64``, and ``gsh``, graph shard 0's
    candidates over the same beams (its owned slots valid, shard-local
    ids; ``gsh_gid`` maps them to global rows).  Shard 0's beams must be
    the unsharded beams and its d0 the unsharded d0, bit for bit, on the
    slots it owns.  ``pq_adc``, the fused kernel (``all_stores``: one- and
    two-level stores, both bounds, delta rows) and the prune alone on the
    beams, the bounds kernel on shard 0's slots, each against its plain
    version; returns the rows of ``pq_adc``, the fused kernel (its prune
    under ``"prune"``) and the bounds kernel at these shapes."""
    valid = gcand.valid
    per_q = [int(r.unique().numel()) for r in gcand.ids]
    print(f"graph kernel shapes: Q={gcand.ids.shape[0]} C="
          f"{gcand.ids.shape[1]} (the beam), {sum(per_q)} distinct ids of "
          f"{gcand.ids.numel()} slots ({gcand.ids.numel() - sum(per_q)} "
          f"repeats); shard 0 owns {int(gsh.valid.sum())} slots")
    d0, adc = check_adc(torch, pq_adc_mod, index.pq_codes, gcand.ids, valid,
                        lut64, "graph beam")
    lib_ms, lib_d = adc_library(torch, index.pq_codes, gcand.ids, lut64)
    ok, lib_err = close(lib_d, d0, ADC_ATOL, ADC_RTOL)
    if not ok:
        fail(f"embedding_bag disagrees with pq_adc on the graph beam "
             f"({lib_err})")
    adc["library_ms"] = lib_ms
    own = gsh.valid
    if not torch.equal(gsh_gid[own], gcand.ids[own].long()):
        fail("graph shard 0's beams differ from the unsharded beams")
    if not torch.equal(gsh.d0[own], d0[own]):
        fail("pq_adc: graph shard 0's d0 is not bit-identical to the "
             "unsharded beam's d0")
    print("graph shard 0: beams and d0 bit-identical to the unsharded ones "
          "on the slots it owns")

    delta = torch.rand(gcand.ids.shape, generator=gen,
                       device=gen.device) < 0.3
    err, ties = 0.0, 0
    for stores, bnd, is_delta in ((all_stores[0], "cauchy", None),
                                  (all_stores[0], "quantile", None),
                                  (all_stores[1], "cauchy", delta),
                                  (all_stores[1], "quantile", delta)):
        e, n = check_refine(torch, tr, ops, stores, model, gcand, q64,
                            is_delta, k=cfg.final_k, bound_name=bnd, z=cfg.z,
                            label=f"graph beam {bnd} "
                                  f"L={stores.num_levels}")
        err, ties = max(err, e), ties + n
    stores1 = all_stores[0]
    args = (stores1, q64, gcand.ids, gcand.d0, valid, None, model)
    kw = dict(k=cfg.final_k, bound="cauchy", z=cfg.z)
    planes = ops.make_query_planes(q64, stores1.packed[0].shape[1])
    params = ops.query_params(q64, model.w, model.bias, model.resid_std,
                              cfg.z)
    refine = dict(
        max_abs_err=err,
        ms=time_ms(lambda: tr.ternary_refine_fused(*args, **kw), 20),
        plain_ms=time_ms(lambda: tr.refine_plain(
            stores1, planes, params, gcand.ids, gcand.d0, valid, None,
            k=cfg.final_k, bound="cauchy"), 3),
        library_ms=None, **refine_cost(torch, stores1, gcand, q64))
    split = kernel_ms(torch, lambda: tr.ternary_refine_fused(*args, **kw),
                      20)
    for part in ("score_kernel", "prune_kernel"):
        refine[f"{part}_device_ms"] = next(
            (ms for name, ms in split.items() if part in name), None)
    print(f"ternary_refine_fused graph beam: {refine['ms']:.4f} ms per call "
          f"(bound {refine['bound_ms']:.4f} ms), device score "
          f"{refine['score_kernel_device_ms']} + prune "
          f"{refine['prune_kernel_device_ms']} ms, plain "
          f"{refine['plain_ms']:.3f} ms, alive mismatches at near-ties "
          f"{ties}")
    _, lo, hi = tr.ternary_refine_fused_bounds(*args[:5], model,
                                               bound="cauchy", z=cfg.z)
    refine["prune"] = check_prune(
        torch, tr, lo[:, 0].contiguous(), hi[:, 0].contiguous(), valid,
        tr.ternary_refine_fused(*args, **kw), k=cfg.final_k,
        label="the graph beam")

    sh_cand = Candidates(ids=gsh_gid.int().contiguous(), valid=own,
                         d0=gsh.d0, counters={})
    b_err = 0.0
    for stores, bnd in ((all_stores[0], "cauchy"),
                        (all_stores[0], "quantile"),
                        (all_stores[1], "cauchy"),
                        (all_stores[1], "quantile")):
        e, _ = check_bounds(torch, tr, ops, alive_chain, stores, model,
                            sh_cand, q64, k=cfg.final_k, bound_name=bnd,
                            z=cfg.z, label=f"graph shard 0 {bnd} "
                                           f"L={stores.num_levels}")
        b_err = max(b_err, e)
    b_args = (stores1, q64, sh_cand.ids, sh_cand.d0, own)
    bounds = dict(
        max_abs_err=b_err,
        ms=time_ms(lambda: tr.ternary_refine_fused_bounds(
            *b_args, model, bound="cauchy", z=cfg.z), 20),
        plain_ms=time_ms(lambda: tr.refine_bounds_plain(
            stores1, planes, params, *b_args[2:], bound="cauchy"), 3),
        library_ms=None, **bounds_cost(torch, stores1, sh_cand, q64))
    bounds["device_ms"] = next(
        (ms for name, ms in kernel_ms(torch, lambda: (
            tr.ternary_refine_fused_bounds(*b_args, model, bound="cauchy",
                                           z=cfg.z)), 20).items()
         if "bounds_kernel" in name), None)
    print(f"ternary_refine_fused_bounds graph shard 0: {bounds['ms']:.4f} ms "
          f"per call, device {bounds['device_ms']} ms (bound "
          f"{bounds['bound_ms']:.4f} ms), plain {bounds['plain_ms']:.3f} ms")
    return adc, refine, bounds


def check_repeatable(torch, one, two) -> None:
    """Two builds from one seed must give bit-equal index arrays."""
    arrays = {"centroids": lambda i: i.ivf.centroids,
              "codebooks": lambda i: i.codebook.codebooks,
              "pq_codes": lambda i: i.pq_codes,
              "lists": lambda i: i.ivf.lists,
              "list_len": lambda i: i.ivf.list_len,
              **{f"trq level {lv} codes": lambda i, lv=lv: i.trq.levels[lv]
                 .packed for lv in range(one.trq.num_levels)}}
    for name, get in arrays.items():
        if not torch.equal(get(one), get(two)):
            fail(f"two builds from one seed differ in {name}")
    print(f"index build repeatable: two builds from one seed give bit-equal "
          f"{', '.join(arrays)}")


# the streaming phase: rounds of churn, rows inserted and deleted per round
STREAM_ROUNDS, STREAM_BATCH = 1, 20_000
PEAK_GB = 70.0                 # device memory the whole run may peak at


class Timers:
    """Seconds spent inside functions of the port, by label: each patched
    function is bracketed by synchronizes, so its time covers the device's
    work too.  A nested function's time is also its caller's."""

    def __init__(self, torch):
        self.torch, self.s = torch, {}

    def patch(self, module, name: str, label: str) -> None:
        fn = getattr(module, name)

        def timed(*a, **kw):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.torch.cuda.synchronize()
                self.s[label] = self.s.get(label, 0.0) + \
                    time.perf_counter() - t
        setattr(module, name, timed)

    def take(self) -> str:
        out, self.s = self.s, {}
        return ", ".join(f"{k} {v:.3f} s" for k, v in out.items())


def timed(torch, fn):
    """(fn(), seconds), the device synchronized before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def same_answer(torch, label: str, ids, cost, want_ids, want_cost) -> None:
    """Equal ids and equal bytes per tier (a delta entry folds into cxl),
    else fail naming how many queries differ."""
    if not torch.equal(ids, want_ids):
        n_rows = int((ids != want_ids).any(1).sum())
        fail(f"{label}: ids differ in {n_rows} queries")
    tb = [{t.value: v.bytes for t, v in c.by_tier().items()}
          for c in (cost, want_cost)]
    if tb[0] != tb[1]:
        fail(f"{label}: per-tier bytes {tb[0]} differ from {tb[1]}")


def list_members(st, snap, gid) -> str:
    """How many live rows sit in another list in the streaming index than
    in its static rebuild (a diagnosis printed beside a failed
    equality)."""
    import numpy as np
    lists = np.concatenate([st.base_lists, st.delta_lists], axis=1)
    where = np.full(st.n_rows, -1)
    for li, row in enumerate(lists):
        where[row[row >= 0]] = li
    snap_lists = snap.ivf.lists.cpu().numpy()
    want = np.full(gid.size, -1)
    for li, row in enumerate(snap_lists):
        want[row[row >= 0]] = li
    got = where[np.nonzero(st.alive[:st.n_rows])[0]]
    return f"{int((got != want).sum())} live rows in other lists"


def streaming_kernels(torch, st, cfg, q64, lut64) -> tuple[dict, dict]:
    """``pq_adc`` and the fused refine kernel at the streaming IVF shape
    (64 queries over base lists ∪ delta pages, dead rows invalid), the
    fused kernel with the candidates' real delta flags, each against its
    plain version and timed beside its bound; returns their rows."""
    from repro_torch.anns import registry
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_adc as pq_adc_mod
    from repro_torch.kernels import ternary_refine as tr
    cand = registry.make_front("ivf", "streaming", st).candidates(q64)
    n_delta = int((cand.valid & cand.is_delta).sum())
    print(f"streaming kernel shapes: Q={cand.ids.shape[0]} C="
          f"{cand.ids.shape[1]}, {int(cand.valid.sum())} valid slots, "
          f"{n_delta} of them delta rows")
    d0, adc = check_adc(torch, pq_adc_mod, st.pq_codes, cand.ids,
                        cand.valid, lut64, "streaming")
    if not torch.equal(d0, cand.d0):
        fail("pq_adc streaming: the front's d0 differs from a second call's")
    lib_ms, lib_d = adc_library(torch, st.pq_codes, cand.ids, lut64)
    ok, lib_err = close(lib_d[cand.valid], d0[cand.valid], ADC_ATOL,
                        ADC_RTOL)
    if not ok:
        fail(f"embedding_bag disagrees with pq_adc at the streaming shape "
             f"({lib_err})")
    adc["library_ms"] = lib_ms
    del lib_d
    stores = tr.RefineStores.from_trq(st.trq)
    model = st.trq.model
    err, n_mism = check_refine(torch, tr, ops, stores, model, cand, q64,
                               cand.is_delta, k=cfg.final_k,
                               bound_name="cauchy", z=cfg.z,
                               label="streaming (real delta flags)")
    args = (stores, q64, cand.ids, cand.d0, cand.valid, cand.is_delta, model)
    kw = dict(k=cfg.final_k, bound="cauchy", z=cfg.z)
    counts = tr.ternary_refine_fused(*args, **kw)[2]
    planes = ops.make_query_planes(q64, stores.packed[0].shape[1])
    params = ops.query_params(q64, model.w, model.bias, model.resid_std,
                              cfg.z)
    refine = dict(
        max_abs_err=err,
        ms=time_ms(lambda: tr.ternary_refine_fused(*args, **kw), 20),
        plain_ms=time_ms(lambda: tr.refine_plain(
            stores, planes, params, *args[2:6], k=cfg.final_k,
            bound="cauchy"), 3),
        library_ms=None,
        **refine_cost(torch, stores, cand, q64, delta=True))
    nl = stores.num_levels
    print(f"ternary_refine_fused streaming: {refine['ms']:.4f} ms per call "
          f"(bound {refine['bound_ms']:.4f} ms), plain "
          f"{refine['plain_ms']:.3f} ms, survivors "
          f"{int(counts[:, nl - 1].sum())} of which delta rows "
          f"{int(counts[:, 2 * nl - 1].sum())}, alive mismatches at "
          f"near-ties {n_mism}")
    print_launches(torch, "ternary_refine_fused streaming",
                   lambda: tr.ternary_refine_fused(*args, **kw), 20)
    return adc, refine


def streaming_phase(torch, args, cfg, index, ds, q64, lut64, launches,
                    reset_launches, read_launches,
                    serve_check) -> tuple[dict, dict]:
    """Wrap the built index in a ``StreamingIndex`` and drive rounds of
    churn through ``Database.query`` (see the module docstring); in round
    0, mid-churn, ``serve_check("streaming", index, queries)`` runs the
    ``Retriever`` check; returns the ``pq_adc`` and fused-kernel rows at
    the streaming IVF shape."""
    import numpy as np
    from repro_torch.anns import (Database, QueryPlan, StreamingConfig,
                                  StreamingIndex, recall_at_k)
    from repro_torch.anns import streaming as streaming_mod
    from repro_torch.anns.executor import SearchExecutor
    from repro_torch.core import trq as trq_mod
    from repro_torch.data.synthetic import brute_force_topk
    from repro_torch.index import graph as graph_mod
    from repro_torch.obs import metrics, trace
    from repro_torch.quant import pq as pq_mod

    timers = Timers(torch)
    for module, name, label in ((streaming_mod, "assign", "assign"),
                                (pq_mod, "encode", "PQ encode"),
                                (trq_mod, "encode_rows", "TRQ encode"),
                                (graph_mod, "insert_nodes", "insert_nodes"),
                                (graph_mod, "compact_graph", "compact_graph"),
                                (graph_mod, "HostRows", "host copy"),
                                (gc, "collect", "cycle collection")):
        timers.patch(module, name, label)
    dev = index.device
    queries = ds.queries
    nq, d = queries.shape
    k = cfg.final_k
    st, wrap_s = timed(torch, lambda: StreamingIndex(
        index, StreamingConfig(auto_compact=False)))
    sdb = Database.wrap(st)
    # the streaming graph adopts the static graph (no mutation yet), so
    # insert_nodes runs in every round
    _, graph_s = timed(torch, st.graph_index)
    print(f"streaming wrap: {wrap_s:.3f} s (row store of {st.cap_rows} rows"
          f"), graph materialized in {graph_s:.3f} s")
    plan_ivf = QueryPlan(backend="cuda")
    plan_graph = QueryPlan(front="graph", backend="cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    rng = np.random.default_rng(args.seed + 6)
    ledger = lambda c: {key: (v.accesses, v.bytes)          # noqa: E731
                        for key, v in c.ledger.items()}
    rows = {}

    def counted(label: str, plan, needs):
        reset_launches()
        res = sdb.query(queries, plan=plan)
        torch.cuda.synchronize()
        got = read_launches()
        for name in needs:
            if got[name] == 0:
                fail(f"the {label} path never launched {name}")
        launches.setdefault(label, got)
        return res

    def no_dead(label: str, ids) -> None:
        live = torch.zeros(st.next_gid, dtype=torch.bool, device=dev)
        live[torch.from_numpy(st.live_gids()).to(dev)] = True
        if not bool(live[ids.long()].all()):
            fail(f"{label}: a dead or unknown global id was returned")

    def settled(label: str):
        """After a compaction or a rebalance: the graph front equal to a
        static search of the snapshot over the maintained adjacency, IVF
        equal to the snapshot's; → (the IVF answer, the snapshot, its
        global ids on the device)."""
        (snap, gid), reb_s = timed(torch, st.rebuild_static)
        gid_t = torch.from_numpy(gid).to(dev)
        gres = sdb.query(queries, plan=plan_graph)
        ex = SearchExecutor.from_index(snap, front="graph", backend="cuda",
                                       micro_batch=cfg.micro_batch,
                                       graph_index=st.graph_index())
        g_rows, _, g_cost = ex.execute(queries, k=k)
        same_answer(torch, f"streaming {label} (graph) against the static "
                    f"search of its adjacency", gres.ids, gres.cost,
                    gid_t[g_rows.long()], g_cost)
        del ex
        res = sdb.query(queries, plan=plan_ivf)
        ref = Database.wrap(snap).query(queries, plan=plan_ivf)
        same_answer(torch, f"streaming {label} (IVF) against its static "
                    f"rebuild", res.ids, res.cost, gid_t[ref.ids.long()],
                    ref.cost)
        no_dead(f"streaming {label} (IVF)", res.ids)
        no_dead(f"streaming {label} (graph)", gres.ids)
        print(f"streaming {label}: graph equal to the static search over "
              f"the maintained adjacency, IVF equal to the static rebuild "
              f"({reb_s:.3f} s), ids and per-tier bytes, no dead id")
        return res, snap, gid_t

    for rnd in range(STREAM_ROUNDS):
        pick = torch.randint(0, ds.x.shape[0], (STREAM_BATCH,),
                             generator=gen, device=dev)
        noise = torch.randn((STREAM_BATCH, d), generator=gen, device=dev)
        new = ds.x[pick] + 0.25 * noise / d ** 0.5
        new = new / torch.linalg.vector_norm(new, dim=-1, keepdim=True)
        timers.take()
        # round 0 traced: its insert and delete events and mutation counts
        tracer, reg = trace.Tracer(), metrics.MetricsRegistry()
        with contextlib.ExitStack() as stack:
            if rnd == 0:
                stack.enter_context(trace.use(tracer))
                stack.enter_context(metrics.use(reg))
            _, ins_s = timed(torch, lambda: st.insert(new))
            print(f"streaming round {rnd}: insert {STREAM_BATCH} rows "
                  f"{ins_s:.3f} s ({STREAM_BATCH / ins_s:.0f} rows/s; "
                  f"{timers.take()})")
            dead = rng.choice(st.live_gids(), size=STREAM_BATCH,
                              replace=False)
            _, del_s = timed(torch, lambda: st.delete(dead))
            print(f"streaming round {rnd}: delete {STREAM_BATCH} ids "
                  f"{del_s:.3f} s")
        if rnd == 0:
            flat = reg.flat()
            if [sp.name for sp in tracer.spans] != ["index.insert",
                                                    "index.delete"] \
                    or flat['streaming_mutations_total{op="insert"}'] != 1 \
                    or flat['streaming_mutations_total{op="delete"}'] != 1:
                fail(f"streaming round 0 traced: events "
                     f"{[sp.name for sp in tracer.spans]}, metrics {flat}")
            print(f"streaming round 0 traced: index.insert "
                  f"{tracer.spans[0].attrs} and index.delete "
                  f"{tracer.spans[1].attrs}; streaming_mutations_total "
                  f"insert 1, delete 1")
        dcap, cap = st.delta_lists.shape[1], st.base_lists.shape[1]
        print(f"streaming round {rnd}: delta pages {dcap} slots wide, base "
              f"lists {cap}, C = {cfg.nprobe * (cap + dcap)} slots per "
              f"query; {st.n_delta_rows} delta rows, {st.n_tombstones} "
              f"tombstones, {st.n_live} live rows")

        # mid-churn: IVF against the static rebuild
        res = counted("streaming", plan_ivf,
                      ("pq_adc", "ternary_refine_fused"))
        (snap, gid), reb_s = timed(torch, st.rebuild_static)
        timers.take()
        gid_t = torch.from_numpy(gid).to(dev)
        ref = Database.wrap(snap).query(queries, plan=plan_ivf)
        if not torch.equal(res.ids, gid_t[ref.ids.long()]):
            print(f"diagnosis: {list_members(st, snap, gid)}")
        same_answer(torch, f"streaming round {rnd} (IVF) against its static "
                    f"rebuild", res.ids, res.cost, gid_t[ref.ids.long()],
                    ref.cost)
        delta = res.cost.ledger.get("delta:cxl")
        if st.n_delta_rows and not (delta and delta.accesses > 0):
            fail(f"streaming round {rnd}: no delta:cxl traffic with "
                 f"{st.n_delta_rows} delta rows")
        no_dead(f"streaming round {rnd} (IVF)", res.ids)
        gt = gid_t[brute_force_topk(snap.x, queries, k)]
        recall = recall_at_k(res.ids, gt, k)
        if recall < 0.5:
            fail(f"streaming round {rnd} (IVF): recall@10 {recall:.4f}")
        gres = counted("streaming_graph", plan_graph,
                       ("pq_adc", "ternary_refine_fused"))
        no_dead(f"streaming round {rnd} (graph)", gres.ids)
        g_recall = recall_at_k(gres.ids, gt, k)
        if g_recall < 0.1:
            fail(f"streaming round {rnd} (graph): recall@10 {g_recall:.4f}")
        print(f"streaming round {rnd} mid-churn: IVF ids and per-tier bytes "
              f"equal to the static rebuild's (rebuild {reb_s:.3f} s), "
              f"delta:cxl accesses {delta.accesses if delta else 0}, "
              f"recall@10 IVF {recall:.4f}, graph {g_recall:.4f}, SSD "
              f"fetches/query {res.cost.ledger['rerank:ssd'].accesses / nq}"
              f" and {gres.cost.ledger['rerank:ssd'].accesses / nq}, no dead "
              f"id returned")
        for label, plan in (("IVF", plan_ivf), ("graph", plan_graph)):
            a = sdb.query(q64, plan=dataclasses.replace(
                plan, backend="reference", micro_batch=8))
            b = sdb.query(q64, plan=plan)
            if not torch.equal(a.ids, b.ids) or ledger(a.cost) != \
                    ledger(b.cost):
                fail(f"streaming round {rnd} ({label}): the reference "
                     f"backend differs from cuda (ids or ledger)")
        print(f"streaming round {rnd}: the reference backend on 64 queries "
              f"gives the cuda backend's ids and ledger, both fronts")
        if rnd == 0:
            serve_check("streaming", st, queries)
            rows["adc"], rows["refine"] = streaming_kernels(
                torch, st, cfg, q64, lut64)
            runs = {"streaming": [], "streaming_graph": []}
            for _ in range(TIMING_RUNS):
                for label, plan in (("streaming", plan_ivf),
                                    ("streaming_graph", plan_graph)):
                    runs[label].append(timed(
                        torch, lambda: sdb.query(queries, plan=plan))[1])
            for label, r in runs.items():
                secs = sorted(r)[len(r) // 2]
                print(f"{label} (mid-churn): {nq / secs:.1f} queries/s "
                      f"(median of {[round(x, 6) for x in r]} s for {nq})")
            device_breakdown(torch, "streaming", lambda: sdb.query(
                queries, plan=plan_ivf))
        del snap, ref, gt

        stats, comp_s = timed(torch, st.compact)
        print(f"streaming round {rnd}: compact {comp_s:.3f} s "
              f"({timers.take()}), folded {stats['folded_delta_rows']} delta"
              f" rows, dropped {stats['dropped_tombstones']} tombstones")
        settled(f"round {rnd} compacted")

    stats, reb_s = timed(torch, lambda: st.rebalance(args.shards))
    print(f"streaming: rebalance({args.shards}) {reb_s:.3f} s "
          f"({timers.take()}), moved {stats['moved_rows']} rows, shard loads "
          f"{stats['shard_loads']}")
    res, snap, gid_t = settled("rebalanced")
    # shards over the snapshot: IVF equals the unsharded streaming answer;
    # graph partitions the snapshot's own fresh graph, so it equals the
    # unsharded graph query over the snapshot
    sres = counted("streaming_sharded",
                   QueryPlan(shards=args.shards, backend="cuda"),
                   ("pq_adc", "ternary_refine_fused_bounds"))
    same_answer(torch, f"streaming shards={args.shards} (IVF)",
                sres.ids, sres.cost, res.ids, res.cost)
    ug, ug_s = timed(torch, lambda: Database.wrap(snap).query(
        queries, plan=plan_graph))
    sg = counted("streaming_graph_sharded",
                 QueryPlan(front="graph", shards=args.shards,
                           backend="cuda"),
                 ("pq_adc", "ternary_refine_fused_bounds"))
    same_answer(torch, f"streaming shards={args.shards} (graph)",
                sg.ids, sg.cost, gid_t[ug.ids.long()], ug.cost)
    print(f"streaming shards={args.shards}: IVF equal to the unsharded "
          f"streaming answer; graph equal to the unsharded graph query over "
          f"the snapshot (its graph built in {ug_s:.1f} s), ids and per-tier "
          f"bytes")
    del snap
    rows["adc"]["launches"] = launches["streaming"]["pq_adc"]
    rows["refine"]["launches"] = launches["streaming"]["ternary_refine_fused"]
    return rows["adc"], rows["refine"]



# the tiered phase's Zipfian trace (tests/test_tiered.py's recipe): queries,
# popularity exponent, Gaussian noise per coordinate
ZIPF_QUERIES, ZIPF_EXP, ZIPF_NOISE = 1000, 1.3, 0.02


def zipf_queries(torch, x, n: int, seed: int):
    """``n`` queries drawn from ``seed``: anchor rows ranked by distance to
    row 0, popularity ∝ rank^-1.3, noise 0.02 per coordinate,
    renormalized."""
    import numpy as np
    near = torch.argsort(((x - x[0]) ** 2).sum(-1)).cpu().numpy()
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, near.size + 1, dtype=np.float64) ** ZIPF_EXP
    rows = near[rng.choice(near.size, size=n, p=p / p.sum())]
    q = x[torch.from_numpy(rows).to(x.device)].cpu().numpy().astype(
        np.float64) + ZIPF_NOISE * rng.standard_normal((n, x.shape[1]))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return torch.from_numpy(q.astype(np.float32)).to(x.device)


def tiered_kernels(torch, ti, cold_ti, cfg, q64, cq64, stores2,
                   hot_launches) -> tuple[dict, dict]:
    """``pq_adc`` and the fused refine kernel at the tiered shape: the IVF
    candidates of the 64 Zipfian queries ``q64`` on the rebalanced
    placement ``ti``, hot slots made invalid with d0 = +inf and cold slots
    as ``is_delta``, as the executor routes them; the fused kernel also on
    the cold-only placement ``cold_ti``'s candidates of the 64 queries
    ``cq64`` (where a quarter of the slots are cold), each on the
    one-level store and on the two-level ``stores2``.  est within
    ``EST_TOL``, alive and counts (cold survivors too) exact; returns the
    two rows at the hot placement's shape."""
    from repro_torch.anns import registry
    from repro_torch.anns.stages import Candidates
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_adc as pq_adc_mod
    from repro_torch.kernels import ternary_refine as tr
    from repro_torch.memory import TIER_COLD, TIER_HOT
    from repro_torch.quant import pq as pq_mod
    index = ti.inner
    cand = registry.make_front("ivf", "tiered", ti).candidates(q64)
    hot = cand.valid & (cand.tier == TIER_HOT)
    cold = cand.valid & (cand.tier == TIER_COLD)
    print(f"tiered kernel shapes: Q={cand.ids.shape[0]} C="
          f"{cand.ids.shape[1]}, {int(cand.valid.sum())} valid slots, "
          f"{int(hot.sum())} hot (invalid for refinement), {int(cold.sum())}"
          f" cold (is_delta)")
    lut = pq_mod.adc_table(index.codebook, q64)
    d0, adc = check_adc(torch, pq_adc_mod, index.pq_codes, cand.ids,
                        cand.valid, lut, "tiered")
    if not torch.equal(d0, cand.d0):
        fail("pq_adc tiered: the front's d0 differs from a second call's")
    lib_ms, lib_d = adc_library(torch, index.pq_codes, cand.ids, lut)
    ok, lib_err = close(lib_d[cand.valid], d0[cand.valid], ADC_ATOL,
                        ADC_RTOL)
    if not ok:
        fail(f"embedding_bag disagrees with pq_adc at the tiered shape "
             f"({lib_err})")
    adc["library_ms"] = lib_ms
    del lib_d
    rcand = Candidates(
        ids=cand.ids, valid=cand.valid & ~hot,
        d0=torch.where(hot, torch.full_like(cand.d0, float("inf")),
                       cand.d0), counters={})
    ccand = registry.make_front("ivf", "tiered", cold_ti).candidates(cq64)
    c_cold = ccand.valid & (ccand.tier == TIER_COLD)
    stores1 = tr.RefineStores.from_trq(index.trq)
    model = index.trq.model
    err = 0.0
    for label, kc, kq, flags in (("hot placement", rcand, q64, cold),
                                 ("cold-only placement", ccand, cq64,
                                  c_cold)):
        for stores in (stores1, stores2):
            e, n_mism = check_refine(
                torch, tr, ops, stores, model, kc, kq, flags,
                k=cfg.final_k, bound_name="cauchy", z=cfg.z,
                label=f"tiered {label} (real hot mask and cold flags)")
            if n_mism:
                fail(f"ternary_refine_fused tiered {label} L="
                     f"{stores.num_levels}: {n_mism} alive mismatches")
            err = max(err, e)
    c_counts = tr.ternary_refine_fused(
        stores1, cq64, ccand.ids, ccand.d0, ccand.valid, c_cold, model,
        k=cfg.final_k, bound="cauchy", z=cfg.z)[2]
    print(f"ternary_refine_fused tiered cold-only placement: "
          f"{int(c_cold.sum())} cold of {int(ccand.valid.sum())} valid "
          f"slots, survivors {int(c_counts[:, 0].sum())} of which cold "
          f"{int(c_counts[:, 1].sum())}; alive and counts exact at L=1 and "
          f"L=2")
    args = (stores1, q64, rcand.ids, rcand.d0, rcand.valid, cold, model)
    kw = dict(k=cfg.final_k, bound="cauchy", z=cfg.z)
    counts = tr.ternary_refine_fused(*args, **kw)[2]
    planes = ops.make_query_planes(q64, stores1.packed[0].shape[1])
    params = ops.query_params(q64, model.w, model.bias, model.resid_std,
                              cfg.z)
    refine = dict(
        max_abs_err=err,
        ms=time_ms(lambda: tr.ternary_refine_fused(*args, **kw), 20),
        plain_ms=time_ms(lambda: tr.refine_plain(
            stores1, planes, params, *args[2:6], k=cfg.final_k,
            bound="cauchy"), 3),
        library_ms=None,
        **refine_cost(torch, stores1, rcand, q64, delta=True))
    print(f"ternary_refine_fused tiered: {refine['ms']:.4f} ms per call "
          f"(bound {refine['bound_ms']:.4f} ms), plain "
          f"{refine['plain_ms']:.3f} ms, survivors {int(counts[:, 0].sum())}"
          f" of which cold {int(counts[:, 1].sum())}; alive and counts "
          f"exact at L=1 and L=2")
    print_launches(torch, "ternary_refine_fused tiered",
                   lambda: tr.ternary_refine_fused(*args, **kw), 20)
    adc["launches"] = hot_launches["pq_adc"]
    refine["launches"] = hot_launches["ternary_refine_fused"]
    return adc, refine


def tiered_phase(torch, args, cfg, db, ds, results, stores2, launches,
                 reset_launches, read_launches,
                 serve_check) -> tuple[dict, dict]:
    """The tiered layout on the 1M index (see the module docstring):
    all-warm and cold-only against the static answers, the Zipfian trace
    before and after ``rebalance_tiers()``, the kernels at the tiered
    shape, queries/s, a profiled hot pass, one traced query batch and
    rebalance, then ``serve_check("tiered", index, queries)`` (the
    ``Retriever`` check) on the rebalanced index and the Zipfian queries;
    returns the ``pq_adc`` and fused-kernel rows at the tiered shape."""
    import tempfile
    from repro_torch.anns import (Database, QueryPlan, TieredConfig,
                                  TieredIndex, recall_at_k)
    from repro_torch.anns import stages as stages_mod
    from repro_torch.data.synthetic import brute_force_topk
    from repro_torch.obs import export, metrics, trace

    index = db.index
    queries, nq = ds.queries, ds.queries.shape[0]
    plans = {"ivf": QueryPlan(backend="cuda"),
             "graph": QueryPlan(front="graph", backend="cuda")}
    ledger = lambda c: {key: (v.accesses, v.bytes)          # noqa: E731
                        for key, v in c.ledger.items()}

    def counted(label: str, tdb, q, plan):
        reset_launches()
        res = tdb.query(q, plan=plan)
        torch.cuda.synchronize()
        got = read_launches()
        for name in ("pq_adc", "ternary_refine_fused"):
            if got[name] == 0:
                fail(f"the {label} path never launched {name}")
        launches[label] = got
        return res

    # all-warm: a never-rebalanced TieredIndex is the static index
    warm_db = Database.wrap(TieredIndex(index))
    for front, static in (("ivf", "fatrq"), ("graph", "graph")):
        label = "tiered_warm" + ("_graph" if front == "graph" else "")
        res, want = counted(label, warm_db, queries, plans[front]), \
            results[static]
        if not (torch.equal(res.ids, want.ids)
                and torch.equal(res.distances, want.distances)
                and ledger(res.cost) == ledger(want.cost)):
            fail(f"{label}: not bit-equal to the static {static} path "
                 f"(ids, distances or ledger)")
    print("tiered all-warm: ids, distances and ledger bit-equal to static, "
          "IVF and graph fronts (cuda)")

    # cold-only: heat from one pass, then 30% of rows to SSD; the hot path
    # must never run (no host synchronize), the answers stay static
    cold_ti = TieredIndex(index, TieredConfig(hot_rows_frac=0.0,
                                              cold_rows_frac=0.3))
    cold_db = Database.wrap(cold_ti)
    cold_db.query(queries, plan=plans["ivf"])
    rep = cold_ti.rebalance_tiers()
    if not rep["changed"] or rep["occupancy"]["hot"] != (0, 0):
        fail(f"cold-only rebalance: {rep}")

    def no_hot(*a, **kw):
        fail("the cold-only placement ran the hot scoring")

    score_hot, stages_mod._score_hot = stages_mod._score_hot, no_hot
    try:
        for front, static in (("ivf", "fatrq"), ("graph", "graph")):
            label = "tiered_cold" + ("_graph" if front == "graph" else "")
            res, want = counted(label, cold_db, queries, plans[front]), \
                results[static]
            if not (torch.equal(res.ids, want.ids)
                    and torch.equal(res.distances, want.distances)):
                fail(f"{label}: ids or distances differ from static")
            got, exp = ledger(res.cost), ledger(want.cost)
            n_cold = got.pop("cold:ssd", (0, 0))[0]
            n_refine = got.pop("refine:cxl")[0]
            if n_refine + n_cold != exp.pop("refine:cxl")[0] or got != exp \
                    or (front == "ivf" and n_cold == 0):
                fail(f"{label}: the ledger {ledger(res.cost)} does not move "
                     f"exactly the cold accesses off {ledger(want.cost)}")
            print(f"{label}: ids and distances bit-equal to static; "
                  f"{n_cold} refine:cxl accesses moved to cold:ssd, every "
                  f"other entry equal; no hot scoring")
    finally:
        stages_mod._score_hot = score_hot
    print(f"tiered cold-only placement: {rep['occupancy']} (lists, rows)")

    # the Zipfian trace: all-warm pass, rebalance, hot pass
    zq = zipf_queries(torch, ds.x, ZIPF_QUERIES, args.seed)
    zgt = brute_force_topk(ds.x, zq, cfg.final_k)
    hot_ti = TieredIndex(index, TieredConfig(decay=0.5, hot_rows_frac=0.1,
                                             cold_rows_frac=0.2))
    zdb = Database.wrap(hot_ti)
    zwarm = zdb.query(zq, plan=plans["ivf"])
    stale = list(hot_ti._executor_cache.values())
    rep, rep_s = timed(torch, hot_ti.rebalance_tiers)
    if not rep["changed"] or rep["occupancy"]["hot"][0] == 0:
        fail(f"Zipfian rebalance placed no hot list: {rep}")
    again = hot_ti.rebalance_tiers()
    if again["changed"] or hot_ti.generation != rep["generation"]:
        fail("a second rebalance_tiers() on unchanged heat moved the "
             "generation")
    zhot = counted("tiered", zdb, zq, plans["ivf"])
    if any(ex is old for ex in hot_ti._executor_cache.values()
           for old in stale) or any(
            key[0] != hot_ti.generation for key in hot_ti._executor_cache):
        fail("the executor was not rebuilt after the migration")
    zstatic = db.query(zq, plan=plans["ivf"])
    led_w, led_h = zwarm.cost.ledger, zhot.cost.ledger
    n_front = led_h["coarse:hbm"].accesses
    n_hot = led_h["hot:hbm"].accesses if "hot:hbm" in led_h else 0
    n_cold = led_h["cold:ssd"].accesses if "cold:ssd" in led_h else 0
    recalls = {lab: recall_at_k(r.ids, zgt, cfg.final_k)
               for lab, r in (("static", zstatic), ("all-warm", zwarm),
                              ("hot", zhot))}
    print(f"tiered Zipfian rebalance ({rep_s:.3f} s): moves {rep['moves']}, "
          f"occupancy (lists, rows) {rep['occupancy']}, generation "
          f"{rep['generation']}; a second rebalance keeps it; the executor "
          f"was rebuilt")
    print(f"tiered Zipfian hot pass: {n_hot} hot ({n_hot / n_front:.4f}) "
          f"and {n_cold} cold ({n_cold / n_front:.4f}) of {n_front} valid "
          f"candidates; rerank:ssd {led_h['rerank:ssd'].accesses} against "
          f"all-warm {led_w['rerank:ssd'].accesses}; modelled "
          f"{zhot.cost.total_seconds():.6f} s against "
          f"{zwarm.cost.total_seconds():.6f} s; recall@10 {recalls}")
    if "hot:hbm" not in led_h:
        fail("the Zipfian hot pass has no hot:hbm entry")
    if led_h["rerank:ssd"].accesses >= led_w["rerank:ssd"].accesses:
        fail("the hot pass fetches no fewer rows from SSD than all-warm")
    if zhot.cost.total_seconds() >= zwarm.cost.total_seconds():
        fail("the hot pass's modelled time is not below all-warm's")
    for lab, r in recalls.items():
        if r < 0.5:
            fail(f"tiered Zipfian {lab}: recall@10 {r:.4f} below 0.5")
    for front in ("ivf", "graph"):
        a = zdb.query(zq[:64], plan=dataclasses.replace(
            plans[front], backend="reference", micro_batch=8))
        b = zdb.query(zq[:64], plan=plans[front])
        if not torch.equal(a.ids, b.ids) or ledger(a.cost) != ledger(b.cost):
            fail(f"tiered hot placement ({front}): the reference backend "
                 f"differs from cuda (ids or ledger)")
    print("tiered hot placement: the reference backend on 64 queries gives "
          "the cuda backend's ids and ledger, both fronts")

    rows = tiered_kernels(torch, hot_ti, cold_ti, cfg, zq[:64].contiguous(),
                          queries[:64].contiguous(), stores2,
                          launches["tiered"])

    # queries/s, the paths in turns, median of TIMING_RUNS; then profiled
    # all-warm and hot passes
    paths = {"static fatrq": (db, queries),
             "tiered all-warm": (warm_db, queries),
             "tiered cold-only": (cold_db, queries),
             "static fatrq, Zipfian": (db, zq),
             "tiered after rebalance, Zipfian": (zdb, zq)}
    runs = {label: [] for label in paths}
    for _ in range(TIMING_RUNS):
        for label, (pdb, q) in paths.items():
            runs[label].append(timed(
                torch, lambda: pdb.query(q, plan=plans["ivf"]))[1])
    for label, r in runs.items():
        secs, n = sorted(r)[len(r) // 2], paths[label][1].shape[0]
        print(f"{label}: {n / secs:.1f} queries/s (median of "
              f"{[round(x, 6) for x in r]} s for {n})")
    device_breakdown(torch, "tiered all-warm", lambda: warm_db.query(
        queries, plan=plans["ivf"]))
    device_breakdown(torch, "tiered hot pass", lambda: zdb.query(
        zq, plan=plans["ivf"]))

    # one traced query batch and one traced rebalance
    plain, plain_s = timed(torch, lambda: zdb.query(zq, plan=plans["ivf"]))
    t0 = time.perf_counter()
    tracer = trace.Tracer(
        virtual_clock=lambda: (time.perf_counter() - t0) * 1e6)
    reg = metrics.MetricsRegistry()
    with trace.use(tracer), metrics.use(reg):
        traced, traced_s = timed(torch, lambda: zdb.query(
            zq, plan=plans["ivf"]))
        hot_ti.rebalance_tiers()
    if not (torch.equal(traced.ids, plain.ids)
            and torch.equal(traced.distances, plain.distances)
            and ledger(traced.cost) == ledger(plain.cost)):
        fail("the traced query differs from the untraced one")
    (q_span,) = tracer.by_name("query")
    (ex_span,) = tracer.by_name("execute")
    n_mb = -(-ZIPF_QUERIES // cfg.micro_batch)
    if ex_span.parent != q_span.sid or [
            s.name for s in tracer.children(ex_span.sid)] != \
            ["front", "refine", "rerank"] * n_mb:
        fail("the span tree is not query → execute → front/refine/rerank "
             "per micro-batch")
    if len(tracer.by_name("index.rebalance_tiers")) != 1:
        fail("no index.rebalance_tiers event")
    flat = reg.flat()
    tier_rows = sum(flat[f'tiered_rows{{tier="{t}"}}']
                    for t in ("hot", "warm", "cold"))
    if tier_rows != args.n:
        fail(f"tiered_rows gauges sum to {tier_rows}, not {args.n}")
    with tempfile.TemporaryDirectory() as tmp:
        path = export.write_chrome_trace(tracer.spans,
                                         os.path.join(tmp, "trace.json"))
        with open(path) as f:
            doc = json.load(f)
    n_x = sum(e["ph"] == "X" for e in doc["traceEvents"])
    drift = {stage: flat[f'fatrq_model_drift_ratio_sum{{stage="{stage}"}}']
             / flat[f'fatrq_model_drift_ratio_count{{stage="{stage}"}}']
             for stage in ("front", "refine", "rerank")}
    totals = {stage: (sum(s.wall_s for s in tracer.by_name(stage)),
                      sum(s.attrs["model_s"] for s in tracer.by_name(stage)))
              for stage in ("front", "refine", "rerank")}
    print(f"tiered traced: ids, distances and ledger bit-equal to untraced; "
          f"{len(tracer.spans)} spans (query → execute → front/refine/rerank"
          f" x {n_mb}), index.rebalance_tiers event, tiered_rows gauges sum "
          f"to {tier_rows}; Chrome trace valid JSON with {n_x} complete "
          f"events; traced query {traced_s:.4f} s against untraced "
          f"{plain_s:.4f} s")
    for stage, (wall, model) in totals.items():
        print(f"tiered traced {stage}: measured {wall:.6f} s, modelled "
              f"{model:.6f} s, drift ratio {wall / model:.4f} overall, mean "
              f"per micro-batch {drift[stage]:.4f}")
    serve_check("tiered", hot_ti, zq)
    return rows


# ---- the serving phase
# ragged Retriever call sizes, cycled until the queries run out
SERVE_SIZES = (37, 5, 64, 1, 23, 50, 2, 64, 17, 9, 33, 3, 48, 11, 60, 29, 7,
               4, 41, 13)
SERVE_REQUESTS, SERVE_ZIPF, SERVE_GAP_US = 4096, 1.1, 10.0
# the throttled tenant (every 4th request, ~25,000 requests/s of virtual
# time): its sustained rate and burst
SERVE_BUSY_RPS, SERVE_BUSY_BURST = 2000.0, 8.0
SERVE_INVALIDATE = 1024        # requests per run of the invalidation checks
BUCKETS = frozenset(1 << i for i in range(7))     # 1, 2, ..., 64


def ragged(n: int) -> list[tuple[int, int]]:
    """(start, stop) of calls of ``SERVE_SIZES`` sizes covering n rows."""
    out, at = [], 0
    while at < n:
        b = min(SERVE_SIZES[len(out) % len(SERVE_SIZES)], n - at)
        out.append((at, at + b))
        at += b
    return out


def retriever_check(torch, label: str, index, queries, launches,
                    reset_launches, read_launches, *, needs,
                    shards: int | None = None) -> None:
    """``Retriever`` over one layout with the queries sent as calls of
    ragged sizes, ``bucket=True`` and ``bucket=False``: ids, distances and
    ledger bit-equal call by call.  The query counts that reach
    ``pq_adc`` (the front's last launch; every later kernel of the path
    takes the same batch) are recorded: with buckets only powers of two up
    to the micro-batch of 64.  The bucketed run's launches are counted."""
    from repro_torch.anns import sharding, stages
    from repro_torch.serving import Retriever
    ledger = lambda c: {key: (v.accesses, v.bytes)          # noqa: E731
                        for key, v in c.ledger.items()}
    calls = ragged(queries.shape[0])
    adc = stages.pq_adc
    out, seen, secs = {}, {}, {}
    for bucket in (True, False):
        shapes = seen[bucket] = set()

        def record(codes, ids, valid, lut, _shapes=shapes):
            _shapes.add(int(ids.shape[0]))
            return adc(codes, ids, valid, lut)

        r = Retriever(index=index, backend="cuda", shards=shards,
                      micro_batch=64, bucket=bucket)
        saved = stages.pq_adc, sharding.pq_adc
        stages.pq_adc = sharding.pq_adc = record
        try:
            if bucket:
                reset_launches()
            res, secs[bucket] = timed(torch, lambda: [
                r.query(queries[a:b], k=10) for a, b in calls])
            if bucket:
                launches[f"serving_{label}"] = read_launches()
        finally:
            stages.pq_adc, sharding.pq_adc = saved
        out[bucket] = res
    for (a, b), got, want in zip(calls, out[True], out[False]):
        if not (torch.equal(got.ids, want.ids)
                and torch.equal(got.distances, want.distances)
                and ledger(got.cost) == ledger(want.cost)):
            fail(f"Retriever {label}: the bucketed call of {b - a} queries "
                 f"differs from the unbucketed one")
    if not seen[True] <= BUCKETS:
        fail(f"Retriever {label}: bucketed calls reached pq_adc at query "
             f"counts {sorted(seen[True] - BUCKETS)}")
    if seen[False] <= BUCKETS:
        fail(f"Retriever {label}: unbucketed calls reached pq_adc only at "
             f"bucket shapes; the shape record is void")
    for name in needs:
        if launches[f"serving_{label}"][name] == 0:
            fail(f"Retriever {label}: never launched {name}")
    print(f"Retriever {label}: {queries.shape[0]} queries in {len(calls)} "
          f"calls of ragged sizes, bucket=True and bucket=False give "
          f"bit-equal ids, distances and ledgers; pq_adc saw query counts "
          f"{sorted(seen[True])} bucketed, {len(seen[False])} distinct "
          f"unbucketed; {secs[True]:.3f} s bucketed, {secs[False]:.3f} s "
          f"not; launches {launches[f'serving_{label}']}")


def shape_invariance(torch, db, cfg, queries) -> dict:
    """Each query-side op of the IVF and graph paths on query 0 alone
    (Q = 1) and inside a 64-row bucket padded from 37: bit-equal or not,
    op by op.  Printed for the record; the serving checks below are the
    gate on the answers."""
    from repro_torch.anns import QueryPlan, stages
    from repro_torch.anns.executor import pad_chunk
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_refine as tr
    from repro_torch.quant import pq as pq_mod
    index = db.index
    q1 = queries[:1].contiguous()
    qpad, qvalid = pad_chunk(queries[:37].contiguous(), 64)
    front = db.executor_for(QueryPlan(backend="cuda")).front
    gfront = db.executor_for(QueryPlan(front="graph", backend="cuda")).front
    backend = db.executor_for(QueryPlan(backend="cuda")).backend
    same = {}
    d1 = stages.rank_centroid_lists(index.ivf.centroids, q1,
                                    nprobe=cfg.nprobe)[0]
    dp = stages.rank_centroid_lists(index.ivf.centroids, qpad,
                                    nprobe=cfg.nprobe)[0]
    same["centroid distances (stages.rank_centroid_lists)"] = torch.equal(
        d1[0], dp[0])
    same["ADC tables (pq.adc_table)"] = torch.equal(
        pq_mod.adc_table(index.codebook, q1)[0],
        pq_mod.adc_table(index.codebook, qpad)[0])
    c1, cp = front.candidates(q1), front.candidates(qpad, qvalid=qvalid)
    same["IVF candidates and d0 (pq_adc)"] = torch.equal(
        c1.ids[0], cp.ids[0]) and torch.equal(c1.d0[0], cp.d0[0])
    kw = dict(k=cfg.final_k, bound=cfg.bound, z=cfg.z)
    stores = backend.stores(index.trq)
    r1 = tr.ternary_refine_fused(stores, q1, c1.ids, c1.d0, c1.valid, None,
                                 index.trq.model, **kw)
    rp = tr.ternary_refine_fused(stores, qpad, cp.ids, cp.d0, cp.valid,
                                 None, index.trq.model, **kw)
    same["est and alive (ternary_refine_fused)"] = torch.equal(
        r1[0][0], rp[0][0]) and torch.equal(r1[1][0], rp[1][0])
    for c in (40, 10):            # the budget, and a degraded budget
        ids_c = cp.ids[:, :c].contiguous()
        same[f"exact L2 over {c} fetched rows (stages._exact_sq)"] = \
            torch.equal(stages._exact_sq(index.x, q1, ids_c[:1])[0],
                        stages._exact_sq(index.x, qpad, ids_c)[0])
    model = index.trq.model
    same["query norm (ops.query_params)"] = torch.equal(
        ops.query_params(q1, model.w, model.bias, model.resid_std,
                         cfg.z)[0],
        ops.query_params(qpad, model.w, model.bias, model.resid_std,
                         cfg.z)[0])
    g1, gp = gfront.candidates(q1), gfront.candidates(qpad, qvalid=qvalid)
    same["graph beam and d0 (graph.search, pq_adc)"] = torch.equal(
        g1.ids[0], gp.ids[0]) and torch.equal(g1.d0[0], gp.d0[0])
    for op, eq in same.items():
        print(f"batch-shape invariance, Q=1 against a padded bucket of 64: "
              f"{op}: {'bit-equal' if eq else 'DIFFERS'}")
    return same


def path_kernels(torch, db, cfg, q, label: str, qvalid=None,
                 k: int | None = None):
    """``pq_adc`` and the fused refine kernel on the candidates that the
    cuda plan's front gives the queries ``q`` (``qvalid``: the bucket's
    valid rows; ``k``: the refine's k, the config's ``final_k`` unless
    given), against their plain versions: d0 within tolerance, +inf
    on exactly the invalid slots and equal to the front's; est within
    tolerance on the valid slots, alive and counts exact.  Returns their
    rows (ms, bound, plain ms, library ms; each kernel's device ms
    printed), the candidates and the kernel's alive and counts."""
    from repro_torch.anns import QueryPlan
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_adc as pq_adc_mod
    from repro_torch.kernels import ternary_refine as tr
    from repro_torch.quant import pq as pq_mod
    index = db.index
    ex = db.executor_for(QueryPlan(backend="cuda"))
    cand = ex.front.candidates(q, qvalid=qvalid)
    lut = pq_mod.adc_table(index.codebook, q)
    g = index.trq.levels[0].packed.shape[1]
    print(f"{label} shapes: Q={cand.ids.shape[0]} C={cand.ids.shape[1]} "
          f"M={cfg.pq_m} K={cfg.pq_k} G={g}")
    d0, adc = check_adc(torch, pq_adc_mod, index.pq_codes, cand.ids,
                        cand.valid, lut, label)
    if not torch.equal(d0, cand.d0):
        fail(f"pq_adc {label}: the front's d0 differs from a second call's")
    adc["library_ms"], lib_d = adc_library(torch, index.pq_codes, cand.ids,
                                           lut, cand.valid)
    ok, lib_err = close(lib_d[cand.valid], d0[cand.valid], ADC_ATOL,
                        ADC_RTOL)
    if not ok:
        fail(f"embedding_bag disagrees with pq_adc at the {label} "
             f"({lib_err})")
    del lib_d, d0
    stores, model = ex.backend.stores(index.trq), index.trq.model
    args = (stores, q, cand.ids, cand.d0, cand.valid, None, model)
    k = k or cfg.final_k
    kw = dict(k=k, bound="cauchy", z=cfg.z)
    est, alive, counts = tr.ternary_refine_fused(*args, **kw)
    planes = ops.make_query_planes(q, g)
    params = ops.query_params(q, model.w, model.bias, model.resid_std,
                              cfg.z)
    p_est, p_alive, p_counts, _ = tr.refine_plain(
        stores, planes, params, cand.ids, cand.d0, cand.valid, None,
        k=k, bound="cauchy")
    torch.cuda.synchronize()
    ok, err = close(est[cand.valid], p_est[cand.valid], EST_TOL, EST_TOL)
    if not ok:
        fail(f"ternary_refine_fused {label}: est off on valid slots (max "
             f"err {err})")
    if not (torch.equal(alive, p_alive) and torch.equal(counts, p_counts)):
        fail(f"ternary_refine_fused {label}: alive or counts differ from "
             f"the plain version ({int((alive != p_alive).sum())} alive "
             f"slots)")
    ms, plan = launched_plan(tr, lambda: time_ms(
        lambda: tr.ternary_refine_fused(*args, **kw), 20))
    refine = dict(
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: tr.refine_plain(
            stores, planes, params, *args[2:6], k=k, bound="cauchy"), 3),
        library_ms=None, **refine_cost(torch, stores, cand, q))
    if plan is not None:
        refine["plan"] = plan
    print_launches(torch, f"ternary_refine_fused {label}",
                   lambda: tr.ternary_refine_fused(*args, **kw), 20)
    print(f"ternary_refine_fused {label}: est within {err:.3g} on "
          f"{int(cand.valid.sum())} valid slots of {cand.valid.numel()}, "
          f"alive and counts exact, survivors {int(counts[:, 0].sum())}; "
          f"{refine['ms']:.4f} ms per call (bound {refine['bound_ms']:.4f} "
          f"ms), plain {refine['plain_ms']:.3f} ms"
          + (f", chunk plan {plan}" if plan else ""))
    return adc, refine, cand, alive, counts


def padded_kernels(torch, db, cfg, queries) -> tuple[dict, dict]:
    """``path_kernels`` on one padded bucket (37 queries padded to 64:
    rows 37..63 have no valid slot, survivor or count).  Returns the two
    kernels' rows."""
    from repro_torch.anns.executor import pad_chunk
    qpad, qvalid = pad_chunk(queries[:37].contiguous(), 64)
    adc, refine, cand, alive, counts = path_kernels(
        torch, db, cfg, qpad, "padded bucket (37 of 64 rows)", qvalid)
    if bool(cand.valid[37:].any()):
        fail("a padded row of the bucket has a valid slot")
    if bool(alive[37:].any()) or bool(counts[37:].any()):
        fail("ternary_refine_fused padded bucket: a padded row has a "
             "survivor or a count")
    print("padded bucket: no valid slot, survivor or count in the 27 "
          "padded rows")
    return adc, refine


def kernel_streams(torch, fn) -> dict | None:
    """One run of ``fn`` under ``torch.profiler`` (device activity only):
    each CUDA stream's kernels as the exported Chrome trace gives them
    (``args.stream``), the device's busy time (the union of all kernel
    intervals) over the span from the first kernel's start to the last
    one's end, and the time during which a kernel of the stream that ran
    ``adc_kernel`` (the fronts) and one of the stream that ran
    ``score_kernel`` (the refines) were both running.  None when the
    profiler recorded no kernel."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kern = [(e["args"].get("stream"), float(e["ts"]),
             float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not kern:
        return None

    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def overlap(u, v):
        total, i, j = 0.0, 0, 0
        while i < len(u) and j < len(v):
            total += max(0.0, min(u[i][1], v[j][1]) - max(u[i][0], v[j][0]))
            if u[i][1] < v[j][1]:
                i += 1
            else:
                j += 1
        return total

    streams = {}
    for s, a, b, name in kern:
        streams.setdefault(s, []).append((a, b, name))
    front = {s for s, _, _, n in kern if "adc_kernel" in n}
    refine = {s for s, _, _, n in kern if "score_kernel" in n}
    span = max(b for _, _, b, _ in kern) - min(a for _, a, _, _ in kern)
    busy = sum(b - a for a, b in union([(a, b) for _, a, b, _ in kern]))
    out = {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / span, "front_streams": sorted(front),
           "refine_streams": sorted(refine),
           "kernels_by_stream": {s: len(v) for s, v in streams.items()}}
    if len(front) == 1 and len(refine) == 1 and front != refine:
        uf = union([(a, b) for a, b, _ in streams[next(iter(front))]])
        ur = union([(a, b) for a, b, _ in streams[next(iter(refine))]])
        out.update(front_busy_ms=sum(b - a for a, b in uf) / 1e3,
                   refine_busy_ms=sum(b - a for a, b in ur) / 1e3,
                   overlap_ms=overlap(uf, ur) / 1e3)
    return out


def zipf_picks(n_queries: int, n: int, seed: int):
    """``n`` query indices: Zipf(``SERVE_ZIPF``) ranks over a random order
    of the ``n_queries`` queries, so popular queries repeat."""
    import numpy as np
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_queries + 1, dtype=np.float64) ** SERVE_ZIPF
    order = rng.permutation(n_queries)
    return order[rng.choice(n_queries, size=n, p=p / p.sum())]


def check_responses(torch, label: str, db, eng, resp, picks, queries,
                    seq: dict) -> None:
    """Every response equals a sequential ``db.query`` of its query under
    its class plan (ids and distances bit for bit), cache hits included;
    the engine's ``total_cost`` equals the sum of the sequential ledgers
    over the misses.  ``seq`` keeps the sequential answers by (query,
    degraded) across calls."""
    import numpy as np
    from repro_torch.memory import QueryCost
    for r in resp:
        key = (int(picks[r.rid]), r.degraded)
        if key not in seq:
            seq[key] = db.query(queries[key[0]][None],
                                plan=eng._class_plan(eng.base_plan.k,
                                                     r.degraded))
    total = QueryCost()
    bad = []
    for r in resp:
        ref = seq[(int(picks[r.rid]), r.degraded)]
        if not (np.array_equal(r.ids, ref.ids[0].cpu().numpy()) and
                np.array_equal(r.distances, ref.distances[0].cpu().numpy())):
            bad.append(r)
        if not r.cache_hit:
            total.merge(ref.cost)
    if bad:
        r = bad[0]
        fail(f"{label}: {len(bad)} responses differ from a sequential "
             f"db.query of their query (first: rid {r.rid}, batch {r.batch},"
             f" cache hit {r.cache_hit}, degraded {r.degraded})")
    ledger = lambda c: {key: (v.accesses, v.bytes)          # noqa: E731
                        for key, v in c.ledger.items()}
    if ledger(eng.total_cost) != ledger(total):
        fail(f"{label}: total_cost {ledger(eng.total_cost)} is not the sum "
             f"of the sequential ledgers of the misses {ledger(total)}")


def finish_waits_not_on_fronts(torch, db, host) -> None:
    """The double buffer's retire (the current stream's wait on the
    front's event, then ``run_finish`` and its blocking counter copy)
    must not wait for the engine's side stream: with a front in flight
    and ~1 s of sleep queued on the side stream behind it, the retire
    returns while the side stream is still busy."""
    from repro_torch.anns import QueryPlan
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(db, plan=QueryPlan(backend="cuda"), max_batch=64)
    responses = []
    for i in range(64):
        eng._admit(Request(query=host[i], rid=i), responses, None)
    eng._dispatch_ready(responses, drain=True)       # the front, in flight
    with torch.cuda.stream(eng._side):
        torch.cuda._sleep(2_000_000_000)             # a later front, ~1 s
    t = time.perf_counter()
    eng._retire_inflight(responses)
    retire_s = time.perf_counter() - t
    busy = not eng._side.query()
    torch.cuda.synchronize()
    if not busy or len(responses) != 64:
        fail(f"engine: the retire waited for the side stream ({retire_s:.3f}"
             f" s, side stream busy after it: {busy})")
    print(f"engine: a retire returned in {retire_s * 1e3:.3f} ms while ~1 s "
          f"of work was still queued on the fronts' stream (the finish's "
          f"host copy waits for the current stream only)")


def engine_phase(torch, args, cfg, db, ds, launches, reset_launches,
                 read_launches) -> None:
    """``ServingEngine`` on the static IVF fatrq plan (see the module
    docstring): bit-identity to sequential ``db.query`` on every row,
    overlap on ≡ off, the cache, requests/s to drain, and one profiled
    run's streams."""
    import numpy as np
    from repro_torch.anns import QueryPlan
    from repro_torch.serving import (Request, ResultCache, ServingEngine,
                                     TenantQoS)
    host = ds.queries.cpu()
    picks = zipf_picks(host.shape[0], SERVE_REQUESTS, args.seed + 7)

    def requests():
        return [Request(query=host[picks[i]],
                        tenant="busy" if i % 4 == 0 else "t0",
                        arrival_us=i * SERVE_GAP_US, rid=i)
                for i in range(SERVE_REQUESTS)]

    def engine(cache=True, **kw):
        return ServingEngine(
            db, plan=QueryPlan(backend="cuda"), max_batch=64,
            max_wait_us=200.0,
            cache=ResultCache(capacity=4096) if cache else None,
            qos={"busy": TenantQoS(rate_rps=SERVE_BUSY_RPS,
                                   burst=SERVE_BUSY_BURST)}, **kw)

    engine().run(requests()[:256])                  # warm-up
    torch.cuda.synchronize()
    finish_waits_not_on_fronts(torch, db, host)
    reset_launches()
    eng = engine()
    resp, on_s = timed(torch, lambda: eng.run(requests()))
    launches["serving_engine"] = read_launches()
    for name in ("pq_adc", "ternary_refine_fused"):
        if launches["serving_engine"][name] == 0:
            fail(f"the engine never launched {name}")
    off = engine(overlap=False)
    resp_off = off.run(requests())
    seq = {}
    check_responses(torch, "engine (overlap on)", db, eng, resp, picks,
                    ds.queries, seq)
    check_responses(torch, "engine (overlap off)", db, off, resp_off, picks,
                    ds.queries, seq)
    # overlap on ≡ off row by row on the same batches: without the cache
    # (with it, a repeat that arrives while its first copy is in flight
    # misses with overlap on and hits with it off, and the token bucket
    # is charged for misses only)
    plain = [engine(cache=False, overlap=o) for o in (True, False)]
    a_resp, b_resp = (e.run(requests()) for e in plain)
    if plain[0].batch_log != plain[1].batch_log:
        fail("engine without cache: overlap on and off formed different "
             "batches")
    for a, b in zip(a_resp, b_resp):
        if not (a.rid == b.rid and np.array_equal(a.ids, b.ids)
                and np.array_equal(a.distances, b.distances)
                and a.degraded == b.degraded):
            fail(f"engine without cache: overlap on and off differ at rid "
                 f"{a.rid}")
    check_responses(torch, "engine without cache (overlap on)", db,
                    plain[0], a_resp, picks, ds.queries, seq)
    hits = [r for r in resp if r.cache_hit]
    st = eng.stats
    if not hits or not st.degraded:
        fail(f"engine: the trace made {len(hits)} cache hits and "
             f"{st.degraded} degraded requests")
    lat = np.array([r.latency_us for r in resp])
    print(f"engine (static IVF fatrq, max_batch 64, max_wait 200 us, "
          f"{SERVE_REQUESTS} requests every {SERVE_GAP_US} us, Zipf "
          f"{SERVE_ZIPF} over {host.shape[0]} queries, tenant 'busy' every "
          f"4th request at {SERVE_BUSY_RPS} rps burst {SERVE_BUSY_BURST}): "
          f"{st.cache_hits} hits, {st.requests - st.cache_hits} misses, "
          f"{st.batches} batches, {st.padded_slots} padded slots, "
          f"{st.degraded} degraded; {len(seq)} distinct (query, class) "
          f"answers; every response equal to a sequential db.query of its "
          f"query under its class plan (overlap on and off, with the "
          f"cache), total_cost equal to the sum of the misses' sequential "
          f"ledgers; without the cache ({plain[0].stats.batches} batches) "
          f"overlap on and off equal on every row; launches "
          f"{launches['serving_engine']}")
    print(f"engine modelled latency (virtual clock, tier model, not "
          f"measured): p50 {np.percentile(lat, 50):.1f} us, p99 "
          f"{np.percentile(lat, 99):.1f} us, drain at "
          f"{max(r.done_us for r in resp):.1f} us")
    runs = {"overlap on": [], "overlap off": [], "batching off": []}
    kws = {"overlap on": {}, "overlap off": {"overlap": False},
           "batching off": {"batching": False}}
    for _ in range(TIMING_RUNS):
        for label, kw in kws.items():
            e, reqs = engine(**kw), requests()
            runs[label].append(timed(torch, lambda: e.run(reqs))[1])
    for label, r in runs.items():
        secs = sorted(r)[len(r) // 2]
        print(f"engine {label}: {SERVE_REQUESTS / secs:.1f} requests/s to "
              f"drain (host clock, median of {[round(x, 6) for x in r]} s)")
    e, reqs = engine(), requests()
    prof = kernel_streams(torch, lambda: e.run(reqs))
    if prof is None:
        print("engine profiled: not measured (the profiler recorded no "
              "kernel)")
        return
    print(f"engine profiled (overlap on): device busy "
          f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span, "
          f"idle share {prof['idle_share']:.4f}; kernels by stream "
          f"{prof['kernels_by_stream']}; fronts (adc_kernel) on "
          f"{prof['front_streams']}, refines (score_kernel) on "
          f"{prof['refine_streams']}")
    if "overlap_ms" not in prof:
        fail("engine: the fronts and the refines did not run on two "
             "streams")
    print(f"engine profiled: front stream busy {prof['front_busy_ms']:.3f} "
          f"ms, refine stream busy {prof['refine_busy_ms']:.3f} ms, both "
          f"running at once {prof['overlap_ms']:.3f} ms")


def serving_phase(torch, args, cfg, db, ds, launches, reset_launches,
                  read_launches) -> tuple[dict, dict]:
    """The serving phase on the static index (see the module docstring);
    returns the ``pq_adc`` and fused-kernel rows at the padded bucket."""
    shape_invariance(torch, db, cfg, ds.queries)
    adc, refine = padded_kernels(torch, db, cfg, ds.queries)
    retriever_check(torch, "static", db.index, ds.queries, launches,
                    reset_launches, read_launches,
                    needs=("pq_adc", "ternary_refine_fused"))
    retriever_check(torch, "sharded", db.index, ds.queries, launches,
                    reset_launches, read_launches, shards=args.shards,
                    needs=("pq_adc", "ternary_refine_fused_bounds"))
    engine_phase(torch, args, cfg, db, ds, launches, reset_launches,
                 read_launches)
    return adc, refine


def invalidation_phase(torch, args, cfg, index, ds) -> None:
    """One engine over a ``StreamingIndex`` of the 1M index: run, insert
    ``STREAM_BATCH`` near-copies of the queries' true neighbours, run
    again; then over a ``TieredIndex``: run on Zipfian queries,
    ``rebalance_tiers()``, run again.  Each mutation must purge the cache,
    and every response of each second run must equal a fresh sequential
    ``db.query`` (so none equals a stale answer that changed): the
    inserted rows change answers by construction, a migration may not."""
    import numpy as np
    from repro_torch.anns import (Database, QueryPlan, StreamingConfig,
                                  StreamingIndex, TieredConfig, TieredIndex)
    from repro_torch.memory import QueryCost
    from repro_torch.serving import Request, ResultCache, ServingEngine

    def two_runs(label, idx, queries, mutate, *, must_change):
        host = queries.cpu()
        picks = zipf_picks(host.shape[0], SERVE_INVALIDATE, args.seed + 8)
        cache = ResultCache(capacity=4096)
        eng = ServingEngine(idx, plan=QueryPlan(backend="cuda"),
                            max_batch=64, max_wait_us=200.0, cache=cache)

        def requests(t0):
            return [Request(query=host[picks[i]],
                            arrival_us=t0 + i * SERVE_GAP_US,
                            rid=i) for i in range(SERVE_INVALIDATE)]

        first = eng.run(requests(0.0))
        inv0 = cache.stats.invalidations
        out, mut_s = timed(torch, mutate)
        if cache.stats.invalidations <= inv0 or len(cache):
            fail(f"{label}: the mutation purged no cache entry "
                 f"({cache.stats.invalidations - inv0} invalidations, "
                 f"{len(cache)} left)")
        eng.total_cost = QueryCost()
        second = eng.run(requests(eng.clock.now_us))
        check_responses(torch, f"{label} (after the mutation)",
                        Database.wrap(idx), eng, second, picks, queries, {})
        changed = sum(not np.array_equal(a.ids, b.ids)
                      for a, b in zip(first, second))
        if must_change and not changed:
            fail(f"{label}: no answer changed across the mutation; the "
                 f"stale-entry check is void")
        print(f"{label}: {out} in {mut_s:.3f} s purged "
              f"{cache.stats.invalidations - inv0} entries; after it "
              f"{changed} of {SERVE_INVALIDATE} responses changed, every "
              f"response equal to a fresh sequential db.query (no stale "
              f"entry served)")

    st = StreamingIndex(index, StreamingConfig(auto_compact=False))
    gen = torch.Generator(device=index.device).manual_seed(args.seed + 9)
    near = ds.gt[:, :STREAM_BATCH // ds.gt.shape[0]].reshape(-1)
    x_new = ds.x[near.long()] + 1e-3 * torch.randn(
        (near.numel(), ds.x.shape[1]), generator=gen, device=index.device)
    two_runs("engine invalidation, streaming insert", st, ds.queries,
             lambda: f"{st.insert(x_new).size} rows inserted (near-copies "
                     f"of the queries' true neighbours)", must_change=True)
    del st, x_new
    gc.collect()
    ti = TieredIndex(index, TieredConfig(decay=0.5, hot_rows_frac=0.1,
                                         cold_rows_frac=0.2))
    two_runs("engine invalidation, tiered rebalance_tiers", ti,
             zipf_queries(torch, ds.x, ZIPF_QUERIES, args.seed),
             lambda: f"rebalance_tiers() to (lists, rows) "
                     f"{ti.rebalance_tiers()['occupancy']}",
             must_change=False)


# the RAG phase: the LM at full width over an index of its width
RAG_ARCH = "qwen2.5-3b"
RAG_REQUESTS, RAG_PROMPT, RAG_K, RAG_STEPS = 8, 32, 5, 16
LM_CHECK_STEPS = 8             # teacher-forced decode steps held to forward
LM_TOL = 2e-3                  # decode ≡ forward, tests/test_models.py's
RAG_RECALL_SHARE = 0.9         # fatrq's recall@10 against baseline's
RAG_RECALL1 = 0.99             # recall@1 of the RAG index's fatrq path


# the other model families at full width, after the RAG phase: their
# parameter counts as the JAX package's init has them (``jax.eval_shape``
# at the published configs; tests/test_torch_ssm.py and
# tests/test_torch_whisper.py hold these constants to it)
FAMILY_PARAMS = {"zamba2-1.2b": 1_170_313_344, "xlstm-1.3b": 3_982_592_000,
                 "whisper-medium": 846_077_952}


def lm_bounds(model, cfg, batch: int, prompt: int, context: int
              ) -> tuple[tuple, tuple]:
    """The least time of a prefill of ``batch`` prompts of ``prompt``
    tokens and of one decode step at ``context`` cached positions:
    every weight read once (float32) plus the cache written or read; the
    operations are 2 per weight of the blocks per token, the tied LM head
    on one position per sequence, and the attention's QK and PV products
    over the causal positions."""
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    head = cfg.vocab * cfg.d_model
    blocks = cfg.params_count() - head * (1 if cfg.tie_embeddings else 2)
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * 4 * cfg.n_layers
    attn = 4 * cfg.n_heads * cfg.hd * cfg.n_layers
    prefill = bound("lm prefill", weight_bytes + batch * prompt * kv_row,
                    batch * (2 * blocks * prompt + 2 * head
                             + attn * prompt * (prompt + 1) // 2))
    decode = bound("lm decode step",
                   weight_bytes + batch * (context + 1) * kv_row,
                   batch * (2 * blocks + 2 * head + attn * (context + 1)))
    return prefill, decode


def runtime_calls(torch, fn) -> dict:
    """The CUDA API calls (``cuda*`` and ``cu*``) the host made inside
    ``fn``, by name and count, from one run under ``torch.profiler``
    (empty if it recorded none)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("under_test"):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    span = [e.time_range for e in events if e.name == "under_test"]
    if not span:
        return {}
    lo, hi = span[0].start, span[0].end
    out: dict = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("cu") and not e.name.startswith(
                    "cutlass") and lo <= e.time_range.start <= hi):
            out[e.name] = out.get(e.name, 0) + 1
    return out


@contextlib.contextmanager
def no_host_sync(torch, label: str):
    """Run the body with any host synchronize raising
    (``torch.cuda.set_sync_debug_mode("error")``); fail naming ``label``
    if one did."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        fail(f"{label} synchronized the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def sync_free(torch, engine):
    """``engine`` with its ``decode`` run under ``no_host_sync`` and timed
    to a synchronize (the seconds summed in ``engine.decode_s``)."""
    decode = engine.decode
    engine.decode_s = 0.0

    def checked(tokens, steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with no_host_sync(torch, "a decode step"):
            out = decode(tokens, steps)
        torch.cuda.synchronize()
        engine.decode_s += time.perf_counter() - t
        return out

    engine.decode = checked
    return engine


def blocking_of(calls: dict) -> dict:
    """The synchronizes and blocking copies or memsets among ``calls``."""
    return {n: c for n, c in calls.items() if "Synchronize" in n or (
        ("Memcpy" in n or "Memset" in n) and "Async" not in n)}


def host_syncs(torch, fn) -> int:
    """The times ``fn`` blocks the host on the card, counted from calls
    rather than from profiler events, which a run may drop: the
    synchronizing operations PyTorch reports under
    ``torch.cuda.set_sync_debug_mode("warn")`` (a copy to the host, a
    stream synchronize: one ``cudaStreamSynchronize`` each) plus the calls
    of ``torch.cuda.synchronize`` (a ``cudaDeviceSynchronize``, which that
    mode does not report)."""
    import warnings
    torch.cuda.synchronize()
    real, calls = torch.cuda.synchronize, []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    torch.cuda.synchronize = counted
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.cuda.synchronize = real
    real()
    return len(calls) + sum("synchronizing CUDA operation" in str(w.message)
                            for w in caught)


def check_syncs(label: str, syncs: int, calls: dict) -> None:
    """Fail if the profiler's runtime calls ``calls`` hold more blocking
    calls than the ``host_syncs`` count ``syncs`` of the same work: one
    that the count cannot see (a profiler may drop events, never add
    them)."""
    seen = sum(blocking_of(calls).values())
    if seen > syncs:
        fail(f"{label}: the profiler recorded blocking calls "
             f"{blocking_of(calls)}, more than the {syncs} host "
             f"synchronizes counted")


def blocking_calls(torch, label: str, fn) -> None:
    """Fail if ``fn`` blocks the host (``host_syncs``), or if its CUDA
    runtime calls (``runtime_calls``) include a synchronize or a blocking
    copy or memset."""
    syncs = host_syncs(torch, fn)
    if syncs:
        fail(f"{label} blocked the host {syncs} times")
    calls = runtime_calls(torch, fn)
    check_syncs(label, 0, calls)
    print(f"{label}: no host synchronize; runtime calls: {calls}, none "
          f"blocks the host" if calls
          else f"{label}: no host synchronize; runtime calls: not "
          f"measured (the profiler recorded no CUDA runtime call)")


def rag_phase(torch, args, launches, reset_launches, read_launches
              ) -> tuple[dict, object]:
    """Phase 9: the RAG round trip at the full width of qwen2.5-3b over a
    1M x 2048 index (the LM's d_model).  Returns the ``rag`` entries of
    ``pq_adc`` and the fused kernel, measured at the round trip's own
    shape (its 8 embedded prompts, k = 5), and the index's ``Database``
    (the LM is freed on return); ``launches`` gains ``rag`` (the
    ``Retriever`` form) and ``rag_serving`` (the ``ServingEngine``
    form)."""
    from repro_torch.anns import Database, PipelineConfig, QueryPlan, \
        recall_at_k
    from repro_torch.configs import ARCHS
    from repro_torch.data import make_dataset
    from repro_torch.data.synthetic import brute_force_topk
    from repro_torch.models import build_model, transformer
    from repro_torch.serving import (Engine, Retriever, ServingEngine,
                                     rag_answer)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    print(f"rag phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
          f"allocated from the earlier phases")
    lm_cfg = ARCHS[RAG_ARCH]
    dim = lm_cfg.d_model

    # ---- the index, at the LM's width
    t = time.perf_counter()
    ds = make_dataset(n=args.n, d=dim, n_queries=args.queries, k_gt=100,
                      generator=torch.Generator(device="cuda")
                      .manual_seed(args.seed))
    torch.cuda.synchronize()
    print(f"rag dataset {args.n} x {dim}, {args.queries} queries, exact "
          f"top-100: {time.perf_counter() - t:.1f} s")
    cfg = PipelineConfig(dim=dim, pq_m=128, pq_k=256, nlist=1024, nprobe=16,
                         trq_levels=1, final_k=10, refine_budget=40,
                         bound="cauchy", micro_batch=64)
    db, build_s = timed(torch, lambda: Database.build(
        ds.x, cfg, generator=torch.Generator(device="cuda")
        .manual_seed(args.seed)))
    index = db.index
    print(f"rag index build ({args.n} x {dim}, PQ M={cfg.pq_m} "
          f"K={cfg.pq_k}, nlist {cfg.nlist}, G "
          f"{index.trq.levels[0].packed.shape[1]}): {build_s:.1f} s (IVF "
          f"cap {index.ivf.cap}; peak so far "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB)")
    plan = QueryPlan(backend="cuda")
    res, secs = timed(torch, lambda: db.query(ds.queries, plan=plan))
    base = db.query(ds.queries, plan=QueryPlan(mode="baseline"))
    nq = ds.queries.shape[0]
    recall = {label: (recall_at_k(r.ids, ds.gt, cfg.final_k),
                      recall_at_k(r.ids[:, :1], ds.gt, 1))
              for label, r in (("fatrq", res), ("baseline", base))}
    print(f"rag index: recall@10 fatrq {recall['fatrq'][0]:.4f}, baseline "
          f"(every candidate reranked exactly) {recall['baseline'][0]:.4f}; "
          f"recall@1 {recall['fatrq'][1]:.4f} and "
          f"{recall['baseline'][1]:.4f}; fatrq {nq / secs:.1f} queries/s "
          f"(first run), SSD fetches/query "
          f"{res.cost.ledger['rerank:ssd'].accesses / nq:.1f}")
    # At this width the synthetic rows are diffuse: the true neighbours
    # after the first lie in many lists, so nprobe 16 lists hold only a
    # third of them and no rerank of the candidates can reach 0.5.  What
    # a broken path would break is held instead: fatrq within a tenth of
    # the exact rerank of the same candidates, and each query's nearest
    # row found.
    if recall["fatrq"][0] < RAG_RECALL_SHARE * recall["baseline"][0]:
        fail(f"rag index: fatrq recall@10 {recall['fatrq'][0]:.4f} below "
             f"{RAG_RECALL_SHARE} of baseline's "
             f"{recall['baseline'][0]:.4f}")
    if recall["fatrq"][1] < RAG_RECALL1:
        fail(f"rag index: recall@1 {recall['fatrq'][1]:.4f} below "
             f"{RAG_RECALL1}")
    ledger = lambda c: {k: (v.accesses, v.bytes)              # noqa: E731
                        for k, v in c.ledger.items()}
    sub = ds.queries[:64]
    ref = db.query(sub, plan=QueryPlan(backend="reference", micro_batch=8))
    cud = db.query(sub, plan=plan)
    if not torch.equal(ref.ids, cud.ids) or \
            ledger(ref.cost) != ledger(cud.cost):
        fail("rag index: the reference and cuda backends differ (ids or "
             "ledger)")
    print(f"rag index: the reference backend on {sub.shape[0]} queries "
          f"gives the cuda backend's ids and ledger")
    path_kernels(torch, db, cfg, ds.queries[:64].contiguous(),
                 "rag dataset queries")
    del res, base, ref, cud, sub, ds
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the LM at full width, float32
    api = build_model(lm_cfg)
    model, init_s = timed(torch, lambda: api.init(
        torch.Generator(device="cuda").manual_seed(args.seed)))
    matrices = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    total = sum(p.numel() for p in model.parameters())
    print(f"rag LM {lm_cfg.name}: {lm_cfg.n_layers} layers, d_model "
          f"{lm_cfg.d_model}, {lm_cfg.n_heads} heads, {lm_cfg.n_kv_heads} KV "
          f"heads, head dim {lm_cfg.hd}, d_ff {lm_cfg.d_ff}, vocab "
          f"{lm_cfg.vocab}: {matrices:,} parameters in its matrices "
          f"(params_count() {lm_cfg.params_count():,}), {total:,} with norms "
          f"and biases, float32, drawn in {init_s:.1f} s")
    if matrices != lm_cfg.params_count():
        fail(f"the LM has {matrices} matrix parameters, params_count() says "
             f"{lm_cfg.params_count()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    n_check = RAG_PROMPT + LM_CHECK_STEPS
    toks = torch.randint(0, lm_cfg.vocab, (RAG_REQUESTS, n_check),
                         generator=gen, device=gen.device)
    with torch.no_grad():
        full = api.forward(model, {"tokens": toks})[0][:, RAG_PROMPT - 1:]
    cache = api.init_cache(model, RAG_REQUESTS, n_check)
    last, cache = transformer.prefill(model, toks[:, :RAG_PROMPT], lm_cfg,
                                      cache)
    got = [last]
    for t in range(RAG_PROMPT, n_check):
        logits, cache = api.decode_step(model, toks[:, t:t + 1], cache)
        got.append(logits)
    ok, err = close(torch.stack(got, 1), full, LM_TOL, LM_TOL)
    if not ok:
        fail(f"rag LM: prefill and decode logits differ from forward's (max "
             f"err {err})")
    print(f"rag LM: prefill of {RAG_REQUESTS} x {RAG_PROMPT} tokens and "
          f"{LM_CHECK_STEPS} teacher-forced decode steps equal one forward "
          f"of {n_check} tokens within {LM_TOL} (max err {err:.3g}, logits "
          f"up to {float(full.abs().max()):.3g})")
    del full, got
    c32 = transformer.prefill(model, toks[:, :RAG_PROMPT], lm_cfg,
                              api.init_cache(model, RAG_REQUESTS,
                                             n_check))[1]
    prefill_ms = time_ms(lambda: transformer.prefill(
        model, toks[:, :RAG_PROMPT], lm_cfg, c32), 5)
    step_tok = toks[:, RAG_PROMPT:RAG_PROMPT + 1]

    def one_step():
        """Decode step 33 again: the cache is written in place, so its
        length goes back to the prompt's before each call."""
        c32["len"] = RAG_PROMPT
        return api.decode_step(model, step_tok, c32)

    step_ms = time_ms(one_step, 20)
    (pre_bound, pre_by), (dec_bound, dec_by) = lm_bounds(
        model, lm_cfg, RAG_REQUESTS, RAG_PROMPT, RAG_PROMPT)
    print(f"rag LM prefill ({RAG_REQUESTS} x {RAG_PROMPT} tokens): "
          f"{prefill_ms:.3f} ms, bound {pre_bound:.3f} ms ({pre_by}); decode "
          f"step (batch {RAG_REQUESTS}, {RAG_PROMPT} cached): {step_ms:.3f} "
          f"ms, bound {dec_bound:.3f} ms ({dec_by})")
    device_breakdown(torch, "rag LM prefill", lambda: transformer.prefill(
        model, toks[:, :RAG_PROMPT], lm_cfg, c32))
    device_breakdown(torch, "rag LM decode step", one_step)
    del c32, cache, toks

    # ---- the round trip, through a Retriever and through a ServingEngine
    prompts = torch.randint(0, lm_cfg.vocab, (RAG_REQUESTS, RAG_PROMPT),
                            generator=gen, device=gen.device)

    def embed_fn(tokens):
        """JAX ``launch/serve.py``'s: mean-pooled token embeddings,
        normalised."""
        with torch.no_grad():
            e = model.embed_tokens(tokens).mean(dim=1)
            return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

    max_len = RAG_PROMPT + RAG_STEPS
    q = embed_fn(prompts)
    # the two kernels against their plain versions at the round trip's
    # shape: the rows that the kernels line reports for rag
    adc, refine = path_kernels(torch, db, cfg, q, "rag round-trip",
                               k=RAG_K)[:2]
    want = db.query(q, plan=dataclasses.replace(plan, k=RAG_K))
    out = {}
    for form in ("rag", "rag_serving"):
        engine = sync_free(torch, Engine(api, model, batch=RAG_REQUESTS,
                                         max_len=max_len))
        kw = ({"retriever": Retriever(index=db, backend="cuda",
                                      micro_batch=8)} if form == "rag" else
              {"serving": ServingEngine(db, plan=plan,
                                        max_batch=RAG_REQUESTS)})
        reset_launches()
        res, secs = timed(torch, lambda: rag_answer(
            engine, index, embed_fn, prompts, k=RAG_K,
            decode_steps=RAG_STEPS, **kw))
        launches[form] = read_launches()
        for name in ("pq_adc", "ternary_refine_fused"):
            if launches[form][name] == 0:
                fail(f"the {form} round trip never launched {name}")
        ids = res.ids.to(want.ids.device)
        if not torch.equal(ids, want.ids):
            fail(f"{form}: the round trip's ids differ from db.query's in "
                 f"{int((ids != want.ids).any(1).sum())} requests")
        if res.tokens.shape != (RAG_REQUESTS, RAG_STEPS) or \
                engine.stats.tokens != RAG_REQUESTS * RAG_STEPS:
            fail(f"{form}: tokens {tuple(res.tokens.shape)}, stats "
                 f"{engine.stats}")
        out[form] = res
        print(f"{form}: {RAG_REQUESTS} requests of {RAG_PROMPT} tokens, "
              f"k={RAG_K}, {RAG_STEPS} decode steps: ids equal to db.query's "
              f"bit for bit; {secs * 1e3:.1f} ms round trip, decode "
              f"{engine.decode_s * 1e3:.1f} ms "
              f"({RAG_REQUESTS * RAG_STEPS / engine.decode_s:.1f} tokens/s, "
              f"{engine.decode_s / RAG_STEPS * 1e3:.3f} ms a step, no host "
              f"synchronize); launches {launches[form]}; ledger "
              f"{ledger(res.cost)}")
    a, b = out["rag"], out["rag_serving"]
    if not (torch.equal(a.ids.to(b.ids.device), b.ids)
            and torch.equal(a.tokens, b.tokens)):
        fail("the Retriever and ServingEngine round trips differ")
    # the CUDA runtime calls of two decode steps, from the profiler: no
    # synchronize and no blocking copy may be among them
    engine = Engine(api, model, batch=RAG_REQUESTS, max_len=max_len)
    blocking_calls(torch, "rag decode of 2 steps", lambda: engine.decode(
        prompts[:, -1:].int(), 2))
    gt = brute_force_topk(index.x, q, RAG_K)
    print(f"rag: the Retriever and ServingEngine forms give equal ids and "
          f"tokens; recall@{RAG_K} of the retrievals against exact top-"
          f"{RAG_K}: {recall_at_k(a.ids, gt, RAG_K):.4f}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"rag phase: {time.perf_counter() - t_phase:.1f} s, peak device "
          f"memory {peak:.1f} GB")
    if peak >= PEAK_GB:
        fail(f"rag phase: peak device memory {peak:.1f} GB reaches "
             f"{PEAK_GB} GB")
    adc["launches"] = launches["rag"]["pq_adc"]
    refine["launches"] = launches["rag"]["ternary_refine_fused"]
    return {"pq_adc": adc, "ternary_refine_fused": refine}, db


FAMILY_ARCHS = ("zamba2-1.2b", "xlstm-1.3b", "whisper-medium")
# decode ≡ forward, tests/test_models.py's bounds
FAMILY_TOL = {"zamba2-1.2b": 5e-3, "xlstm-1.3b": 5e-3,
              "whisper-medium": 2e-3}
FAMILY_CHECK = RAG_PROMPT + LM_CHECK_STEPS   # teacher-forced decode steps
FAMILY_RAG = {"zamba2-1.2b": "rag_zamba2", "xlstm-1.3b": "rag_xlstm"}


def _cache_tensors(cache: dict, prefix: str = ""):
    for key, value in cache.items():
        if isinstance(value, dict):
            yield from _cache_tensors(value, f"{prefix}{key}.")
        elif key != "len":
            yield prefix + key, value


def family_step_bound(model, cfg, cache: dict, batch: int, pos: int
                      ) -> tuple[float, str]:
    """The least time of one decode step at batch ``batch`` with ``pos``
    positions cached.  Bytes: every weight the step reads once (the
    embedding rows and the one decoder position it gathers; not the
    encoder, nor the cross-attention K/V projections that the prefill
    applied), each recurrent state read and written, the self-attention
    caches' ``pos`` + 1 rows read and one written, the cross K/V read.
    Operations: 2 per matrix weight and sequence (zamba2's shared block
    at each of its g positions), 4 per attention score over the positions
    attended, 4 per recurrent state element."""
    weight_bytes, macs = 0, 0
    shared = 0
    for name, p in model.named_parameters():
        row = cfg.d_model * p.element_size()
        if name == "embed":
            weight_bytes += batch * row
            continue
        if name == "dec_pos":
            weight_bytes += row
            continue
        if name.startswith("enc_") or ".xattn.wk." in name \
                or ".xattn.wv." in name:
            continue
        weight_bytes += p.numel() * p.element_size()
        if p.dim() >= 2:
            macs += p.numel()
            if name.startswith("shared_attn."):
                shared += p.numel()
    if cfg.family == "hybrid":
        macs += (cfg.n_layers // cfg.attn_every - 1) * shared
    state_bytes, ops = 0, 2.0 * batch * macs
    for name, t in _cache_tensors(cache):
        nbytes = t.numel() * t.element_size()
        if name in ("k", "v", "attn_k", "attn_v"):
            layers = t.shape[0]
            state_bytes += nbytes * (pos + 2) / t.shape[2]
            ops += 2 * batch * layers * cfg.n_heads * cfg.hd * (pos + 1)
        elif name in ("xk", "xv"):
            state_bytes += nbytes
            ops += 2 * t.numel() // cfg.n_kv_heads * cfg.n_heads
        else:
            state_bytes += 2 * nbytes
            ops += 4 * t.numel()
    print(f"{cfg.name} decode step: weights read {weight_bytes / 1e9:.3f} "
          f"GB, state and caches read and written {state_bytes / 1e9:.3f} "
          f"GB")
    return bound(f"{cfg.name} decode step", weight_bytes + state_bytes, ops)


def families_phase(torch, args, db, launches, reset_launches,
                   read_launches) -> None:
    """Phase 10: zamba2-1.2b, xlstm-1.3b and whisper-medium at their
    published widths and depths in float32 with random weights from
    ``--seed``, one at a time: the parameter count equal to the JAX
    package's (``FAMILY_PARAMS``); 8 x 40 teacher-forced decode steps
    (whisper's after ``prefill_encoder`` on seeded frames (8, 1500, 1024))
    equal to one forward in float64 within ``FAMILY_TOL``, every step with
    host synchronizes raising (the float32 forward's distance to both
    printed); one decode step at batch 8 timed (20 runs)
    beside its bound (``family_step_bound``) and profiled once; no
    blocking CUDA runtime call among two ``Engine`` steps; for zamba2 and
    xlstm the RAG round trip over ``db`` (the 1M x 2048 index: 8 requests
    of 32 tokens, k = 5, 16 decode steps, through a ``Retriever``): ids
    equal to ``db.query``'s, ``pq_adc`` and the fused kernel launched
    (``launches`` gains ``rag_zamba2`` and ``rag_xlstm``); for whisper
    ``launch.serve``'s path, ``Engine.prefill`` of the frames and 16
    ``Engine.decode`` steps at batch 8.  Then the phase's time and peak
    memory (under 70 GB)."""
    from repro_torch.anns import QueryPlan
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, Retriever, rag_answer
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    print(f"families phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated (the RAG index)")
    n, dev = RAG_REQUESTS, db.index.device
    for name in FAMILY_ARCHS:
        cfg = ARCHS[name]
        api = build_model(cfg)
        model, init_s = timed(torch, lambda: api.init(
            torch.Generator(device=dev).manual_seed(args.seed)))
        total = sum(p.numel() for p in model.parameters())
        print(f"{name}: {cfg.n_layers} layers"
              + (f" (+{cfg.n_enc_layers} encoder, {cfg.enc_frames} frames)"
                 if cfg.enc_dec else "")
              + f", d_model {cfg.d_model}, {cfg.n_heads} heads, vocab "
              f"{cfg.vocab}: {total:,} parameters (JAX's init: "
              f"{FAMILY_PARAMS[name]:,}), float32, drawn in {init_s:.1f} s")
        if total != FAMILY_PARAMS[name]:
            fail(f"{name} has {total} parameters, the JAX package's init "
                 f"{FAMILY_PARAMS[name]}")
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        toks = torch.randint(0, cfg.vocab, (n, FAMILY_CHECK), generator=gen,
                             device=dev)
        batch = {"tokens": toks}
        if cfg.enc_dec:
            batch["frames"] = torch.randn((n, cfg.enc_frames, cfg.d_model),
                                          generator=gen, device=dev)
        with torch.no_grad():
            full, fwd_s = timed(torch, lambda: api.forward(model, batch)[0])
            # the same forward with the weights and inputs in float64 (the
            # gates the reference computes in float32 stay float32): the
            # reference the decode is held to, since at these widths
            # xlstm's float32 chunked forward is itself further from it
            # than the bound (PERF.md §6)
            model.double()
            full64 = api.forward(model, {
                k: v.double() if v.is_floating_point() else v
                for k, v in batch.items()})[0]
            model.float()
        cache = api.init_cache(model, n, FAMILY_CHECK)
        if cfg.enc_dec:
            cache, pre_s = timed(torch, lambda: api.prefill(
                model, {"frames": batch["frames"]}, cache))
            print(f"{name} prefill_encoder of {n} x {cfg.enc_frames} "
                  f"frames: {pre_s * 1e3:.1f} ms")
        got = []
        with no_host_sync(torch, f"a {name} decode step"):
            for t in range(FAMILY_CHECK):
                logits, cache = api.decode_step(model, toks[:, t:t + 1],
                                                cache)
                got.append(logits)
        got = torch.stack(got, 1)
        tol = FAMILY_TOL[name]
        ok, err = close(got.double(), full64, tol, tol)
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"{name}: teacher-forced decode differs from the float64 "
                 f"forward's logits (max err {err})")
        err32 = close(got, full, tol, tol)[1]
        fwd_err = close(full.double(), full64, tol, tol)[1]
        print(f"{name}: {FAMILY_CHECK} teacher-forced decode steps at batch "
              f"{n} equal one forward in float64 within {tol} (max err "
              f"{err:.3g}, logits up to {float(full64.abs().max()):.3g}); "
              f"the float32 forward ({fwd_s * 1e3:.1f} ms) is {fwd_err:.3g} "
              f"from the float64 one and {err32:.3g} from the decode; no "
              f"step synchronized the host")
        del full, full64, got
        step_tok = toks[:, RAG_PROMPT:RAG_PROMPT + 1]

        def one_step():
            """A decode step at position 32 again (a recurrent state just
            advances)."""
            cache["len"] = RAG_PROMPT
            return api.decode_step(model, step_tok, cache)

        step_ms = time_ms(one_step, 20)
        b_ms, b_by = family_step_bound(model, cfg, cache, n, RAG_PROMPT)
        print(f"{name} decode step (batch {n}, {RAG_PROMPT} positions "
              f"before it): {step_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
        device_breakdown(torch, f"{name} decode step", one_step)
        del cache, toks, batch, one_step, step_tok, logits
        gc.collect()

        # the Engine: whisper prefills its encoder first, as launch.serve
        max_len = RAG_PROMPT + RAG_STEPS
        frames = torch.randn((n, cfg.enc_frames, cfg.d_model),
                             generator=gen, device=dev) \
            if cfg.enc_dec else None
        seed = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        engine = Engine(api, model, batch=n, max_len=max_len)
        if cfg.enc_dec:
            engine.prefill({"frames": frames})
        blocking_calls(torch, f"{name} Engine decode of 2 steps",
                       lambda: engine.decode(seed, 2))
        del engine
        engine = sync_free(torch, Engine(api, model, batch=n,
                                         max_len=max_len))
        if name not in FAMILY_RAG:
            engine.prefill({"frames": frames})
            out = engine.decode(seed, RAG_STEPS)
            if out.shape != (n, RAG_STEPS) or \
                    engine.cache["len"] != RAG_STEPS:
                fail(f"{name} Engine: tokens {tuple(out.shape)}, cache "
                     f"length {engine.cache['len']}")
            print(f"{name} Engine (launch.serve's path): prefill of {n} x "
                  f"{cfg.enc_frames} frames, then {RAG_STEPS} decode steps "
                  f"at batch {n}: {n * RAG_STEPS / engine.decode_s:.1f} "
                  f"tokens/s, {engine.decode_s / RAG_STEPS * 1e3:.3f} ms a "
                  f"step, no host synchronize")
        else:
            prompts = torch.randint(0, cfg.vocab, (n, RAG_PROMPT),
                                    generator=gen, device=dev)

            def embed_fn(tokens):
                """Mean-pooled token embeddings, normalised (JAX
                ``launch/serve.py``'s)."""
                with torch.no_grad():
                    e = model.embed_tokens(tokens).mean(dim=1)
                    return e / torch.linalg.vector_norm(e, dim=-1,
                                                        keepdim=True)

            want = db.query(embed_fn(prompts),
                            plan=QueryPlan(backend="cuda", k=RAG_K))
            path = FAMILY_RAG[name]
            reset_launches()
            res, secs = timed(torch, lambda: rag_answer(
                engine, db.index, embed_fn, prompts, k=RAG_K,
                decode_steps=RAG_STEPS, retriever=Retriever(
                    index=db, backend="cuda", micro_batch=8)))
            launches[path] = read_launches()
            for kernel in ("pq_adc", "ternary_refine_fused"):
                if launches[path][kernel] == 0:
                    fail(f"the {path} round trip never launched {kernel}")
            ids = res.ids.to(want.ids.device)
            if not torch.equal(ids, want.ids):
                fail(f"{path}: the round trip's ids differ from db.query's "
                     f"in {int((ids != want.ids).any(1).sum())} requests")
            if res.tokens.shape != (n, RAG_STEPS):
                fail(f"{path}: tokens {tuple(res.tokens.shape)}")
            print(f"{path}: {n} requests of {RAG_PROMPT} tokens, k={RAG_K}, "
                  f"{RAG_STEPS} decode steps: ids equal to db.query's bit "
                  f"for bit; {secs * 1e3:.1f} ms round trip, decode "
                  f"{engine.decode_s * 1e3:.1f} ms "
                  f"({n * RAG_STEPS / engine.decode_s:.1f} tokens/s, "
                  f"{engine.decode_s / RAG_STEPS * 1e3:.3f} ms a step, no "
                  f"host synchronize); launches {launches[path]}")
            del embed_fn, want, res, ids, prompts
        del engine, model, api, frames
        gc.collect()
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"families phase: {time.perf_counter() - t_phase:.1f} s, peak "
          f"device memory {peak:.1f} GB")
    if peak >= PEAK_GB:
        fail(f"families phase: peak device memory {peak:.1f} GB reaches "
             f"{PEAK_GB} GB")


# ---- training (phase 11) and the baseline quantizers (in phase 5)

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 128, 6, 3e-4
TRAIN_PASSES = 11              # bytes of the bound: params read 3 times,
#                                grads written once, AdamW's 7 passes
F64_LOSS_RTOL = 1e-5           # float32 step against a float64 copy
F64_GRAD_RTOL = 1e-3           # |g32 − g64| / |g64| over every gradient
REMAT_RTOL = 1e-6              # remat=True against remat=False
RESUME_RTOL = 1e-6             # resumed losses against uninterrupted ones


def grad_norm(torch, grads) -> float:
    """The global L2 norm of a list of tensors, in float64."""
    return float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.double()) for g in grads])))


def rel_dist(torch, a: list, b: list) -> float:
    """|a − b| / |b| over every tensor of the lists, in float64."""
    return grad_norm(torch, [x.double() - y.double() for x, y in zip(a, b)]) \
        / grad_norm(torch, b)


def grads_of(torch, api, model, batch, loss_fn, **kw):
    """(loss as a float, every parameter's gradient) of one backward."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(api, model, batch, **kw)
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def ce_loss64(api, model, batch):
    """``loss_fn``'s cross-entropy with the logits kept in their own
    dtype (``loss_fn`` casts them to float32): the float64 reference."""
    import torch
    logits, aux = api.forward(model, batch)
    lse = torch.logsumexp(logits, dim=-1)
    label = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    return (lse - label).mean() + 0.01 * aux


def train_phase(torch, args, dev="cuda") -> None:
    """Phase 11: training, after every earlier phase's tensors are freed.

    1. qwen2.5-3b at its published configuration (36 layers, d_model 2048,
       3,085,697,024 parameters, tied embeddings), float32 with TF32 off,
       weights from ``--seed``: ``train`` for 6 steps of batch 8 x 128
       tokens at lr 3e-4 on one fixed batch (``extra_batch``; fresh
       uniform tokens sit at the entropy floor), remat on.  Every loss
       finite, no step skipped, the mean of the last two losses below the
       first two's; the median step time over steps 2-5 beside the bound
       max(8·N·T FLOPs / 67 TFLOP/s, 11·4N bytes / 3.35 TB/s), tokens/s,
       peak memory, and one profiled step's device busy and idle share.
    2. The same widths at 2 layers: one step's loss and gradients against
       a float64 copy of the weights and batch (loss within a relative
       1e-5, the gradients' global distance within 1e-3), ``remat=True``
       against ``remat=False`` (1e-6 each), and ``compress_grads`` on
       those gradients (sent + err within 1 ulp of the gradient,
       ``wire_bytes`` about 4x smaller).
    3. The reduced qwen2.5-3b: 4 steps with a checkpoint every 2, and a
       run to step 2 resumed to step 4, whose losses must equal the
       uninterrupted run's within a relative 1e-6; ``restore`` puts every
       leaf on the card, from a like tree on the card or on the CPU."""
    import copy
    import tempfile

    from repro_torch.configs import ARCHS
    from repro_torch.data import make_token_batch
    from repro_torch.models import build_model, loss_fn
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import compression
    from repro_torch.train.loop import TrainConfig, make_step_fn, train
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    print(f"train phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"still allocated from the earlier phases")
    cfg = ARCHS[RAG_ARCH]
    api = build_model(cfg)
    model = api.init(torch.Generator(device=dev).manual_seed(args.seed))
    n_params = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fixed = make_token_batch(torch.Generator().manual_seed(args.seed + 7),
                             TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, device=dev)
    stamps = []

    def extra(gen):
        stamps.append(time.perf_counter())
        return fixed

    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                         seq_len=TRAIN_SEQ, lr=TRAIN_LR, ckpt_every=0,
                         ckpt_dir=tmp, seed=args.seed)
        state = train(api, tc, model=model, resume=False, extra_batch=extra)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    losses = state.losses
    if len(losses) != TRAIN_STEPS or state.skipped or not all(
            math.isfinite(v) for v in losses):
        fail(f"train: losses {losses}, {state.skipped} skipped")
    first, last = sum(losses[:2]) / 2, sum(losses[-2:]) / 2
    if not last < first:
        fail(f"train: the loss did not fall on a fixed batch ({losses})")
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(steps_s[2:])
    b_ms, b_by = bound("train step", TRAIN_PASSES * 4 * n_params,
                       8 * n_params * tokens)
    print(f"train {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params:,} parameters, float32 (TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, lr {TRAIN_LR}, remat: losses "
          f"{[round(v, 6) for v in losses]} (mean of the first two "
          f"{first:.6f}, of the last two {last:.6f}), {state.skipped} "
          f"skipped, {state.stragglers} stragglers")
    print(f"train step: {step_s * 1e3:.3f} ms (median of steps 2-5 of "
          f"{[round(s * 1e3, 3) for s in steps_s]} ms), bound "
          f"{b_ms:.3f} ms ({b_by}); {tokens / step_s:.1f} tokens/s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    step_fn = make_step_fn(api, tc)

    def one_step():
        float(step_fn(model, state.opt, fixed)[0])

    device_breakdown(torch, "train step", one_step)
    print(f"train phase peak device memory (full model): "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model, state, fixed, one_step, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the same widths at 2 layers: float64, remat, compression
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    api2 = build_model(cfg2)
    m32 = api2.init(torch.Generator(device=dev).manual_seed(args.seed))
    batch = make_token_batch(torch.Generator().manual_seed(args.seed + 8),
                             TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, device=dev)
    loss32, g32 = grads_of(torch, api2, m32, batch, loss_fn)
    m64 = copy.deepcopy(m32).double()
    loss64, g64 = grads_of(torch, api2, m64, batch, ce_loss64)
    del m64
    loss_err = abs(loss32 - loss64) / abs(loss64)
    grad_err = rel_dist(torch, g32, g64)
    del g64
    print(f"train step at 2 layers ({sum(p.numel() for p in m32.parameters()):,}"
          f" parameters): float32 against a float64 copy of the weights "
          f"and batch: loss {loss32:.8f} against {loss64:.8f} (relative "
          f"{loss_err:.3g}, limit {F64_LOSS_RTOL}), gradients' global "
          f"distance {grad_err:.3g} (limit {F64_GRAD_RTOL})")
    if not (loss_err <= F64_LOSS_RTOL and grad_err <= F64_GRAD_RTOL):
        fail("train: the float32 step is too far from the float64 one")
    loss_n, g_n = grads_of(torch, api2, m32, batch, loss_fn, remat=False)
    remat_loss = abs(loss32 - loss_n) / abs(loss_n)
    remat_err = rel_dist(torch, g32, g_n)
    remat_max = max(float((a - b).abs().max()) for a, b in zip(g32, g_n))
    del g_n
    print(f"train step at 2 layers: remat=True against remat=False: loss "
          f"relative {remat_loss:.3g}, gradients' global distance "
          f"{remat_err:.3g} (limit {REMAT_RTOL}), max abs {remat_max:.3g}")
    if not (remat_loss <= REMAT_RTOL and remat_err <= REMAT_RTOL):
        fail("train: remat changes the loss or the gradients")
    grads = dict(zip((n for n, _ in m32.named_parameters()), g32))
    sent, err = compression.compress_grads(grads, None)
    worst = 0.0
    for name, g in grads.items():
        ulp = torch.nextafter(g.abs(), torch.full_like(g, math.inf)) \
            - g.abs()
        off = ((sent[name] + err[name] - g).abs() / ulp)
        worst = max(worst, float(off.max()))
    wire = compression.wire_bytes(grads, compressed=True)
    wire32 = compression.wire_bytes(grads, compressed=False)
    print(f"compress_grads at 2 layers: sent + err within {worst:.3g} ulp "
          f"of the gradients; wire bytes {wire:,} against {wire32:,} in "
          f"float32 ({wire32 / wire:.3f}x fewer)")
    if worst > 1.0 or wire32 / wire < 3.9:
        fail("train: compress_grads is not error-feedback exact or not ~4x")
    del m32, g32, grads, sent, err, batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the reduced model: checkpoint and resume on the card
    api_r = build_model(cfg.reduced())
    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(steps=4, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                         lr=TRAIN_LR, ckpt_every=2,
                         ckpt_dir=os.path.join(tmp, "a"), seed=args.seed)
        whole = train(api_r, tc, resume=False, device=dev)
        cut = dataclasses.replace(tc, steps=2,
                                  ckpt_dir=os.path.join(tmp, "b"))
        train(api_r, cut, resume=False, device=dev)
        resumed = train(api_r, dataclasses.replace(cut, steps=4),
                        resume=True, device=dev)
        errs = [abs(a - b) / abs(b)
                for a, b in zip(resumed.losses, whole.losses[2:])]
        if resumed.step != 4 or len(resumed.losses) != 2 or \
                max(errs) > RESUME_RTOL:
            fail(f"train: the resumed losses {resumed.losses} differ from "
                 f"the uninterrupted run's {whole.losses[2:]}")
        like = {"params": resumed.params, "opt": resumed.opt}
        on_card = ckpt.restore(cut.ckpt_dir, 2, like)
        cpu_like = {"params": {n: p.detach().cpu()
                               for n, p in resumed.params.items()},
                    "opt": resumed.opt}
        moved = ckpt.restore(cut.ckpt_dir, 2, cpu_like, device=dev)
        leaves = [t for tree in (on_card, moved) for t in
                  ckpt._flatten(tree).values() if isinstance(t, torch.Tensor)]
        if not all(t.device.type == torch.device(dev).type for t in leaves):
            fail("train: restore left a leaf off the card")
    print(f"train checkpoint round trip ({cfg.name} reduced, on the card): "
          f"losses of a run resumed at step 2 {resumed.losses} equal the "
          f"uninterrupted run's {whole.losses[2:]} within {max(errs):.3g} "
          f"(limit {RESUME_RTOL}); restore put all {len(leaves)} leaves on "
          f"the card")
    print(f"train phase: {time.perf_counter() - t_phase:.1f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


# ------------------------------------------------------ the LM mesh phase

LM_MESH_LAYERS = 4              # depth of the 4-rank cells (full width)
# an 8 x 34 prompt and 2 decode steps: a 36-position cache, split in 4
# chunks of 9 by flash decode on (1, 4)
LM_MESH_PROMPT, LM_MESH_STEPS = 34, 2
LM_MESH_JOIN_S = 420            # a gloo rank that takes longer is hung
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6           # tests/test_torch_train_grads.py's
LOSS_RTOL = 1e-4                            # tests/test_torch_train.py's


def sync_ms(torch, fn) -> tuple:
    """(fn()'s result, its milliseconds to a synchronize)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def lm_mesh_rank(rank: int, world: int, port: int, path: str, cfg,
                 dev: str = "cuda") -> None:
    """One gloo rank of ``lm_mesh_phase``, on ``cuda:0`` with the others
    (``dev="cpu"`` to rehearse), ``cfg``'s model with the weights mapped
    from ``path/weights.pt``: on the (1, 4) mesh (sequence-sharded cache,
    flash decode) and on the (2, 2) mesh (batch and KV heads split), the
    prefill step that fills this rank's shard of a cache from the
    ``LM_MESH_PROMPT`` prompt, then ``LM_MESH_STEPS`` teacher-forced
    decode steps; on the (2, 2) mesh, one
    ``"2d"`` train step on this rank's rows, with the gradients it hands
    the optimizer compared on its shards with the parent's one-process
    gradients.  Its logits, errors, step times and peak memory to
    ``path/rank{rank}.pt``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.launch.input_specs import params_structs
    from repro_torch.launch.mesh import dp_axes, make_lm_mesh
    from repro_torch.models import build_model
    from repro_torch.train import optimizer

    if dev == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    on = None if dev == "cuda" else dev         # the mesh's device
    try:
        api = build_model(cfg)
        state = torch.load(os.path.join(path, "weights.pt"), mmap=True)
        data = torch.load(os.path.join(path, "inputs.pt"))
        out = {}
        b, p = data["prompt"].shape
        s = p + LM_MESH_STEPS                   # the cache's positions
        kw = dict(dtype=torch.float32)
        for shape in ((1, 4), (2, 2)):
            mesh = make_lm_mesh(shape, ("data", "model"), device=on)
            fill, _, _, _, pmeta = steps.make_prefill_step(
                api, mesh, ShapeConfig("p", p, b, "prefill"), cache_len=s,
                **kw)
            dec, _, _, _, meta = steps.make_decode_step(
                api, mesh, ShapeConfig("d", s, b, "decode"), **kw)
            model = steps.place_model(params_structs(api, torch.float32),
                                      meta["specs"]["params"], mesh,
                                      state=state)
            cache = steps.init_cache(api, b, s, meta["specs"]["cache"], mesh)
            batch = steps.place({"tokens": data["prompt"]},
                                pmeta["specs"]["batch"], mesh)
            torch.cuda.reset_peak_memory_stats()
            (lg, cache), fill_ms = sync_ms(torch, lambda: fill(model, batch,
                                                               cache))
            logits, times = [lg.cpu()], []
            for tok in data["decode"]:
                t = steps.place({"t": tok}, {"t": meta["specs"]["tokens"]},
                                mesh)["t"]
                (lg, cache), ms = sync_ms(torch, lambda: dec(model, t,
                                                             cache))
                logits.append(lg.cpu())
                times.append(ms)
            rows = b // mesh.axis_size(dp_axes(mesh))
            first = mesh.index(dp_axes(mesh)) * rows
            out[shape] = {"logits": torch.stack(logits), "ms": times,
                          "fill_ms": fill_ms, "rows": (first, first + rows),
                          "flash_decode": meta["flash_decode"],
                          "cache_k": tuple(cache["k"].shape),
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            del model, cache, dec, fill
            gc.collect()
            torch.cuda.empty_cache()
        # ---- (2, 2): one "2d" train step on this rank's rows
        mesh = make_lm_mesh((2, 2), ("data", "model"), device=on)
        tokens = data["train"]
        step, _, _, _, meta = steps.make_train_step(
            api, mesh, ShapeConfig("t", tokens["tokens"].shape[1],
                                   tokens["tokens"].shape[0], "train"),
            dtype=torch.float32, lr=TRAIN_LR)
        specs = meta["specs"]["params"]
        model = steps.place_model(params_structs(api, torch.float32), specs,
                                  mesh, batch_axes=meta["batch_axes"],
                                  state=state)
        batch = steps.place(tokens, meta["specs"]["batch"], mesh)
        opt = optimizer.init(model)
        ref = torch.load(os.path.join(path, "grads.pt"), mmap=True)
        errs, real = {}, optimizer.update

        def spy(grads, st, params, **kw):
            # the reduced gradient shards, against the parent's whole
            # gradients cut the same way (each element checked where it
            # is held; a copy on a replicated axis checked once)
            for name, g in grads.items():
                want = sh.shard_of(ref[name], specs[name], mesh).to(
                    g.device)
                d = (g.double() - want.double())
                owner = all(mesh.coords[i] == 0 for i, a in
                            enumerate(mesh.axis_names)
                            if not any(a in sh.spec_axes(e)
                                       for e in specs[name]))
                errs[name] = (float(d.abs().max()),
                              float(d.square().sum()) if owner else 0.0,
                              float(want.double().square().sum())
                              if owner else 0.0)
            return real(grads, st, params, **kw)

        torch.cuda.reset_peak_memory_stats()
        optimizer.update = spy
        try:
            (loss, model, opt), ms = sync_ms(
                torch, lambda: step(model, opt, batch))
        finally:
            optimizer.update = real
        out["train"] = {"loss": float(loss), "ms": ms, "errs": errs,
                        "opt_step": opt.step,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def lm_mesh_phase(torch, args, dev="cuda") -> None:
    """Phase 11, after training: the LM across processes
    (``launch.steps``); ``dev="cpu"`` rehearses it (gloo for NCCL).

    1. One NCCL rank on ``make_host_mesh()``, qwen2.5-3b at its published
       configuration (float32, TF32 off, weights from ``--seed``): the
       prefill step (last-position logits) equal to
       ``transformer.forward``'s, the prefill step that fills a cache of
       36 positions (8 x 34 prompt) equal to ``transformer.prefill``'s,
       then 2 decode steps equal to ``transformer.decode_step``'s, logits
       and cache bit for bit; one train step on 8 x 128 tokens equal to
       ``train.loop.make_step_fn``'s, loss and every updated parameter
       bit for bit; the step times beside the plain path's (prefill after
       a warm-up of each, decode step by step in turns, the train steps
       after those two, two more of each in turns).
    2. Four gloo ranks on the one card at the full width and
       ``LM_MESH_LAYERS`` layers, the weights mapped from one file: on
       (1, 4) (flash decode: qwen2.5-3b's 2 KV heads do not divide 4,
       so the cache's 36 positions are split in 4 chunks) and on (2, 2)
       (each rank 4 rows and one KV head), the prefill step filling the
       rank's shard of the cache from the 8 x 34 prompt, then 2
       teacher-forced decode steps, each rank's logits within ``LM_TOL``
       of the one-process prefill and decode the parent ran on its rows;
       on (2, 2), ``"2d"``, one train
       step whose loss is within 1e-4 of the one-process step's on the
       joined batch and whose reduced gradients are, leaf by leaf, within
       1e-4 · max|leaf| + 1e-6 of its gradients; each rank's step times
       and peak memory, and the phase's wall time (gloo through the host
       on one card: not a multi-GPU throughput).
    3. ``lm_mesh_gaps``: the families' model-axis decode, a sequence
       split over data and the MoE's routing across ranks."""
    import multiprocessing

    import torch.distributed as dist
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import make_token_batch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, loss_fn, transformer
    from repro_torch.train import optimizer
    from repro_torch.train.loop import TrainConfig, make_step_fn
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    cfg = ARCHS[RAG_ARCH]
    api = build_model(cfg)
    b, p, n = TRAIN_BATCH, LM_MESH_PROMPT, LM_MESH_STEPS
    gen = torch.Generator().manual_seed(args.seed + 9)
    prompt = torch.randint(0, cfg.vocab, (b, p), generator=gen).to(dev)
    decode = torch.randint(0, cfg.vocab, (n, b, 1), generator=gen).to(dev)
    train_batch = make_token_batch(
        torch.Generator().manual_seed(args.seed + 10), TRAIN_BATCH,
        TRAIN_SEQ, cfg.vocab, device=dev)

    # ---- one NCCL rank, the host mesh: bit for bit the plain path
    dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_host_mesh(None if dev == "cuda" else dev)
        model = api.init(torch.Generator(device=dev).manual_seed(args.seed))
        n_params = sum(q.numel() for q in model.parameters())
        kw = dict(dtype=torch.float32)
        pre, *_ = steps.make_prefill_step(
            api, mesh, ShapeConfig("p", p, b, "prefill"), **kw)
        fill, *_, pmeta = steps.make_prefill_step(
            api, mesh, ShapeConfig("p", p, b, "prefill"), cache_len=p + n,
            **kw)
        dec, *_ = steps.make_decode_step(
            api, mesh, ShapeConfig("d", p + n, b, "decode"), **kw)
        def forward():
            with torch.no_grad():
                return transformer.forward(model, prompt, cfg,
                                           last_only=True, remat=False)[0]

        forward(), pre(model, {"tokens": prompt})          # warm up
        want, plain_ms = sync_ms(torch, forward)
        got, step_ms = sync_ms(torch, lambda: pre(model,
                                                  {"tokens": prompt}))
        if not torch.equal(got, want):
            fail("lm mesh: the host-mesh prefill step's logits differ from "
                 "transformer.forward's")
        times = {"prefill": (step_ms, plain_ms)}
        plain = transformer.init_cache(cfg, b, p + n, device=dev)
        cache = steps.init_cache(api, b, p + n, pmeta["specs"]["cache"],
                                 mesh)
        (want, plain), plain_ms = sync_ms(torch, lambda: transformer.prefill(
            model, prompt, cfg, plain))
        (got, cache), step_ms = sync_ms(torch, lambda: fill(
            model, {"tokens": prompt}, cache))
        times["prefill, cache"] = (step_ms, plain_ms)
        if not torch.equal(got, want):
            fail("lm mesh: the cache-filling prefill step differs from "
                 "transformer.prefill")
        dec_ms = []
        for tok in decode:
            (want, plain), plain_ms = sync_ms(
                torch, lambda: transformer.decode_step(model, tok, plain,
                                                       cfg))
            (got, cache), step_ms = sync_ms(torch, lambda: dec(model, tok,
                                                               cache))
            dec_ms.append((step_ms, plain_ms))
            if not torch.equal(got, want):
                fail("lm mesh: a host-mesh decode step's logits differ from "
                     "transformer.decode_step's")
        if not (torch.equal(cache["k"], plain["k"]) and
                torch.equal(cache["v"], plain["v"]) and
                cache["len"] == plain["len"] == p + n):
            fail("lm mesh: the host-mesh decode cache differs from the "
                 "plain path's")
        times[f"decode (median of {n})"] = (
            statistics.median(m for m, _ in dec_ms),
            statistics.median(m for _, m in dec_ms))
        del cache, plain, got, want
        # the train step, then make_step_fn from the same seed's weights
        tstep, *_ = steps.make_train_step(
            api, mesh, ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train"),
            lr=TRAIN_LR, **kw)
        loss, model, opt = tstep(model, optimizer.init(model), train_batch)
        stepped = {k: q.detach().cpu() for k, q in model.named_parameters()}
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
        model = api.init(torch.Generator(device=dev).manual_seed(args.seed))
        plain_step = make_step_fn(api, TrainConfig(lr=TRAIN_LR))
        want, model, opt = plain_step(model, optimizer.init(model),
                                      train_batch)
        if not torch.equal(loss, want):
            fail(f"lm mesh: the host-mesh train step's loss {float(loss)} "
                 f"is not make_step_fn's {float(want)}")
        for k, q in model.named_parameters():
            if not torch.equal(q.detach().cpu(), stepped[k]):
                fail(f"lm mesh: {k} after the host-mesh train step differs "
                     f"from make_step_fn's")
        del stepped
        # the times of further steps, each form warm, in turns
        runs = {"step": [], "plain": []}
        for _ in range(2):
            for name, fn in (("step", tstep), ("plain", plain_step)):
                runs[name].append(sync_ms(torch, lambda: fn(
                    model, opt, train_batch))[1])
        times["train (2nd and 3rd steps)"] = (
            statistics.mean(runs["step"]), statistics.mean(runs["plain"]))
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"lm mesh, one NCCL rank, make_host_mesh(): {cfg.name} "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {n_params:,} "
          f"parameters, float32): the prefill step ({b} x {p}), the "
          f"cache-filling prefill, {n} decode steps (logits and cache) and "
          f"a train step ({TRAIN_BATCH} x {TRAIN_SEQ}: loss and every "
          f"parameter) equal to the plain path bit for bit; ms step / plain: "
          + ", ".join(f"{k} {s:.3f} / {q:.3f}" for k, (s, q) in
                      times.items())
          + f"; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # ---- four gloo ranks on the one card
    layers = LM_MESH_LAYERS
    cfg4 = dataclasses.replace(cfg, n_layers=layers)
    api4 = build_model(cfg4)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_")
    procs = []
    try:
        t = time.perf_counter()
        model = api4.init(torch.Generator(device=dev).manual_seed(args.seed))
        n4 = sum(q.numel() for q in model.parameters())
        with torch.no_grad():
            cache = transformer.init_cache(cfg4, b, p + n, device=dev)
            lg, cache = transformer.prefill(model, prompt, cfg4, cache)
            want = [lg.cpu()]
            for tok in decode:
                lg, cache = transformer.decode_step(model, tok, cache, cfg4)
                want.append(lg.cpu())
        want = torch.stack(want)            # (1 + n, b, V)
        del cache
        model.zero_grad(set_to_none=True)
        ref_loss = loss_fn(api4, model, train_batch)
        ref_loss.backward()
        ref_loss = float(ref_loss.detach())
        grads = {k: q.grad.cpu() for k, q in model.named_parameters()}
        gmax = {k: float(g.abs().max()) for k, g in grads.items()}
        torch.save(grads, os.path.join(tmp, "grads.pt"))
        torch.save({k: q.detach().cpu() for k, q in model.named_parameters()},
                   os.path.join(tmp, "weights.pt"))
        torch.save({"prompt": prompt.cpu(), "decode": decode.cpu(),
                    "train": {k: v.cpu() for k, v in train_batch.items()}},
                   os.path.join(tmp, "inputs.pt"))
        del model, grads
        gc.collect()
        torch.cuda.empty_cache()
        save_s = time.perf_counter() - t
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=lm_mesh_rank,
                             args=(r, 4, port, tmp, cfg4, dev))
                 for r in range(4)]
        t = time.perf_counter()
        for q in procs:
            q.start()
        while any(q.is_alive() for q in procs) and \
                time.perf_counter() - t < LM_MESH_JOIN_S and \
                all(q.exitcode in (None, 0) for q in procs):
            time.sleep(0.2)
        wall = time.perf_counter() - t
        codes = [q.exitcode for q in procs]
        if codes != [0] * 4:
            fail(f"lm mesh: gloo ranks exited with {codes} after {wall:.0f} "
                 f"s (None: still running, stopped)")
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(4)]
    finally:
        for q in procs:
            if q.is_alive():
                q.kill()
            q.join()
        shutil.rmtree(tmp, ignore_errors=True)
    worst = {}
    for r, o in enumerate(outs):
        serve = []
        for shape, flash in (((1, 4), True), ((2, 2), False)):
            d = o[shape]
            lo, hi = d["rows"]
            errs = (d["logits"] - want[:, lo:hi]).abs().amax((1, 2))
            if d["flash_decode"] is not flash or float(errs.max()) > LM_TOL:
                fail(f"lm mesh {shape} rank {r}: prefill logits "
                     f"{float(errs[0]):.3g} and decode logits "
                     f"{float(errs[1:].max()):.3g} from the one-process "
                     f"prefill and decode (limit {LM_TOL}), flash decode "
                     f"{d['flash_decode']}")
            serve.append(
                f"{shape} rows {lo}:{hi} prefill {float(errs[0]):.3g}, "
                f"decode {float(errs[1:].max()):.3g} from one process, "
                f"cache shard {d['cache_k']}, prefill "
                f"{d['fill_ms']:.1f} ms, decode ms "
                f"{[round(m, 1) for m in d['ms']]}, peak "
                f"{d['peak_gb']:.2f} GB")
        tr = o["train"]
        loss_err = abs(tr["loss"] - ref_loss) / abs(ref_loss)
        if loss_err > LOSS_RTOL or tr["opt_step"] != 1:
            fail(f"lm mesh (2, 2) rank {r}: loss {tr['loss']} against the "
                 f"one-process {ref_loss} (relative {loss_err:.3g})")
        for k, (mx, _, _) in tr["errs"].items():
            if mx > GRAD_RTOL * gmax[k] + GRAD_ATOL:
                fail(f"lm mesh (2, 2) rank {r}: gradient {k} off by {mx:.3g}"
                     f" (limit {GRAD_RTOL * gmax[k] + GRAD_ATOL:.3g})")
            worst[k] = max(worst.get(k, 0.0), mx / (gmax[k] or 1.0))
        print(f"lm mesh rank {r}: " + "; ".join(serve) +
              f"; (2, 2) train loss {tr['loss']:.6f} (one process "
              f"{ref_loss:.6f}, relative {loss_err:.3g}), step "
              f"{tr['ms']:.1f} ms, peak {tr['peak_gb']:.2f} GB")
    sq = sum(e[1] for o in outs for e in o["train"]["errs"].values())
    ref_sq = sum(e[2] for o in outs for e in o["train"]["errs"].values())
    print(f"lm mesh: {cfg4.name} at {layers} layers, full width "
          f"({n4:,} parameters, float32); 4 gloo ranks on one card (each "
          f"collective through the host; not a multi-GPU throughput): "
          f"(2, 2) gradients' global relative distance "
          f"{math.sqrt(sq / ref_sq):.3g}, worst leaf max|diff|/max|leaf| "
          f"{max(worst.values()):.3g} (limit {GRAD_RTOL} + {GRAD_ATOL}); "
          f"{wall:.1f} s wall from spawn to the last exit, reference and "
          f"files {save_s:.1f} s; phase {time.perf_counter() - t_phase:.1f}"
          f" s")
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    lm_mesh_gaps(torch, args, dev)


# ---- the LM steps' last gaps: MoE groups over the batch axes, the
# families' caches split over model, a sequence split over data

GAPS_BATCH, GAPS_LEN, GAPS_STEPS = 8, 16, 1     # the families' decode
GAPS_LONG, GAPS_LONG_STEPS = 32768, 4           # zamba2 at batch 1
GAPS_MOE = "phi3.5-moe-42b-a6.6b"
# The MoE takes one layer: with two, four ranks do not fit the one card
# (float32 serving on (2, 2): each rank ~18 GB, its shards and a 5 GB
# layer gathered whole, ~2.5 copies of it while the gather is assembled;
# a bfloat16 train step: ~19 GB, AdamW's float32 moments, a layer and
# its gradients whole, a second gather for remat).  Its train step runs
# in bfloat16 (float32 would be the two-layer case's bytes again), its
# weights rounded to bfloat16 throughout.  Its limits are bfloat16
# roundings (2^-8 = 3.9e-3) of the one-process step: each rank's
# gradient is rounded to bfloat16, then summed over up to 4 ranks in
# bfloat16, so an element may move by several units in the last place
# of the ranks' partial gradients; the loss and the norm relative
GAPS_MOE_LAYERS, GAPS_MOE_STEPS = 1, 1          # after the 8 x 34 prompt
GAPS_MOE_LOSS_RTOL, GAPS_MOE_GRAD_RTOL, GAPS_MOE_NORM_RTOL = 2e-3, 3e-2, 1e-2
GAPS_MESHES = ((1, 4), (2, 2))                  # the families' meshes
GAPS_JOIN_S = 600               # a gloo rank that takes longer is hung


def gaps_cfgs() -> dict:
    """Published widths at cut depth: zamba2 one group of 6 Mamba-2
    layers, the shared attention and one tail layer; xlstm one group of 7
    mLSTM layers and an sLSTM layer; whisper 2 encoder and 2 decoder
    layers; phi3.5-moe ``GAPS_MOE_LAYERS`` layers."""
    from repro_torch.configs import ARCHS
    z, x, w, m = (ARCHS[n] for n in (*FAMILY_ARCHS, GAPS_MOE))
    return {"zamba2-1.2b": dataclasses.replace(z, n_layers=z.attn_every + 1),
            "xlstm-1.3b": dataclasses.replace(x, n_layers=x.slstm_every),
            "whisper-medium": dataclasses.replace(w, n_layers=2,
                                                  n_enc_layers=2),
            GAPS_MOE: dataclasses.replace(m, n_layers=GAPS_MOE_LAYERS)}


def rss_gb() -> float:
    """This process's resident memory on the host, GB (``/proc``)."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f
                  if line.startswith("VmRSS:"))
    return kb * 1024 / 1e9


def to_host(tree):
    """A cache (nested dicts of tensors and ints) copied to the host."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True) if hasattr(tree, "cpu") \
        else tree


def lm_mesh_gaps_rank(rank: int, world: int, port: int, path: str, cfgs,
                      dev: str = "cuda") -> None:
    """One gloo rank of ``lm_mesh_gaps`` on ``cuda:0`` with the others
    (``dev="cpu"`` to rehearse), every case's inputs from ``path``: each
    family's decode on (1, 4) and (2, 2); zamba2 at batch 1 on (4, 1);
    the MoE's prefill and decode, then its bfloat16 train step, on
    (4, 1) and (2, 2).  Its logits, cache and gradient errors, step times
    and peak memory to ``path/rank{rank}.pt``."""
    # four ranks' whole-layer gathers share the one card: grow segments in
    # place rather than cache fragments (read at the first allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.launch.input_specs import params_structs
    from repro_torch.launch.mesh import dp_axes, make_lm_mesh
    from repro_torch.models import build_model
    from repro_torch.train import optimizer

    if dev == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    on = None if dev == "cuda" else dev
    f32 = torch.float32

    def load(name):
        return torch.load(os.path.join(path, f"{name}.pt"), mmap=True)

    def cache_err(cache, want, specs, mesh) -> float:
        """max |this rank's cache shard − its slice of the whole cache|."""
        out = 0.0
        for k, t in cache.items():
            if isinstance(t, dict):
                out = max(out, cache_err(t, want[k], specs[k], mesh))
            elif hasattr(t, "shape"):
                w = sh.shard_of(want[k], specs[k], mesh).to(t.device)
                out = max(out, float((t.double() - w.double()).abs().max()))
        return out

    def rows(mesh, b):
        n = mesh.axis_size(dp_axes(mesh))
        if b % n:
            return 0, b
        return mesh.index(dp_axes(mesh)) * (b // n), \
            (mesh.index(dp_axes(mesh)) + 1) * (b // n)

    def decode(api, mesh, f, fill=None, dtype=torch.float32):
        """Decode ``f["tokens"]`` from the cache ``f["cache"]`` (or, with
        ``fill`` the prompt, from the cache-filling prefill), the model in
        ``dtype``."""
        toks, s = f["tokens"], f["max_len"]
        b, n = toks.shape
        dec, *_, meta = steps.make_decode_step(
            api, mesh, ShapeConfig("d", s, b, "decode"), dtype=dtype)
        model = steps.place_model(params_structs(api, dtype),
                                  meta["specs"]["params"], mesh,
                                  state=f["state"])
        torch.cuda.reset_peak_memory_stats()
        logits, times = [], []
        if fill is not None:
            pre, *_, pmeta = steps.make_prefill_step(
                api, mesh, ShapeConfig("p", fill.shape[1], b, "prefill"),
                cache_len=s, dtype=dtype)
            cache = steps.init_cache(api, b, s, meta["specs"]["cache"], mesh,
                                     dtype)
            batch = steps.place({"tokens": fill}, pmeta["specs"]["batch"],
                                mesh)
            (lg, cache), ms = sync_ms(torch, lambda: pre(model, batch, cache))
            logits.append(lg.float().cpu())
            times.append(ms)
        else:
            cache = steps.place(f["cache"], meta["specs"]["cache"], mesh)
        for i in range(n):
            t = steps.place({"t": toks[:, i:i + 1]},
                            {"t": meta["specs"]["tokens"]}, mesh)["t"]
            (lg, cache), ms = sync_ms(torch, lambda: dec(model, t, cache))
            logits.append(lg.float().cpu())
            times.append(ms)
        out = {"logits": torch.stack(logits), "ms": times,
               "rows": rows(mesh, b),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if "final" in f:
            out["cache_err"] = cache_err(cache, f["final"],
                                         meta["specs"]["cache"], mesh)
        return out

    def train(api, mesh, f):
        """The MoE's bfloat16 train step: the loss, each non-expert
        gradient's max error on this rank's shard, the global norm."""
        tr = f["train"]
        step, *_, meta = steps.make_train_step(
            api, mesh, ShapeConfig("t", tr["tokens"].shape[1],
                                   tr["tokens"].shape[0], "train"),
            dtype=torch.bfloat16, lr=TRAIN_LR)
        specs = meta["specs"]["params"]
        model = steps.place_model(params_structs(api, torch.bfloat16),
                                  specs, mesh, batch_axes=meta["batch_axes"],
                                  state=f["state"])
        batch = steps.place(tr, meta["specs"]["batch"], mesh)
        opt = optimizer.init(model)
        seen, real = {}, optimizer.update

        def spy(grads, st, params, **kw):
            seen["norm"] = float(optimizer.global_norm(
                grads, mesh=kw["mesh"], specs=kw["specs"]))
            seen["errs"] = {
                name: float((g.double() - sh.shard_of(
                    f["grads"][name], specs[name], mesh).to(
                        g.device).double()).abs().max())
                for name, g in grads.items() if name in f["grads"]}
            return real(grads, st, params, **kw)

        torch.cuda.reset_peak_memory_stats()
        optimizer.update = spy
        try:
            (loss, model, opt), ms = sync_ms(torch, lambda: step(model, opt,
                                                                 batch))
        finally:
            optimizer.update = real
        return {"loss": float(loss), "ms": ms, "opt_step": opt.step,
                "num_micro": meta["num_micro"], **seen,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    def free(key):
        """Drop what the case left: the device cache, and the pinned host
        buffers gloo staged the card's tensors through (the host's 96 GiB
        are shared by the four ranks); its host memory is printed."""
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
            pinned = next((v for k, v in
                           torch.cuda.host_memory_stats().items()
                           if k.startswith("reserved_bytes")
                           and k.endswith("current")), 0)
            release = getattr(torch.accelerator, "empty_host_cache", None) \
                or getattr(torch._C, "_host_emptyCache", None)
            if release is not None:
                release()
            out[key]["host_gb"] = (rss_gb(), pinned / 1e9)
            print(f"lm mesh gaps rank {rank} {key}: host RSS "
                  f"{out[key]['host_gb'][0]:.2f} GB, pinned "
                  f"{pinned / 1e9:.2f} GB released", flush=True)

    try:
        out = {}
        meshes = {shape: make_lm_mesh(shape, ("data", "model"), device=on)
                  for shape in ((1, 4), (2, 2), (4, 1))}
        for name in FAMILY_ARCHS:
            api, f = build_model(cfgs[name]), load(name)
            for shape in GAPS_MESHES:
                out[name, shape] = decode(api, meshes[shape], f)
                free((name, shape))
        api = build_model(cfgs["zamba2-1.2b"])
        key = "zamba2-1.2b long", (4, 1)
        out[key] = decode(api, meshes[4, 1], load("zamba2-1.2b long"))
        free(key)
        api, f = build_model(cfgs[GAPS_MOE]), load(GAPS_MOE)
        for shape in ((4, 1), (2, 2)):
            out[GAPS_MOE, shape] = decode(api, meshes[shape], f,
                                          fill=f["prompt"])
            free((GAPS_MOE, shape))
        for shape in ((4, 1), (2, 2)):
            out["train", shape] = train(api, meshes[shape], f)
            free(("train", shape))
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def lm_mesh_gaps(torch, args, dev="cuda") -> None:
    """The second part of ``lm_mesh_phase``: the LM steps where the batch,
    the state or the cache is split beyond the plain layout, 4 gloo ranks
    on the card at published widths (``gaps_cfgs``), float32 (the MoE
    bfloat16), each rank held to the one-process path the
    parent ran on the same weights and inputs:

      * zamba2, xlstm and whisper: ``GAPS_STEPS`` decode steps at batch
        ``GAPS_BATCH`` on (1, 4) and (2, 2) (KV caches split over KV
        heads, recurrent states over a state dim, a layer's state whole
        while it runs), from an empty cache (whisper: the encoded
        frames' cross K/V): logits within ``LM_TOL`` and each rank's
        cache shard after them within ``LM_TOL`` of its slice;
      * zamba2 at batch 1 over a ``GAPS_LONG``-position cache whose
        sequence the data axis splits, on (4, 1): ``GAPS_LONG_STEPS``
        steps from a cache filled with seeded values up to
        ``GAPS_LONG − GAPS_LONG_STEPS`` (every chunk holds positions),
        the same way;
      * phi3.5-moe: the prefill that fills the cache (8 x 34) and
        ``GAPS_MOE_STEPS`` decode steps on (4, 1) and (2, 2) (the
        router's groups spanning ranks), logits within ``LM_TOL``; its
        bfloat16 train step (8 x 128) on both meshes: the loss, the
        global gradient norm and every non-expert gradient against the
        one-process bfloat16 step.

    Every case is printed before any limit fails the phase.

    Each case's error, step ms and per-rank peak are printed."""
    import multiprocessing

    from repro_torch.data import make_token_batch
    from repro_torch.models import build_model, loss_fn, transformer
    from repro_torch.train import optimizer
    t_phase = time.perf_counter()
    cfgs = gaps_cfgs()
    b, n = GAPS_BATCH, GAPS_STEPS
    gen = torch.Generator().manual_seed(args.seed + 11)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_gaps_")
    want, procs, ref = {}, [], {}
    try:
        t = time.perf_counter()
        for name in FAMILY_ARCHS:
            cfg = cfgs[name]
            api = build_model(cfg)
            model = api.init(torch.Generator(device=dev).manual_seed(
                args.seed))
            toks = torch.randint(0, cfg.vocab, (b, n), generator=gen)
            with torch.no_grad():
                cache = api.init_cache(model, b, GAPS_LEN)
                if cfg.enc_dec:
                    frames = torch.randn((b, cfg.enc_frames, cfg.d_model),
                                         generator=gen).to(dev)
                    cache = api.prefill(model, {"frames": frames}, cache)
                first = to_host(cache)
                want[name] = torch.stack([
                    api.decode_step(model, toks[:, i:i + 1].to(dev),
                                    cache)[0].cpu() for i in range(n)])
            state = {k: q.detach().cpu() for k, q in
                     model.named_parameters()}
            torch.save({"state": state, "cache": first,
                        "final": to_host(cache), "tokens": toks,
                        "max_len": GAPS_LEN}, os.path.join(tmp, f"{name}.pt"))
            if name == "zamba2-1.2b":
                gdev = torch.Generator(device=dev).manual_seed(args.seed + 12)
                with torch.no_grad():
                    cache = api.init_cache(model, 1, GAPS_LONG)
                    pos = GAPS_LONG - GAPS_LONG_STEPS
                    for key in ("attn_k", "attn_v"):
                        cache[key][:, :, :pos].normal_(generator=gdev)
                    for leaf in cache["ssm"].values():
                        leaf.normal_(generator=gdev).mul_(0.1)
                    cache["len"] = pos
                    first = to_host(cache)
                    toks = torch.randint(0, cfg.vocab, (1, GAPS_LONG_STEPS),
                                         generator=gen)
                    want["zamba2-1.2b long"] = torch.stack([
                        api.decode_step(model, toks[:, i:i + 1].to(dev),
                                        cache)[0].cpu()
                        for i in range(GAPS_LONG_STEPS)])
                torch.save({"state": state, "cache": first,
                            "final": to_host(cache), "tokens": toks,
                            "max_len": GAPS_LONG},
                           os.path.join(tmp, "zamba2-1.2b long.pt"))
            del model, cache, state
            gc.collect()
            torch.cuda.empty_cache()
        # the MoE: weights rounded to bfloat16 (the file's dtype), the
        # serving reference in float32, the train reference in bfloat16
        cfg = cfgs[GAPS_MOE]
        api = build_model(cfg)
        model = api.init(torch.Generator(device=dev).manual_seed(args.seed))
        with torch.no_grad():
            for q in model.parameters():
                q.copy_(q.to(torch.bfloat16))
        prompt = torch.randint(0, cfg.vocab, (b, LM_MESH_PROMPT),
                               generator=gen)
        toks = torch.randint(0, cfg.vocab, (b, GAPS_MOE_STEPS),
                             generator=gen)
        with torch.no_grad():
            cache = transformer.init_cache(cfg, b, LM_MESH_PROMPT +
                                           GAPS_MOE_STEPS, device=dev)
            lg, cache = transformer.prefill(model, prompt.to(dev), cfg,
                                            cache)
            logits = [lg.cpu()]
            for i in range(GAPS_MOE_STEPS):
                lg, cache = transformer.decode_step(
                    model, toks[:, i:i + 1].to(dev), cache, cfg)
                logits.append(lg.cpu())
        want[GAPS_MOE] = torch.stack(logits)
        del cache
        model.to(torch.bfloat16)
        batch = make_token_batch(
            torch.Generator().manual_seed(args.seed + 13), TRAIN_BATCH,
            TRAIN_SEQ, cfg.vocab, device=dev)
        model.zero_grad(set_to_none=True)
        loss = loss_fn(api, model, batch)
        loss.backward()
        grads = {k: q.grad for k, q in model.named_parameters()}
        ref = {"loss": float(loss.detach()), "norm": float(
            optimizer.global_norm(grads))}
        experts = tuple(f"moe.{w}" for w in ("wg", "wu", "wd"))
        kept = {k: g.cpu() for k, g in grads.items()
                if not k.endswith(experts)}
        ref["gmax"] = {k: float(g.float().abs().max())
                       for k, g in kept.items()}
        torch.save({"state": {k: q.detach().cpu() for k, q in
                              model.named_parameters()},
                    "prompt": prompt, "tokens": toks,
                    "max_len": LM_MESH_PROMPT + GAPS_MOE_STEPS,
                    "train": {k: v.cpu() for k, v in batch.items()},
                    "grads": kept}, os.path.join(tmp, f"{GAPS_MOE}.pt"))
        del model, grads, kept, batch, loss
        gc.collect()
        torch.cuda.empty_cache()
        save_s = time.perf_counter() - t
        files = sum(os.path.getsize(os.path.join(tmp, n))
                    for n in os.listdir(tmp))
        free_b, total_b = torch.cuda.mem_get_info() if dev == "cuda" \
            else (0, 0)
        print(f"lm mesh gaps: references and {files / 1e9:.2f} GB of "
              f"files in {save_s:.1f} s, host RSS {rss_gb():.2f} GB; this "
              f"process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              f"({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved), "
              f"{free_b / 1e9:.2f} of {total_b / 1e9:.2f} GB free on the "
              f"card", flush=True)
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=lm_mesh_gaps_rank,
                             args=(r, 4, port, tmp, cfgs, dev))
                 for r in range(4)]
        t = time.perf_counter()
        for q in procs:
            q.start()
        while any(q.is_alive() for q in procs) and \
                time.perf_counter() - t < GAPS_JOIN_S and \
                all(q.exitcode in (None, 0) for q in procs):
            time.sleep(0.2)
        wall = time.perf_counter() - t
        codes = [q.exitcode for q in procs]
        if codes != [0] * 4:
            fail(f"lm mesh gaps: gloo ranks exited with {codes} after "
                 f"{wall:.0f} s (None: still running, stopped)")
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(4)]
    finally:
        for q in procs:
            if q.is_alive():
                q.kill()
            q.join()
        shutil.rmtree(tmp, ignore_errors=True)
    cases = [(name, shape) for name in FAMILY_ARCHS for shape in GAPS_MESHES]
    cases += [("zamba2-1.2b long", (4, 1)), (GAPS_MOE, (4, 1)),
              (GAPS_MOE, (2, 2))]
    bad = []
    for name, shape in cases:
        errs, cache_errs, peaks, ms = [], [], [], []
        for r, o in enumerate(outs):
            d = o[name, shape]
            lo, hi = d["rows"]
            err = float((d["logits"] - want[name][:, lo:hi]).abs().max())
            errs.append(err)
            cache_errs.append(d.get("cache_err", 0.0))
            peaks.append(d["peak_gb"])
            ms.append(statistics.median(d["ms"]))
            if err > LM_TOL or cache_errs[-1] > LM_TOL:
                bad.append(f"{name} {shape} rank {r}: logits {err:.3g}, "
                           f"cache shard {cache_errs[-1]:.3g} from the "
                           f"one-process path (limit {LM_TOL})")
        shards = f", cache shards {max(cache_errs):.3g}" \
            if name != GAPS_MOE else ""
        print(f"lm mesh gaps: {name} {shape}: logits max|diff| "
              f"{max(errs):.3g}{shards} from one process (limit "
              f"{LM_TOL}); step ms (median, rank 0..3) "
              f"{[round(m, 1) for m in ms]}; peak GB "
              f"{[round(q, 2) for q in peaks]}")
    for shape in ((4, 1), (2, 2)):
        worst, rel = 0.0, []
        for r, o in enumerate(outs):
            tr = o["train", shape]
            rel = [abs(tr["loss"] - ref["loss"]) / abs(ref["loss"]),
                   abs(tr["norm"] - ref["norm"]) / ref["norm"]]
            if rel[0] > GAPS_MOE_LOSS_RTOL or rel[1] > GAPS_MOE_NORM_RTOL \
                    or tr["opt_step"] != 1:
                bad.append(f"{GAPS_MOE} train {shape} rank {r}: loss "
                           f"{tr['loss']} against {ref['loss']} (relative "
                           f"{rel[0]:.3g}), gradient norm {tr['norm']} "
                           f"against {ref['norm']} ({rel[1]:.3g})")
            for k, mx in tr["errs"].items():
                lim = GAPS_MOE_GRAD_RTOL * ref["gmax"][k] + GRAD_ATOL
                if mx > lim:
                    bad.append(f"{GAPS_MOE} train {shape} rank {r}: "
                               f"gradient {k} off by {mx:.3g} (limit "
                               f"{lim:.3g})")
                worst = max(worst, mx / (ref["gmax"][k] or 1.0))
        print(f"lm mesh gaps: {GAPS_MOE} bfloat16 train step {shape} "
              f"({TRAIN_BATCH} x {TRAIN_SEQ}, num_micro "
              f"{outs[0]['train', shape]['num_micro']}): loss "
              f"{outs[0]['train', shape]['loss']:.6f} (one process "
              f"{ref['loss']:.6f}, relative {rel[0]:.3g}), gradient norm "
              f"relative {rel[1]:.3g}, worst non-expert leaf "
              f"max|diff|/max|leaf| {worst:.3g} (limits "
              f"{GAPS_MOE_LOSS_RTOL}, {GAPS_MOE_NORM_RTOL}, "
              f"{GAPS_MOE_GRAD_RTOL}); step ms "
              f"{[round(o['train', shape]['ms'], 1) for o in outs]}; peak GB "
              f"{[round(o['train', shape]['peak_gb'], 2) for o in outs]}")
    depth = ", ".join(f"{k} {c.n_layers} layers" for k, c in cfgs.items())
    host = [d["host_gb"][0] for o in outs for d in o.values()
            if "host_gb" in d]
    print(f"lm mesh gaps: {depth} at full width; 4 gloo ranks on one "
          f"card: {wall:.1f} s from spawn to the last exit, references "
          f"and files {save_s:.1f} s; part "
          f"{time.perf_counter() - t_phase:.1f} s; host RSS a rank after "
          f"a case up to {max(host, default=0.0):.2f} GB")
    if bad:
        fail("lm mesh gaps: " + "; ".join(bad))


# ----------------------------------------------- the dry run and roofline

DRYRUN_STEPS = (("train", 128, 8), ("prefill", 1024, 8), ("decode", 4096, 8))
DRYRUN_BYTES_RTOL = 0.01        # bytes counted on the card against on meta
DRYRUN_PEAK_BAND = (0.95, 1.05)  # meta live peak / the allocator's
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k", "single", "ok"),
                ("qwen2.5-3b", "decode_32k", "single", "ok"),
                ("qwen2-72b", "prefill_32k", "multipod", "ok"),
                ("whisper-medium", "decode_32k", "single", "ok"))


def dryrun_phase(torch, args, dev="cuda") -> None:
    """Phase 11, after the LM mesh phase: the dry run's counters
    (``launch.roofline``, ``launch.dryrun``) held to the card
    (``dev="cpu"`` rehearses it).

    (a) qwen2.5-3b at its published configuration, bfloat16, weights from
        ``--seed``, on ``make_host_mesh()``: for each of ``DRYRUN_STEPS``
        (train 8 x 128, prefill 8 x 1024, decode at batch 8 against a
        4096-position cache), a fresh model placed by
        ``dryrun.place_inputs``, one warm-up step, one step counted on the
        card by ``dryrun.count_step`` (peak memory reset before it), the
        same step counted on the meta device over a (1, 1) recording mesh,
        and 5 timed steps (CUDA events, median).  FLOPs must be equal and
        bytes within 1%, else the ops whose counts differ are printed; the
        meta live high-water mark must lie within 0.95x-1.05x of
        ``max_memory_allocated()`` minus what was allocated before the
        step.  The measured ms is printed beside the modelled
        ``step_time_s`` (H100 SXM5 data-sheet constants) with the achieved
        share model_flops / (ms x peak): no gate on these.
    (b) ``DRYRUN_CELLS`` through ``dryrun.run_cell`` on meta (production
        meshes, published widths): each status must be the expected one.
    """
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.launch import dryrun, roofline, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    t_phase = time.perf_counter()
    cfg = ARCHS[RAG_ARCH]
    api = build_model(cfg)
    dtype = torch.bfloat16
    mesh = make_host_mesh(None if dev == "cuda" else dev)
    gen = torch.Generator().manual_seed(args.seed + 11)
    lines = []
    for kind, seq, batch in DRYRUN_STEPS:
        shape = ShapeConfig(kind, seq, batch, kind)
        fn, structs, _, _, meta = steps.make_step(cfg, mesh, shape,
                                                  dtype=dtype)
        model = api.init(torch.Generator(device=dev).manual_seed(args.seed),
                         dtype)
        token_s = {"train": structs[-1], "prefill": structs[1],
                   "decode": {"t": structs[1]}}[kind]
        tokens = {k: torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                   dtype=v.dtype).to(dev)
                  for k, v in token_s.items()}
        if kind == "train":
            inputs = (model, None, tokens)
        elif kind == "prefill":
            inputs = (model, tokens)
        else:
            cache = api.init_cache(model, batch, seq, dtype)
            cache["len"] = seq - 8          # 7 steps: warm-up, count, 5
            inputs = (model, tokens["t"], cache)
        model, run_args, arg_bytes = dryrun.place_inputs(inputs, meta, mesh)
        fn(model, *run_args)                                # warm-up
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        card = dryrun.count_step(fn, meta, model, *run_args)
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated() - before
        # the same step on meta, its cache at the counted step's length
        mmesh = roofline.RecordingMesh(("data", "model"), (1, 1))
        mfn, mstructs, _, _, mmeta = steps.make_step(cfg, mmesh, shape,
                                                     dtype=dtype)
        mmodel, margs, marg_bytes = dryrun.place_inputs(mstructs, mmeta,
                                                        mmesh)
        if kind == "decode":
            margs[1]["len"] = seq - 7
        on_meta = dryrun.count_step(mfn, mmeta, mmodel, *margs, mesh=mmesh)
        times = []
        for _ in range(TIMING_RUNS):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            fn(model, *run_args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        report = roofline.analyze(on_meta, arch=cfg.name, shape=shape,
                                  mesh_name="host", chips=1, cfg=cfg,
                                  argument_bytes=marg_bytes, dtype=dtype)
        diff = {op: (card.ops.get(op), on_meta.ops.get(op))
                for op in set(card.ops) | set(on_meta.ops)
                if card.ops.get(op) != on_meta.ops.get(op)}
        rel = abs(card.bytes - on_meta.bytes) / on_meta.bytes
        ratio = on_meta.live_peak / used if used else math.inf
        share = report.model_flops / (ms / 1e3 * report.peak_flops)
        lines.append(
            f"dry run {kind} ({batch} x {seq}): FLOPs card {card.flops:,} / "
            f"meta {on_meta.flops:,}; bytes card {card.bytes:,} / meta "
            f"{on_meta.bytes:,} (relative {rel:.3g}); argument bytes card "
            f"{arg_bytes:,} / meta {marg_bytes:,}; live peak meta "
            f"{on_meta.live_peak / 1e9:.3f} GB, card counter "
            f"{card.live_peak / 1e9:.3f} GB, card allocator "
            f"{used / 1e9:.3f} GB (ratio {ratio:.3f}); step "
            f"{ms:.3f} ms (median of {TIMING_RUNS}: "
            f"{[round(t, 3) for t in times]}) against the modelled "
            f"step_time_s {report.step_time_s * 1e3:.3f} ms (compute "
            f"{report.compute_s * 1e3:.3f}, memory "
            f"{report.memory_s * 1e3:.3f}, modelled from H100 SXM5 "
            f"data-sheet constants), achieved share {share:.4f} of the "
            f"bf16 peak")
        print(lines[-1])
        if card.flops != on_meta.flops or rel > DRYRUN_BYTES_RTOL:
            for op, (c, m) in sorted(diff.items()):
                print(f"  {op}: card [calls, bytes, flops] {c}, meta {m}")
            fail(f"dry run {kind}: the counts on the card differ from those "
                 f"on meta (FLOPs {card.flops} / {on_meta.flops}, bytes "
                 f"relative {rel:.3g}, limit {DRYRUN_BYTES_RTOL})")
        lo, hi = DRYRUN_PEAK_BAND
        if not lo <= ratio <= hi:
            fail(f"dry run {kind}: the meta live peak "
                 f"{on_meta.live_peak:,} B is {ratio:.3f}x the card's "
                 f"{used:,} B (band {lo}-{hi})")
        del model, run_args, inputs, mmodel, margs, fn, mfn
        gc.collect()
        torch.cuda.empty_cache()
    t_cells = time.perf_counter()
    for arch, shape_name, mesh_name, want in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape_name, mesh_name, save=False)
        if rec["status"] != want:
            fail(f"dry run {arch} x {shape_name} x {mesh_name}: status "
                 f"{rec['status']}, expected {want}: "
                 f"{rec.get('error', rec.get('reason', ''))[:300]}")
        if want == "ok":
            print(f"dry run cell {arch} x {shape_name} x {mesh_name} "
                  f"(modelled from H100 SXM5 data-sheet constants): "
                  f"{rec['bottleneck']}-bound, step_time_s "
                  f"{rec['step_time_s']:.6g}, mfu {rec['mfu']:.4g}, "
                  f"useful_flops_ratio {rec['useful_flops_ratio']:.4g}, "
                  f"peak {rec['peak_memory_bytes'] / 1e9:.2f} GB a device, "
                  f"collectives {rec['coll_detail']}, {rec['run_s']} s")
        else:
            print(f"dry run cell {arch} x {shape_name} x {mesh_name}: "
                  f"{rec['status']} ({rec['reason'][:120]})")
    print(f"dry run phase: {time.perf_counter() - t_phase:.1f} s (the four "
          f"meta cells {time.perf_counter() - t_cells:.1f} s)")


BASELINE_BYTES = {"fatrq": 162, "sq4": 392, "sq3": 296, "int8": 776,
                  "rq2": 192}           # bytes per 768-d record
RQ_LEVELS, RQ_ITERS = 2, 8


def norm_mse(torch, est, true) -> float:
    """``bench_distortion.py``'s distortion: the mean squared error
    relative to the mean true distance."""
    return float((((est - true) / true.mean()) ** 2).mean())


def baselines_phase(torch, args, index, ds) -> None:
    """The storage and distortion comparators of the paper's §V-C and
    Fig. 7 (``benchmarks/bench_storage.py``, ``bench_distortion.py``) on
    the 1M x 768 index: bytes per record of FaTRQ, SQ-4, SQ-3, INT8 and a
    2-level RQ (M = 96, K = 256); the normalized distortion against each
    query's exact top-100 of INT8, PQ + per-record 3-bit SQ residuals,
    PQ + FaTRQ (one ternary level, calibrated) and the 2-level RQ.  RQ's
    error must fall with each level, SQ's from 3 to 4 to 8 bits."""
    from repro_torch.core import packing, residual_ip_estimate, unpack_level
    from repro_torch.core.calibration import build_features, predict
    from repro_torch.device import chunks
    from repro_torch.quant import pq as pq_mod
    from repro_torch.quant import rq, sq
    from repro_torch.quant.kmeans import random_init
    t_phase = time.perf_counter()
    x, trq = index.x, index.trq
    n, d = x.shape
    m = index.codebook.m
    got = {"fatrq": packing.storage_bytes(d),
           "sq4": sq.sq_bytes_per_record(d, 4),
           "sq3": sq.sq_bytes_per_record(d, 3),
           "int8": sq.sq_bytes_per_record(d, 8),
           "rq2": RQ_LEVELS * m}
    print(f"baselines: bytes per {d}-d record {got}")
    if got != BASELINE_BYTES:
        fail(f"baselines: bytes per record {got}, expected "
             f"{BASELINE_BYTES}")
    x_c = pq_mod.decode(index.codebook, index.pq_codes)
    delta = x - x_c
    sq_err = {}
    for bits in (3, 4, 8):                  # in row chunks: 3 GB a copy
        total = 0.0
        for a, b in chunks(n, 1 << 17):
            rec = sq.sq_decode(sq.sq_encode(delta[a:b], bits))
            total += float(((rec - delta[a:b]) ** 2).sum())
        sq_err[bits] = total / n
    gen = torch.Generator(device=x.device).manual_seed(args.seed + 9)
    init = torch.stack([torch.stack([random_init(n, 256, gen)
                                     for _ in range(m)])
                        for _ in range(RQ_LEVELS)])
    (rqc, _), rq_s = timed(torch, lambda: rq.train(
        x, m, 256, RQ_LEVELS, RQ_ITERS, init_idx=init))
    codes = rq.encode(rqc, x)
    rq_err = [float((x ** 2).sum(-1).mean())] + [
        float(((rq.decode(rqc, codes, through_level=lv) - x) ** 2)
              .sum(-1).mean()) for lv in range(1, RQ_LEVELS + 1)]
    print(f"baselines: residual SQ mean squared error by bits "
          f"{ {b: round(e, 6) for b, e in sq_err.items()} }; RQ ({m} x 256 "
          f"a level, {RQ_ITERS} iterations, trained on all {n:,} rows in "
          f"{rq_s:.1f} s) error through 0, 1, 2 levels "
          f"{[round(e, 6) for e in rq_err]}")
    if not sq_err[3] > sq_err[4] > sq_err[8]:
        fail(f"baselines: SQ error does not fall with the bits {sq_err}")
    if not all(a > b for a, b in zip(rq_err, rq_err[1:])):
        fail(f"baselines: RQ error does not fall with each level {rq_err}")

    # distortion against each query's exact top-100
    q, idx = ds.queries, ds.gt.long()
    rows = x[idx]                                        # (Q, 100, D)
    true = ((rows - q[:, None]) ** 2).sum(-1)
    xc_rows = x_c[idx]
    d0 = ((xc_rows - q[:, None]) ** 2).sum(-1)
    sc = trq.scalars.take(idx)
    d_ip = residual_ip_estimate(q, unpack_level(trq, 0, idx), sc.norm,
                                sc.rho)
    est = {"pq_fatrq": predict(trq.model, build_features(
        d0, d_ip, sc.delta_sq, sc.cross))}
    sq3 = sq.sq_decode(sq.sq_encode(delta[idx], 3))
    est["pq_sq3"] = ((xc_rows + sq3 - q[:, None]) ** 2).sum(-1)
    int8 = sq.sq_decode(sq.int8_encode(rows))
    est["int8"] = ((int8 - q[:, None]) ** 2).sum(-1)
    rq_rows = rq.decode(rqc, codes[idx.reshape(-1)]).reshape(rows.shape)
    est["rq2"] = ((rq_rows - q[:, None]) ** 2).sum(-1)
    dist = {k: norm_mse(torch, v, true) for k, v in est.items()}
    for k, v in est.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"baselines: non-finite {k} estimates")
    print(f"baselines: normalized distortion against the exact top-100 of "
          f"{q.shape[0]} queries {dist} ({time.perf_counter() - t_phase:.1f}"
          f" s in all)")


def zero_launches(pq_adc_mod, tr) -> None:
    """Set every kernel wrapper's launch count to 0."""
    pq_adc_mod.launches = pq_adc_mod.global_launches = 0
    tr.launches = tr.bounds_launches = 0
    tr.batch_launches = tr.single_launches = tr.prune_launches = 0
    tr.global_launches = tr.bounds_global_launches = 0
    tr.level0_global_launches = tr.prune_global_launches = 0
    tr.tables_launches = tr.pair_tables_launches = 0


#: the launch counts of the kernels' global forms (``launch_counts``)
GLOBAL_COUNTS = ("pq_adc (global)", "ternary_refine_fused (global)",
                 "ternary_refine_fused_bounds (global)", "level-0 (global)",
                 "prune (global)", "refine tables (global)",
                 "pair tables (global)")


def launch_counts(pq_adc_mod, tr) -> dict:
    """Every kernel wrapper's launch count, by kernel name, and of them the
    global forms' (``GLOBAL_COUNTS``: the level-0 kernel's over both entry
    points, the prune's over the fused kernel's and its own launches, and
    the table kernels' that only the global forms launch: the refine
    tables once a fused or bounds call, the pair tables once a level-0
    call)."""
    return {"pq_adc": pq_adc_mod.launches,
            "ternary_refine_fused": tr.launches,
            "ternary_refine_fused_bounds": tr.bounds_launches,
            "ternary_refine_batch": tr.batch_launches,
            "ternary_refine": tr.single_launches,
            "ternary_refine_prune": tr.prune_launches,
            **dict(zip(GLOBAL_COUNTS, (
                pq_adc_mod.global_launches, tr.global_launches,
                tr.bounds_global_launches, tr.level0_global_launches,
                tr.prune_global_launches, tr.tables_launches,
                tr.pair_tables_launches)))}


# -------------------------------------------------------- the mesh phase

MESH_JOIN_S = 600               # a gloo rank that takes longer is hung


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def index_arrays(index, queries) -> dict:
    """The index's arrays under ``interop.index_from_numpy``'s keys (its
    kNN graph too) and the queries, on the host, for the ranks to load."""
    from repro_torch.anns.stages import graph_for
    trq, graph = index.trq, graph_for(index)
    out = {"codebook.codebooks": index.codebook.codebooks,
           "pq_codes": index.pq_codes, "ivf.centroids": index.ivf.centroids,
           "ivf.lists": index.ivf.lists, "ivf.list_len": index.ivf.list_len,
           "x": index.x, "graph.neighbors": graph.neighbors,
           "graph.start": graph.start, "queries": queries}
    for i, lv in enumerate(trq.levels):
        for f in ("packed", "proj", "norm", "rho"):
            out[f"trq.levels.{i}.{f}"] = getattr(lv, f)
    for f in ("delta_sq", "cross", "rho", "norm"):
        out[f"trq.scalars.{f}"] = getattr(trq.scalars, f)
    for f in ("w", "bias", "resid_std"):
        out[f"trq.model.{f}"] = getattr(trq.model, f)
    return {k: v.cpu() for k, v in out.items()}


def ledger_of(cost) -> dict:
    return {k: (v.accesses, v.bytes) for k, v in cost.ledger.items()}


def same_bits(torch, label: str, ids, dists, ledger, breakdown, want) -> None:
    """ids, distances, ledger and modelled breakdown all equal to the
    ``SearchResult`` ``want``'s, bit for bit, else fail."""
    if not torch.equal(ids.cpu(), want.ids.cpu()):
        n_rows = int((ids.cpu() != want.ids.cpu()).any(1).sum())
        fail(f"{label}: ids differ from the stacked form's in {n_rows} "
             f"queries")
    if not torch.equal(dists.cpu(), want.distances.cpu()):
        fail(f"{label}: distances differ from the stacked form's")
    if ledger != ledger_of(want.cost):
        fail(f"{label}: ledger {ledger} differs from the stacked form's "
             f"{ledger_of(want.cost)}")
    if breakdown != want.cost.breakdown():
        fail(f"{label}: modelled breakdown differs from the stacked form's")


def mesh_rank(rank: int, world: int, port: int, path: str, cfg) -> None:
    """One rank of the gloo mesh (``mesh_phase``), on ``cuda:0`` with the
    other ranks: ``Database.query`` with ``QueryPlan(shards=world,
    backend="cuda")`` and ``mesh=`` on both fronts, over the parent's
    index (IVF: partitioned and placed by the query) and over the
    parent's stacked graph partition (placed with ``place``); its
    answers, launches, times and peak memory to ``path/rank{rank}.pt``."""
    import resource

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.anns import Database, QueryPlan
    from repro_torch.interop import index_from_numpy
    from repro_torch.kernels import pq_adc as pq_adc_mod
    from repro_torch.kernels import ternary_refine as tr
    from repro_torch.launch.mesh import make_search_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        t = time.perf_counter()
        arrays = torch.load(os.path.join(path, "index.pt"), mmap=True)
        queries = arrays.pop("queries").cuda()
        index = index_from_numpy({k: v.numpy() for k, v in arrays.items()},
                                 cfg, device="cuda")
        del arrays
        mesh = make_search_mesh(world)
        out = {"load_s": time.perf_counter() - t}
        torch.cuda.reset_peak_memory_stats()
        db = Database.wrap(index)
        for front in ("ivf", "graph"):
            plan = QueryPlan(shards=world, front=front, backend="cuda")
            t = time.perf_counter()
            if front == "graph":
                # the stacked graph partition (~15 GB of halo copies and
                # rows at 1M x 768) would not fit on the card once per
                # rank: each rank maps the parent's copy and place()
                # reads only this rank's block of it
                stacked = torch.load(os.path.join(path, "graph.pt"),
                                     mmap=True, weights_only=False)
                target = Database.wrap(stacked.place(mesh))
                del stacked
            else:
                target = db
            target.query(queries[:64], plan=plan, mesh=mesh)
            torch.cuda.synchronize()
            dist.barrier()
            place_s = time.perf_counter() - t
            zero_launches(pq_adc_mod, tr)
            t = time.perf_counter()
            res = target.query(queries, plan=plan, mesh=mesh)
            torch.cuda.synchronize()
            out[front] = {
                "ids": res.ids.cpu(), "distances": res.distances.cpu(),
                "ledger": ledger_of(res.cost),
                "breakdown": res.cost.breakdown(),
                "query_s": time.perf_counter() - t, "place_s": place_s,
                "launches": launch_counts(pq_adc_mod, tr)}
            del target, res
            index.__dict__.pop("_placed_cache", None)
            db._compiled.clear()
            gc.collect()
            torch.cuda.empty_cache()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["host_peak_gb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def check_mesh_launches(label: str, counts: dict, mesh_rows: dict) -> None:
    """A sharded run launches ``pq_adc`` and the bounds kernel (kept in
    ``mesh_rows``) and no other refine kernel."""
    for name in ("pq_adc", "ternary_refine_fused_bounds"):
        if counts[name] == 0:
            fail(f"{label}: never launched {name}")
        mesh_rows[name][label] = counts[name]
    for name in ("ternary_refine_fused", "ternary_refine_batch",
                 "ternary_refine"):
        if counts[name]:
            fail(f"{label}: launched {name}")


def mesh_phase(torch, args, cfg, db, queries, results, launches,
               reset_launches, read_launches) -> dict:
    """The sharded search across processes (``launch.mesh``): a one-rank
    NCCL group, whose ``shards=1`` answers must equal the stacked
    ``shards=1`` ones bit for bit on both fronts, then ``--shards`` gloo
    ranks on the one card, one shard each, whose answers must each equal
    the stacked ``shards=--shards`` results (``results``) bit for bit.
    Returns the per-rank launches of ``pq_adc`` and the bounds kernel."""
    import multiprocessing

    import torch.distributed as dist
    from repro_torch.anns import QueryPlan, make_sharded_executor
    from repro_torch.launch.mesh import make_search_mesh

    index = db.index
    nq = queries.shape[0]
    mesh_rows = {"pq_adc": {}, "ternary_refine_fused_bounds": {}}

    def drop_partitions():
        index.__dict__.pop("_sharded_cache", None)
        index.__dict__.pop("_placed_cache", None)
        db._compiled.clear()
        gc.collect()
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    # ---- one process under NCCL: the mesh form against shards=1
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_search_mesh(1)
        print(f"mesh: NCCL {dist.get_backend()}, world 1, "
              f"{mesh.device}")
        for front in ("ivf", "graph"):
            label = "mesh_nccl" if front == "ivf" else "mesh_nccl_graph"
            plan = QueryPlan(shards=1, front=front, backend="cuda")
            want = db.query(queries, plan=plan)
            db.query(queries[:64], plan=plan, mesh=mesh)   # place, warm up
            torch.cuda.synchronize()
            reset_launches()
            got = db.query(queries, plan=plan, mesh=mesh)
            torch.cuda.synchronize()
            launches[label] = read_launches()
            same_bits(torch, label, got.ids, got.distances,
                      ledger_of(got.cost), got.cost.breakdown(), want)
            check_mesh_launches(label, launches[label], mesh_rows)
            # NCCL queues its collectives on the stream: the mesh form
            # blocks the host exactly as often as the stacked form (the
            # counters' transfers), counted by host_syncs; the profiler's
            # runtime calls are printed beside it and may only hold fewer
            forms = (("stacked", {}), ("nccl", {"mesh": mesh}))
            syncs = {name: host_syncs(torch, lambda kw=kw: db.query(
                queries[:64], plan=plan, **kw)) for name, kw in forms}
            calls = {name: runtime_calls(torch, lambda kw=kw: db.query(
                queries[:64], plan=plan, **kw)) for name, kw in forms}
            if syncs["nccl"] != syncs["stacked"]:
                fail(f"{label}: one 64-query batch blocks the host "
                     f"{syncs['nccl']} times, the stacked form "
                     f"{syncs['stacked']}")
            for name, _ in forms:
                check_syncs(f"{label} ({name} form)", syncs[name],
                            calls[name])
            print(f"{label}: one 64-query batch blocks the host "
                  f"{syncs['nccl']} times, as the stacked form does "
                  f"(set_sync_debug_mode counts); the profiler's blocking "
                  f"runtime calls {blocking_of(calls['nccl'])} against "
                  f"{blocking_of(calls['stacked'])}, all calls "
                  f"{calls['nccl'] or 'not recorded'}")
            runs = {"stacked": [], "nccl": []}
            for _ in range(3):
                for name, kw in (("stacked", {}), ("nccl", {"mesh": mesh})):
                    _, s = timed(torch, lambda: db.query(queries, plan=plan,
                                                         **kw))
                    runs[name].append(s)
            med = {k: sorted(v)[1] for k, v in runs.items()}
            print(f"{label}: ids, distances and ledger equal to the stacked "
                  f"shards=1 path's; launches {launches[label]}; "
                  f"{nq / med['nccl']:.1f} queries/s against stacked "
                  f"{nq / med['stacked']:.1f} (median of "
                  f"{[round(s, 6) for s in runs['nccl']]} and "
                  f"{[round(s, 6) for s in runs['stacked']]} s, in turns)")
            del want, got
            drop_partitions()
    finally:
        dist.destroy_process_group()

    # ---- --shards gloo ranks on the one card, one shard each
    world = args.shards
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    procs = []
    try:
        t = time.perf_counter()
        torch.save(index_arrays(index, queries), os.path.join(tmp,
                                                              "index.pt"))
        graph = make_sharded_executor(index, shards=world,
                                      front="graph").sharded
        torch.save(graph.to("cpu"), os.path.join(tmp, "graph.pt"))
        del graph
        drop_partitions()
        save_s = time.perf_counter() - t
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, world, port, tmp, cfg))
                 for r in range(world)]
        t = time.perf_counter()
        for p in procs:
            p.start()
        # a rank that fails leaves the others waiting in a collective:
        # stop at the first failure rather than at the deadline
        while any(p.is_alive() for p in procs) and \
                time.perf_counter() - t < MESH_JOIN_S and \
                all(p.exitcode in (None, 0) for p in procs):
            time.sleep(0.2)
        wall = time.perf_counter() - t
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            fail(f"mesh: gloo ranks exited with {codes} after {wall:.0f} s "
                 f"(None: still running, stopped)")
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    for front, flat in (("ivf", "sharded"), ("graph", "graph_sharded")):
        for r, o in enumerate(outs):
            got = o[front]
            label = f"mesh_gloo_{front}_r{r}"
            same_bits(torch, label, got["ids"], got["distances"],
                      got["ledger"], got["breakdown"], results[flat])
            launches[label] = got["launches"]
            check_mesh_launches(label, got["launches"], mesh_rows)
            print(f"{label}: ids, distances and ledger equal to the stacked "
                  f"{flat} path's; launches {got['launches']}; placement "
                  f"{got['place_s']:.2f} s, {nq} queries "
                  f"{got['query_s']:.3f} s")
    for r, o in enumerate(outs):
        print(f"mesh gloo rank {r}: load {o['load_s']:.1f} s, peak device "
              f"memory {o['peak_gb']:.2f} GB, peak host memory "
              f"{o['host_peak_gb']:.1f} GB (resident, the mapped files' "
              f"shared pages included)")
    parent = torch.cuda.max_memory_allocated() / 1e9
    card = parent + sum(o["peak_gb"] for o in outs)
    print(f"mesh phase: parent peak device memory {parent:.1f} GB; with the "
          f"ranks' peaks at most {card:.1f} GB on the card")
    if card >= PEAK_GB:
        fail(f"mesh phase: up to {card:.1f} GB on the card reaches "
             f"{PEAK_GB} GB")
    print(f"mesh: {world} gloo ranks on one card (each collective through "
          f"the host; not a multi-GPU throughput): {wall:.1f} s wall from "
          f"spawn to the last exit; index and stacked graph partition "
          f"saved in {save_s:.1f} s")
    return mesh_rows


# ------------------------------------------------------------ the examples

EXAMPLES = Path(__file__).resolve().parent / "examples"


def examples_phase(torch) -> None:
    """The four ``examples/*_torch.py`` on the card at their defaults
    (``train_lm_torch`` at 60 steps of its 200),
    each timed, each result checked as ``tests/test_torch_examples.py``
    checks it on the host."""
    import importlib

    sys.path.insert(0, str(EXAMPLES))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_lm_")
    total = 0.0
    try:
        for name, argv in (("quickstart_torch", []), ("tiered_torch", []),
                           ("rag_serving_torch", []),
                           ("train_lm_torch", ["--steps", "60",
                                               "--ckpt-dir", tmp])):
            print(f"---- example {name} {' '.join(argv)}".rstrip())
            got, s = timed(torch, lambda: importlib.import_module(name)
                           .main(argv))
            total += s
            print(f"example {name}: {s:.1f} s")
            if name == "quickstart_torch" and not (
                    got["recall"] >= got["baseline_recall"] - 0.1
                    and got["ssd"] < got["baseline_ssd"]):
                fail(f"quickstart_torch: {got}")
            if name == "tiered_torch" and not got["hot_s"] < got["warm_s"]:
                fail(f"tiered_torch: no modelled saving ({got})")
            if name == "rag_serving_torch":
                with torch.no_grad():
                    want = got["db"].query(got["embed_fn"](got["prompts"]),
                                           plan=got["plan"], k=5)
                if not torch.equal(got["result"].ids, want.ids):
                    fail("rag_serving_torch: ids differ from db.query's")
            if name == "train_lm_torch":
                # uniform random tokens: the loss falls towards ln(vocab)
                losses = got.losses
                first, last = (statistics.fmean(losses[:20]),
                               statistics.fmean(losses[-20:]))
                print(f"train_lm_torch: mean loss of the first 20 steps "
                      f"{first:.4f}, of the last 20 {last:.4f} (ln vocab "
                      f"{math.log(8192):.4f})")
                if not (all(math.isfinite(v) for v in losses)
                        and last < first):
                    fail(f"train_lm_torch: losses {losses[:3]} ... "
                         f"{losses[-3:]}")
            del got
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"examples: {total:.1f} s for the four")


def index_paths(torch, args, edge_errs: tuple, level0_attrs: dict,
                reset_launches, read_launches) -> tuple[dict, dict]:
    """Phases 2 to 8 over the 1M x 768 index.  Returns each kernel's row
    of the ``kernels`` line by name, and the launches by path.  Every
    tensor these phases make is freed when it returns."""
    from repro_torch.anns import Database, PipelineConfig, QueryPlan, \
        make_sharded_executor, recall_at_k
    from repro_torch.anns import registry
    from repro_torch.anns.stages import Candidates, graph_for, \
        make_graph_front, make_ivf_front
    from repro_torch.core import trq as trq_mod
    from repro_torch.core.estimator import alive_chain
    from repro_torch.data import make_dataset
    from repro_torch.index import graph as graph_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_adc as pq_adc_mod
    from repro_torch.kernels import ternary_refine as tr
    from repro_torch.quant import pq as pq_mod
    edge_err, edge_bounds_err, edge_adc_err, edge_level0_err = edge_errs


    # ---- data + index build
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t = t_phase = time.perf_counter()
    ds = make_dataset(n=args.n, d=768, n_queries=args.queries, k_gt=100,
                      generator=gen)
    torch.cuda.synchronize()
    print(f"dataset {args.n} x 768, {args.queries} queries, exact top-100: "
          f"{time.perf_counter() - t:.1f} s")
    cfg = PipelineConfig(dim=768, pq_m=96, pq_k=256, nlist=1024, nprobe=16,
                         trq_levels=1, final_k=10, refine_budget=40,
                         bound="cauchy", micro_batch=64)
    dbs, build_s = [], []
    for _ in range(2):
        t = time.perf_counter()
        dbs.append(Database.build(
            ds.x, cfg,
            generator=torch.Generator(device="cuda").manual_seed(args.seed)))
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t)
    db = dbs[0]
    index = db.index
    print(f"index build: {build_s[0]:.1f} s, again {build_s[1]:.1f} s (IVF "
          f"cap {index.ivf.cap})")
    check_repeatable(torch, index, dbs[1].index)
    del dbs
    t = time.perf_counter()
    si = make_sharded_executor(index, shards=args.shards).sharded
    torch.cuda.synchronize()
    print(f"partition into {args.shards} shards: "
          f"{time.perf_counter() - t:.2f} s (rows per shard "
          f"{si.shard_rows.tolist()}, up to {si.list_gid.shape[1]} lists "
          f"each)")
    # the graph front's kNN graph, then its repeatability on 100,000 rows
    # (no float atomics on the build path), then its range + halo shards
    t = time.perf_counter()
    graph = graph_for(index)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t
    print(f"graph build ({args.n} x 768, degree {graph.degree}): "
          f"{graph_s:.1f} s")
    n_rep = min(100_000, args.n)
    twice = []
    for _ in range(2):
        t = time.perf_counter()
        twice.append(graph_mod.build(
            ds.x[:n_rep], generator=torch.Generator(device="cuda")
            .manual_seed(args.seed)))
        torch.cuda.synchronize()
        twice.append(time.perf_counter() - t)
    if not (torch.equal(twice[0].neighbors, twice[2].neighbors)
            and torch.equal(twice[0].start, twice[2].start)):
        fail(f"two graph builds of the first {n_rep} rows differ")
    print(f"graph build repeatable: two builds of the first {n_rep} rows "
          f"({twice[1]:.1f} s, {twice[3]:.1f} s) give equal adjacency and "
          f"start nodes")
    del twice
    t = time.perf_counter()
    gsi = make_sharded_executor(index, shards=args.shards,
                                front="graph").sharded
    torch.cuda.synchronize()
    xs_loc = gsi.front_db[0]
    print(f"graph partition into {args.shards} shards: "
          f"{time.perf_counter() - t:.2f} s (rows per shard "
          f"{gsi.shard_rows.tolist()}; halo vectors xs_loc "
          f"{tuple(xs_loc.shape)}, {xs_loc.numel() * 4 / 1e9:.2f} GB)")
    t_phase = phase("dataset, index, graphs and partitions", t_phase)

    # ---- kernel phase, at the main path's shapes
    q64 = ds.queries[:64].contiguous()
    cand = make_ivf_front(index).candidates(q64)
    print(f"kernel phase shapes: Q={cand.ids.shape[0]} C={cand.ids.shape[1]}"
          f" M={cfg.pq_m} K={cfg.pq_k} G={index.trq.levels[0].packed.shape[1]}")
    lut64 = pq_mod.adc_table(index.codebook, q64)
    adc_d0, adc = check_adc(torch, pq_adc_mod, index.pq_codes, cand.ids,
                            cand.valid, lut64, "fatrq shape")
    lib_ms, lib_d = adc_library(torch, index.pq_codes, cand.ids, lut64)
    ok, lib_err = close(lib_d[cand.valid], adc_d0[cand.valid], ADC_ATOL,
                        ADC_RTOL)
    if not ok:
        fail(f"embedding_bag disagrees with pq_adc on valid slots ({lib_err})")
    adc["library_ms"] = lib_ms
    print(f"pq_adc library: embedding_bag {lib_ms:.4f} ms over every slot "
          f"(int32 indices built outside the timer, no +inf mask), max err "
          f"on valid slots {lib_err:.3g}")
    del lib_d
    # each kernel's global form at the fatrq shape, where the shared form
    # fits: bit-equal to it, timed beside it
    glob = {"pq_adc": form_times(
        torch, "pq_adc fatrq shape",
        lambda: pq_adc_mod.pq_adc(index.pq_codes, cand.ids, cand.valid,
                                  lut64),
        lambda: pq_adc_mod._pq_adc(index.pq_codes, cand.ids, cand.valid,
                                   lut64, form="global"))}
    stores1 = tr.RefineStores.from_trq(index.trq)
    x_c = pq_mod.decode(index.codebook, index.pq_codes)
    trq2 = trq_mod.encode_database(index.x, x_c, num_levels=2)
    del x_c
    stores2 = tr.RefineStores.from_trq(trq2)
    del trq2
    model = index.trq.model
    delta = torch.rand(cand.ids.shape, generator=gen,
                       device=gen.device) < 0.3
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
    # pq_adc on shard 0's own store and shard-local ids; each valid slot's
    # d0 must be the unsharded d0 of the same global row, bit for bit
    sh_d0, sh_adc = check_adc(torch, pq_adc_mod, si.pq_codes[0], sh.ids,
                              sh.valid, lut64, "shard 0")
    glob_d0 = pq_adc_mod.pq_adc(index.pq_codes, sh_cand.ids, sh.valid, lut64)
    if not torch.equal(sh_d0[sh.valid], glob_d0[sh.valid]):
        fail("pq_adc: shard 0's d0 is not bit-identical to the unsharded d0 "
             "of the same rows")
    print("pq_adc shard 0: d0 bit-identical to the unsharded d0 of the same "
          "global rows")
    adc["max_abs_err"] = max(adc["max_abs_err"], sh_adc["max_abs_err"],
                             edge_adc_err)
    del sh_d0, glob_d0, adc_d0
    bounds_err, bounds_ties = 0.0, 0
    for stores, bnd in ((stores1, "cauchy"), (stores1, "quantile"),
                        (stores2, "cauchy"), (stores2, "quantile")):
        err, n = check_bounds(torch, tr, ops, alive_chain, stores, model,
                              sh_cand, q64, k=cfg.final_k, bound_name=bnd,
                              z=cfg.z,
                              label=f"{bnd} L={stores.num_levels}")
        bounds_err, bounds_ties = max(bounds_err, err), bounds_ties + n
    # the same kernels at the graph front's shapes
    gcand = make_graph_front(index).candidates(q64)
    gsh = registry.sharded_front("graph").body(
        q64, gsi.front_rep, gsi.front_db, gsi.codebook, gsi.pq_codes,
        **dict(gsi.front_args))[0]
    g_adc, g_refine, g_bounds = graph_kernels(
        torch, tr, ops, alive_chain, pq_adc_mod, Candidates, gcand, gsh,
        gsi.gid[0][gsh.ids.long()].long(), q64, lut64, index,
        (stores1, stores2), model, cfg,
        torch.Generator(device="cuda").manual_seed(args.seed + 5))
    del gcand, gsh
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
    glob["ternary_refine_fused_bounds"] = form_times(
        torch, "ternary_refine_fused_bounds shard 0",
        lambda: tr.ternary_refine_fused_bounds(*b_args, model,
                                               bound="cauchy", z=cfg.z),
        lambda: tr._bounds(*b_args, model, bound="cauchy", z=cfg.z,
                           form="global"))
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
                               counted, edge_level0_err, level0_attrs)
    l0 = ops.level0_inputs(q64, packed64.shape[-1], *cols, model.w,
                           model.bias)
    glob["ternary_refine_batch"] = form_times(
        torch, "ternary_refine_batch fatrq shape",
        lambda: tr.ternary_refine_batch(packed64, l0[0], l0[2], l0[1]),
        lambda: tr._level0_batch(packed64, l0[0], l0[2], l0[1],
                                 form="global"))
    glob["ternary_refine"] = form_times(
        torch, "ternary_refine fatrq shape (query 0)",
        lambda: tr.ternary_refine(packed64[0], l0[0][0], l0[2][0],
                                  l0[1][:1]),
        lambda: tr._level0_single(packed64[0], l0[0][0], l0[2][0],
                                  l0[1][:1], form="global"))
    del l0
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
    # the prune alone on these candidates' level-0 bounds: the bounds
    # kernel's, which the score launch's equal (the same device code)
    _, lo_b, hi_b = tr.ternary_refine_fused_bounds(
        *refine_args[:5], model, bound="cauchy", z=cfg.z)
    prune_row = check_prune(
        torch, tr, lo_b[:, 0].contiguous(), hi_b[:, 0].contiguous(),
        cand.valid, tr.ternary_refine_fused(*refine_args, **refine_kw),
        k=cfg.final_k)
    glob["ternary_refine_fused"] = form_times(
        torch, "ternary_refine_fused fatrq shape",
        lambda: tr.ternary_refine_fused(*refine_args, **refine_kw),
        lambda: tr._fused(*refine_args, **refine_kw, form="global"))

    def prune_in(form):
        out = torch.empty_like(cand.valid)
        counts = torch.zeros((cand.valid.shape[0], 2), dtype=torch.int32,
                             device=out.device)
        tau = tr._prune(lo_b[:, 0].contiguous(), hi_b[:, 0].contiguous(),
                        cand.valid, None, counts, out, k=cfg.final_k,
                        form=form)
        return tau, out, counts
    glob["prune"] = form_times(torch, "prune fatrq shape",
                               lambda: prune_in(None),
                               lambda: prune_in("global"))
    del cand, stores1, every, lo_b, hi_b
    t_phase = phase("kernels at the index paths' shapes", t_phase)

    # ---- main path
    queries = ds.queries
    plans = {"fatrq": QueryPlan(backend="cuda"),
             "baseline": QueryPlan(mode="baseline"),
             "sharded": QueryPlan(shards=args.shards, backend="cuda"),
             "graph": QueryPlan(front="graph", backend="cuda"),
             "graph_baseline": QueryPlan(front="graph", mode="baseline"),
             "graph_sharded": QueryPlan(front="graph", shards=args.shards,
                                        backend="cuda")}
    for plan in plans.values():                 # warm-up: load, allocate
        db.query(q64, plan=plan)
    torch.cuda.synchronize()
    # each path runs with every count set to 0 just before it and read just
    # after; pq_adc must launch in all six, the fused refine kernel in the
    # two fatrq paths, the bounds kernel (and not the fused one) in the two
    # sharded ones
    needs = {"fatrq": ("pq_adc", "ternary_refine_fused"),
             "baseline": ("pq_adc",),
             "sharded": ("pq_adc", "ternary_refine_fused_bounds")}
    needs.update(graph=needs["fatrq"], graph_baseline=needs["baseline"],
                 graph_sharded=needs["sharded"])
    results = {}
    for mode, plan in plans.items():
        reset_launches()
        results[mode] = db.query(queries, plan=plan)
        torch.cuda.synchronize()
        launches[mode] = read_launches()
        for name in needs[mode]:
            if launches[mode][name] == 0:
                fail(f"the {mode} path never launched {name}")
        if any(launches[mode][name] for name in GLOBAL_COUNTS):
            fail(f"the {mode} path ran a global form at the 768-wide shapes")
        print(f"{mode} path launches over {queries.shape[0]} queries in "
              f"{cfg.micro_batch}-query micro-batches: {launches[mode]}")
    t_phase = phase("static, sharded and graph paths: counted runs", t_phase)
    # the multi-level kernels are each path's only refine scoring
    for mode, others in (("fatrq", ("ternary_refine_fused_bounds",
                                    "ternary_refine_batch",
                                    "ternary_refine")),
                         ("sharded", ("ternary_refine_fused",
                                      "ternary_refine_batch",
                                      "ternary_refine"))):
        for path in (mode, "graph" if mode == "fatrq" else "graph_sharded"):
            for name in others:
                if launches[path][name]:
                    fail(f"the {path} path launched {name}")

    # queries/s: host clock around whole searches ended by a synchronize,
    # the paths in turns, median of TIMING_RUNS
    runs = {mode: [] for mode in plans}
    for _ in range(TIMING_RUNS):
        for mode, plan in plans.items():
            t = time.perf_counter()
            db.query(queries, plan=plan)
            torch.cuda.synchronize()
            runs[mode].append(time.perf_counter() - t)
    t_phase = phase("static, sharded and graph paths: timed runs", t_phase)
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
        # the graph paths' floor only catches a broken traversal
        floor = 0.1 if label.startswith("graph") else 0.5
        if recall < floor:
            fail(f"{label}: recall@10 {recall:.4f} below {floor}")
        prof_q = queries[:PROFILE_GRAPH_QUERIES] \
            if label.startswith("graph") else queries
        device_breakdown(torch, f"{label} ({prof_q.shape[0]} queries)",
                         lambda: db.query(prof_q, plan=plans[label]))
    tier_bytes = lambda c: {t.value: v.bytes                  # noqa: E731
                            for t, v in c.by_tier().items()}
    for flat, sharded in (("fatrq", "sharded"), ("graph", "graph_sharded")):
        if not torch.equal(results[sharded].ids, results[flat].ids):
            n_rows = int((results[sharded].ids != results[flat].ids)
                         .any(1).sum())
            fail(f"{sharded} ids differ from the unsharded {flat} ids in "
                 f"{n_rows} queries")
        if tier_bytes(results[sharded].cost) != tier_bytes(
                results[flat].cost):
            fail(f"{sharded} per-tier bytes "
                 f"{tier_bytes(results[sharded].cost)} differ from {flat}'s "
                 f"{tier_bytes(results[flat].cost)}")
        print(f"{sharded} ({args.shards} shards): ids and per-tier bytes "
              f"equal to the unsharded {flat} path's")

    t_phase = phase("static, sharded and graph paths: checks and profiles",
                    t_phase)

    # ---- the plain reference backend on the card, over a subset
    sub = queries[:64]
    ledger = lambda c: {k: (v.accesses, v.bytes)              # noqa: E731
                        for k, v in c.ledger.items()}
    for label in ("fatrq", "sharded", "graph", "graph_sharded"):
        ref = db.query(sub, plan=dataclasses.replace(
            plans[label], backend="reference", micro_batch=8))
        cud = db.query(sub, plan=plans[label])
        if not torch.equal(ref.ids, cud.ids):
            fail(f"{label}: reference and cuda backends return different "
                 f"ids")
        if ledger(ref.cost) != ledger(cud.cost):
            fail(f"{label}: ledgers differ: {ledger(ref.cost)} vs "
                 f"{ledger(cud.cost)}")
        print(f"{label}: the reference backend on {sub.shape[0]} queries "
              f"gives the cuda backend's ids and ledger")

    t_phase = phase("static, sharded and graph paths: the reference "
                    "backend", t_phase)

    # ---- the paper's storage and distortion comparators on the index
    baselines_phase(torch, args, index, ds)
    gc.collect()
    t_phase = phase("baselines", t_phase)

    # ---- the serving path over the same index
    v_adc, v_refine = serving_phase(torch, args, cfg, db, ds, launches,
                                    reset_launches, read_launches)
    t_phase = phase("serving (static and sharded)", t_phase)

    def serve_check(label, idx, q):
        t = time.perf_counter()
        retriever_check(torch, label, idx, q, launches, reset_launches,
                        read_launches,
                        needs=("pq_adc", "ternary_refine_fused"))
        print(f"serving phase ({label}): {time.perf_counter() - t:.1f} s")

    # ---- the tiered layout over the same index
    t_adc, t_refine = tiered_phase(torch, args, cfg, db, ds, results,
                                   stores2, launches, reset_launches,
                                   read_launches, serve_check)
    del stores2
    gc.collect()          # the tiered indexes and their executors
    t_phase = phase("tiered", t_phase)

    # ---- the streaming layout over the same index; the static paths are
    # done, so their partitions (the graph's 11.9 GB) and executors (each
    # graph front's 3.1 GB PQ decode) are freed first
    peak_static = torch.cuda.max_memory_allocated() / 1e9
    index.__dict__.pop("_sharded_cache")
    index.__dict__.pop("_executor_cache")
    db._compiled.clear()
    del gsi, xs_loc, si
    torch.cuda.reset_peak_memory_stats()
    s_adc, s_refine = streaming_phase(torch, args, cfg, index, ds, q64,
                                      lut64, launches, reset_launches,
                                      read_launches, serve_check)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"peak device memory: {max(peak_static, peak):.1f} GB "
          f"({peak_static:.1f} GB before the streaming phase, {peak:.1f} GB "
          f"in it)")
    if max(peak_static, peak) >= PEAK_GB:
        fail(f"peak device memory {max(peak_static, peak):.1f} GB reaches "
             f"{PEAK_GB} GB")
    gc.collect()          # the streaming index and its snapshots
    t_phase = phase("streaming", t_phase)
    invalidation_phase(torch, args, cfg, index, ds)
    t_phase = phase("serving (invalidation)", t_phase)

    # ---- the high-recall IVF path (the prune's global form)
    nprobe_row, nprobe_adc_err = nprobe_path(
        torch, cfg, index, ds, launches, reset_launches, read_launches)
    t_phase = phase(f"fatrq_nprobe{NPROBE}", t_phase)

    # ---- the sharded search across processes, over the same index
    mesh_rows = mesh_phase(torch, args, cfg, db, queries, results, launches,
                           reset_launches, read_launches)
    phase("mesh", t_phase)

    print("library_ms: pq_adc's is one embedding_bag call at the fatrq "
          "shape (int32 indices built outside the timer, no +inf mask; the "
          "port never calls it); null for the refine kernels, which no "
          "single PyTorch call computes")
    print("launches: each kernel's own path's run (fatrq for pq_adc and "
          "ternary_refine_fused, sharded for ternary_refine_fused_bounds, "
          "ops for ternary_refine_batch and ternary_refine); "
          "launches_by_path gives every path's own run; each row's graph "
          "entry holds the kernel at the graph path's shapes (the graph "
          "path's launches; graph_sharded's for the bounds kernel); the "
          "streaming entries of pq_adc and ternary_refine_fused hold them "
          "at the streaming IVF shape (round 0, mid-churn) with the "
          "streaming path's launches; the tiered entries hold them at the "
          "tiered shape (64 Zipfian queries on the rebalanced placement, "
          "hot slots invalid, cold slots is_delta) with the tiered hot "
          "pass's launches; the fused call "
          "launches its prune once per level, so the prune's launches on "
          "the fatrq path are the fused kernel's (ternary_refine_prune "
          "counts only the prune launched alone)")
    print("ternary_refine_fused prune: its own ms, device ms, plain ms and "
          "bound; library_ms is one torch.topk of the masked upper bounds, "
          "which computes tau only, not the mask or the counts")
    prune_row["launches"] = launches["fatrq"]["ternary_refine_fused"]
    refine["prune"] = prune_row
    g_adc["launches"] = launches["graph"]["pq_adc"]
    g_refine["launches"] = g_refine["prune"]["launches"] = \
        launches["graph"]["ternary_refine_fused"]
    g_bounds["launches"] = launches["graph_sharded"][
        "ternary_refine_fused_bounds"]
    adc["graph"], refine["graph"], bounds_row["graph"] = \
        g_adc, g_refine, g_bounds
    adc["streaming"], refine["streaming"] = s_adc, s_refine
    adc["tiered"], refine["tiered"] = t_adc, t_refine
    v_adc["launches"] = launches["serving_engine"]["pq_adc"]
    v_refine["launches"] = launches["serving_engine"]["ternary_refine_fused"]
    adc["serving"], refine["serving"] = v_adc, v_refine
    adc["mesh"] = mesh_rows["pq_adc"]
    bounds_row["mesh"] = mesh_rows["ternary_refine_fused_bounds"]

    for name, row in (("pq_adc", adc), ("ternary_refine_fused", refine),
                      ("ternary_refine_fused_bounds", bounds_row),
                      ("prune", refine["prune"]),
                      *level0_rows.items()):
        row["global"] = {"fatrq_shape": glob[name]}
    refine["prune"]["global"]["fatrq_nprobe256"] = nprobe_row
    adc["max_abs_err"] = max(adc["max_abs_err"], nprobe_adc_err)
    return {"pq_adc": adc, "ternary_refine_fused": refine,
            "ternary_refine_fused_bounds": bounds_row,
            "ternary_refine_batch": level0_rows["ternary_refine_batch"],
            "ternary_refine": level0_rows["ternary_refine"]}, launches


# ------------------------------------------------ the high-recall IVF path

NPROBE = 256                    # lists probed by the fatrq_nprobe256 path
NPROBE_C = 750_080              # its C at the 1M index's IVF cap of 2,930
NPROBE_REF_QUERIES = 128        # queries of its reference-backend check
NPROBE_ADC_QUERIES = 8          # queries of its pq_adc check
NPROBE_REF_BATCH = 2            # micro-batch of that check (the plain
                                # unpack of (2, C, 768) trits)


def nprobe_path(torch, cfg, index, ds, launches, reset_launches,
                read_launches) -> tuple[dict, float]:
    """The high-recall end of a recall/QPS sweep (``fatrq_nprobe256``):
    the static IVF fatrq search with ``NPROBE`` of the 1024 lists probed,
    through ``make_executor(index, front="ivf", backend="cuda",
    micro_batch=64, nprobe=NPROBE)``, where C = NPROBE x cap is past the
    prune's shared form.  Over all queries, every count reset just before
    and read just after: one fused call and one prune launch in the
    global form per 64-query micro-batch and TRQ level, no other global
    form, no bounds or level-0 kernel; distances the ids' exact L2, ``rerank:ssd`` the budget
    per query, recall@10 beside the IVF ceiling (``recall_by_cut``),
    queries/s (median of ``TIMING_RUNS``), each kernel's device ms in one
    run; ``pq_adc`` against its plain version on the first
    ``NPROBE_ADC_QUERIES`` queries' candidates (``hold_adc``: the
    ``reference`` backend's front calls the same kernel, so the check
    below cannot see it), the front's d0 bit-equal to it; one fused call
    allocating only its outputs (no scratch); the prune alone on the first
    64 queries' level-0 bounds (``check_prune``); the ``reference``
    backend's ids, distances and ledger equal to ``cuda``'s on the first
    ``NPROBE_REF_QUERIES``.  Returns the prune's row at the path's shape
    and ``pq_adc``'s max error there."""
    from repro_torch.anns import recall_at_k
    from repro_torch.anns.executor import make_executor
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_adc as pq_adc_mod
    from repro_torch.kernels import ternary_refine as tr
    from repro_torch.quant import pq as pq_mod
    label = "fatrq_nprobe256"
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    queries = ds.queries
    nq = queries.shape[0]
    c = NPROBE * index.ivf.cap
    ex = make_executor(index, front="ivf", backend="cuda",
                       micro_batch=cfg.micro_batch, nprobe=NPROBE)
    print(f"{label}: nprobe {NPROBE} of {cfg.nlist} lists, C = {c:,} "
          f"(cap {index.ivf.cap}), prune form {ops.prune_form(c)}")
    if ops.prune_form(c) != "global":
        fail(f"{label}: C = {c} does not select the prune's global form")
    ex.execute(queries[:64])                        # warm-up
    torch.cuda.synchronize()
    reset_launches()
    ids, dists, cost = ex.execute(queries)
    torch.cuda.synchronize()
    launches[label] = got = read_launches()
    print(f"{label} path launches over {nq} queries: {got}")
    calls = -(-nq // cfg.micro_batch) * cfg.trq_levels
    for name in ("ternary_refine_fused", "prune (global)"):
        if got[name] != calls:
            fail(f"{label}: {got[name]} launches of {name}, not {calls}")
    if got["pq_adc"] == 0:
        fail(f"the {label} path never launched pq_adc")
    for name in ("ternary_refine_fused_bounds", "ternary_refine_batch",
                 "ternary_refine", *GLOBAL_COUNTS):
        if name != "prune (global)" and got[name]:
            fail(f"the {label} path launched {name}")
    runs = []
    for _ in range(TIMING_RUNS):
        t = time.perf_counter()
        ex.execute(queries)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
    exact = ((index.x[ids.long()] - queries[:, None]) ** 2).sum(-1)
    ok, err = close(dists, exact, 1e-5, 1e-5)
    if not ok:
        fail(f"{label}: distances are not the ids' exact L2 ({err})")
    ssd = cost.ledger["rerank:ssd"].accesses / nq
    if ssd != cfg.refine_budget:
        fail(f"{label}: {ssd} SSD fetches a query, not the budget "
             f"{cfg.refine_budget}")
    recall = recall_at_k(ids, ds.gt, cfg.final_k)
    cuts = ex.recall_by_cut(queries, ds.gt)
    valid = cost.ledger["refine:cxl"].accesses / nq
    print(f"{label}: C {c:,}, {valid:.1f} valid slots a query; recall@10 "
          f"{recall:.4f} (the IVF ceiling {cuts['candidates']:.4f}: the "
          f"share of the true top-10 among the candidates; by cut {cuts}),"
          f" {nq / statistics.median(runs):.1f} queries/s (median of "
          f"{[round(r, 6) for r in runs]} s), rerank:ssd {ssd:.1f} a query")
    if recall < 0.5:
        fail(f"{label}: recall@10 {recall:.4f} below 0.5")
    print_launches(torch, f"{label} path (ms per path run of {nq} queries)",
                   lambda: ex.execute(queries), 1)
    device_breakdown(torch, f"{label} ({nq} queries)",
                     lambda: ex.execute(queries))
    del exact

    # one fused call on the first 64 queries allocates its outputs (est,
    # lo, hi: 4 B a slot; alive: 1 B) and small per-query rows, no scratch
    q64 = queries[:64].contiguous()
    cand = ex.front.candidates(q64)
    # pq_adc at the path's shape, on a few queries: the plain version's
    # (Q, C, M) gather takes ~13 B an element
    na = NPROBE_ADC_QUERIES
    lut = pq_mod.adc_table(index.codebook, q64)       # the front's LUTs
    d0, adc_err = hold_adc(torch, pq_adc_mod, index.pq_codes,
                           cand.ids[:na], cand.valid[:na], lut[:na],
                           f"the {label} shape")
    if not torch.equal(d0, cand.d0[:na]):
        fail(f"{label}: the front's d0 is not pq_adc's")
    print(f"pq_adc at the {label} shape (Q = {na}, C = {c:,}, M = "
          f"{index.pq_codes.shape[1]}, {int(cand.valid[:na].sum())} valid): "
          f"equal to pq_adc_plain (max err {adc_err:.3g}), the front's d0 "
          f"bit-equal to it")
    del d0, lut
    stores, model = ex.backend.stores(index.trq), index.trq.model
    kw = dict(k=cfg.final_k, bound=cfg.bound, z=cfg.z)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused = tr.ternary_refine_fused(stores, q64, cand.ids, cand.d0,
                                    cand.valid, None, model, **kw)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    outputs = 13 * cand.ids.numel()
    if extra > outputs + (4 << 20):
        fail(f"{label}: one fused call allocated {extra} B, over its "
             f"outputs' {outputs} B")
    print(f"{label}: one fused call over {tuple(cand.ids.shape)} slots "
          f"allocated {extra / 1e6:.1f} MB (its outputs {outputs / 1e6:.1f} "
          f"MB; no prune scratch)")
    _, lo_b, hi_b = tr.ternary_refine_fused_bounds(
        stores, q64, cand.ids, cand.d0, cand.valid, model,
        bound=cfg.bound, z=cfg.z)
    row = check_prune(torch, tr, lo_b[:, 0].contiguous(),
                      hi_b[:, 0].contiguous(), cand.valid, fused,
                      k=cfg.final_k, label=f"the {label} shape")
    row.update(smem_bytes=ops.PRUNE_STREAM_SMEM,
               launches=got["prune (global)"])
    del fused, lo_b, hi_b, cand

    # the plain reference backend on the first queries
    sub = queries[:NPROBE_REF_QUERIES]
    ref = make_executor(index, front="ivf", backend="reference",
                        micro_batch=NPROBE_REF_BATCH, nprobe=NPROBE)
    r_ids, r_d, r_cost = ref.execute(sub)
    c_ids, c_d, c_cost = ex.execute(sub)
    if not (torch.equal(r_ids, c_ids) and torch.equal(r_d, c_d)
            and ledger_of(r_cost) == ledger_of(c_cost)):
        fail(f"{label}: the reference and cuda backends differ on "
             f"{sub.shape[0]} queries (ids, distances or ledger)")
    print(f"{label}: the reference backend on {sub.shape[0]} queries "
          f"(micro-batch {NPROBE_REF_BATCH}) gives the cuda backend's ids, "
          f"distances and ledger")
    del ref, r_ids, r_d, c_ids, c_d
    peak = max(peak, torch.cuda.max_memory_allocated()) / 1e9
    index.__dict__.get("_executor_cache", {}).clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: peak device memory {peak:.1f} GB, "
          f"{time.perf_counter() - t0:.1f} s")
    if peak >= PEAK_GB:
        fail(f"{label}: peak device memory {peak:.1f} GB reaches {PEAK_GB}"
             f" GB")
    return row, adc_err


# ------------------------------------------------------- the wide phase

#: (D, pq_m) of the wide cells: backbone widths at the JAX package's
#: pq_m = d // 8 (qwen2.5-3b, xlstm, zamba2: 2048; qwen2-72b: 8192), K = 256
WIDE_SHAPES = ((2048, 256), (8192, 1024))
WIDE_N, WIDE_QUERIES, WIDE_RECALL = 100_000, 1000, 0.5
#: fatrq's recall@10 against the IVF front's ceiling (the share of the true
#: top-10 among the candidates: what an exact rerank of them all reaches)
WIDE_CEILING_SHARE = 0.9
#: the within-cluster spread of ``make_embeddings`` at D = 768; the wide
#: rows take 0.35 * sqrt(768 / D), which keeps the 768-wide rows' ratio of
#: the within-cluster noise's norm to the cluster centre's (at a fixed
#: spread the noise's norm grows as sqrt(D), and at the default spread the
#: rows are so diffuse at D = 8192 that the IVF front holds 38% of the
#: true top-10)
WIDE_BASE_SPREAD, WIDE_BASE_D = 0.35, 768


def wide_dataset(torch, n: int, dim: int, n_queries: int, seed: int):
    """``make_dataset``'s rows, queries and exact top-10 at width ``dim``
    with the within-cluster spread scaled as ``WIDE_BASE_SPREAD`` says,
    drawn on the card from ``seed``."""
    from repro_torch.data import Dataset, brute_force_topk, make_embeddings
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = make_embeddings(gen, n, dim, spread=WIDE_BASE_SPREAD
                        * (WIDE_BASE_D / dim) ** 0.5)
    pick = torch.randint(0, n, (n_queries,), generator=gen,
                         device=gen.device)
    noise = torch.randn((n_queries, dim), generator=gen, device=gen.device)
    q = x[pick] + 0.25 * noise / dim ** 0.5
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return Dataset(x=x, queries=q, gt=brute_force_topk(x, q, 10))
WIDE_OPS_QUERIES = 8            # queries of the level-0 ops path at D = 8192
WIDE_SHARDED_REF_BATCH = 2      # micro-batch of the sharded reference check
WIDE_SHARDED_ADC_QUERIES = 4    # queries of its shard-0 pq_adc check


def wide_phase(torch, args, launches, reset_launches, read_launches,
               build) -> dict:
    """The port's own build and search at the backbones' widths, where
    ``pq_adc`` (both), the fused kernel, the bounds kernel and the level-0
    kernel (D = 8192, G = 1639) run their global forms: for each (D, M) of
    ``WIDE_SHAPES`` a 100,000-row index
    (``wide_dataset``; nlist 100, nprobe 16, budget 40, one TRQ level) and
    1000 queries through ``QueryPlan(backend="cuda")``, every count reset
    just before and read just after (``wide_<D>``): the global forms
    launched, the refine tables once a fused call, distances the ids'
    exact L2, the ``reference`` backend's ids and ledger on 64 queries,
    recall@10 of at least 0.5 and of at least 0.9 of the IVF front's
    ceiling (the share of the true top-10 among the candidates), queries/s
    (median of 3), each kernel's device ms in one run of the path, and the
    kernels against their plain versions at the path's shape
    (``path_kernels``); at D = 8192 also the level-0 ops path
    (``wide_ops``: ``ops.refine_scores_batch`` / ``refine_scores`` on 8
    queries' candidates, its global form) and the sharded layout on the
    same index (``wide_sharded``: the bounds kernel's global form on every
    shard).  Returns the rows by cell."""
    from repro_torch.anns import Database, PipelineConfig, QueryPlan, \
        recall_at_k
    from repro_torch.anns.stages import make_ivf_front
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_refine as tr
    rows = {}
    ledger = lambda c: {k: (v.accesses, v.bytes)              # noqa: E731
                        for k, v in c.ledger.items()}
    for dim, m in WIDE_SHAPES:
        t0 = time.perf_counter()
        label = f"wide_{dim}"
        ds = wide_dataset(torch, WIDE_N, dim, WIDE_QUERIES, args.seed)
        cfg = PipelineConfig(dim=dim, pq_m=m, pq_k=256, nlist=100,
                             nprobe=16, trq_levels=1, final_k=10,
                             refine_budget=40, bound="cauchy",
                             micro_batch=64)
        db, build_s = timed(torch, lambda: Database.build(
            ds.x, cfg, generator=torch.Generator(device="cuda")
            .manual_seed(args.seed)))
        index = db.index
        g = index.trq.levels[0].packed.shape[1]
        forms = {"pq_adc": ops.adc_form(m, cfg.pq_k),
                 "ternary_refine_fused": ops.refine_form(g)}
        print(f"{label}: {WIDE_N} x {dim}, PQ M={m} K={cfg.pq_k}, G={g}, "
              f"IVF cap {index.ivf.cap} (C = {cfg.nprobe * index.ivf.cap}); "
              f"data and build {time.perf_counter() - t0:.1f} s (build "
              f"{build_s:.1f}); forms {forms}")
        if forms["pq_adc"] != "global":
            fail(f"{label}: pq_adc selects the {forms['pq_adc']} form")
        plan = QueryPlan(backend="cuda")
        db.query(ds.queries[:64], plan=plan)        # warm-up
        torch.cuda.synchronize()
        reset_launches()
        res = db.query(ds.queries, plan=plan)
        torch.cuda.synchronize()
        launches[label] = got = read_launches()
        print(f"{label} path launches over {WIDE_QUERIES} queries: {got}")
        for name in ("pq_adc", "ternary_refine_fused", "pq_adc (global)"):
            if got[name] == 0:
                fail(f"the {label} path never launched {name}")
        if (got["ternary_refine_fused (global)"] > 0) != (
                forms["ternary_refine_fused"] == "global"):
            fail(f"the {label} path ran the fused kernel in a form its "
                 f"shapes do not select")
        if got["refine tables (global)"] * cfg.trq_levels != \
                got["ternary_refine_fused (global)"]:
            fail(f"the {label} path did not build the refine tables once "
                 f"per fused call")
        runs = []
        for _ in range(TIMING_RUNS):
            t = time.perf_counter()
            db.query(ds.queries, plan=plan)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
        exact = ((index.x[res.ids.long()] - ds.queries[:, None]) ** 2).sum(-1)
        ok, err = close(res.distances, exact, 1e-5, 1e-5)
        if not ok:
            fail(f"{label}: distances are not the ids' exact L2 ({err})")
        sub = ds.queries[:64]
        ref = db.query(sub, plan=QueryPlan(backend="reference",
                                           micro_batch=8))
        cud = db.query(sub, plan=plan)
        if not torch.equal(ref.ids, cud.ids) or \
                ledger(ref.cost) != ledger(cud.cost):
            fail(f"{label}: the reference and cuda backends differ (ids or "
                 f"ledger)")
        print(f"{label}: the reference backend on {sub.shape[0]} queries "
              f"gives the cuda backend's ids and ledger")
        recall = recall_at_k(res.ids, ds.gt, cfg.final_k)
        ceiling = ivf_ceiling(torch, make_ivf_front(index), ds.queries,
                              ds.gt[:, :cfg.final_k])
        print(f"{label}: recall@10 {recall:.4f} (the IVF front's ceiling "
              f"{ceiling:.4f}: the share of the true top-10 among the "
              f"candidates), {WIDE_QUERIES / statistics.median(runs):.1f} "
              f"queries/s (median of {[round(r, 6) for r in runs]} s), SSD "
              f"fetches/query "
              f"{res.cost.ledger['rerank:ssd'].accesses / WIDE_QUERIES:.1f}")
        if recall < WIDE_CEILING_SHARE * ceiling:
            fail(f"{label}: recall@10 {recall:.4f} below {WIDE_CEILING_SHARE}"
                 f" of the IVF front's ceiling {ceiling:.4f}")
        if recall < WIDE_RECALL:
            fail(f"{label}: recall@10 {recall:.4f} below {WIDE_RECALL}")
        print_launches(torch, f"{label} path (ms per path run of "
                              f"{WIDE_QUERIES} queries)",
                       lambda: db.query(ds.queries, plan=plan), 1)
        del ref, cud, exact     # res: the answers a sharded path must give
        adc, refine, *_ = path_kernels(torch, db, cfg,
                                       ds.queries[:64].contiguous(),
                                       f"{label} shape")
        adc["launches"] = got["pq_adc"]
        refine["launches"] = got["ternary_refine_fused"]
        rows[label] = {"pq_adc": adc, "ternary_refine_fused": refine,
                       "queries_per_s": WIDE_QUERIES / statistics.median(runs),
                       "recall_at_10": recall, "ivf_ceiling": ceiling}
        if forms["ternary_refine_fused"] == "global":
            rows["wide_ops"] = wide_ops(torch, tr, ops, build, index,
                                        make_ivf_front, ds.queries, launches,
                                        reset_launches, read_launches)
            rows[f"{label}_sharded"] = wide_sharded(
                torch, args, db, cfg, ds, res, ceiling, launches,
                reset_launches, read_launches)
        print(f"{label}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        del db, index, ds, res
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{label}: {time.perf_counter() - t0:.1f} s")
    return rows


def wide_sharded(torch, args, db, cfg, ds, want, ceiling, launches,
                 reset_launches, read_launches) -> dict:
    """The sharded layout at the wide index's width (``wide_<D>_sharded``,
    D = 8192: G = 1639, past the refine tables' shared memory): the same
    ``db`` through ``QueryPlan(shards=args.shards, backend="cuda")``, every
    count reset just before and read just after: the bounds kernel's
    global form launched once a shard and micro-batch, the refine tables
    once a bounds call, never the bounds kernel's shared form or another
    refine kernel; ids, distances and per-tier bytes equal to the
    unsharded answers ``want``; the ``reference`` backend's ids and ledger
    on 64 queries; recall@10 beside the IVF front's ``ceiling``; queries/s
    (median of 3) and each kernel's device ms in one run of the path; and
    the bounds kernel on shard 0's candidates of 64 queries (its own
    store, shard-local ids: what the path launches) against its plain
    version and the fused kernel's est (``check_bounds``), timed with the
    chunk plan its launch took, and ``pq_adc`` (its global form) on the
    same candidates against its plain version on a few queries
    (``hold_adc``), timed beside its per-shard bound (``adc_cost``).
    Returns the row of the cell."""
    from repro_torch.anns import QueryPlan, make_sharded_executor, \
        recall_at_k, registry
    from repro_torch.anns.stages import Candidates
    from repro_torch.core.estimator import alive_chain
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_adc as pq_adc_mod
    from repro_torch.kernels import ternary_refine as tr
    from repro_torch.quant import pq as pq_mod
    t0 = time.perf_counter()
    label = f"wide_{cfg.dim}_sharded"
    plan = QueryPlan(shards=args.shards, backend="cuda")
    db.query(ds.queries[:64], plan=plan)  # warm-up: partition, executor
    torch.cuda.synchronize()
    reset_launches()
    res = db.query(ds.queries, plan=plan)
    torch.cuda.synchronize()
    launches[label] = got = read_launches()
    print(f"{label} path launches over {WIDE_QUERIES} queries, "
          f"{args.shards} shards: {got}")
    calls = args.shards * -(-WIDE_QUERIES // cfg.micro_batch)
    name = "ternary_refine_fused_bounds"
    if got[name] != calls or got[f"{name} (global)"] != calls:
        fail(f"{label}: {got[name]} bounds launches, {got[f'{name} (global)']}"
             f" of them global, where {calls} global ones were expected")
    if got["refine tables (global)"] != calls:
        fail(f"{label}: {got['refine tables (global)']} refine table "
             f"launches for {calls} bounds calls")
    if got["pq_adc"] == 0 or any(got[n] for n in (
            "ternary_refine_fused", "ternary_refine_batch", "ternary_refine")):
        fail(f"{label}: pq_adc not launched, or another refine kernel was")
    same_answer(torch, label, res.ids, res.cost, want.ids, want.cost)
    ok, err = close(res.distances, want.distances, 1e-5, 1e-5)
    if not ok:
        fail(f"{label}: distances off the unsharded ones ({err})")
    print(f"{label}: ids and per-tier bytes equal to the unsharded "
          f"wide_{cfg.dim} path's, distances "
          + ("bit-equal" if torch.equal(res.distances, want.distances)
             else f"within {err:.3g}"))
    ledger = lambda c: {k: (v.accesses, v.bytes)              # noqa: E731
                        for k, v in c.ledger.items()}
    sub = ds.queries[:64]
    # the plain sharded refine unpacks every slot's trits at full width
    # ((micro-batch, C, D) elements): 2 queries a micro-batch, the cache freed
    gc.collect()
    torch.cuda.empty_cache()
    ref = db.query(sub, plan=QueryPlan(shards=args.shards,
                                       backend="reference",
                                       micro_batch=WIDE_SHARDED_REF_BATCH))
    cud = db.query(sub, plan=plan)
    if not torch.equal(ref.ids, cud.ids) or \
            ledger(ref.cost) != ledger(cud.cost):
        fail(f"{label}: the reference and cuda backends differ (ids or "
             f"ledger)")
    print(f"{label}: the reference backend on {sub.shape[0]} queries gives "
          f"the cuda backend's ids and ledger")
    runs = []
    for _ in range(TIMING_RUNS):
        t = time.perf_counter()
        db.query(ds.queries, plan=plan)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
    recall = recall_at_k(res.ids, ds.gt, cfg.final_k)
    print(f"{label}: recall@10 {recall:.4f} (the IVF front's ceiling "
          f"{ceiling:.4f}), {WIDE_QUERIES / statistics.median(runs):.1f} "
          f"queries/s (median of {[round(r, 6) for r in runs]} s), SSD "
          f"fetches/query "
          f"{res.cost.ledger['rerank:ssd'].accesses / WIDE_QUERIES:.1f}")
    print_launches(torch, f"{label} path (ms per path run of {WIDE_QUERIES} "
                          f"queries)", lambda: db.query(ds.queries, plan=plan),
                   1)
    del res, ref, cud
    # the bounds kernel at the path's shape: shard 0's candidates
    si = make_sharded_executor(db.index, shards=args.shards).sharded
    q = sub.contiguous()
    sh = registry.sharded_front("ivf").body(
        q, si.front_rep, si.front_db, si.codebook, si.pq_codes,
        **dict(si.front_args))[0]
    cand = Candidates(ids=sh.ids, valid=sh.valid, d0=sh.d0, counters={})
    stores = tr.RefineStores.from_trq(si.shard_trqs[0])
    model = db.index.trq.model
    err, ties = check_bounds(torch, tr, ops, alive_chain, stores, model, cand,
                             q, k=cfg.final_k, bound_name="cauchy", z=cfg.z,
                             label=f"{label} shard 0")
    args_b = (stores, q, cand.ids, cand.d0, cand.valid)
    call = lambda: tr.ternary_refine_fused_bounds(            # noqa: E731
        *args_b, model, bound="cauchy", z=cfg.z)
    ms, b_plan = launched_plan(tr, lambda: time_ms(call, 20),
                               "bounds_last_plan")
    g = stores.packed[0].shape[1]
    planes = ops.make_query_planes(q, g)
    params = ops.query_params(q, model.w, model.bias, model.resid_std, cfg.z)
    row = dict(max_abs_err=err, ms=ms, plan=b_plan,
               plain_ms=time_ms(lambda: tr.refine_bounds_plain(
                   stores, planes, params, *args_b[2:], bound="cauchy"), 3),
               library_ms=None, **bounds_cost(torch, stores, cand, q))
    row["device_ms"] = next((t for k, t in kernel_ms(torch, call, 20).items()
                             if "bounds_kernel" in k), None)
    row["launches"] = got[name]
    print(f"{name} {label} shard 0 (Q={q.shape[0]}, C={cand.ids.shape[1]}, "
          f"{int(cand.valid.sum())} valid, G={g}): {ms:.4f} ms per call, "
          f"device {row['device_ms']} ms (bound {row['bound_ms']:.4f} ms), "
          f"plain {row['plain_ms']:.3f} ms, chunk plan {b_plan}, alive "
          f"mismatches at near-ties {ties}")
    lut = pq_mod.adc_table(db.index.codebook, q)
    # pq_adc on shard 0's candidates: against its plain version on the
    # first WIDE_SHARDED_ADC_QUERIES queries (its (Q, C, M) gather takes
    # ~13 B an element), then timed on all 64
    na = WIDE_SHARDED_ADC_QUERIES
    adc_err = hold_adc(torch, pq_adc_mod, si.pq_codes[0], sh.ids[:na],
                       sh.valid[:na], lut[:na], f"{label} shard 0")[1]
    adc = dict(max_abs_err=adc_err, ms=time_ms(lambda: pq_adc_mod.pq_adc(
        si.pq_codes[0], sh.ids, sh.valid, lut), 20), launches=got["pq_adc"],
        **adc_cost(torch, f"pq_adc {label} shard 0", sh.ids, sh.valid,
                   cfg.pq_m, cfg.pq_k))
    print(f"pq_adc {label} shard 0: equal to pq_adc_plain on {na} queries "
          f"(max err {adc_err:.3g}); {adc['ms']:.4f} ms per call (bound "
          f"{adc['bound_ms']:.4f} ms, {adc['bound_by']})")
    print(f"{label}: {time.perf_counter() - t0:.1f} s")
    return {name: row, "pq_adc": adc, "queries_per_s": WIDE_QUERIES
            / statistics.median(runs), "recall_at_10": recall,
            "ivf_ceiling": ceiling}


def ivf_ceiling(torch, front, queries, gt) -> float:
    """The share of the true top-k ``gt`` (Q, k) that lies among the IVF
    front's valid candidates, over 64-query micro-batches: the recall@k
    an exact rerank of every candidate reaches."""
    found = 0
    for a in range(0, queries.shape[0], 64):
        cand = front.candidates(queries[a:a + 64].contiguous())
        hit = (cand.ids[:, :, None].long() == gt[a:a + 64, None, :]) \
            & cand.valid[:, :, None]
        found += int(hit.any(1).sum())
    return found / gt.numel()


def wide_ops(torch, tr, ops, build, index, make_ivf_front, queries,
             launches, reset_launches, read_launches) -> dict:
    """The level-0 ops path at the wide index's width: the first
    ``WIDE_OPS_QUERIES`` queries' IVF candidates gathered (Q, C, G) and
    scored once through ``ops.refine_scores_batch`` / ``refine_scores``,
    every count reset just before and read just after (``wide_ops``: the
    level-0 kernel's global form), then against the plain version and
    timed (``check_level0``)."""
    q = queries[:WIDE_OPS_QUERIES].contiguous()
    cand = make_ivf_front(index).candidates(q)
    stores = tr.RefineStores.from_trq(index.trq)
    ids = cand.ids.long()
    rec, packed = stores.records[ids], stores.packed[0][ids]
    cols = (cand.d0, rec[..., 0], rec[..., 1], rec[..., 2], rec[..., 3])
    model = index.trq.model
    reset_launches()
    tr.level0_last_plan = None
    counted = (ops.refine_scores_batch(packed, q, *cols, model.w,
                                       model.bias),
               ops.refine_scores(packed[0], q[0], *(t[0] for t in cols),
                                 model.w, model.bias))
    torch.cuda.synchronize()
    launches["wide_ops"] = got = read_launches()
    print(f"wide_ops path launches: {got}")
    if got["level-0 (global)"] != 2 or got["pair tables (global)"] != 2:
        fail("the wide ops path did not run the level-0 kernel's global "
             "form twice, each after its pair tables")
    plan = dataclasses.asdict(tr.level0_last_plan)
    print(f"wide_ops: the level-0 global form's chunk plan from the launch "
          f"{plan}")
    g = packed.shape[-1]
    rows = check_level0(torch, tr, ops, model, q, packed, cols, counted,
                        (0.0, 0.0), level0_attributes(build, g, "global"))
    for row in rows.values():
        row["plan"] = plan
    return rows


def global_entries(rows, wide, edge_rows, launches) -> None:
    """Each kernel's ``global`` entry of the ``kernels`` line: its global
    form's numbers at the widest shape that runs it (the wide_8192 path for
    ``pq_adc`` and the fused kernel, shard 0 of the wide_8192_sharded path
    for the bounds kernel, the wide_ops path for the level-0 entry points,
    the fatrq_nprobe256 path for the prune), ``launches`` its global-form
    launches over the wide paths' runs (the prune's over the
    fatrq_nprobe256 path's; ``tables_launches`` and
    ``pair_tables_launches`` its table kernel's there, over both level-0
    entry points), ``fatrq_shape`` the global form beside the shared one
    at the fatrq shape (bit-equal), and its other wide and edge shapes;
    the fused kernel's ``wide_2048`` entry holds its shared form at
    G = 410.  ``plan``, in every entry of a global form, is the plan its
    wrapper launched with at the timed call (``launched_plan``); the
    prune's global form has no plan, and its entry gives its fixed shared
    bytes (``smem_bytes``) instead."""
    wide_runs = [launches[p] for p in ("wide_2048", "wide_8192",
                                       "wide_8192_sharded", "wide_ops")]
    count = lambda key: sum(r[key] for r in wide_runs)        # noqa: E731
    refine = rows["ternary_refine_fused"]
    big = wide["wide_8192"]
    rows["pq_adc"]["global"].update(
        big["pq_adc"], launches=count("pq_adc (global)"),
        wide_2048=wide["wide_2048"]["pq_adc"],
        wide_8192_sharded=wide["wide_8192_sharded"]["pq_adc"],
        edge=edge_rows["pq_adc"])
    refine["global"].update(
        big["ternary_refine_fused"],
        launches=count("ternary_refine_fused (global)"),
        tables_launches=count("refine tables (global)"),
        edge=edge_rows["ternary_refine_fused"])
    refine["wide_2048"] = wide["wide_2048"]["ternary_refine_fused"]
    rows["ternary_refine_fused_bounds"]["global"].update(
        wide["wide_8192_sharded"]["ternary_refine_fused_bounds"],
        launches=count("ternary_refine_fused_bounds (global)"),
        tables_launches=launches["wide_8192_sharded"][
            "refine tables (global)"],
        edge=edge_rows["ternary_refine_fused_bounds"])
    prune = refine["prune"]["global"]
    prune.update(prune.pop("fatrq_nprobe256"), edge=edge_rows["prune"])
    if count("prune (global)"):
        fail("a wide path ran the prune's global form")
    for name in ("ternary_refine_batch", "ternary_refine"):
        rows[name]["global"].update(
            wide["wide_ops"][name], launches=launches["wide_ops"][name],
            pair_tables_launches=launches["wide_ops"]["pair tables (global)"],
            edge=edge_rows[name])
    print("global entries: each kernel's global form (its state in device "
          "memory, staged back into shared memory by the chunk plan in its "
          "entry; the prune's streams its slice and keeps candidate keys "
          "only) at its widest shape with its global-form launches over the "
          "wide paths (wide_2048, wide_8192, wide_8192_sharded, wide_ops; "
          "the prune's over fatrq_nprobe256); fatrq_shape: "
          "the global form beside the shared form at the fatrq shape, "
          "bit-equal; edge: at the edge shapes (pq_adc M=1024 K=256; the "
          "refine kernels G=1639, C=4133, Q=5 (the single-query form Q=1); "
          "the prune C=1,048,576, k=10)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database rows (only N is ever cut)")
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=4,
                    help="shards of the sharded path (on one card)")
    args = ap.parse_args()

    t_run = time.perf_counter()
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
    from repro_torch.anns.stages import Candidates
    from repro_torch.core import calibration as cal
    from repro_torch.core import trq as trq_mod
    from repro_torch.core.estimator import alive_chain
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import pq_adc as pq_adc_mod
    from repro_torch.kernels import ternary_refine as tr

    def reset_launches():
        zero_launches(pq_adc_mod, tr)

    def read_launches() -> dict:
        return launch_counts(pq_adc_mod, tr)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    t = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    print_resources(build._target(name) for name in build.SOURCES)
    print(prune_attributes(build))
    print(prune_attributes(build, "global", NPROBE_C))
    level0_attrs = level0_attributes(build, 154)
    sass_profile(build._target("ternary_refine"), "level0_kernelILb1ELb0E")
    t = phase("kernel build and attributes", t)
    edge_rows = {"prune": edge_prune(
        torch, tr, ops,
        torch.Generator(device="cuda").manual_seed(args.seed + 3))}
    edge_err, edge_bounds_err, refine_rows = edge_shapes(
        torch, tr, ops, alive_chain, trq_mod, cal, Candidates,
        torch.Generator(device="cuda").manual_seed(args.seed + 1))
    edge_adc_err, edge_rows["pq_adc"] = edge_adc(
        torch, pq_adc_mod, ops,
        torch.Generator(device="cuda").manual_seed(args.seed + 2))
    *edge_level0_err, level0_rows = edge_level0(
        torch, tr, ops,
        torch.Generator(device="cuda").manual_seed(args.seed + 4))
    edge_rows.update(refine_rows, **level0_rows)
    t = phase("edge shapes", t)

    rows, launches = index_paths(
        torch, args, (edge_err, edge_bounds_err, edge_adc_err,
                      edge_level0_err), level0_attrs, reset_launches,
        read_launches)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    wide = wide_phase(torch, args, launches, reset_launches, read_launches,
                      build)
    t = phase("wide", t)
    rag, db = rag_phase(torch, args, launches, reset_launches,
                        read_launches)
    gc.collect()
    torch.cuda.empty_cache()
    t = phase("rag", t)
    families_phase(torch, args, db, launches, reset_launches, read_launches)
    del db
    gc.collect()
    torch.cuda.empty_cache()
    t = phase("families", t)
    train_phase(torch, args)
    gc.collect()
    torch.cuda.empty_cache()
    t = phase("train", t)
    lm_mesh_phase(torch, args)
    gc.collect()
    torch.cuda.empty_cache()
    t = phase("lm_mesh (lm_mesh_gaps within)", t)
    dryrun_phase(torch, args)
    gc.collect()
    torch.cuda.empty_cache()
    t = phase("dryrun", t)
    examples_phase(torch)
    phase("examples", t)
    rows["pq_adc"]["rag"] = rag["pq_adc"]
    rows["ternary_refine_fused"]["rag"] = rag["ternary_refine_fused"]
    print("rag entries: pq_adc and ternary_refine_fused at the round "
          "trip's shape (its 8 embedded prompts over the 1M x 2048 index, "
          "k = 5, G = 410) with the round trip's launches (the Retriever "
          "form; rag_serving the ServingEngine form's)")
    global_entries(rows, wide, edge_rows, launches)

    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s in all")
    src = "src/repro_torch/kernels/csrc/ternary_refine.cu"
    table = [("pq_adc", "src/repro_torch/kernels/csrc/pq_adc.cu",
              "src/repro/kernels/pq_adc.py:36", "fatrq"),
             ("ternary_refine_fused", src,
              "src/repro/kernels/ternary_refine.py:364", "fatrq"),
             ("ternary_refine_fused_bounds", src,
              "src/repro/kernels/ternary_refine.py:418", "sharded"),
             ("ternary_refine_batch", src,
              "src/repro/kernels/ternary_refine.py:178", "ops"),
             ("ternary_refine", src,
              "src/repro/kernels/ternary_refine.py:213", "ops")]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[path][name],
         "launches_by_path": {p: launches[p][name] for p in launches},
         **rows[name]}
        for name, source, replaces, path in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
