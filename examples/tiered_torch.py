"""Adaptive tiered placement on the PyTorch/CUDA port: watch heat build up
under a skewed query trace, migrate the hot lists into HBM (and the cold
ones to SSD) with ``rebalance_tiers()``, and compare the modeled per-tier
cost before and after.

    PYTHONPATH=src python examples/tiered_torch.py [--device cpu]

The counterpart of ``examples/tiered.py``: the same configuration, steps
and printed lines, through ``repro_torch``.  The ``TieredIndex`` starts
all-warm, bit-identical to the static layout it wraps.  Every search folds
per-list access counters into an EMA-decayed heat tracker;
``rebalance_tiers()`` turns that heat into a hot/warm/cold placement,
migrates, and bumps the index generation so compiled executors and
serving result caches drop stale entries.

It runs on the GPU unless ``--device`` names another device, and fails with
no GPU.  Each ``jax.random.PRNGKey(s)`` of the JAX example is a
``torch.Generator`` seeded ``s`` on the run's device here, so the data,
and the numbers printed, differ from the JAX example's.
"""

import argparse

import numpy as np
import torch

from repro_torch.anns import (Database, PipelineConfig, QueryPlan,
                              TieredConfig, TieredIndex, recall_at_k)
from repro_torch.data import make_dataset
from repro_torch.data.synthetic import brute_force_topk
from repro_torch.device import resolve_device
from repro_torch.memory import Tier


def zipfian_queries(ds, n=64, seed=11):
    """Seeded Zipfian trace: query popularity ∝ rank^-1.3 over database
    rows ranked by distance to one anchor — a few IVF lists absorb
    nearly all probes, the skew adaptive placement exploits."""
    x = ds.x.cpu().numpy()
    near = np.argsort(((x - x[0]) ** 2).sum(axis=1))
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(near) + 1, dtype=np.float64) ** 1.3
    rows = near[rng.choice(len(near), size=n, p=p / p.sum())]
    q = x[rows] + 0.02 * rng.standard_normal((n, x.shape[1]))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(q).to(ds.x.device)


def per_tier(cost, nq):
    by = cost.by_tier()
    return "  ".join(f"{t.value}={by[t].accesses / nq:.1f}acc"
                     for t in Tier if by[t].accesses)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, or fail)")
    ap.add_argument("--n", type=int, default=20_000,
                    help="database rows (the JAX example's 20,000)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"building index ({args.n // 1000}k × 128d)...")
    ds = make_dataset(n=args.n, d=128, n_queries=64, k_gt=100,
                      generator=torch.Generator(device=dev).manual_seed(0))
    cfg = PipelineConfig(dim=128, pq_m=16, pq_k=256, nlist=64, nprobe=8,
                         final_k=10, refine_budget=40, bound="cauchy")
    static = Database.build(
        ds.x, cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1)).index

    ti = TieredIndex(static, TieredConfig(decay=0.5, hot_rows_frac=0.25,
                                          cold_rows_frac=0.2))
    db = Database.wrap(ti)
    plan = QueryPlan(front="ivf", k=10)
    q = zipfian_queries(ds)
    gt = brute_force_topk(ds.x, q, 10)
    nq = q.shape[0]

    print("replaying skewed trace on the all-warm placement "
          "(≡ static layout)...")
    warm = db.query(q, plan=plan)
    print(f"  heat observed over {ti.heat.observations} batch(es); "
          f"top-3 lists hold "
          f"{np.sort(ti.heat.heat)[-3:].sum() / ti.heat.heat.sum():.0%} "
          f"of the heat")
    print(f"  per-tier: {per_tier(warm.cost, nq)}")
    print(f"  modeled: {warm.cost.total_seconds() / nq * 1e6:.0f}us/query  "
          f"recall@10={recall_at_k(warm.ids, gt, 10):.3f}")

    out = ti.rebalance_tiers()
    occ = out["occupancy"]
    print(f"\nrebalance_tiers(): generation {out['generation']}, moves:")
    for (src, dst), rows in sorted(out["moves"].items()):
        print(f"  {src:>4} → {dst:<4} {rows} rows")
    print("  occupancy: " + "  ".join(
        f"{name}={lists}lists/{rows}rows"
        for name, (lists, rows) in occ.items()))

    print("\nreplaying the same trace on the adapted placement...")
    hot = db.query(q, plan=plan)
    print(f"  per-tier: {per_tier(hot.cost, nq)}")
    print(f"  modeled: {hot.cost.total_seconds() / nq * 1e6:.0f}us/query  "
          f"recall@10={recall_at_k(hot.ids, gt, 10):.3f}")
    saved = 1 - hot.cost.total_seconds() / warm.cost.total_seconds()
    print(f"\n  adaptive placement saves {saved:.0%} modeled time on this "
          f"trace (hot lists score exactly from HBM and skip refinement; "
          f"cold lists were barely probed)")
    return {"warm_s": warm.cost.total_seconds(),
            "hot_s": hot.cost.total_seconds(), "generation":
            out["generation"]}


if __name__ == "__main__":
    main()
