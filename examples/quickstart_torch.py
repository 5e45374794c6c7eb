"""Quickstart on the PyTorch/CUDA port: build a FaTRQ database and run
planned progressive-refinement search through the unified ``Database`` API.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The counterpart of ``examples/quickstart.py``: the same configuration,
steps and printed lines, through ``repro_torch``.  It runs on the GPU unless
``--device`` names another device, and fails with no GPU.  Each
``jax.random.PRNGKey(s)`` of the JAX example is a ``torch.Generator``
seeded ``s`` on the run's device here, so the data, and the numbers
printed, differ from the JAX example's.
"""

import argparse

import torch

from repro_torch.anns import Database, PipelineConfig, QueryPlan, recall_at_k
from repro_torch.data import make_dataset
from repro_torch.device import resolve_device
from repro_torch.memory import Tier


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, or fail)")
    ap.add_argument("--n", type=int, default=20_000,
                    help="database rows (the JAX example's 20,000)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    print(f"generating synthetic embedding dataset ({args.n // 1000}k × "
          f"128d)...")
    ds = make_dataset(n=args.n, d=128, n_queries=64, k_gt=100,
                      generator=gen(0))

    cfg = PipelineConfig(dim=128, pq_m=16, pq_k=256, nlist=64, nprobe=8,
                         final_k=10, refine_budget=40, bound="cauchy")
    print("building index (PQ → IVF → TRQ encode → calibration)...")
    db = Database.build(ds.x, cfg, device=dev, generator=gen(1))
    print(f"  far-memory layout: {db.index.layout.describe()} bytes/record")

    print("searching (FaTRQ progressive refinement)...")
    res = db.query(ds.queries, k=10)
    rec = recall_at_k(res.ids, ds.gt, 10)
    print(f"  resolved plan: {res.plan}")
    print(f"  nearest distance (query 0): {float(res.distances[0, 0]):.4f}")

    base = db.query(ds.queries, plan=QueryPlan(k=10, mode="baseline"))
    base_rec = recall_at_k(base.ids, ds.gt, 10)

    cost, base_cost = res.cost, base.cost
    ssd = cost.by_tier()[Tier.SSD].accesses
    ssd_b = base_cost.by_tier()[Tier.SSD].accesses
    print(f"\n  recall@10: FaTRQ={rec:.3f}  baseline={base_rec:.3f}")
    print(f"  SSD fetches/query: FaTRQ={ssd / 64:.1f}  "
          f"baseline={ssd_b / 64:.1f}  ({ssd_b / max(ssd, 1):.1f}x fewer)")
    print(f"  modeled time/query: FaTRQ={cost.total_seconds() / 64 * 1e6:.0f}us"
          f"  baseline={base_cost.total_seconds() / 64 * 1e6:.0f}us"
          f"  ({base_cost.total_seconds() / cost.total_seconds():.1f}x faster)")
    return {"recall": rec, "baseline_recall": base_rec, "ssd": ssd,
            "baseline_ssd": ssd_b}


if __name__ == "__main__":
    main()
