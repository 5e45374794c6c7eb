"""The rank side of ``tests/test_torch_mesh.py``: what each spawned gloo
rank runs, and the answers it is held to.  It imports no JAX (only the
test process does), so each rank starts in the time torch takes."""

import os

import numpy as np
import torch

from repro_torch.anns import Database, PipelineConfig, QueryPlan, search
from repro_torch.anns import executor
from repro_torch.interop import index_from_numpy
from repro_torch.launch.mesh import make_search_mesh
from repro_torch.obs import trace
from repro_torch.serving import ServingEngine

FRONTS = ("ivf", "graph")
BACKENDS = ("reference", "cuda")
MAX_BATCH = 8                    # the engine's batches: 24 queries → 3


def ledger(cost) -> dict:
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


def answers(index, q, shards: int, mesh) -> dict:
    """Every case's answer on one layout: the stacked form (``mesh`` None)
    or this rank's mesh form."""
    out = {}
    for front in FRONTS:
        for backend in BACKENDS:
            plan = QueryPlan(shards=shards, front=front, backend=backend)
            res = Database.wrap(index).query(q, plan=plan, mesh=mesh)
            ids, cost = search(index, q, front=front, backend=backend,
                               shards=shards, mesh=mesh)
            eng = ServingEngine(index, plan=plan, max_batch=MAX_BATCH,
                                mesh=mesh)
            resp = eng.serve(q)
            out[f"{front}/{backend}"] = {
                "ids": res.ids, "distances": res.distances,
                "ledger": ledger(res.cost),
                "breakdown": res.cost.breakdown(),
                "search_ids": ids, "search_ledger": ledger(cost),
                "engine_ids": torch.from_numpy(np.stack([r.ids
                                                         for r in resp])),
                "engine_distances": torch.from_numpy(
                    np.stack([r.distances for r in resp])),
                "engine_ledger": ledger(eng.total_cost)}
    return out


class Boom:
    """Stands in for a clock or a synchronize that must not be called."""

    def __getattr__(self, name):
        raise AssertionError(f"{name} called with no tracer active")

    def __call__(self, *a, **kw):
        raise AssertionError("called with no tracer active")


def rank_main(rank: int, world: int, port: int, path: str,
              config: dict) -> None:
    """One gloo rank: the exported index from ``path``, every case on a
    mesh of all ``world`` ranks, at world 4 a mesh of the first two, and
    an untraced query with the clock and the synchronizes replaced by
    ``Boom``; its answers to ``path/rank{rank}.pt``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        with np.load(os.path.join(path, "index.npz")) as f:
            arrays = dict(f)
        q = np.load(os.path.join(path, "queries.npy"))
        index = index_from_numpy(arrays, PipelineConfig(**config),
                                 device="cpu")
        mesh = make_search_mesh(device="cpu")
        out = answers(index, q, world, mesh)
        if world == 4:
            # a mesh over the first two ranks; the other two hold no shard.
            # Asked for twice, it is made once: one subgroup, one mesh
            groups, new_group = [], dist.new_group
            dist.new_group = lambda *a, **kw: groups.append(
                new_group(*a, **kw)) or groups[-1]
            try:
                meshes = []
                for _ in range(2):
                    try:
                        meshes.append(make_search_mesh(2, device="cpu"))
                    except ValueError as e:
                        meshes.append(str(e))
            finally:
                dist.new_group = new_group
            out["sub_groups"] = len(groups)
            out["sub_same"] = meshes[0] is meshes[1] or meshes[0] == meshes[1]
            if isinstance(meshes[0], str):
                out["sub"] = meshes[0]
            else:
                out["sub"] = Database.wrap(index).query(
                    q, plan=QueryPlan(shards=2, backend="reference"),
                    mesh=meshes[0]).ids
        # untraced, the mesh path reads no clock and synchronizes nothing
        trace.time = executor._sync = torch.cuda.synchronize = Boom()
        out["untraced"] = [Database.wrap(index).query(
            q, plan=QueryPlan(shards=world, front=f), mesh=mesh).ids
            for f in FRONTS]
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
