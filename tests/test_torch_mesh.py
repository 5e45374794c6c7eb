"""The sharded search across processes (``repro_torch.launch.mesh``,
``mesh=`` from ``Database.query`` down to the shard body) on the CPU under
``gloo``: at 2 and 4 ranks, one shard each, every rank returns the stacked
form's ids, distances and ledger bit for bit (``Database.query``,
``pipeline.search`` and a ``ServingEngine`` batch, both fronts, both
backends), and the ids and per-tier bytes of the JAX package's unsharded
search; then the single-process cases: the one-process mesh, the world
size check, ``ShardedIndex.place``'s checks and the executor cache."""

import dataclasses
import multiprocessing
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.anns import Database as JDatabase  # noqa: E402
from repro.anns import PipelineConfig as JConfig  # noqa: E402
from repro.anns import QueryPlan as JPlan  # noqa: E402
from repro.anns import build as jbuild  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro_torch.anns import (Database, PipelineConfig, QueryPlan,  # noqa
                              make_sharded_executor, partition_database)
from repro_torch.anns import sharding  # noqa: E402
from repro_torch.interop import index_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_search_mesh, \
    mesh_axis_sizes  # noqa: E402
from test_torch_graph import export_with_graph  # noqa: E402
from test_torch_pipeline import CFG  # noqa: E402
from torch_mesh_ranks import FRONTS, answers, ledger, rank_main  # noqa

LEVELS = 2                       # two levels: two pooled thresholds a batch
JOIN_S = 60                      # a rank that takes longer is hung
CONFIG = dict(CFG, trq_levels=LEVELS)


def _tier_bytes(entries: dict) -> dict:
    out = {}
    for key, (_, nbytes) in entries.items():
        tier = key.rsplit(":", 1)[-1]
        out[tier] = out.get(tier, 0) + nbytes
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(world: int, path) -> list:
    run = path / f"world{world}"
    run.mkdir()
    for name in ("index.npz", "queries.npy"):
        os.link(path / name, run / name)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, port, str(run), CONFIG))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join_ranks(procs: list, path) -> list[dict]:
    for p in procs:
        p.join(timeout=JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    world = len(procs)
    assert not hung, f"gloo ranks {hung} of {world} did not finish in " \
                     f"{JOIN_S} s (a collective that not every rank reached?)"
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(path / f"world{world}" / f"rank{r}.pt")
            for r in range(world)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory, request):
    """The small JAX index with its graph, exported to disk for the ranks
    (world 2 and world 4 are started at once, on it); the port's copy of
    it; the queries; JAX's unsharded answers; the running ranks."""
    ds = jmake_dataset(jax.random.PRNGKey(0), n=3000, d=64, n_queries=24,
                       k_gt=20, clusters=8)
    x, q = np.array(ds.x), np.array(ds.queries)
    jidx = jbuild(jax.random.PRNGKey(1), jnp.asarray(x),
                  JConfig(**CFG, trq_levels=LEVELS))
    arrays = export_with_graph(jidx)
    path = tmp_path_factory.mktemp("mesh")
    np.savez(path / "index.npz", **arrays)
    np.save(path / "queries.npy", q)
    procs = {world: _start_ranks(world, path) for world in (2, 4)}

    def stop():                       # ranks no test waited for
        for p in sum(procs.values(), []):
            if p.is_alive():
                p.kill()
            p.join()
    request.addfinalizer(stop)
    jres = {f: JDatabase.wrap(jidx).query(
        jnp.asarray(q), plan=JPlan(front=f, backend="reference"))
        for f in FRONTS}
    pidx = index_from_numpy(arrays, PipelineConfig(**CONFIG), device="cpu")
    return pidx, q, jres, (path, procs)


@pytest.fixture(scope="module")
def ranks(setup):
    """Each rank's answers at world 2 and world 4."""
    path, procs = setup[3]
    return {world: _join_ranks(p, path) for world, p in procs.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_gives_the_stacked_answer(setup, ranks, world):
    pidx, q, jres, _ = setup
    want = answers(pidx, q, world, None)
    for case, w in want.items():
        front = case.split("/")[0]
        np.testing.assert_array_equal(w["ids"].numpy(),
                                      np.asarray(jres[front].ids))
        assert _tier_bytes(w["ledger"]) == \
            _tier_bytes(ledger(jres[front].cost))
        for rank, got in enumerate(ranks[world]):
            if case.endswith("/reference"):
                untraced = got["untraced"][FRONTS.index(case.split("/")[0])]
                assert torch.equal(untraced, w["ids"]), (rank, case)
            g = got[case]
            for key in ("ids", "distances", "search_ids", "engine_ids",
                        "engine_distances"):
                assert torch.equal(g[key], w[key]), (rank, case, key)
            for key in ("ledger", "breakdown", "search_ledger",
                        "engine_ledger"):
                assert g[key] == w[key], (rank, case, key)
    if world == 4:
        sub = make_sharded_executor(pidx, shards=2).execute(
            torch.from_numpy(q))[0]
        for rank, got in enumerate(ranks[world]):
            if rank < 2:
                assert torch.equal(got["sub"], sub)
            else:
                assert "hold a shard" in got["sub"]
            assert got["sub_groups"] == 1 and got["sub_same"]


# ----------------------------------------------------- one process


def test_make_search_mesh_beyond_the_world_raises():
    with pytest.raises(ValueError, match="torchrun"):
        make_search_mesh(2, device="cpu")


def test_one_process_mesh(setup):
    """With no process group a mesh of one process: collectives are
    identities, and ``shards=1`` on it gives the stacked ``shards=1``
    answer, both fronts."""
    pidx, q, _, _ = setup
    mesh = make_search_mesh(device="cpu")
    assert mesh_axis_sizes(mesh) == {"search": 1}
    assert make_search_mesh(1, device="cpu").size == 1
    t = torch.arange(6).reshape(2, 3)
    assert mesh.all_gather(t, 1) is t and mesh.all_sum(t) is t
    db = Database.wrap(pidx)
    for front in FRONTS:
        plan = QueryPlan(shards=1, front=front, backend="cuda")
        got = db.query(q, plan=plan, mesh=mesh)
        want = db.query(q, plan=plan)
        assert torch.equal(got.ids, want.ids)
        assert torch.equal(got.distances, want.distances)
        assert ledger(got.cost) == ledger(want.cost)


def test_place_keeps_one_block(setup):
    pidx, _, _, _ = setup
    si = partition_database(pidx, 1)
    placed = si.place(make_search_mesh(device="cpu"))
    assert placed.gid.shape[0] == 1 and placed.n_shards == 1
    assert torch.equal(placed.x, si.x)
    assert placed.x.data_ptr() != si.x.data_ptr()     # a copy, not a view
    with pytest.raises(ValueError, match="already placed"):
        placed.place(make_search_mesh(device="cpu"))


def test_place_raises_when_the_mesh_size_differs(setup):
    pidx, q, _, _ = setup
    mesh = make_search_mesh(device="cpu")
    with pytest.raises(ValueError, match="size 1 but the index has 2"):
        partition_database(pidx, 2).place(mesh)
    with pytest.raises(ValueError, match="2 shards"):
        Database.wrap(pidx).query(q, plan=QueryPlan(shards=2), mesh=mesh)


@dataclasses.dataclass(eq=False)
class _TwoRanks:
    """Rank 0 of a two-rank mesh whose other rank holds ``other``'s
    digest: the all-gather ``place`` makes, without a second process."""

    other: torch.Tensor
    size: int = 2
    rank: int = 0
    device: torch.device = torch.device("cpu")

    def all_gather(self, t, dim=0):
        return torch.cat([t, self.other[None]], dim)


@pytest.mark.parametrize("front", FRONTS)
def test_place_raises_on_another_partition(setup, front):
    """A rank whose block differs (one global id changed) makes every
    rank's ``place`` raise; equal partitions pass."""
    pidx, _, _, _ = setup
    si = partition_database(pidx, 2, front=front)
    same = sharding._partition_digest(si)
    assert si.place(_TwoRanks(same)).gid.shape[0] == 1
    gid = si.gid.clone()
    gid[1, 0] += 1
    other = sharding._partition_digest(dataclasses.replace(si, gid=gid))
    with pytest.raises(ValueError, match=r"ranks \[1\] hold another"):
        si.place(_TwoRanks(other))


def test_executor_cache_keeps_placements_apart(setup):
    pidx, q, _, _ = setup
    mesh = make_search_mesh(device="cpu")
    stacked = make_sharded_executor(pidx, shards=1)
    on_mesh = make_sharded_executor(pidx, shards=1, mesh=mesh)
    assert on_mesh is not stacked
    assert on_mesh.sharded is not stacked.sharded
    assert on_mesh.sharded.mesh is mesh and stacked.sharded.mesh is None
    assert make_sharded_executor(pidx, shards=1, mesh=mesh) is on_mesh
    other = make_search_mesh(device="cpu")        # equal meshes are one
    assert other is mesh
    assert make_sharded_executor(pidx, shards=1, mesh=other) is on_mesh
    # another backend shares the placement, never the stacked partition
    cu = make_sharded_executor(pidx, shards=1, backend="cuda", mesh=mesh)
    assert cu.sharded is on_mesh.sharded
    db = Database.wrap(pidx)
    plan = QueryPlan(shards=1)
    assert db.executor_for(plan, mesh=mesh) is not db.executor_for(plan)
    assert db.compiled(plan, mesh=mesh)._ex.sharded.mesh is mesh


def test_equal_search_meshes_share_one_placement_and_plan(setup):
    """A second ``make_search_mesh()``, and a second query on a fresh
    one, hit both caches: one compiled plan, one placement (the JAX
    package's ``jax.make_mesh`` returns one ``Mesh`` for equal
    arguments), with the same answer."""
    pidx, q, _, _ = setup
    mesh = make_search_mesh(device="cpu")
    assert make_search_mesh(device="cpu") is mesh
    assert make_search_mesh(1, device="cpu") is mesh
    placed = pidx.__dict__.setdefault("_placed_cache", {})
    before = set(placed)
    db = Database.wrap(pidx)
    plan = QueryPlan(shards=1, backend="cuda")
    one = db.query(q, plan=plan, mesh=make_search_mesh(device="cpu"))
    two = db.query(q, plan=plan, mesh=make_search_mesh(device="cpu"))
    assert torch.equal(one.ids, two.ids)
    assert [k[2] for k in db._compiled
            if k[1] == one.plan and k[2] is not None] == [mesh]
    assert len(set(placed) - before) <= 1
    assert {k for k in placed if k[0] == 1 and k[1] == "ivf"} == \
        {(1, "ivf", mesh)}
