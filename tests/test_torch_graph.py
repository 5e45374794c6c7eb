"""The port's graph front (``repro_torch.index.graph``, the graph stage of
``repro_torch.anns.stages`` and the graph half of
``repro_torch.anns.sharding``) against the JAX package's: the graph build,
the kNN select, the beam-step helpers and the search bit for bit, the front
stage's candidates, ``Database.query`` with ``front="graph"`` (fatrq and
baseline, one and two TRQ levels), and the range + halo partition with 1,
2 and 4 shards against both packages' unsharded graph search."""

from functools import partial

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
from repro.anns import sharding as jsharding  # noqa: E402
from repro.anns import stages as jstages  # noqa: E402
from repro.anns.executor import fold_counts as jfold_counts  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro.data.synthetic import brute_force_topk as jbrute  # noqa: E402
from repro.index import graph as jgraph  # noqa: E402
from repro.quant import pq as jpq  # noqa: E402
from repro_torch.anns import (Database, PipelineConfig, PlanError,  # noqa
                              QueryPlan, make_sharded_executor,
                              partition_database)
from repro_torch.anns import stages  # noqa: E402
from repro_torch.anns.executor import SearchExecutor  # noqa: E402
from repro_torch.data.synthetic import brute_force_topk, smallest_k  # noqa
from repro_torch.index import graph  # noqa: E402
from repro_torch.interop import index_from_numpy  # noqa: E402
from repro_torch.quant import pq  # noqa: E402
from test_torch_pipeline import CFG, export_jax_index  # noqa: E402

BEAM, ITERS, EXPAND = 64, 32, 4      # GraphFrontStage's defaults, both sides


def export_with_graph(jidx) -> dict[str, np.ndarray]:
    """A JAX index's leaves plus its graph and the JAX search's start
    draw, so both packages traverse one graph from the same nodes."""
    out = export_jax_index(jidx)
    out["graph.neighbors"] = np.array(jstages.graph_for(jidx).neighbors)
    out["graph.start"] = np.array(jax.random.randint(
        jax.random.PRNGKey(0), (BEAM,), 0, jidx.x.shape[0]))
    return out


@pytest.fixture(scope="module")
def data():
    ds = jmake_dataset(jax.random.PRNGKey(0), n=3000, d=64, n_queries=24,
                       k_gt=20, clusters=8)
    return np.array(ds.x), np.array(ds.queries)


@pytest.fixture(scope="module", params=[1, 2], ids=["L1", "L2"])
def levels(request):
    return request.param


@pytest.fixture(scope="module")
def jindex(data, levels):
    return jbuild(jax.random.PRNGKey(1), jnp.asarray(data[0]),
                  JConfig(**CFG, trq_levels=levels))


@pytest.fixture(scope="module")
def pindex(jindex, levels):
    return index_from_numpy(export_with_graph(jindex),
                            PipelineConfig(**CFG, trq_levels=levels),
                            device="cpu")


@pytest.fixture(scope="module")
def triplicated():
    """Every database row three times over: each row's twins tie in every
    distance and estimate, so the kNN cut, the beam, the budget of 40
    (40 = 3·13 + 1) and the top 10 (10 = 3·3 + 1) all see exact ties.
    Vectors, JAX index, the port's copy of it, and queries."""
    ds = jmake_dataset(jax.random.PRNGKey(5), n=1000, d=64, n_queries=24,
                       k_gt=20, clusters=8)
    x = np.concatenate([np.array(ds.x)] * 3)
    jidx = jbuild(jax.random.PRNGKey(6), jnp.asarray(x), JConfig(**CFG))
    pidx = index_from_numpy(export_with_graph(jidx), PipelineConfig(**CFG),
                            device="cpu")
    return x, jidx, pidx, np.array(ds.queries)


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


def _tier_bytes(cost):
    out = {}
    for key, t in cost.ledger.items():
        tier = key.rsplit(":", 1)[-1]
        out[tier] = out.get(tier, 0) + t.bytes
    return out


def _same_result(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=1e-5)
    assert _ledger(got.cost) == _ledger(want.cost)
    for tier, s in want.cost.breakdown().items():
        assert got.cost.breakdown()[tier] == pytest.approx(s, rel=1e-12)


# ------------------------------------------------------ build and select


@pytest.mark.parametrize("which", ["clustered", "triplicated"])
def test_build_matches_jax(data, triplicated, which):
    """The same vectors give JAX's adjacency (on triplicated rows every
    kNN cut ties among twins)."""
    x = data[0] if which == "clustered" else triplicated[0]
    want = np.asarray(jgraph.build(jnp.asarray(x)).neighbors)
    got = graph.build(torch.from_numpy(x),
                      generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.neighbors.numpy(), want)
    assert got.neighbors.dtype == torch.int32
    assert got.start.shape == (BEAM,) and got.start.dtype == torch.int32
    assert int(got.start.min()) >= 0 and int(got.start.max()) < x.shape[0]


@pytest.mark.parametrize("width", [20, 117, 700])
@pytest.mark.parametrize("values", ["distinct", "few"])
def test_smallest_k_is_a_full_stable_sort(width, values):
    """The margin select equals a full stable sort's first k, lower
    position first on ties: on rows narrower than k + the margin (one
    sort), on distinct values (the select), and on few distinct values,
    where the kth ties past the margin and rows take the full sort."""
    g = torch.Generator().manual_seed(width)
    d = torch.randn((40, width), generator=g)
    if values == "few":
        d = torch.randint(0, 6, (40, width), generator=g).float()
    for k in (1, 17, 100):
        want = torch.sort(d, dim=-1, stable=True).indices[:, :k]
        assert torch.equal(smallest_k(d, k), want)


def test_knn_select_ties_at_the_kth_place():
    """Duplicate rows tie at the kth place of the kNN select: the blocked
    brute force gives the full stable sort's ids, and JAX's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2000, 24)).astype(np.float32)
    x[100:140] = x[5]                    # 41 copies of row 5
    x[1500:1503] = x[7]
    q = np.concatenate([x[:10], x[[5, 7, 120]]])
    got = brute_force_topk(torch.from_numpy(x), torch.from_numpy(q), 17,
                           block=4)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    d = (qt @ xt.T).mul_(-2.0).add_((xt * xt).sum(-1))
    want = torch.sort(d, dim=-1, stable=True).indices[:, :17]
    assert torch.equal(got, want)
    assert bool((d.gather(1, want[:, -1:]) == d.gather(
        1, torch.sort(d, dim=-1, stable=True).indices[:, 17:18])).any())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbrute(jnp.asarray(x), jnp.asarray(q), 17)))


# ----------------------------------------------------- beam-step helpers


def _beam_states(seed: int, nq: int = 16):
    """Random beam states with forced distance ties (values from a small
    set), repeated ids, +inf entries, an all-expanded beam and an
    all-unexpanded one; plus expansion results with ties and repeats."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 80, (nq, BEAM)).astype(np.int32)
    ds = (rng.integers(0, 5, (nq, BEAM)) / 4).astype(np.float32)
    ds[rng.random((nq, BEAM)) < 0.1] = np.inf
    expanded = rng.random((nq, BEAM)) < 0.5
    expanded[0], expanded[1] = True, False
    new_ids = rng.integers(0, 80, (nq, EXPAND * 16)).astype(np.int32)
    new_d = (rng.integers(0, 5, (nq, EXPAND * 16)) / 4).astype(np.float32)
    return ids, ds, expanded, new_ids, new_d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_frontier_bit_equal_jax(seed):
    _, ds, expanded, _, _ = _beam_states(seed)
    want = jax.vmap(partial(jgraph.pick_frontier, expand=EXPAND))(
        jnp.asarray(ds), jnp.asarray(expanded))
    got = graph.pick_frontier(torch.from_numpy(ds),
                              torch.from_numpy(expanded), expand=EXPAND)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_merge_bit_equal_jax(seed):
    states = _beam_states(seed)
    want = jax.vmap(partial(jgraph.beam_merge, beam=BEAM))(
        *map(jnp.asarray, states))
    got = graph.beam_merge(*map(torch.from_numpy, states), beam=BEAM)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(torch.isinf(got[1]).any())       # repeats kept at +inf


@pytest.mark.parametrize("rows", ["x", "x_score"])
def test_search_matches_jax(data, jindex, pindex, rows):
    """The batched search on JAX's graph and start draw gives JAX's
    vmapped beams, over the raw vectors and the PQ reconstructions."""
    q = data[1]
    jx = jindex.x if rows == "x" else jpq.decode(jindex.codebook,
                                                  jindex.pq_codes)
    want = jax.vmap(lambda qq: jgraph.search(
        jstages.graph_for(jindex), jx, qq, iters=ITERS, beam=BEAM,
        expand=EXPAND))(jnp.asarray(q))
    px = pindex.x if rows == "x" else pq.decode(pindex.codebook,
                                                pindex.pq_codes)
    got = graph.search(stages.graph_for(pindex), px, torch.from_numpy(q),
                       iters=ITERS, beam=BEAM, expand=EXPAND)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_search_checks_the_beam(pindex, data):
    with pytest.raises(ValueError, match="start"):
        graph.search(stages.graph_for(pindex), pindex.x,
                     torch.from_numpy(data[1]), beam=32)


# ------------------------------------------------------------ front stage


def test_front_candidates_match_jax(data, jindex, pindex):
    q = data[1]
    jf = jstages.make_graph_front(jindex)
    want = jf.candidates(jnp.asarray(q))
    got = stages.make_graph_front(pindex).candidates(torch.from_numpy(q))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.d0.numpy(), np.asarray(want.d0),
                               rtol=1e-5, atol=1e-5)
    assert {n: int(v) for n, v in got.counters.items()} == \
        {n: int(v) for n, v in want.counters.items()}
    np.testing.assert_array_equal(
        stages.make_graph_front(pindex).x_score.numpy(),
        np.asarray(jf.x_score))


def test_executor_takes_a_graph_index(data, pindex):
    """``graph_index=`` hands the front a graph of the caller's."""
    g = stages.graph_for(pindex)
    other = graph.GraphIndex(neighbors=g.neighbors,
                             start=torch.flip(g.start, (0,)))
    ex = SearchExecutor.from_index(pindex, front="graph", graph_index=other)
    assert ex.front.graph is other
    assert stages.make_graph_front(pindex).graph is g    # cached per index


# ------------------------------------------------------- Database.query


@pytest.mark.parametrize("mode,backend", [("fatrq", "reference"),
                                          ("fatrq", "cuda"),
                                          ("baseline", None)])
def test_graph_query_matches_jax(data, jindex, pindex, mode, backend):
    want = JDatabase.wrap(jindex).query(
        jnp.asarray(data[1]), plan=JPlan(front="graph", mode=mode,
                                         backend="reference"))
    got = Database.wrap(pindex).query(
        data[1], plan=QueryPlan(front="graph", mode=mode, backend=backend))
    assert got.plan.front == "graph"
    assert got.cost.ledger["front:hbm"].accesses == \
        len(data[1]) * ITERS * EXPAND * 16
    _same_result(got, want)


def test_graph_micro_batches_change_nothing(data, pindex):
    db = Database.wrap(pindex)
    plan = QueryPlan(front="graph", backend="cuda")
    whole = db.query(data[1], plan=plan)
    split = db.query(data[1], plan=plan, micro_batch=7)
    np.testing.assert_array_equal(split.ids.numpy(), whole.ids.numpy())
    np.testing.assert_array_equal(split.distances.numpy(),
                                  whole.distances.numpy())
    assert _ledger(split.cost) == _ledger(whole.cost)


# ---------------------------------------------------------------- sharded


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_graph_partition_matches_jax(pindex, jindex, shards):
    """The range + halo partition of one graph: JAX's arrays, and the
    invariants of ``tests/test_sharding.py``'s graph partitioner test
    (every row owned once, owned adjacency published with global ids,
    every edge resolvable into ``xs_loc``), with halo copies equal to the
    owner's reconstructions."""
    want = jsharding.partition_database(jindex, shards, front="graph")
    got = partition_database(pindex, shards, front="graph")
    assert got.front == "graph"
    np.testing.assert_array_equal(got.shard_rows, want.shard_rows)
    for g, w in zip(got.front_db, want.front_db):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in ((got.gid, want.gid), (got.pq_codes, want.pq_codes),
                 (got.x, want.x)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.front_rep[0].numpy(),
                                  export_with_graph(jindex)["graph.start"])

    n = pindex.x.shape[0]
    gids = got.gid.numpy()
    assert sorted(gids[gids >= 0].tolist()) == list(range(n))
    xs_loc, adj_gid, adj_loc, loc_of = (t.numpy() for t in got.front_db)
    g = stages.graph_for(pindex).neighbors.numpy()
    x_score = pq.decode(pindex.codebook, pindex.pq_codes).numpy()
    for s in range(shards):
        rows = np.where(loc_of[s] >= 0)[0]
        assert np.array_equal(gids[s, loc_of[s, rows]], rows)
        assert np.array_equal(adj_gid[s, :rows.size], g[rows])
        assert (adj_loc[s, :rows.size] < xs_loc.shape[1]).all()
        assert np.array_equal(xs_loc[s][adj_loc[s, :rows.size]],
                              x_score[g[rows]])


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_sharded_graph_matches_unsharded(data, jindex, pindex, shards,
                                         backend):
    """S shards return the unsharded graph ids, per-tier bytes and ledger
    entries, the port's and JAX's (which pins its own sharded graph to its
    unsharded one); the merged ledger is the port's per-shard counts
    folded by the JAX package's ``fold_counts`` + ``merge_parallel``."""
    db = Database.wrap(pindex)
    got = db.query(data[1], plan=QueryPlan(front="graph", shards=shards,
                                           backend=backend))
    flat = db.query(data[1], plan=QueryPlan(front="graph", backend=backend))
    want = JDatabase.wrap(jindex).query(
        jnp.asarray(data[1]), plan=JPlan(front="graph", backend="reference"))
    for ref in (flat, want):
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
        np.testing.assert_allclose(got.distances.numpy(),
                                   np.asarray(ref.distances), rtol=1e-5,
                                   atol=1e-5)
        assert _tier_bytes(got.cost) == _tier_bytes(ref.cost)
        assert _ledger(got.cost) == _ledger(ref.cost)
    assert bool(got.cost.parallel_s) == (shards > 1), \
        "per-shard ledgers must be folded"

    ex = make_sharded_executor(pindex, shards=shards, front="graph",
                               backend=backend)
    _, _, shard_counts = ex._search(torch.from_numpy(data[1]))
    assert sum(c["front_hops"] for c in shard_counts) == \
        len(data[1]) * ITERS * EXPAND * 16
    jcosts = [jfold_counts(c, cost=None, config=jindex.config,
                           layout=jindex.layout,
                           front_fold=jstages.fold_graph_front_cost)
              for c in shard_counts]
    folded = jcosts[0]
    for c in jcosts[1:]:
        folded.merge_parallel(c)
    assert _ledger(got.cost) == _ledger(folded)


def test_triplicated_graph_ties_at_the_budget(triplicated):
    """The fixture's point: on the graph beam, alive twins tie exactly at
    the 40th estimate of some query, and at the 10th exact distance."""
    _, _, pidx, qs = triplicated
    q = torch.from_numpy(qs)
    front = stages.make_graph_front(pidx)
    cand = front.candidates(q)
    refined = stages.ReferenceRefineBackend().refine(
        q, cand, pidx.trq, k=10, bound="cauchy", z=3.0)
    est = torch.sort(torch.where(refined.alive, refined.est,
                                 float("inf")), dim=1).values
    budget = CFG["refine_budget"]
    assert bool((est[:, budget - 1] == est[:, budget]).any())
    # a twin group cut by the top 10: the 10th id's twins, at its exact
    # distance, are not all returned
    groups = Database.wrap(pidx).query(
        qs, plan=QueryPlan(front="graph")).ids.numpy() % 1000
    assert any((g == g[9]).sum() < 3 for g in groups)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_triplicated_sharded_graph_gives_the_unsharded_ids(triplicated,
                                                           shards, backend):
    """With exact ties in the kNN graph, the beam, the budget and the top
    10, S shards fetch what the unsharded graph search fetches and return
    its ids and per-tier bytes: the port's, and JAX's (the port's
    unsharded graph search equal to JAX's, ledger included)."""
    _, jidx, pidx, qs = triplicated
    db = Database.wrap(pidx)
    want = JDatabase.wrap(jidx).query(
        jnp.asarray(qs), plan=JPlan(front="graph", backend="reference"))
    flat = db.query(qs, plan=QueryPlan(front="graph", backend=backend))
    _same_result(flat, want)
    got = db.query(qs, plan=QueryPlan(front="graph", shards=shards,
                                      backend=backend))
    for ref in (flat, want):
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
        assert _tier_bytes(got.cost) == _tier_bytes(ref.cost)
        assert _ledger(got.cost) == _ledger(ref.cost)


def test_graph_plan_errors(data, pindex):
    """Baseline stays on the static layout; a ShardedIndex answers only
    the front it was partitioned for."""
    db = Database.wrap(pindex)
    with pytest.raises(PlanError, match="baseline"):
        db.query(data[1], plan=QueryPlan(front="graph", mode="baseline",
                                         shards=2))
    gdb = Database.wrap(partition_database(pindex, 2, front="graph"))
    with pytest.raises(PlanError, match="partitioned for the 'graph'"):
        gdb.query(data[1], plan=QueryPlan(front="ivf"))
    res = gdb.query(data[1], plan=QueryPlan(front="graph"))
    flat = db.query(data[1], plan=QueryPlan(front="graph"))
    np.testing.assert_array_equal(res.ids.numpy(), flat.ids.numpy())
    with pytest.raises(ValueError, match="n_shards"):
        partition_database(pindex, pindex.x.shape[0] + 1, front="graph")
