"""The port's streaming layout (``repro_torch.anns.streaming``, the row
helpers of ``repro_torch.core.trq`` and the graph maintenance of
``repro_torch.index.graph``) against the JAX package's.

One JAX index is carried across with ``interop.index_from_numpy`` (its
kNN graph too) and wrapped in both packages' ``StreamingIndex``; the same
three interleaved rounds of inserts, deletes, a rebalance and compactions
are replayed in both, with JAX's start draws, and after every operation the
row store, the lists and id maps, the statistics, the graph and the search
answers (both fronts, both port backends, one and two TRQ levels) must be
JAX's.  Within the port, the churned index must answer as its static
rebuild does, sharded or not."""

import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.anns import PipelineConfig as JConfig  # noqa: E402
from repro.anns import StreamingConfig as JStreamingConfig  # noqa: E402
from repro.anns import StreamingIndex as JStreamingIndex  # noqa: E402
from repro.anns import build as jbuild  # noqa: E402
from repro.anns import registry as jregistry  # noqa: E402
from repro.anns import stages as jstages  # noqa: E402
from repro.anns.api import Database as JDatabase  # noqa: E402
from repro.anns.api import QueryPlan as JPlan  # noqa: E402
from repro.core import trq as jtrq  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro.index import graph as jgraph  # noqa: E402
from repro.quant import pq as jpq  # noqa: E402
from repro_torch.anns import (Database, PipelineConfig, PlanError,  # noqa
                              QueryPlan, StreamingConfig, StreamingIndex)
from repro_torch.anns import registry  # noqa: E402
from repro_torch.anns.executor import SearchExecutor  # noqa: E402
from repro_torch.core import trq  # noqa: E402
from repro_torch.index import graph  # noqa: E402
from repro_torch.interop import index_from_numpy  # noqa: E402
from test_torch_pipeline import export_jax_index  # noqa: E402

# tests/test_streaming.py's fixture
CFG = dict(dim=32, pq_m=4, pq_k=32, nlist=16, nprobe=4, final_k=5,
           refine_budget=20)
BEAM = 64


def jax_start(n: int) -> torch.Tensor:
    """The JAX search's start draw over n rows."""
    return torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(0), (BEAM,), 0, n))).int()


def carry(jidx, levels: int = 1, **cfg):
    """The port's copy of a JAX index, with its kNN graph."""
    arrays = export_jax_index(jidx)
    arrays["graph.neighbors"] = np.array(jstages.graph_for(jidx).neighbors)
    arrays["graph.start"] = jax_start(jidx.x.shape[0]).numpy()
    return index_from_numpy(arrays, PipelineConfig(**{**CFG, **cfg},
                                                   trq_levels=levels),
                            device="cpu")


def pair(jidx, pidx, **scfg):
    scfg.setdefault("auto_compact", False)
    return (JStreamingIndex(jidx, JStreamingConfig(**scfg)),
            StreamingIndex(pidx, StreamingConfig(**scfg), start=jax_start))


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


def _tier_bytes(cost):
    return {t.value: v.bytes for t, v in cost.by_tier().items()}


@pytest.fixture(scope="module")
def ds():
    d = jmake_dataset(jax.random.PRNGKey(0), n=4000, d=32, n_queries=12,
                      k_gt=50, clusters=16)
    return np.array(d.x), np.array(d.queries)


@pytest.fixture(scope="module", params=[1, 2], ids=["L1", "L2"])
def levels(request):
    return request.param


@pytest.fixture(scope="module")
def base(ds, levels):
    jidx = jbuild(jax.random.PRNGKey(1), jnp.asarray(ds[0][:3000]),
                  JConfig(**CFG, trq_levels=levels))
    return jidx, carry(jidx, levels)


# --------------------------------------------------------------- row helpers


def _encode(ds, jidx, pidx, rows):
    x = ds[0][rows]
    jx_c = jpq.decode(jidx.codebook, jpq.encode(jidx.codebook,
                                                jnp.asarray(x)))
    return x, np.array(jx_c)


def _same_codes(got: trq.TRQCodes, want) -> None:
    assert got.num_levels == want.num_levels and got.dim == want.dim
    for gl, wl in zip(got.levels, want.levels):
        np.testing.assert_array_equal(gl.packed.numpy(), np.array(wl.packed))
        for f in ("proj", "norm", "rho"):
            np.testing.assert_allclose(getattr(gl, f).numpy(),
                                       np.array(getattr(wl, f)), rtol=1e-5,
                                       atol=1e-5)
    for f in ("delta_sq", "cross", "rho", "norm"):
        np.testing.assert_allclose(getattr(got.scalars, f).numpy(),
                                   np.array(getattr(want.scalars, f)),
                                   rtol=1e-5, atol=1e-5)


def test_encode_rows_matches_jax(ds, base, levels):
    jidx, pidx = base
    x, x_c = _encode(ds, jidx, pidx, slice(3000, 3064))
    want = jtrq.encode_rows(jnp.asarray(x), jnp.asarray(x_c),
                            num_levels=levels, model=jidx.trq.model)
    got = trq.encode_rows(torch.from_numpy(x), torch.from_numpy(x_c),
                          num_levels=levels, model=pidx.trq.model)
    _same_codes(got, want)
    assert got.model is pidx.trq.model
    assert trq.encode_rows(torch.from_numpy(x), torch.from_numpy(x_c),
                           num_levels=levels).model is not pidx.trq.model


def test_write_rows_matches_jax(ds, base, levels):
    """In place into the port's own copy, functional in JAX: the same
    codes, rows outside the write untouched."""
    jidx, pidx = base
    x, x_c = _encode(ds, jidx, pidx, slice(3000, 3032))
    jrows = jtrq.encode_rows(jnp.asarray(x), jnp.asarray(x_c),
                             num_levels=levels)
    prows = trq.encode_rows(torch.from_numpy(x), torch.from_numpy(x_c),
                            num_levels=levels)
    dst = trq.map_rows(pidx.trq, torch.clone)
    out = trq.write_rows(dst, prows, 200)
    assert out is dst
    _same_codes(out, jtrq.write_rows(jidx.trq, jrows, 200))
    for lv in range(levels):
        packed = out.levels[lv].packed
        assert torch.equal(packed[:200], pidx.trq.levels[lv].packed[:200])
        assert torch.equal(packed[232:], pidx.trq.levels[lv].packed[232:])
        assert torch.equal(packed[200:232], prows.levels[lv].packed)


def test_write_rows_rejects_a_level_mismatch(ds, base, levels):
    jidx, pidx = base
    x, x_c = _encode(ds, jidx, pidx, slice(0, 8))
    rows = trq.encode_rows(torch.from_numpy(x), torch.from_numpy(x_c),
                           num_levels=levels + 1)
    with pytest.raises(ValueError, match="mismatch"):
        trq.write_rows(trq.map_rows(pidx.trq, torch.clone), rows, 0)


def test_gather_rows_matches_jax(base):
    jidx, pidx = base
    idx = np.array([5, 0, 2999, 17, 17, 1200])
    _same_codes(trq.gather_rows(pidx.trq, torch.from_numpy(idx)),
                jtrq.gather_rows(jidx.trq, jnp.asarray(idx)))


# ------------------------------------------------------ graph maintenance


def _graph_case(case: str):
    """(x, neighbors, n_old, live rows) of one maintenance case at n_old =
    600 rows plus 80 new, degree 8."""
    rng = np.random.default_rng(["clustered", "repeats", "mostly_dead",
                                 "two_live"].index(case))
    n_old, b, d, degree = 600, 80, 16, 8
    centers = rng.standard_normal((6, d)).astype(np.float32)
    x = (centers[rng.integers(0, 6, n_old + b)]
         + 0.3 * rng.standard_normal((n_old + b, d))).astype(np.float32)
    if case == "repeats":          # equal distances everywhere
        x[300:400] = x[200:300]
        x[n_old + 40:] = x[n_old:n_old + 40]
    nb = np.array(jgraph.build(jnp.asarray(x[:n_old]),
                               degree=degree).neighbors)
    dead = {"clustered": 0.3, "repeats": 0.3, "mostly_dead": 0.9,
            "two_live": 1.0}[case]
    alive = rng.random(n_old + b) >= dead
    if case == "two_live":         # every neighbourhood dead: fallbacks
        alive[[5, n_old + 3]] = True
    return x, nb, n_old, np.nonzero(alive)[0]


@pytest.mark.parametrize("case", ["clustered", "repeats", "mostly_dead",
                                  "two_live"])
def test_insert_and_compact_graph_match_jax(case):
    x, nb, n_old, live = _graph_case(case)
    want = jgraph.insert_nodes(nb, x, n_old)
    got = graph.insert_nodes(nb, torch.from_numpy(x), n_old,
                             jax_start(n_old))
    np.testing.assert_array_equal(got, want)
    want_c = jgraph.compact_graph(want, x, live)
    got_c = graph.compact_graph(got, torch.from_numpy(x), live)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_c.dtype == np.int32 and (got_c >= 0).all()


def test_compact_graph_fallbacks_are_exercised():
    """The two-live-rows case reaches both fallbacks: a row whose dead
    edges have no live candidate takes ``(r + 1) % n_live`` first, then its
    first live edge."""
    x, nb, n_old, live = _graph_case("two_live")
    out = graph.compact_graph(graph.insert_nodes(
        nb, torch.from_numpy(x), n_old, jax_start(n_old)),
        torch.from_numpy(x), live)
    assert out.shape == (2, nb.shape[1])
    assert set(out.ravel().tolist()) <= {0, 1}


def test_insert_nodes_rejects_a_short_adjacency():
    x, nb, n_old, _ = _graph_case("clustered")
    with pytest.raises(ValueError, match="adjacency covers"):
        graph.insert_nodes(nb[:-1], torch.from_numpy(x), n_old,
                           jax_start(n_old))
    with pytest.raises(ValueError, match="zero live rows"):
        graph.compact_graph(nb, torch.from_numpy(x), np.zeros(0, np.int64))


# ------------------------------------------------------------ the replay

SEARCHES = [("ivf", "reference"), ("ivf", "cuda"), ("graph", "reference"),
            ("graph", "cuda")]


def _state(st):
    """Everything of a streaming index the two packages must agree on
    (copies: the port writes its row store in place)."""
    x = st.x.numpy().copy() if isinstance(st.x, torch.Tensor) \
        else np.array(st.x)
    out = {"x": x, "base_lists": np.array(st.base_lists),
           "base_len": np.array(st.base_len),
           "delta_lists": np.array(st.delta_lists),
           "delta_len": np.array(st.delta_len),
           "alive": np.array(st.alive), "row_gid": np.array(st.row_gid),
           "stats": st.stats(), "needs": st.needs_compaction(),
           "graph": None if st._graph is None else np.array(st._graph)}
    if isinstance(st, StreamingIndex):
        out["live"] = st.live_gids()
        out["pq_codes"] = st.pq_codes.numpy().copy()
        out["packed"] = [lv.packed.numpy().copy() for lv in st.trq.levels]
    else:
        out["live"] = np.sort(np.fromiter(st._gid_row.keys(), np.int64))
        out["pq_codes"] = np.array(st.pq_codes)
        out["packed"] = [np.array(lv.packed) for lv in st.trq.levels]
    return out


def _answers(jst, pst, queries):
    """JAX's reference answer and the port's, per (front, backend)."""
    out = {}
    for front in ("ivf", "graph"):
        jres = JDatabase.wrap(jst).query(jnp.asarray(queries),
                                         plan=JPlan(front=front, k=5))
        for backend in ("reference", "cuda"):
            out[(front, backend)] = (jres, Database.wrap(pst).query(
                queries, plan=QueryPlan(front=front, backend=backend, k=5)))
    return out


def _rebuilt(pst, queries):
    """Per front: the port's streaming answer and the same plan over its
    static rebuild (the graph over the maintained adjacency, start nodes
    ``start(n_rows)``) mapped to global ids, when that must be equal."""
    snap, gid = pst.rebuild_static()
    gid = torch.from_numpy(gid)
    out = {}
    for backend in ("reference", "cuda"):
        a = Database.wrap(pst).query(queries, plan=QueryPlan(
            backend=backend, k=5))
        b = Database.wrap(snap).query(queries, plan=QueryPlan(
            backend=backend, k=5))
        out[("ivf", backend)] = (a, gid[b.ids.long()], b.cost)
        if pst.n_tombstones == 0 and pst.n_delta_rows == 0:
            a = Database.wrap(pst).query(queries, plan=QueryPlan(
                front="graph", backend=backend, k=5))
            ex = SearchExecutor.from_index(snap, front="graph",
                                           backend=backend,
                                           graph_index=pst.graph_index())
            rows, _, cost = ex.execute(torch.from_numpy(queries), k=5)
            out[("graph", backend)] = (a, gid[rows.long()], cost)
    return out


@pytest.fixture(scope="module")
def replay(ds, base):
    """Three interleaved rounds in both packages (JAX's test: 300 inserts,
    200 deletes from ``default_rng(7)``, a rebalance over 2 shards in
    round 1, a compaction closing each round), recording after every
    operation both states, both packages' answers, the port's rebuild
    answers and, mid-churn in round 2, its sharded answers."""
    jidx, pidx = base
    x, queries = ds
    jst, pst = pair(jidx, pidx)
    # materialize the graph before the first insert in both
    jst.search(jnp.asarray(queries[:1]), k=5, front="graph")
    pst.search(queries[:1], k=5, front="graph")
    steps = [("wrap", _state(jst), _state(pst), None, None, None)]
    rng = np.random.default_rng(7)
    ins = 3000
    for rnd in range(3):
        gids = [jst.insert(jnp.asarray(x[ins:ins + 300])),
                pst.insert(x[ins:ins + 300])]
        np.testing.assert_array_equal(gids[0], gids[1])
        ins += 300
        steps.append((f"insert {rnd}", _state(jst), _state(pst), None, None,
                      None))
        dead = rng.choice(np.fromiter(jst._gid_row.keys(), np.int64),
                          size=200, replace=False)
        assert jst.delete(dead) == pst.delete(dead) == 200
        label = f"delete {rnd}"
        if rnd == 1:
            assert jst.rebalance(2) == pst.rebalance(2)
            label = f"delete + rebalance {rnd}"
        sharded = None
        if rnd == 2:
            snap, gid = pst.rebuild_static()
            sharded = {}
            for shards in (1, 2):
                for front in ("ivf", "graph"):
                    got = Database.wrap(pst).query(queries, plan=QueryPlan(
                        front=front, shards=shards, backend="cuda", k=5))
                    ref = Database.wrap(snap).query(queries, plan=QueryPlan(
                        front=front, backend="cuda", k=5))
                    sharded[(front, shards)] = (
                        got, torch.from_numpy(gid)[ref.ids.long()], ref.cost)
        steps.append((label, _state(jst), _state(pst),
                      _answers(jst, pst, queries), _rebuilt(pst, queries),
                      sharded))
        jst.compact()
        pst.compact()
        steps.append((f"compact {rnd}", _state(jst), _state(pst),
                      _answers(jst, pst, queries), _rebuilt(pst, queries),
                      None))
    return steps


def test_row_store_matches_jax(replay):
    for label, js, ps, *_ in replay:
        for key in ("x", "pq_codes"):
            np.testing.assert_array_equal(ps[key], js[key], err_msg=label)
        for got, want in zip(ps["packed"], js["packed"]):
            np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("key", ["base_lists", "base_len", "delta_lists",
                                 "delta_len", "alive", "row_gid", "live"])
def test_lists_and_maps_match_jax(replay, key):
    for label, js, ps, *_ in replay:
        np.testing.assert_array_equal(ps[key], js[key], err_msg=label)
        assert ps[key].dtype.kind == js[key].dtype.kind, (label, key)


def test_stats_drift_and_trigger_match_jax(replay):
    for label, js, ps, *_ in replay:
        assert ps["stats"] == js["stats"], label
        assert ps["needs"] == js["needs"], label
    assert "shard_imbalance" in replay[-1][2]["stats"]


def test_graph_adjacency_matches_jax(replay):
    """The graph taken over at wrap time, grown by ``insert_nodes`` and
    shrunk by ``compact_graph``, is JAX's after every operation."""
    for label, js, ps, *_ in replay:
        np.testing.assert_array_equal(ps["graph"], js["graph"],
                                      err_msg=label)


@pytest.mark.parametrize("front,backend", SEARCHES)
def test_execute_matches_jax_reference(replay, front, backend):
    """Ids, distances and the ledger (``delta:cxl`` split included) of
    both port backends equal JAX's reference backend, mid-churn and
    compacted, in every round."""
    n_delta = 0
    for label, _, ps, answers, *_ in replay:
        if answers is None:
            continue
        want, got = answers[(front, backend)]
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids),
                                      err_msg=label)
        np.testing.assert_allclose(got.distances.numpy(),
                                   np.asarray(want.distances), rtol=1e-5,
                                   atol=1e-5, err_msg=label)
        assert _ledger(got.cost) == _ledger(want.cost), label
        assert set(got.ids.numpy().ravel()) <= set(ps["live"]), label
        n_delta += "delta:cxl" in got.cost.ledger
    assert n_delta >= 2        # rounds 0 and 2 bill delta pages mid-churn


@pytest.mark.parametrize("front,backend", SEARCHES)
def test_churn_equals_static_rebuild(replay, front, backend):
    """Within the port: the IVF front equals the same plan over
    ``rebuild_static`` at every step, and the graph front, once compacted,
    the static search over the maintained adjacency (ids and bytes per
    tier; a ``delta:cxl`` entry folds into cxl)."""
    seen = 0          # the graph: 3 compactions and the rebalance's
    for label, *_, rebuilt, _ in replay:
        if rebuilt is None or (front, backend) not in rebuilt:
            continue
        got, want_ids, want_cost = rebuilt[(front, backend)]
        np.testing.assert_array_equal(got.ids.numpy(), want_ids.numpy(),
                                      err_msg=label)
        assert _tier_bytes(got.cost) == _tier_bytes(want_cost), label
        seen += 1
    assert seen == (6 if front == "ivf" else 4)


@pytest.mark.parametrize("front,shards", [("ivf", 1), ("ivf", 2),
                                          ("graph", 1), ("graph", 2)])
def test_sharded_snapshot(replay, front, shards):
    """``shards=S`` searches the ``rebuild_static`` snapshot: on the IVF
    front the unsharded streaming answer (JAX's ids), on the graph front
    the unsharded graph query over the snapshot (whose own kNN graph both
    build)."""
    label, _, _, answers, _, sharded = replay[-2]
    got, want_ids, want_cost = sharded[(front, shards)]
    np.testing.assert_array_equal(got.ids.numpy(), want_ids.numpy(),
                                  err_msg=label)
    assert _tier_bytes(got.cost) == _tier_bytes(want_cost)
    assert bool(got.cost.parallel_s) == (shards > 1)
    if front == "ivf":
        np.testing.assert_array_equal(
            got.ids.numpy(), np.asarray(answers[("ivf", "reference")][0].ids))


# ----------------------------------------------------- deeper-level split


def test_level1_delta_split_matches_jax(ds):
    """Level-1 survivors on delta pages bill ``delta:cxl``, not
    ``refine:cxl``: the counters of both port backends equal JAX's
    reference stage counters, and the ledgers equal JAX's."""
    x, queries = ds
    cfg = dict(nlist=8, trq_levels=2)
    jidx = jbuild(jax.random.PRNGKey(3), jnp.asarray(x[:1500]),
                  JConfig(**{**CFG, **cfg}))
    jst, pst = pair(jidx, carry(jidx, 2, nlist=8))
    jst.insert(jnp.asarray(x[1500:1900]))
    pst.insert(x[1500:1900])
    jfs = jregistry.make_front("ivf", "streaming", jst)
    jcand = jfs.candidates(jnp.asarray(queries))
    jref = jregistry.make_backend("reference").refine(
        jnp.asarray(queries), jcand, jst.trq, k=5, bound="cauchy", z=3.0)
    want = {n: int(v) for n, v in {**jcand.counters,
                                   **jref.counters}.items()}
    assert want["delta_cand"] > 0 and want["refine_alive_l1_delta"] > 0
    q = torch.from_numpy(queries)
    cand = registry.make_front("ivf", "streaming", pst).candidates(q)
    for backend in ("reference", "cuda"):
        ref = registry.make_backend(backend).refine(
            q, cand, pst.trq, k=5, bound="cauchy", z=3.0)
        got = {n: int(v) for n, v in {**cand.counters,
                                      **ref.counters}.items()}
        assert got == want, backend
        ids, _, cost = pst.execute(queries, k=5, backend=backend)
        jids, jcost = jst.search(jnp.asarray(queries), k=5)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        assert _ledger(cost) == _ledger(jcost), backend
        t_delta = cost.ledger["delta:cxl"]
        assert t_delta.accesses == want["delta_cand"] + \
            want["refine_alive_l1_delta"]


# ------------------------------------------------- mutations and the API


def test_bad_delete_is_atomic(ds, base):
    x, queries = ds
    jst, pst = pair(*base)
    pst.insert(x[3000:3010])
    gen = pst.generation
    for bad in ([11, 12, 10 ** 9], [13, 13], [-1], [3009, 3010]):
        with pytest.raises(KeyError):
            pst.delete(bad)
    assert pst.n_tombstones == 0 and pst.generation == gen
    assert pst.delete([11]) == 1
    with pytest.raises(KeyError):
        pst.delete([11])                       # already gone
    ids, _ = pst.search(x[12:13], k=5)
    assert 12 in ids.numpy()[0] and 11 not in ids.numpy()[0]


def test_delete_to_empty_with_auto_compact(ds):
    """Deleting every row under ``auto_compact`` leaves an empty index
    that takes inserts again, as JAX's does."""
    x, _ = ds
    cfg = dict(dim=32, pq_m=4, pq_k=32, nlist=4, nprobe=2, final_k=2,
               refine_budget=4)
    jidx = jbuild(jax.random.PRNGKey(5), jnp.asarray(x[:64]), JConfig(**cfg))
    pidx = index_from_numpy(export_jax_index(jidx), PipelineConfig(**cfg),
                            device="cpu")
    jst, pst = pair(jidx, pidx, auto_compact=True)
    for st in (jst, pst):
        st.delete(np.arange(64))
        assert st.n_live == 0
    assert pst.stats() == jst.stats()
    gids = [jst.insert(jnp.asarray(x[100:110])), pst.insert(x[100:110])]
    np.testing.assert_array_equal(gids[0], gids[1])
    ids, _ = pst.search(x[100:101], k=2)
    assert int(gids[1][0]) in ids.numpy()[0]
    assert pst.stats() == jst.stats()


def test_row_store_and_delta_pages_grow(ds, base):
    x, _ = ds
    jst, pst = pair(*base, delta_page=8, row_headroom=0.01)
    cap0, dcap0 = pst.cap_rows, pst.delta_lists.shape[1]
    jst.insert(jnp.asarray(x[3000:4000]))
    pst.insert(x[3000:4000])
    assert pst.cap_rows > cap0 and pst.delta_lists.shape[1] > dcap0
    assert pst.cap_rows == int(jst.x.shape[0]) and pst.n_live == 4000
    np.testing.assert_array_equal(pst.delta_lists, jst.delta_lists)
    np.testing.assert_array_equal(pst.x.numpy(), np.array(jst.x))
    ids, _ = pst.search(x[3999:4000], k=5)
    assert 3999 in ids.numpy()[0]


def test_wrapped_index_is_never_written(ds, base):
    """The row store is the streaming index's own: inserts and compaction
    leave the wrapped static index as it was."""
    x, _ = ds
    _, pidx = base
    before = [t.clone() for t in (pidx.x, pidx.pq_codes,
                                  pidx.trq.levels[0].packed)]
    _, pst = pair(*base)
    pst.insert(x[3000:3100])
    pst.delete(np.arange(50))
    pst.compact()
    for b, a in zip(before, (pidx.x, pidx.pq_codes,
                             pidx.trq.levels[0].packed)):
        assert torch.equal(a, b)


def test_generation_hooks(ds, base):
    x, _ = ds
    _, pst = pair(*base)
    seen = []
    pst.add_generation_hook(lambda st, gen: seen.append((st, gen)))
    pst.insert(x[3000:3010])
    pst.delete([3])
    pst.compact()
    pst.rebalance(2)
    assert [g for _, g in seen] == [1, 2, 3, 4, 5]  # rebalance compacts
    assert all(st is pst for st, _ in seen)


def test_database_on_the_streaming_layout(ds, base):
    """``len`` is the live count, the generation follows mutations, and
    executors are kept per generation: a mutation drops the older ones."""
    x, queries = ds
    _, pst = pair(*base)
    db = Database.wrap(pst)
    assert db is Database.wrap(pst) and db.layout == "streaming"
    assert len(db) == 3000 and db.generation == 0
    res = db.query(queries)
    assert res.plan.backend == "reference" and res.ids.dtype == torch.int64
    db.query(queries, plan=QueryPlan(front="graph"))
    assert {k[0] for k in db._compiled} == {0} and len(db._compiled) == 2
    pst.insert(x[3000:3020])
    pst.delete([0, 3005])
    assert len(db) == 3018 and db.generation == 2
    db.query(queries)
    assert set(db._compiled) == {(2,) + k[1:] for k in db._compiled}
    assert len(db._compiled) == 1


def test_stale_snapshot_is_freed_at_the_next_mutation(ds, base):
    """A snapshot and what is cached on it (its executors, its sharded
    partition) refer to each other; a mutation frees them at once, with
    the automatic cycle collector off."""
    x, queries = ds
    _, pst = pair(*base)
    pst.insert(x[3000:3010])
    db = Database.wrap(pst)
    db.query(queries, plan=QueryPlan(shards=2))
    snap, _ = pst.rebuild_static()
    Database.wrap(snap).query(queries)
    ref, part = weakref.ref(snap), weakref.ref(
        snap.__dict__["_sharded_cache"][(2, "ivf")])
    del snap
    gc.disable()
    try:
        pst.delete([0])
        assert ref() is None and part() is None
        assert db._compiled == {}
    finally:
        gc.enable()


def test_baseline_plan_error_matches_jax(ds, base):
    x, queries = ds
    jst, pst = pair(*base)
    with pytest.raises(PlanError) as got:
        Database.wrap(pst).query(queries, plan=QueryPlan(mode="baseline"))
    with pytest.raises(Exception) as want:
        JDatabase.wrap(jst).query(jnp.asarray(queries),
                                  plan=JPlan(mode="baseline"))
    assert str(got.value) == str(want.value)
    with pytest.raises(PlanError):
        Database.wrap(pst).query(queries, plan=QueryPlan(front="lsh"))
