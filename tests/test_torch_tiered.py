"""The port's tiered layout (``repro_torch.memory.placement``,
``repro_torch.anns.tiered`` and the executor's hot/cold routing) against
the JAX package's.

One JAX index (``tests/test_tiered.py``'s fixture, one and two TRQ
levels) is carried across with ``interop.index_from_numpy``, its kNN
graph too, and wrapped in both packages' ``TieredIndex``.  The same
seeded Zipfian trace is replayed in both: heat, placement and rebalance
reports must be JAX's exactly, the answers after migration JAX's ids and
ledger, with distances within f32 rounding (rtol = atol = 1e-5).  The JAX
side runs its ``reference`` backend."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.anns import PipelineConfig as JConfig  # noqa: E402
from repro.anns import TieredConfig as JTieredConfig  # noqa: E402
from repro.anns import TieredIndex as JTieredIndex  # noqa: E402
from repro.anns import build as jbuild  # noqa: E402
from repro.anns import registry as jregistry  # noqa: E402
from repro.anns import stages as jstages  # noqa: E402
from repro.anns.api import Database as JDatabase  # noqa: E402
from repro.anns.api import QueryPlan as JPlan  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro.memory import placement as jplacement  # noqa: E402
from repro_torch.anns import (Database, PipelineConfig, PlanError,  # noqa
                              QueryPlan, TieredConfig, TieredIndex,
                              recall_at_k, registry)
from repro_torch.anns import stages, tiered  # noqa: E402
from repro_torch.anns.executor import make_executor  # noqa: E402
from repro_torch.data.synthetic import brute_force_topk  # noqa: E402
from repro_torch.interop import (index_from_numpy,  # noqa: E402
                                 tiered_from_numpy)
from repro_torch.memory import (TIER_COLD, TIER_HOT, TIER_WARM,  # noqa: E402
                                HeatTracker, Tier, occupancy, plan_migration,
                                plan_placement)
from repro_torch.serving import ResultCache, query_key  # noqa: E402
from test_torch_graph import export_with_graph  # noqa: E402

# tests/test_tiered.py's fixture
CFG = dict(dim=32, pq_m=4, pq_k=32, nlist=16, nprobe=4, final_k=5,
           refine_budget=20)
ZIPF = dict(decay=0.5, hot_rows_frac=0.25, cold_rows_frac=0.2)
MATRIX = list(itertools.product(("ivf", "graph"), ("reference", "cuda")))


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


def _same_answer(got, want):
    """JAX's ids and ledger, distances within f32 rounding."""
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=1e-5)
    assert _ledger(got.cost) == _ledger(want.cost)


@pytest.fixture(scope="module")
def ds():
    d = jmake_dataset(jax.random.PRNGKey(0), n=1500, d=32, n_queries=6,
                      k_gt=20, clusters=8)
    return np.array(d.x), np.array(d.queries)


@pytest.fixture(scope="module")
def skewed(ds):
    """``tests/test_tiered.py``'s seeded Zipfian trace: anchor rows ranked
    by distance to one point, popularity ∝ rank^-1.3, noise 0.02,
    renormalized."""
    x = ds[0]
    near = np.argsort(((x - x[0]) ** 2).sum(axis=1))
    rng = np.random.default_rng(11)
    p = 1.0 / np.arange(1, len(near) + 1, dtype=np.float64) ** 1.3
    rows = near[rng.choice(len(near), size=48, p=p / p.sum())]
    q = x[rows] + 0.02 * rng.standard_normal((48, x.shape[1]))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", params=[1, 2], ids=["L1", "L2"])
def levels(request):
    return request.param


@pytest.fixture(scope="module")
def base(ds, levels):
    jidx = jbuild(jax.random.PRNGKey(1), jnp.asarray(ds[0]),
                  JConfig(**CFG, trq_levels=levels))
    arrays = export_with_graph(jidx)
    pidx = index_from_numpy(arrays, PipelineConfig(**CFG, trq_levels=levels),
                            device="cpu")
    return jidx, pidx, arrays


# ------------------------------------------------------------ the policy


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placement_matches_jax(seed):
    """Heat EMA, placement (heat ties broken by list id), migration plan and
    occupancy bit-equal to JAX's on seeded heat with ties."""
    rng = np.random.default_rng(seed)
    nlist = 40
    rows = rng.integers(0, 60, nlist)
    ht, jht = HeatTracker(nlist, decay=0.7), jplacement.HeatTracker(
        nlist, decay=0.7)
    for _ in range(4):
        counts = rng.integers(0, 4, nlist) * 8       # few values: ties
        ht.observe(counts)
        jht.observe(counts)
        np.testing.assert_array_equal(ht.heat, jht.heat)
    assert ht.observations == jht.observations == 4
    old = np.full(nlist, TIER_WARM, np.int8)
    for hot, cold in ((0.1, 0.0), (0.3, 0.3), (0.0, 0.5), (1.0, 0.0)):
        for enabled in (True, False):
            cfg = TieredConfig(hot_rows_frac=hot, cold_rows_frac=cold,
                               enabled=enabled)
            jcfg = jplacement.TieredConfig(hot_rows_frac=hot,
                                           cold_rows_frac=cold,
                                           enabled=enabled)
            new = plan_placement(ht.heat, rows, cfg)
            want = jplacement.plan_placement(jht.heat, rows, jcfg)
            np.testing.assert_array_equal(new, want)
            assert new.dtype == want.dtype == np.int8
            assert plan_migration(old, new, rows) == \
                jplacement.plan_migration(old, want, rows)
            assert occupancy(new, rows) == jplacement.occupancy(want, rows)
            old = new


def test_score_hot_matches_jax(ds):
    """Exact squared L2 on hot slots only (gathered apart), +inf
    elsewhere; within f32 rounding of JAX's all-slot gather."""
    x, q = ds
    rng = np.random.default_rng(3)
    ids = rng.integers(0, x.shape[0], (6, 50)).astype(np.int32)
    hot = rng.random((6, 50)) < 0.4
    hot[2] = False                                # a query with no hot slot
    got = stages._score_hot(torch.from_numpy(x), torch.from_numpy(q),
                            torch.from_numpy(ids), torch.from_numpy(hot))
    want = np.asarray(jstages._score_hot(jnp.asarray(x), jnp.asarray(q),
                                         jnp.asarray(ids), jnp.asarray(hot)))
    assert np.isinf(got.numpy()[~hot]).all()
    np.testing.assert_allclose(got.numpy()[hot], want[hot], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("routed", [True, False])
def test_tier_annotate_counts_exactly(base, routed):
    """The heat histogram (sub-bins and spare bins) is the plain count of
    valid slots per list, at a slot count that is no multiple of the
    bins; the tier counters and codes are the rows' placements (no codes
    where nothing is routed)."""
    _, pidx, _ = base
    ti = TieredIndex(pidx)
    ti.list_tier = np.random.default_rng(4).integers(0, 3, 16).astype(
        np.int8)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, pidx.x.shape[0], (7, 4133)).astype(np.int32)
    valid = rng.random((7, 4133)) < 0.3
    valid[3] = False
    front = make_executor(ti, layout="tiered").front
    assert front.routed and front.any_hot
    tier, cnt = tiered._tier_annotate(
        torch.from_numpy(ids), torch.from_numpy(valid), front.row_tier,
        front.row_bin, front.list_tier, front.slot_bins(4133), nlist=16,
        routed=routed)
    want_tier = ti.list_tier[ti.row_list[ids]]
    if routed:
        np.testing.assert_array_equal(tier.numpy(), want_tier)
    else:
        assert tier is None
    np.testing.assert_array_equal(
        cnt["list_heat"].numpy(),
        np.bincount(ti.row_list[ids][valid], minlength=16))
    for name, code in (("hot_cand", TIER_HOT), ("cold_cand", TIER_COLD)):
        assert int(cnt[name]) == int((valid & (want_tier == code)).sum())


# ---------------------------------------- all-warm and cold-only = static


@pytest.mark.parametrize("front,backend", MATRIX)
def test_all_warm_matches_static_bitwise(ds, base, front, backend):
    _, pidx, _ = base
    ti = TieredIndex(pidx)                        # never rebalanced
    assert (ti.list_tier == TIER_WARM).all() and ti.generation == 0
    plan = QueryPlan(front=front, backend=backend)
    a = Database.wrap(pidx).query(ds[1], plan=plan)
    b = Database.wrap(ti).query(ds[1], plan=plan)
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.distances, b.distances)
    assert _ledger(a.cost) == _ledger(b.cost)
    assert ti.heat.observations == 1


@pytest.mark.parametrize("front,backend", MATRIX)
def test_cold_only_moves_only_the_cold_stream(ds, base, skewed, levels,
                                              front, backend, monkeypatch):
    """A cold-only placement answers as static, bit for bit, with no hot
    scoring at all; the ledger moves exactly the cold rows' residual
    stream from ``refine:cxl`` to ``cold:ssd``."""
    _, pidx, _ = base
    ti = TieredIndex(pidx, TieredConfig(hot_rows_frac=0.0,
                                        cold_rows_frac=0.3))
    db = Database.wrap(ti)
    plan = QueryPlan(front=front, backend=backend)
    db.query(skewed, plan=plan)
    out = ti.rebalance_tiers()
    assert out["changed"] and out["occupancy"]["hot"] == (0, 0)
    assert out["occupancy"]["cold"][0] > 0
    monkeypatch.setattr(stages, "_score_hot", None)   # never reached
    q = np.concatenate([skewed, ds[1]])         # ds[1] reaches cold lists
    got = db.query(q, plan=plan)
    want = Database.wrap(pidx).query(q, plan=plan)
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.distances, want.distances)
    g, w = _ledger(got.cost), _ledger(want.cost)
    cold = g.pop("cold:ssd")
    assert cold[0] > 0
    assert g.pop("refine:cxl")[0] + cold[0] == w.pop("refine:cxl")[0]
    assert g == w


# --------------------------------------------- the Zipfian trace, replayed


@pytest.fixture(scope="module")
def replayed(ds, base, skewed):
    """Both packages' tiered index after one all-warm pass of the trace
    and ``rebalance_tiers()`` (IVF front), with both passes' answers."""
    jidx, pidx, _ = base
    jti = JTieredIndex(jidx, JTieredConfig(**ZIPF))
    ti = TieredIndex(pidx, TieredConfig(**ZIPF))
    jwarm = JDatabase.wrap(jti).query(jnp.asarray(skewed),
                                      plan=JPlan(front="ivf", k=5))
    warm = Database.wrap(ti).query(skewed, plan=QueryPlan(front="ivf"))
    return jti, ti, jwarm, warm, jti.rebalance_tiers(), ti.rebalance_tiers()


def test_zipf_heat_and_rebalance_match_jax(replayed):
    jti, ti, jwarm, warm, jout, out = replayed
    _same_answer(warm, jwarm)
    np.testing.assert_array_equal(ti.heat.heat, jti.heat.heat)
    assert ti.heat.observations == jti.heat.observations == 1
    assert out == jout
    assert out["changed"] and out["occupancy"]["hot"][0] > 0
    np.testing.assert_array_equal(ti.list_tier, jti.list_tier)
    np.testing.assert_array_equal(ti._dev()["row_tier"].numpy(),
                                  np.asarray(jti._dev()["row_tier"]))


@pytest.mark.parametrize("front,backend", MATRIX)
def test_after_rebalance_matches_jax(skewed, replayed, front, backend):
    jti, ti, *_ = replayed
    want = JDatabase.wrap(jti).query(
        jnp.asarray(skewed), plan=JPlan(front=front, backend="reference",
                                        k=5))
    got = Database.wrap(ti).query(skewed, plan=QueryPlan(front=front,
                                                         backend=backend))
    _same_answer(got, want)
    assert "hot:hbm" in got.cost.ledger
    np.testing.assert_array_equal(ti.heat.heat, jti.heat.heat)


def test_tiered_from_numpy_gives_jax_answer(ds, base, skewed, replayed,
                                            levels):
    """A rebalanced JAX state carried across answers as JAX does, on a
    fresh micro-batched plan."""
    jti, *_ = replayed
    _, _, arrays = base
    placement = {"list_tier": np.asarray(jti.list_tier),
                 "heat": jti.heat.heat, "observations": jti.heat.observations,
                 "generation": jti.generation}
    ti = tiered_from_numpy(arrays, placement,
                           PipelineConfig(**CFG, trq_levels=levels),
                           device="cpu", tiered=TieredConfig(**ZIPF))
    assert ti.generation == jti.generation and ti.device.type == "cpu"
    np.testing.assert_array_equal(ti.list_tier, jti.list_tier)
    want = JDatabase.wrap(jti).query(jnp.asarray(skewed),
                                     plan=JPlan(front="ivf", k=5,
                                                micro_batch=16))
    got = Database.wrap(ti).query(skewed, plan=QueryPlan(front="ivf",
                                                         micro_batch=16))
    _same_answer(got, want)
    np.testing.assert_array_equal(ti.heat.heat, jti.heat.heat)
    with pytest.raises(ValueError, match="lists"):
        tiered_from_numpy(arrays, {**placement, "heat": np.zeros(3)},
                          PipelineConfig(**CFG, trq_levels=levels),
                          device="cpu")


def test_hot_path_fetches_fewer_rows_from_ssd(ds, replayed, skewed):
    """Hot rows are scored from HBM: the SSD rerank shrinks by exactly the
    fetches that went hot, HBM accesses grow, the modeled time falls, and
    recall does not drop."""
    _, ti, _, warm, *_ = replayed
    hot = Database.wrap(ti).query(skewed, plan=QueryPlan(front="ivf"))
    assert hot.cost.ledger["rerank:ssd"].accesses \
        < warm.cost.ledger["rerank:ssd"].accesses
    assert hot.cost.by_tier()[Tier.HBM].accesses \
        > warm.cost.by_tier()[Tier.HBM].accesses
    assert hot.cost.total_seconds() < warm.cost.total_seconds()
    gt = brute_force_topk(torch.from_numpy(ds[0]), torch.from_numpy(skewed),
                          20)
    assert recall_at_k(hot.ids, gt, 5) >= recall_at_k(warm.ids, gt, 5)


# ---------------------------------------------- gate, no-op, invalidation


def test_rebalance_gate_noop_and_force(ds, base):
    _, pidx, _ = base
    ti = TieredIndex(pidx, TieredConfig(hot_rows_frac=0.25,
                                        min_observations=99))
    hooks = []
    ti.add_generation_hook(lambda idx, gen: hooks.append(gen))
    Database.wrap(ti).query(ds[1])
    out = ti.rebalance_tiers()                  # gated
    assert not out["changed"] and out["moves"] == {} and ti.generation == 0
    out = ti.rebalance_tiers(force=True)        # overrides the gate only
    assert out["changed"] and ti.generation == 1 and hooks == [1]
    out = ti.rebalance_tiers(force=True)        # same heat: same plan
    assert not out["changed"] and ti.generation == 1 and hooks == [1]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_rebalance_invalidates_executor_cache(ds, base, backend):
    _, pidx, _ = base
    ti = TieredIndex(pidx, TieredConfig(hot_rows_frac=0.25,
                                        cold_rows_frac=0.25))
    ex0 = make_executor(ti, front="ivf", backend=backend, layout="tiered")
    assert make_executor(ti, front="ivf", backend=backend,
                         layout="tiered") is ex0
    assert not ex0.front.any_hot
    db = Database.wrap(ti)
    db.query(ds[1], plan=QueryPlan(backend=backend))
    assert {k[0] for k in db._compiled} == {0}
    assert ti.rebalance_tiers()["changed"]
    assert db._compiled == {}                   # dropped at the migration
    ex1 = make_executor(ti, front="ivf", backend=backend, layout="tiered")
    assert ex1 is not ex0 and ex1.front.any_hot
    assert all(k[0] == ti.generation for k in ti._executor_cache)
    db.query(ds[1], plan=QueryPlan(backend=backend))
    assert {k[0] for k in db._compiled} == {1}


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_rebalance_invalidates_result_cache(ds, base, backend):
    _, pidx, _ = base
    ti = TieredIndex(pidx, TieredConfig(hot_rows_frac=0.25,
                                        cold_rows_frac=0.25))
    db = Database.wrap(ti)
    plan = db.validate(QueryPlan(front="ivf", backend=backend, k=5))
    res = db.query(ds[1], plan=plan)
    rc = ResultCache()
    rc.attach(ti)                                 # generation hook
    qk = query_key(ds[1][0])
    rc.insert(qk, plan, ti.generation, res.ids[0].numpy(),
              res.distances[0].numpy())
    assert rc.lookup(qk, plan, ti.generation) is not None
    assert ti.rebalance_tiers()["changed"]
    assert rc.lookup(qk, plan, ti.generation) is None
    assert rc.stats.invalidations == 1


# ---------------------------------------------------------- plan errors


def test_plan_errors_match_jax(ds, base):
    jidx, pidx, _ = base
    db, jdb = Database.wrap(TieredIndex(pidx)), JDatabase.wrap(
        JTieredIndex(jidx))
    for plan, jplan, match in (
            (QueryPlan(shards=2), JPlan(front="ivf", shards=2, k=5),
             "tiered.*per-device"),
            (QueryPlan(mode="baseline"), JPlan(front="ivf", mode="baseline",
                                               k=5), "baseline")):
        with pytest.raises(PlanError, match=match) as got:
            db.query(ds[1], plan=plan)
        with pytest.raises(Exception) as want:
            jdb.validate(jplan)
        assert str(got.value) == str(want.value)
    assert registry.LAYOUTS == jregistry.LAYOUTS
    assert str(registry._pair_error("flat", ("static",), "tiered")) == str(
        jregistry._pair_error("front", "flat", ("static",), "tiered"))
