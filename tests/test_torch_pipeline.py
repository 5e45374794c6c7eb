"""The port's main path end to end against the JAX package: a JAX-built
index carried across by ``repro_torch.interop.index_from_numpy`` answers
the same queries with the same ids, distances and traffic ledger, and the
port's own build, fed the JAX build's draws, reaches the same recall."""

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
from repro.anns import recall_at_k as jrecall  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro_torch.anns import (Database, PipelineConfig, PlanError,  # noqa
                              QueryPlan, recall_at_k)
from repro_torch.anns.pipeline import build  # noqa: E402
from repro_torch.interop import index_from_numpy  # noqa: E402

CFG = dict(dim=64, pq_m=8, pq_k=32, nlist=16, nprobe=4, final_k=10,
           refine_budget=40)


def export_jax_index(idx) -> dict[str, np.ndarray]:
    """A JAX FaTRQIndex's leaves as numpy arrays, keyed by field path."""
    out = {"codebook.codebooks": idx.codebook.codebooks,
           "pq_codes": idx.pq_codes, "ivf.centroids": idx.ivf.centroids,
           "ivf.lists": idx.ivf.lists, "ivf.list_len": idx.ivf.list_len,
           "x": idx.x}
    for i, lv in enumerate(idx.trq.levels):
        for f in ("packed", "proj", "norm", "rho"):
            out[f"trq.levels.{i}.{f}"] = getattr(lv, f)
    for f in ("delta_sq", "cross", "rho", "norm"):
        out[f"trq.scalars.{f}"] = getattr(idx.trq.scalars, f)
    for f in ("w", "bias", "resid_std"):
        out[f"trq.model.{f}"] = getattr(idx.trq.model, f)
    return {k: np.array(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def data():
    ds = jmake_dataset(jax.random.PRNGKey(0), n=3000, d=64, n_queries=24,
                       k_gt=20, clusters=8)
    return np.array(ds.x), np.array(ds.queries), np.array(ds.gt)


@pytest.fixture(scope="module", params=[1, 2], ids=["L1", "L2"])
def levels(request):
    return request.param


@pytest.fixture(scope="module")
def jindex(data, levels):
    return jbuild(jax.random.PRNGKey(1), jnp.asarray(data[0]),
                  JConfig(**CFG, trq_levels=levels))


@pytest.fixture(scope="module")
def pindex(jindex, levels):
    return index_from_numpy(export_jax_index(jindex),
                            PipelineConfig(**CFG, trq_levels=levels),
                            device="cpu")


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


def _same_result(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=1e-5)
    assert _ledger(got.cost) == _ledger(want.cost)
    for tier, s in want.cost.breakdown().items():
        assert got.cost.breakdown()[tier] == pytest.approx(s, rel=1e-12)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_fatrq_query_matches_jax(data, jindex, pindex, backend):
    want = JDatabase.wrap(jindex).query(jnp.asarray(data[1]),
                                        plan=JPlan(backend="reference"))
    got = Database.wrap(pindex).query(data[1],
                                      plan=QueryPlan(backend=backend))
    assert got.plan.backend == backend
    _same_result(got, want)


def test_baseline_query_matches_jax(data, jindex, pindex):
    want = JDatabase.wrap(jindex).query(jnp.asarray(data[1]),
                                        plan=JPlan(mode="baseline"))
    got = Database.wrap(pindex).query(data[1],
                                      plan=QueryPlan(mode="baseline"))
    _same_result(got, want)


@pytest.mark.parametrize("mode", ["fatrq", "baseline"])
def test_micro_batches_and_buckets_change_nothing(data, pindex, mode):
    """Ragged micro-batches (24 queries in 7s) give the one-batch result."""
    db = Database.wrap(pindex)
    whole = db.query(data[1], plan=QueryPlan(mode=mode, backend="cuda"))
    split = db.query(data[1], plan=QueryPlan(mode=mode, backend="cuda"),
                     micro_batch=7)
    np.testing.assert_array_equal(split.ids.numpy(), whole.ids.numpy())
    np.testing.assert_array_equal(split.distances.numpy(),
                                  whole.distances.numpy())
    assert _ledger(split.cost) == _ledger(whole.cost)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_recall_by_cut(data, pindex, backend):
    """The cuts hold ever fewer true neighbours; the candidates' share is
    the baseline's recall, the answer's the query's, in micro-batches
    too."""
    from repro_torch.anns import recall_at_k
    from repro_torch.anns.executor import SearchExecutor
    q, gt = torch.from_numpy(data[1]), torch.from_numpy(data[2])
    db = Database.wrap(pindex)
    for micro_batch in (None, 7):
        ex = SearchExecutor.from_index(pindex, backend=backend,
                                       micro_batch=micro_batch)
        cuts = ex.recall_by_cut(q, gt)
        assert list(cuts) == ["candidates", "survivors", "fetched",
                              "answer"]
        vals = list(cuts.values())
        assert vals == sorted(vals, reverse=True) and vals[-1] > 0
        k = pindex.config.final_k
        assert cuts["candidates"] == recall_at_k(db.query(
            q, plan=QueryPlan(mode="baseline")).ids, gt, k)
        assert cuts["answer"] == recall_at_k(db.query(
            q, plan=QueryPlan(backend=backend)).ids, gt, k)


def test_default_backend_follows_the_device(pindex):
    from repro_torch.anns import registry
    assert registry.front_names() == ("ivf", "graph")
    assert registry.backend_names() == ("reference", "cuda")
    assert Database.wrap(pindex).validate().backend == "reference"
    assert QueryPlan(backend="cuda").resolve(pindex).backend == "cuda"


def test_port_build_recall_matches_jax(data, jindex, levels):
    """The port's own build, fed the draws the JAX build made from its key,
    reaches the JAX index's recall@10."""
    x, q, gt = data
    cfg = JConfig(**CFG, trq_levels=levels)
    pcfg = PipelineConfig(**CFG, trq_levels=levels)
    k_pq, k_ivf, k_cal, k_calq = jax.random.split(jax.random.PRNGKey(1), 4)
    n = x.shape[0]

    def choice(key, k):
        return torch.from_numpy(np.array(
            jax.random.choice(key, n, (k,), replace=False)))

    n_samples = max(int(cfg.calib_fraction * n), 32)
    idx = build(
        x, pcfg, device="cpu",
        pq_init=torch.stack([choice(s, cfg.pq_k)
                             for s in jax.random.split(k_pq, cfg.pq_m)]),
        ivf_init=choice(k_ivf, cfg.nlist),
        calib_samples=choice(k_cal, n_samples),
        calib_noise=lambda p, d: torch.from_numpy(np.array(
            jax.random.normal(k_calq, (p, d)))))
    want = jrecall(JDatabase.wrap(jindex).query(jnp.asarray(q)).ids, gt, 10)
    got = recall_at_k(Database.wrap(idx).query(q).ids, gt, 10)
    assert abs(got - want) <= 0.02, (got, want)
    np.testing.assert_allclose(idx.trq.model.w.numpy(),
                               np.asarray(jindex.trq.model.w), rtol=1e-2,
                               atol=1e-2)
    # and with the port's own torch.Generator draws
    own = build(x, pcfg, device="cpu",
                generator=torch.Generator().manual_seed(5))
    assert recall_at_k(Database.wrap(own).query(q).ids, gt, 10) >= \
        want - 0.1


def test_unported_plans_raise_plan_error(data, pindex):
    db = Database.wrap(pindex)
    with pytest.raises(PlanError, match="not ported"):
        db.query(data[1], plan=QueryPlan(front="lsh"))
    with pytest.raises(PlanError, match="not ported"):
        db.query(data[1], plan=QueryPlan(front="lsh", shards=2))
    with pytest.raises(PlanError, match="not ported"):
        db.query(data[1], plan=QueryPlan(backend="pallas"))
    with pytest.raises(PlanError, match="mode"):
        db.query(data[1], plan=QueryPlan(mode="exact"))


def test_entry_points_raise_without_a_gpu(data, jindex, levels,
                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Database.build(data[0], PipelineConfig(**CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index_from_numpy(export_jax_index(jindex),
                         PipelineConfig(**CFG, trq_levels=levels))
