"""The port's sharded layout (``repro_torch.anns.sharding``) against the JAX
package's: the partition of a JAX-built index, the single-shard path
against JAX's in-process ``shards=1`` path, and 2 and 4 shards against the
unsharded JAX search (ids, per-tier bytes, the parallel fold)."""

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
from repro.anns.executor import fold_counts as jfold_counts  # noqa: E402
from repro.anns.stages import fold_ivf_front_cost  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro.memory import Tier as JTier  # noqa: E402
from repro_torch.anns import (Database, PipelineConfig, PlanError,  # noqa
                              QueryPlan, ShardedIndex, lpt_assign,
                              make_sharded_executor, partition_database)
from repro_torch.anns import registry  # noqa: E402
from repro_torch.core.estimator import pooled_k_smallest  # noqa: E402
from repro_torch.interop import index_from_numpy  # noqa: E402
from repro_torch.memory import Tier  # noqa: E402
from test_torch_pipeline import CFG, export_jax_index  # noqa: E402


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
    return index_from_numpy(export_jax_index(jindex),
                            PipelineConfig(**CFG, trq_levels=levels),
                            device="cpu")


@pytest.fixture(scope="module")
def unsharded(data, jindex):
    """The JAX unsharded search, the comparator for S ≥ 2."""
    return JDatabase.wrap(jindex).query(jnp.asarray(data[1]),
                                        plan=JPlan(backend="reference"))


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


def _tier_bytes(cost):
    out = {}
    for key, t in cost.ledger.items():
        tier = key.rsplit(":", 1)[-1]
        out[tier] = out.get(tier, 0) + t.bytes
    return out


# ------------------------------------------------------------- partitioner


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_partition_matches_jax(jindex, pindex, shards):
    want = jsharding.partition_database(jindex, shards)
    got = partition_database(pindex, shards)
    np.testing.assert_array_equal(got.shard_rows, want.shard_rows)
    pairs = [(got.gid, want.gid), (got.list_gid, want.list_gid),
             (got.lists, want.lists), (got.centroids, want.centroids),
             (got.pq_codes, want.pq_codes), (got.x, want.x)]
    for lg, lw in zip(got.trq.levels, want.trq.levels):
        pairs += [(getattr(lg, f), getattr(lw, f))
                  for f in ("packed", "proj", "norm", "rho")]
    pairs += [(getattr(got.trq.scalars, f), getattr(want.trq.scalars, f))
              for f in ("delta_sq", "cross", "rho", "norm")]
    for g, w in pairs:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.front_args == want.front_args


def test_every_row_exactly_once(pindex):
    si = partition_database(pindex, 4)
    real = si.gid.numpy()[si.gid.numpy() >= 0]
    listed = pindex.ivf.lists.numpy()
    assert sorted(real.tolist()) == sorted(listed[listed >= 0].tolist())
    assert len(set(real.tolist())) == real.size


def test_whole_lists_per_shard(pindex):
    """Each global list lives on exactly one shard, its members mapped
    contiguously into that shard's local rows."""
    si = partition_database(pindex, 4)
    list_gid = si.list_gid.numpy()
    assert sorted(list_gid[list_gid >= 0].tolist()) == \
        list(range(pindex.ivf.nlist))
    lists_np = pindex.ivf.lists.numpy()
    lens = pindex.ivf.list_len.numpy()
    gid, local = si.gid.numpy(), si.lists.numpy()
    for s in range(4):
        for j, li in enumerate(list_gid[s]):
            if li < 0:
                continue
            rows = local[s, j, :lens[li]]
            assert (rows >= 0).all()
            assert np.array_equal(gid[s, rows], lists_np[li, :lens[li]])


def test_lpt_balance(pindex):
    """LPT bound: heaviest shard ≤ mean + the largest single list."""
    si = partition_database(pindex, 4)
    lens = pindex.ivf.list_len.numpy()
    assert si.shard_rows.sum() == lens.sum()
    assert si.shard_rows.max() <= lens.sum() / 4 + lens.max()
    members, loads = lpt_assign(lens, 4)
    assert sorted(sum(members, [])) == list(range(len(lens)))
    np.testing.assert_array_equal(loads, si.shard_rows)


def test_shards_bounded_by_nlist(pindex):
    with pytest.raises(ValueError, match="nlist"):
        partition_database(pindex, pindex.ivf.nlist + 1)


# -------------------------------------------------------- single shard


@pytest.mark.parametrize("micro_batch", [None, 5])
@pytest.mark.parametrize("backend,jbackend", [("reference", "reference"),
                                              ("cuda", "pallas")])
def test_single_shard_matches_jax_sharded(data, jindex, pindex, backend,
                                          jbackend, micro_batch):
    """shards=1 against the JAX ``shard_map`` datapath on one device: the
    same ids, distances and ledger (accesses, bytes, tier seconds)."""
    want = JDatabase.wrap(jindex).query(
        jnp.asarray(data[1]),
        plan=JPlan(shards=1, backend=jbackend, micro_batch=micro_batch))
    got = Database.wrap(pindex).query(
        data[1], plan=QueryPlan(shards=1, backend=backend,
                                micro_batch=micro_batch))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=1e-5)
    assert _ledger(got.cost) == _ledger(want.cost)
    for tier, s in want.cost.breakdown().items():
        assert got.cost.breakdown()[tier] == pytest.approx(s, rel=1e-12)


# ---------------------------------------------- exact ties at the cuts


@pytest.fixture(scope="module")
def triplicated():
    """Every database row three times over: each candidate's estimate and
    exact distance are tied with its two twins', so the budget of 40
    (40 = 3·13 + 1) and the top 10 (10 = 3·3 + 1) each cut a group of
    three in two.  JAX index, the port's copy of it, queries and the JAX
    unsharded search."""
    ds = jmake_dataset(jax.random.PRNGKey(5), n=1000, d=64, n_queries=24,
                       k_gt=20, clusters=8)
    x = np.concatenate([np.array(ds.x)] * 3)
    jidx = jbuild(jax.random.PRNGKey(6), jnp.asarray(x), JConfig(**CFG))
    pidx = index_from_numpy(export_jax_index(jidx), PipelineConfig(**CFG),
                            device="cpu")
    qs = np.array(ds.queries)
    want = JDatabase.wrap(jidx).query(jnp.asarray(qs),
                                      plan=JPlan(backend="reference"))
    return pidx, qs, want


def test_triplicated_rows_tie_at_the_budget(triplicated):
    """The fixture's point: at 2 shards, more alive candidates than the
    budget have an estimate at or below the pooled τ_b, so a threshold cut
    alone would fetch too many."""
    pidx, qs, _ = triplicated
    ex = make_sharded_executor(pidx, shards=2)
    si, q = ex.sharded, torch.from_numpy(qs)
    cands = registry.sharded_front("ivf").body(
        q, si.front_rep, si.front_db, si.codebook, si.pq_codes,
        **dict(si.front_args))
    refined = ex.backend.refine_sharded(q, cands, si.shard_trqs, k=10,
                                        bound="cauchy", z=3.0)
    est_m = torch.where(refined.alive, refined.est, float("inf"))
    tau_b = pooled_k_smallest(est_m, CFG["refine_budget"], shard_dim=0)
    at_or_below = (est_m <= tau_b[None, :, None]).sum((0, 2))
    assert bool((at_or_below > CFG["refine_budget"]).all())


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_exact_ties_give_the_unsharded_fetches_and_ids(triplicated, shards,
                                                       backend):
    """With exact estimate ties at τ_b and exact distance ties at the
    top-k boundary, S shards fetch exactly the budget per query and return
    the unsharded ids and per-tier bytes: the port's unsharded path's and
    the JAX unsharded path's."""
    pidx, qs, want = triplicated
    db = Database.wrap(pidx)
    got = db.query(qs, plan=QueryPlan(shards=shards, backend=backend))
    flat = db.query(qs, plan=QueryPlan(backend=backend))
    assert got.cost.ledger["rerank:ssd"].accesses == \
        CFG["refine_budget"] * len(qs)
    for ref in (flat, want):
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
        np.testing.assert_allclose(got.distances.numpy(),
                                   np.asarray(ref.distances), rtol=1e-5,
                                   atol=1e-5)
        assert _tier_bytes(got.cost) == _tier_bytes(ref.cost)


# ----------------------------------------------------------- 2 and 4 shards


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_multishard_matches_jax_unsharded(data, jindex, pindex, unsharded,
                                          shards, backend):
    """S shards return the unsharded ids and per-tier bytes; the merged
    ledger is parallel-folded, no tier slower than the unsharded one, and
    equal to the port's per-shard counts folded by the JAX package's own
    ``fold_counts`` + ``merge_parallel``."""
    got = Database.wrap(pindex).query(
        data[1], plan=QueryPlan(shards=shards, backend=backend))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(unsharded.ids))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(unsharded.distances), rtol=1e-5,
                               atol=1e-5)
    assert _tier_bytes(got.cost) == _tier_bytes(unsharded.cost)
    assert got.cost.parallel_s, "per-shard ledgers must be folded"
    for tier in Tier:
        assert got.cost.tier_seconds(tier) <= \
            unsharded.cost.tier_seconds(JTier(tier.value)) + 1e-12

    ex = make_sharded_executor(pindex, shards=shards, backend=backend)
    _, _, shard_counts = ex._search(torch.from_numpy(data[1]))
    assert len(shard_counts) == shards
    jcosts = [jfold_counts(c, cost=None, config=jindex.config,
                           layout=jindex.layout,
                           front_fold=fold_ivf_front_cost)
              for c in shard_counts]
    folded = jcosts[0]
    for c in jcosts[1:]:
        folded.merge_parallel(c)
    assert _ledger(got.cost) == _ledger(folded)
    assert got.cost.breakdown() == folded.breakdown()


def test_executor_memoized_per_index(pindex):
    e1 = make_sharded_executor(pindex, shards=2)
    assert make_sharded_executor(pindex, shards=2) is e1
    e2 = make_sharded_executor(pindex, shards=2, backend="cuda")
    # another backend: a new executor over the same partition
    assert e2 is not e1 and e2.sharded is e1.sharded


def test_wrapped_sharded_index(data, pindex, unsharded):
    si = partition_database(pindex, 2)
    db = Database.wrap(si)
    assert db.layout == "sharded" and len(db) == pindex.x.shape[0]
    res = db.query(data[1])
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(unsharded.ids))
    moved = si.to("cpu")
    assert isinstance(moved, ShardedIndex) and moved.n_shards == 2
    assert torch.equal(moved.x, si.x)


def test_sharded_plan_errors(data, pindex):
    db = Database.wrap(pindex)
    with pytest.raises(PlanError, match="baseline"):
        db.query(data[1], plan=QueryPlan(mode="baseline", shards=2))
    with pytest.raises(PlanError, match="not ported"):
        db.query(data[1], plan=QueryPlan(backend="pallas", shards=2))
    sdb = Database.wrap(partition_database(pindex, 2))
    with pytest.raises(PlanError, match="partitioned 2 ways"):
        sdb.query(data[1], plan=QueryPlan(shards=4))
    with pytest.raises(PlanError, match="baseline"):
        sdb.query(data[1], plan=QueryPlan(mode="baseline"))
