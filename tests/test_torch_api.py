"""The port's legacy tuple surfaces (the counterpart of
``tests/test_api.py``'s shim tests): ``pipeline.search`` and
``baseline_search`` give ``Database.query``'s ids and ledger on the
static, sharded and streaming layouts, ``Retriever.retrieve`` gives its
plan's, the executor's ``search`` / ``search_baseline`` give ``execute``'s,
and on one index carried across from the JAX package each shim gives the
JAX shim's ids and ledger.  The JAX side runs its ``reference``
backend."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.anns import PipelineConfig as JConfig  # noqa: E402
from repro.anns import baseline_search as jbaseline_search  # noqa: E402
from repro.anns import build as jbuild  # noqa: E402
from repro.anns import search as jsearch  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro_torch.anns import (Database, PipelineConfig,  # noqa: E402
                              QueryPlan, StreamingConfig, StreamingIndex,
                              baseline_search, search)
from repro_torch.interop import index_from_numpy  # noqa: E402
from repro_torch.serving import Retriever  # noqa: E402
from test_torch_pipeline import export_jax_index  # noqa: E402

# tests/test_api.py's fixture
CFG = dict(dim=32, pq_m=4, pq_k=32, nlist=16, nprobe=4, final_k=5,
           refine_budget=20)
BACKENDS = ("reference", "cuda")


@pytest.fixture(scope="module")
def ds():
    d = jmake_dataset(jax.random.PRNGKey(0), n=2500, d=32, n_queries=8,
                      k_gt=20, clusters=8)
    return np.array(d.x), np.array(d.queries)


@pytest.fixture(scope="module")
def base(ds):
    jidx = jbuild(jax.random.PRNGKey(1), jnp.asarray(ds[0]), JConfig(**CFG))
    return jidx, index_from_numpy(export_jax_index(jidx),
                                  PipelineConfig(**CFG), device="cpu")


@pytest.fixture(scope="module")
def streaming(ds, base):
    """A live mutable index: inserted rows (delta pages) and
    tombstones."""
    st = StreamingIndex(base[1], StreamingConfig(auto_compact=False))
    st.insert(ds[0][:300] + 0.01)
    st.delete(np.arange(100, 200))
    return st


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


class TestShimEquivalence:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_static(self, ds, base, backend):
        ids, cost = search(base[1], ds[1], k=5, backend=backend)
        res = Database.wrap(base[1]).query(
            ds[1], plan=QueryPlan(backend=backend, k=5))
        assert torch.equal(ids, res.ids)
        assert _ledger(cost) == _ledger(res.cost)

    @pytest.mark.parametrize("shards", [1, 2])
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_sharded(self, ds, base, backend, shards):
        ids, cost = search(base[1], ds[1], k=5, shards=shards,
                           backend=backend)
        res = Database.wrap(base[1]).query(
            ds[1], plan=QueryPlan(shards=shards, backend=backend, k=5))
        assert torch.equal(ids, res.ids)
        assert _ledger(cost) == _ledger(res.cost)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_streaming(self, ds, streaming, backend):
        ids, cost = search(streaming, ds[1], k=5, backend=backend)
        res = Database.wrap(streaming).query(
            ds[1], plan=QueryPlan(backend=backend, k=5))
        assert torch.equal(ids, res.ids)
        assert _ledger(cost) == _ledger(res.cost)
        assert "delta:cxl" in res.cost.ledger      # delta pages were live

    def test_retriever(self, ds, base):
        r = Retriever(index=base[1], micro_batch=4)
        ids, cost = r.retrieve(ds[1], k=5)
        res = Database.wrap(base[1]).query(
            ds[1], plan=QueryPlan(front="ivf", micro_batch=4), k=5)
        assert torch.equal(ids, res.ids)
        assert _ledger(cost) == _ledger(res.cost)

    def test_baseline(self, ds, base):
        ids, cost = baseline_search(base[1], ds[1], k=5)
        res = Database.wrap(base[1]).query(
            ds[1], plan=QueryPlan(k=5, mode="baseline"))
        assert torch.equal(ids, res.ids)
        assert _ledger(cost) == _ledger(res.cost)

    def test_executor_tuples(self, ds, base):
        """``search`` / ``search_baseline`` are ``execute`` /
        ``execute_baseline`` without the distances; ``Database.compiled``
        hands out the executor ``executor_for`` gives."""
        db = Database.wrap(base[1])
        ex = db.executor_for(QueryPlan(k=5))
        assert db.compiled(QueryPlan(k=5))._ex is ex
        q = torch.from_numpy(ds[1])
        for tup, full in ((ex.search, ex.execute),
                          (ex.search_baseline, ex.execute_baseline)):
            ids, cost = tup(q, k=5)
            want_ids, _, want_cost = full(q, k=5)
            assert torch.equal(ids, want_ids)
            assert _ledger(cost) == _ledger(want_cost)


@pytest.mark.parametrize("shards", [None, 1])
def test_shims_match_jax(ds, base, shards):
    """On one index, the port's ``search`` (both backends) and
    ``baseline_search`` give the JAX shims' ids and ledger."""
    jidx, pidx = base
    want_ids, want_cost = jsearch(jidx, jnp.asarray(ds[1]), k=5,
                                  shards=shards)
    for backend in BACKENDS:
        ids, cost = search(pidx, ds[1], k=5, shards=shards, backend=backend)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        assert _ledger(cost) == _ledger(want_cost)
    if shards is None:
        want_ids, want_cost = jbaseline_search(jidx, jnp.asarray(ds[1]), k=5)
        ids, cost = baseline_search(pidx, ds[1], k=5)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        assert _ledger(cost) == _ledger(want_cost)
