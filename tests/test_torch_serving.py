"""The port's serving path (``repro_torch.serving``, the executor's bucket
padding and split surface, ``CompiledPlan``) against the JAX package's.

``bucket_for`` / ``pad_chunk`` must be JAX's; a padded micro-batch must
give the unpadded ids, distances, ledger and tiered heat on every front x
layout x backend; the ``tests/test_serving.py`` pins of the
``Retriever``, the ``ServingEngine`` (bit-identity to sequential
``db.query`` on every layout x backend, the result cache and its
invalidation, the scheduler under the virtual clock, the bucket shapes)
hold in the port; one request trace through both packages' engines over
one exported index gives the same batch log, responses and
``total_cost`` (distances within f32 rounding, rtol = atol = 1e-5, as
the other port parity tests); and ``query_key`` gives JAX's packed-code
bytes with a scale pair within a few ulp.  The JAX side runs its
``reference`` backend."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.anns import PipelineConfig as JConfig  # noqa: E402
from repro.anns import build as jbuild  # noqa: E402
from repro.anns.api import QueryPlan as JPlan  # noqa: E402
from repro.anns.executor import bucket_for as jbucket_for  # noqa: E402
from repro.anns.executor import pad_chunk as jpad_chunk  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ResultCache as JResultCache  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import TenantQoS as JTenantQoS  # noqa: E402
from repro.serving import query_key as jquery_key  # noqa: E402
from repro_torch.anns import (Database, PipelineConfig,  # noqa: E402
                              QueryPlan, StreamingConfig, StreamingIndex,
                              TieredConfig, TieredIndex, registry)
from repro_torch.anns.executor import bucket_for, pad_chunk  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.device import row_sum  # noqa: E402
from repro_torch.interop import index_from_numpy  # noqa: E402
from repro_torch.memory import TIER_HOT, QueryCost  # noqa: E402
from repro_torch.serving import (Request, ResultCache,  # noqa: E402
                                 Retriever, ServingEngine, TenantQoS,
                                 query_key)
from test_torch_pipeline import export_jax_index  # noqa: E402

# tests/test_serving.py's fixture
CFG = dict(dim=16, pq_m=4, pq_k=16, nlist=8, nprobe=2, final_k=5,
           refine_budget=10)
BACKENDS = ("reference", "cuda")


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


@pytest.fixture(scope="module")
def serve_ds():
    """``tests/test_serving.py``'s dataset and index, carried across."""
    ds = jmake_dataset(jax.random.PRNGKey(7), n=1500, d=16, n_queries=16)
    jidx = jbuild(jax.random.PRNGKey(8), ds.x, JConfig(**CFG))
    pidx = index_from_numpy(export_jax_index(jidx), PipelineConfig(**CFG),
                            device="cpu")
    return np.array(ds.queries), jidx, pidx


def _layout_index(pidx, layout: str):
    """A fresh index of ``layout`` over ``pidx`` (its shard count for the
    sharded layout)."""
    if layout == "streaming":
        return StreamingIndex(pidx, StreamingConfig(auto_compact=False)), None
    if layout == "tiered":
        return TieredIndex(pidx, TieredConfig(hot_rows_frac=0.25,
                                              cold_rows_frac=0.25)), None
    return pidx, (1 if layout == "sharded" else None)


# --------------------------------------------------- buckets and padding


@pytest.mark.parametrize("micro_batch", [None, 1, 4, 6, 8, 64])
def test_bucket_for_matches_jax(micro_batch):
    for n in range(1, 70):
        assert bucket_for(n, micro_batch) == jbucket_for(n, micro_batch), n


@pytest.mark.parametrize("n,bucket", [(1, 1), (3, 4), (5, 8), (8, 8),
                                      (37, 64)])
def test_pad_chunk_matches_jax(n, bucket):
    rng = np.random.default_rng(n)
    chunk = rng.standard_normal((n, 6)).astype(np.float32)
    got, qvalid = pad_chunk(torch.from_numpy(chunk), bucket)
    want, jvalid = jpad_chunk(jnp.asarray(chunk), bucket)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(qvalid.numpy(), np.asarray(jvalid))
    assert qvalid.dtype == torch.bool and qvalid.device == got.device


@pytest.mark.parametrize("d", [16, 32, 33, 768, 1100])
def test_row_sum_is_a_sum_of_the_row_alone(d):
    """``device.row_sum``: the row's sum within float32 rounding of a
    float64 sum, and each row's bits the same alone as among 63 others."""
    rng = np.random.default_rng(d)
    t = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    got = row_sum(t)
    np.testing.assert_allclose(got.numpy(), t.double().sum(-1).numpy(),
                               rtol=1e-5, atol=1e-5)
    for i in (0, 17, 63):
        assert torch.equal(row_sum(t[i:i + 1])[0], got[i])


# a port-built index with two TRQ levels; its streaming generation holds
# live delta pages and tombstones, its tiered placement live hot and cold
# lists
PAD_CFG = dict(dim=32, pq_m=4, pq_k=32, nlist=16, nprobe=4, final_k=5,
               refine_budget=20, trq_levels=2)


@pytest.fixture(scope="module")
def pad_indexes():
    ds = make_dataset(n=1500, d=32, n_queries=13, k_gt=20, clusters=8,
                      generator=torch.Generator().manual_seed(0))
    db = Database.build(ds.x, PipelineConfig(**PAD_CFG), device="cpu")
    st = StreamingIndex(db.index, StreamingConfig(auto_compact=False))
    st.insert(ds.x[:200] + 0.01)
    st.delete([3, 5, 7, 1501])
    ti = TieredIndex(db.index, TieredConfig(hot_rows_frac=0.25,
                                            cold_rows_frac=0.25))
    Database.wrap(ti).query(ds.queries, plan=QueryPlan(k=5))
    assert ti.rebalance_tiers()["changed"]
    return ds.queries, {"static": db.index, "sharded": db.index,
                        "streaming": st, "tiered": ti}


@pytest.mark.parametrize("front,layout,backend", list(itertools.product(
    ("ivf", "graph"), registry.LAYOUTS, BACKENDS)))
def test_padded_equals_unpadded(pad_indexes, front, layout, backend,
                                monkeypatch):
    """13 queries in micro-batches of 8 (the second padded from 5 to 8):
    the ids, distances, whole ledger and, on the tiered layout, each
    search's per-list heat histogram are the unpadded ones."""
    queries, indexes = pad_indexes
    idx = indexes[layout]
    heats = []
    if layout == "tiered":
        monkeypatch.setattr(idx, "observe_heat",
                            lambda h: heats.append(np.array(h)))
    plan = QueryPlan(front=front, backend=backend, k=5, micro_batch=8,
                     shards=2 if layout == "sharded" else None)
    db = Database.wrap(idx)
    a = db.query(queries, plan=plan)
    b = db.query(queries, plan=plan, bucket=True)
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.distances, b.distances)
    assert _ledger(a.cost) == _ledger(b.cost)
    if layout == "tiered":
        assert len(heats) == 2 and heats[0].sum() > 0
        np.testing.assert_array_equal(heats[0], heats[1])


@pytest.mark.parametrize("layout", ["static", "streaming", "tiered"])
def test_padded_rows_add_nothing(pad_indexes, layout):
    """``run_front`` on a batch padded from 3 to 8 rows: no valid slot, no
    hot or delta slot in a padded row, and the counters of the 3 real
    rows alone."""
    queries, indexes = pad_indexes
    for front in ("ivf", "graph"):
        cp = Database.wrap(indexes[layout]).compiled(
            QueryPlan(front=front, k=5))
        real = cp.run_front(queries[:3])
        qpad, qvalid = pad_chunk(queries[:3], 8)
        cand = cp.run_front(qpad, qvalid=qvalid)
        for t in (cand.ids, cand.valid, cand.d0):   # as the kernels take
            assert t.is_contiguous()
        assert not cand.valid[3:].any()
        assert torch.equal(cand.valid[:3], real.valid)
        assert torch.isinf(cand.d0[3:]).all()
        for name in cand.counters:
            assert torch.equal(cand.counters[name], real.counters[name]), \
                name
        if cand.tier is not None:          # no hot slot in a padded row
            assert not (cand.valid[3:] & (cand.tier[3:] == TIER_HOT)).any()
        res = cp.run_finish(qpad, cand)
        want = cp.execute(queries[:3])
        assert torch.equal(res.ids[:3], want.ids)
        assert _ledger(res.cost) == _ledger(want.cost)


# ----------------------------------------------- Retriever accounting


class TestRetrieverAccounting:
    def test_total_cost_accumulates_across_calls(self, serve_ds):
        q, _, pidx = serve_ds
        r = Retriever(index=pidx, micro_batch=4)
        _, c1 = r.retrieve(q[:8], k=5)
        _, c2 = r.retrieve(q[:8], k=5)
        for key in c1.ledger:
            assert r.total_cost.ledger[key].accesses == \
                c1.ledger[key].accesses + c2.ledger[key].accesses
            assert r.total_cost.ledger[key].bytes == \
                c1.ledger[key].bytes + c2.ledger[key].bytes
        assert r.total_cost.compute_s == pytest.approx(
            c1.compute_s + c2.compute_s)

    def test_sharded_retriever_single_device(self, serve_ds):
        q, _, pidx = serve_ds
        plain = Retriever(index=pidx, micro_batch=None)
        sharded = Retriever(index=pidx, micro_batch=None, shards=1)
        ids_p, cost_p = plain.retrieve(q[:8], k=5)
        ids_s, cost_s = sharded.retrieve(q[:8], k=5)
        assert torch.equal(ids_p, ids_s)
        assert _ledger(cost_p) == _ledger(cost_s)

    @pytest.mark.parametrize("layout", ["static", "sharded", "streaming",
                                        "tiered"])
    def test_ragged_calls_bucketed_equal_unbucketed(self, serve_ds, layout):
        q, _, pidx = serve_ds
        idx, shards = _layout_index(pidx, layout)
        got = Retriever(index=idx, shards=shards, micro_batch=8)
        want = Retriever(index=idx, shards=shards, micro_batch=8,
                         bucket=False)
        at = 0
        for n in (5, 8, 1, 2):
            a = got.query(q[at:at + n], k=5)
            b = want.query(q[at:at + n], k=5)
            assert torch.equal(a.ids, b.ids)
            assert torch.equal(a.distances, b.distances)
            assert _ledger(a.cost) == _ledger(b.cost)
            at += n
        assert _ledger(got.total_cost) == _ledger(want.total_cost)


# --------------------------------------------------- continuous batching


class TestServingEngineBitIdentity:
    """Engine responses (ids, exact distances, the summed ledger) are those
    of sequential ``db.query`` calls on every layout x backend."""

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("layout", ["static", "sharded", "streaming",
                                        "tiered"])
    def test_matches_sequential_query(self, serve_ds, layout, backend):
        q, _, pidx = serve_ds
        idx, shards = _layout_index(pidx, layout)
        if layout == "tiered":                   # live hot and cold lists
            Database.wrap(idx).query(q, plan=QueryPlan(backend=backend))
            assert idx.rebalance_tiers()["changed"]
        plan = QueryPlan(backend=backend, shards=shards)
        eng = ServingEngine(idx, plan=plan, max_batch=4, max_wait_us=100.0,
                            cache=ResultCache())
        # distinct queries: every lookup misses and the datapath runs for
        # all of them, in batches of 1-4 (37 us apart, 100 us close age)
        reqs = [Request(query=q[i], arrival_us=i * 37.0, rid=i)
                for i in range(10)]
        resp = eng.run(reqs)
        assert [r.rid for r in resp] == list(range(10))
        assert eng.stats.cache_hits == 0
        assert eng.stats.batches >= 2
        db = Database.wrap(idx)
        seq_cost = QueryCost()
        for i, r in enumerate(resp):
            ref = db.query(q[i][None], plan=plan, k=5)
            np.testing.assert_array_equal(r.ids, ref.ids[0].numpy())
            np.testing.assert_array_equal(r.distances,
                                          ref.distances[0].numpy())
            seq_cost.merge(ref.cost)
        assert _ledger(eng.total_cost) == _ledger(seq_cost)

    def test_overlap_off_same_results(self, serve_ds):
        q, _, pidx = serve_ds
        resp_ov = ServingEngine(pidx, max_batch=4, overlap=True).serve(
            q[:8], k=5)
        resp_sr = ServingEngine(pidx, max_batch=4, overlap=False).serve(
            q[:8], k=5)
        for a, b in zip(resp_ov, resp_sr):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.distances, b.distances)

    def test_cpu_index_touches_no_cuda(self, serve_ds, monkeypatch):
        """A CPU index serves on the CPU: no stream, event or device
        synchronize is asked for."""
        q, _, pidx = serve_ds

        def boom(*a, **kw):
            raise AssertionError("CUDA touched by a CPU engine")

        for name in ("Stream", "Event", "synchronize", "current_stream",
                     "stream"):
            monkeypatch.setattr(torch.cuda, name, boom)
        resp = ServingEngine(pidx, max_batch=4).serve(q[:6], k=5)
        assert len(resp) == 6
        ids, _ = Retriever(index=pidx).retrieve(q[:6], k=5)
        assert ids.device.type == "cpu"


class TestResultCache:
    def test_hit_miss_accounting_and_bit_identity(self, serve_ds):
        q, _, pidx = serve_ds
        cache = ResultCache()
        eng = ServingEngine(pidx, max_batch=4, max_wait_us=50.0,
                            cache=cache)
        first = eng.serve(q[:4], k=5)
        assert (cache.stats.misses, cache.stats.hits,
                cache.stats.inserts) == (4, 0, 4)
        second = eng.serve(q[:4], k=5)
        assert cache.stats.hits == 4 and cache.stats.misses == 4
        for a, b in zip(first, second):
            assert not a.cache_hit and b.cache_hit
            assert b.cost is None and b.batch is None
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.distances, b.distances)
        assert eng.stats.batches == 1

    def test_lru_eviction(self):
        cache = ResultCache(capacity=2)
        for tag in (b"a", b"b", b"c"):
            cache.insert(tag, "plan", 0, np.arange(3), np.arange(3.0))
        assert len(cache) == 2 and cache.stats.evictions == 1
        assert cache.lookup(b"a", "plan", 0) is None
        assert cache.lookup(b"c", "plan", 0) is not None

    def test_plan_and_generation_partition_keys(self):
        cache = ResultCache()
        cache.insert(b"q", "planA", 0, np.arange(3), np.arange(3.0))
        assert cache.lookup(b"q", "planB", 0) is None
        assert cache.lookup(b"q", "planA", 1) is None
        assert cache.lookup(b"q", "planA", 0) is not None

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_streaming_mutations_invalidate(self, serve_ds, backend):
        q, _, pidx = serve_ds
        st = StreamingIndex(pidx, StreamingConfig(auto_compact=False))
        cache = ResultCache()
        eng = ServingEngine(st, plan=QueryPlan(backend=backend),
                            max_batch=4, max_wait_us=50.0, cache=cache)

        def warm():
            eng.serve(q[:4], k=5)
            assert len(cache) >= 4

        warm()
        inv0 = cache.stats.invalidations
        gids = st.insert(q[:2])
        assert len(cache) == 0
        assert cache.stats.invalidations > inv0
        hits0 = cache.stats.hits
        warm()                         # fresh misses after the mutation
        assert cache.stats.hits == hits0
        for mutate in (lambda: st.delete(gids[:1]),
                       lambda: st.compact(),
                       lambda: st.rebalance(2)):
            warm()
            mutate()
            assert len(cache) == 0, "a mutation must purge stale entries"


class TestScheduler:
    def test_deadline_ordered_admission(self, serve_ds):
        q, _, pidx = serve_ds
        eng = ServingEngine(pidx, max_batch=2, max_wait_us=100.0)
        reqs = [Request(query=q[i], arrival_us=0.0,
                        deadline_us=1000.0 - 100.0 * i, rid=i)
                for i in range(4)]
        eng.run(reqs)
        assert eng.batch_log[0][2] == (3, 2)
        assert eng.batch_log[1][2] == (1, 0)

    def test_close_on_size(self, serve_ds):
        q, _, pidx = serve_ds
        eng = ServingEngine(pidx, max_batch=4, max_wait_us=10_000.0)
        eng.run([Request(query=q[i], arrival_us=5.0, rid=i)
                 for i in range(4)])
        assert eng.batch_log == [(0, 5.0, (0, 1, 2, 3))]

    def test_close_on_age(self, serve_ds):
        q, _, pidx = serve_ds
        eng = ServingEngine(pidx, max_batch=4, max_wait_us=200.0)
        eng.run([Request(query=q[0], arrival_us=10.0, rid=0)])
        assert eng.batch_log == [(0, 210.0, (0,))]

    def test_token_bucket_fairness(self, serve_ds):
        q, _, pidx = serve_ds
        qos = {"heavy": TenantQoS(rate_rps=1000.0, burst=2.0)}
        eng = ServingEngine(pidx, max_batch=4, max_wait_us=100.0, qos=qos)
        reqs, rid = [], 0
        for i in range(16):            # heavy: 10k rps, 10x its contract
            reqs.append(Request(query=q[i % 8], tenant="heavy",
                                arrival_us=i * 100.0, rid=rid))
            rid += 1
        for i in range(3):             # light tenant: unthrottled
            reqs.append(Request(query=q[8 + i], tenant="light",
                                arrival_us=400.0 + i * 300.0, rid=rid))
            rid += 1
        resp = eng.run(reqs)
        assert len(resp) == 19
        heavy = [r for r in resp if r.tenant == "heavy"]
        light = [r for r in resp if r.tenant == "light"]
        assert not any(r.degraded for r in light)
        assert sum(r.degraded for r in heavy) >= 10
        assert sum(not r.degraded for r in heavy) >= 2
        for r in heavy:
            assert r.ids.shape == (5,)
            assert np.isfinite(r.done_us)

    def test_degraded_runs_reduced_refine_budget(self, serve_ds):
        _, _, pidx = serve_ds
        eng = ServingEngine(pidx, degrade_factor=2)
        full = eng._class_plan(5, False)
        deg = eng._class_plan(5, True)
        assert deg.refine_budget == max(5, full.refine_budget // 2)
        assert deg.refine_budget < full.refine_budget

    def test_deterministic_batch_boundaries(self, serve_ds):
        q, _, pidx = serve_ds
        rng = np.random.default_rng(3)
        arr = np.cumsum(rng.exponential(80.0, size=12))

        def trace():
            return [Request(query=q[i % 8], arrival_us=float(arr[i]),
                            deadline_us=float(arr[i]) + 500.0, rid=i)
                    for i in range(12)]

        e1 = ServingEngine(pidx, max_batch=4, max_wait_us=150.0,
                           cache=ResultCache())
        e2 = ServingEngine(pidx, max_batch=4, max_wait_us=150.0,
                           cache=ResultCache())
        r1, r2 = e1.run(trace()), e2.run(trace())
        assert e1.batch_log == e2.batch_log
        assert [(r.rid, r.done_us, r.cache_hit) for r in r1] == \
            [(r.rid, r.done_us, r.cache_hit) for r in r2]


def test_executor_sees_only_bucket_shapes(serve_ds, monkeypatch):
    """Retrieving any batch size pads to the buckets {1, 2, 4, 8}: the
    front (so every kernel after it) sees only those query shapes."""
    q, _, pidx = serve_ds
    r = Retriever(index=pidx, micro_batch=8)
    front = r.db.executor_for(r.default_plan()).front
    seen = []
    inner = front.candidates
    monkeypatch.setattr(front, "candidates", lambda queries, qvalid=None: (
        seen.append(queries.shape[0]), inner(queries, qvalid=qvalid))[1])
    for n in (5, 3, 2, 1, 6, 7, 8, 3, 2, 4, 1, 5, 13):
        r.retrieve(q[:n], k=5)
    assert set(seen) == {1, 2, 4, 8}


# ------------------------------------------------ parity with JAX's engine


def _trace(q, make, n=40, seed=0):
    """``tests/test_obs.py``'s trace: ~40 us mean inter-arrival, every
    third request from a throttled tenant, queries drawn with repeats."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(40.0, size=n))
    picks = rng.integers(0, q.shape[0], size=n)
    return [make(query=q[picks[i]], tenant="busy" if i % 3 == 0 else "t0",
                 arrival_us=float(arrivals[i]), rid=i) for i in range(n)]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_matches_jax_engine(serve_ds, backend, overlap):
    q, jidx, pidx = serve_ds
    kw = dict(max_batch=4, max_wait_us=100.0, overlap=overlap)
    eng = ServingEngine(pidx, plan=QueryPlan(backend=backend),
                        qos={"busy": TenantQoS(rate_rps=2000.0, burst=2)},
                        cache=ResultCache(capacity=64), **kw)
    jeng = JServingEngine(jidx, plan=JPlan(backend="reference"),
                          qos={"busy": JTenantQoS(rate_rps=2000.0, burst=2)},
                          cache=JResultCache(capacity=64), **kw)
    resp = eng.run(_trace(q, Request))
    jresp = jeng.run(_trace(jnp.asarray(q), JRequest))
    assert eng.batch_log == jeng.batch_log
    assert eng.stats.as_dict() == jeng.stats.as_dict()
    assert eng.stats.cache_hits > 0 and eng.stats.degraded > 0
    assert len(resp) == len(jresp) == 40
    for r, j in zip(resp, jresp):
        assert (r.rid, r.tenant, r.degraded, r.cache_hit, r.batch,
                r.admit_us, r.done_us) == \
            (j.rid, j.tenant, j.degraded, j.cache_hit, j.batch, j.admit_us,
             j.done_us)
        np.testing.assert_array_equal(r.ids, np.asarray(j.ids))
        np.testing.assert_allclose(r.distances, np.asarray(j.distances),
                                   rtol=1e-5, atol=1e-5)
    assert _ledger(eng.total_cost) == _ledger(jeng.total_cost)
    assert eng.total_cost.total_seconds() == pytest.approx(
        jeng.total_cost.total_seconds(), rel=1e-12)


# ------------------------------------------------------------- query_key


def test_query_key_against_jax(serve_ds):
    """The packed-code bytes are JAX's and the (norm, rho) pair within 4
    ulp of JAX's; the same query gives the same key on every call (and
    from a device-less numpy copy); queries whose code differs miss."""
    q, _, _ = serve_ds
    keys = set()
    for row in q:
        key, jkey = query_key(row), jquery_key(jnp.asarray(row))
        assert len(key) == len(jkey)
        assert key[:-8] == jkey[:-8]
        np.testing.assert_array_max_ulp(
            np.frombuffer(key[-8:], np.float32),
            np.frombuffer(jkey[-8:], np.float32), maxulp=4)
        assert query_key(torch.from_numpy(row)) == key == query_key(row)
        keys.add(key[:-8])
    assert len(keys) == q.shape[0]            # distinct codes: no collision
    flipped = q[0].copy()
    flipped[np.argmax(np.abs(flipped))] *= -1  # another code, same norm
    assert query_key(flipped)[:-8] != query_key(q[0])[:-8]
    cache = ResultCache()
    cache.insert(query_key(q[0]), "plan", 0, np.arange(5), np.zeros(5))
    assert cache.lookup(query_key(flipped), "plan", 0) is None
    assert cache.lookup(query_key(q[0].copy()), "plan", 0) is not None
