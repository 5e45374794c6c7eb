"""The port's observability layer (``repro_torch.obs``) and its wiring into
the query path, the streaming mutations and the tiered migration, against
the JAX package's ``repro.obs``.

Tracer and registry semantics are pinned as ``tests/test_obs.py`` pins
them; then the same operations must give the same bytes in both packages
(Prometheus text, ``flat()``, JSONL and Chrome trace), one traced query
the same span tree (names, tracks, parents) as JAX's for the same plan,
and a traced query the untraced answer bit for bit.  With no tracer
active the query path and the serving engine read no clock and
synchronize nothing.  The serving engine's pins of ``tests/test_obs.py``
hold: tracing changes no response, a seeded trace exports the same bytes
on every run (and JAX's bytes), the Chrome trace shows batch N+1's front
overlapping batch N's refine on the virtual clock, one flat metrics dict
unifies the engine's series, drift is observed only when traced, and
the cache emits its events."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.anns import PipelineConfig as JConfig  # noqa: E402
from repro.anns import StreamingConfig as JStreamingConfig  # noqa: E402
from repro.anns import StreamingIndex as JStreamingIndex  # noqa: E402
from repro.anns import TieredConfig as JTieredConfig  # noqa: E402
from repro.anns import TieredIndex as JTieredIndex  # noqa: E402
from repro.anns import build as jbuild  # noqa: E402
from repro.anns.api import Database as JDatabase  # noqa: E402
from repro.anns.api import QueryPlan as JPlan  # noqa: E402
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.anns import (Database, PipelineConfig,  # noqa: E402
                              QueryPlan, StreamingConfig, StreamingIndex,
                              TieredConfig, TieredIndex)
from repro_torch.anns import executor  # noqa: E402
from repro_torch.interop import index_from_numpy  # noqa: E402
from repro_torch.obs import export, metrics, trace  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ResultCache as JResultCache  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving import TenantQoS as JTenantQoS  # noqa: E402
from repro_torch.serving import (Request, ResultCache,  # noqa: E402
                                 ServingEngine, TenantQoS)
from test_torch_pipeline import export_jax_index  # noqa: E402

# tests/test_obs.py's fixture
CFG = dict(dim=32, pq_m=4, pq_k=32, nlist=16, nprobe=4, final_k=5,
           refine_budget=20, trq_levels=2)


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


@pytest.fixture(scope="module")
def ds():
    d = jmake_dataset(jax.random.PRNGKey(0), n=1500, d=32, n_queries=8,
                      k_gt=20, clusters=8)
    return np.array(d.x), np.array(d.queries)


@pytest.fixture(scope="module")
def base(ds):
    jidx = jbuild(jax.random.PRNGKey(1), jnp.asarray(ds[0][:1200]),
                  JConfig(**CFG))
    return jidx, index_from_numpy(export_jax_index(jidx),
                                  PipelineConfig(**CFG), device="cpu")


# ----------------------------------------------------------- trace core


def test_span_nesting_and_sids():
    tr = trace.Tracer()
    with trace.use(tr):
        with trace.span("a") as ha:
            with trace.span("b"):
                trace.event("e", x=1)
            with trace.span("c"):
                pass
    a, b, e, c = tr.spans
    assert [s.sid for s in tr.spans] == [0, 1, 2, 3]
    assert (a.parent, b.parent, e.parent, c.parent) == (None, 0, 1, 0)
    assert ha.span is a
    assert e.attrs == {"x": 1}
    assert e.wall_start_s == e.wall_end_s           # zero-duration
    assert a.wall_s >= b.wall_s >= 0.0
    assert [s.sid for s in tr.children(0)] == [1, 3]
    assert tr.by_name("b") == [b]
    assert trace.active() is None                   # use() restored it


def test_set_attr_after_exit_and_wall_prefix_stripping():
    tr = trace.Tracer()
    with trace.use(tr):
        with trace.span("s", keep=1) as h:
            pass
        h.set_attr("wall_model_drift", 3.5)
        h.set_attrs(model_s=2.0)
    rec = tr.spans[0].to_record(include_wall=False)
    assert rec["attrs"] == {"keep": 1, "model_s": 2.0}
    assert "wall_start_s" not in rec
    assert tr.spans[0].to_record()["attrs"]["wall_model_drift"] == 3.5


def test_virtual_clock_stamping():
    now = {"t": 100.0}
    tr = trace.Tracer(virtual_clock=lambda: now["t"])
    with trace.use(tr):
        with trace.span("s"):
            now["t"] = 250.0
        ev = tr.event("e", virtual_us=999.0)
    s = tr.spans[0]
    assert (s.virtual_start_us, s.virtual_end_us) == (100.0, 250.0)
    assert s.virtual_us == 150.0
    assert ev.virtual_start_us == ev.virtual_end_us == 999.0
    ex = tr.add_span("x", virtual_start_us=10.0, virtual_end_us=20.0)
    assert ex.virtual_us == 10.0 and ex.wall_s is None


def test_disabled_path_is_noop():
    assert trace.active() is None
    assert trace.span("anything", attr=1) is trace.NOOP_SPAN
    assert trace.event("anything") is None
    with trace.span("x") as h:
        h.set_attr("a", 1)
        h.set_attrs(b=2)
    assert h.span is None


class _Boom:
    """Stands in for a clock or a synchronize that must not be called."""

    def __getattr__(self, name):
        raise AssertionError(f"{name} called with no tracer active")

    def __call__(self, *a, **kw):
        raise AssertionError("called with no tracer active")


@pytest.mark.parametrize("layout", ["static", "tiered", "streaming"])
def test_untraced_query_reads_no_clock_and_syncs_nothing(ds, base, layout,
                                                         monkeypatch):
    _, pidx = base
    index = {"static": pidx, "tiered": TieredIndex(pidx),
             "streaming": StreamingIndex(pidx, StreamingConfig(
                 auto_compact=False))}[layout]
    monkeypatch.setattr(trace, "time", _Boom())
    monkeypatch.setattr(executor, "_sync", _Boom())
    monkeypatch.setattr(torch.cuda, "synchronize", _Boom())
    reg = metrics.MetricsRegistry()
    with metrics.use(reg):
        Database.wrap(index).query(ds[1], micro_batch=3)
        if layout == "streaming":
            index.insert(ds[0][1200:1210])
    assert not any(k.startswith("fatrq_model_drift") for k in reg.flat())


# -------------------------------------------------------------- metrics


def _same_ops(m):
    """One fixed sequence of registry operations, in package ``m``."""
    reg = m.MetricsRegistry()
    c = reg.counter("req_total", "requests", labelnames=("t",))
    c.labels(t="a").inc(3)
    c.labels(t="b").inc(0.5)
    reg.gauge("g", "a gauge").set(4.25)
    h = reg.histogram("lat_us", "latency", labelnames=("stage",),
                      buckets=(1.0, 10.0, 2.5))
    for v in (0.5, 0.7, 5.0, 500.0, 2.5, 1e-3):
        h.labels(stage="front").observe(v)
    h.labels(stage="refine").observe(7.0)
    reg.histogram("plain").observe(3.0)
    reg.add_collector(lambda: reg.gauge("snap").set(7.0))
    return reg


def test_counter_gauge_histogram_semantics():
    reg = metrics.MetricsRegistry()
    c = reg.counter("c_total", "a counter", labelnames=("t",))
    c.labels(t="x").inc()
    c.labels(t="x").inc(2.0)
    with pytest.raises(ValueError):
        c.labels(t="x").inc(-1.0)
    with pytest.raises(ValueError):
        c.labels(wrong="x")
    with pytest.raises(ValueError):
        c.inc()                            # labeled metric, unlabeled use
    g = reg.gauge("g")
    g.set(4.5)
    g._default_child().inc(0.5)
    h = reg.histogram("h", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    assert reg.flat() == {'c_total{t="x"}': 3.0, "g": 5.0,
                          "h_count": 3, "h_sum": 55.5}
    with pytest.raises(ValueError):        # conflicting redeclaration
        reg.gauge("c_total")
    assert reg.counter("c_total", labelnames=("t",)) is c
    with pytest.raises(ValueError, match="finite"):
        reg.histogram("bad", buckets=(1.0, float("inf")))


def test_registry_collectors_and_context():
    reg = metrics.MetricsRegistry()
    reg.add_collector(lambda: reg.gauge("snap").set(7.0))
    assert metrics.active() is metrics.default_registry()
    with metrics.use(reg):
        assert metrics.active() is reg
    assert metrics.active() is metrics.default_registry()
    assert reg.flat()["snap"] == 7.0       # collector ran at export


def test_prometheus_and_flat_byte_equal_to_jax(tmp_path):
    reg, jreg = _same_ops(metrics), _same_ops(jmetrics)
    text = export.prometheus_text(reg)
    assert text == jexport.prometheus_text(jreg)
    assert reg.flat() == jreg.flat()
    lines = text.splitlines()
    assert 'lat_us_bucket{stage="front",le="1"} 3' in lines   # cumulative
    assert 'lat_us_bucket{stage="front",le="+Inf"} 6' in lines
    a = export.write_prometheus(reg, str(tmp_path / "a.prom"))
    b = jexport.write_prometheus(jreg, str(tmp_path / "b.prom"))
    assert open(a, "rb").read() == open(b, "rb").read()


def _same_spans(tr_mod, now):
    """One fixed sequence of spans under a virtual clock."""
    tr = tr_mod.Tracer(virtual_clock=lambda: now["t"])
    with tr_mod.use(tr):
        with tr_mod.span("query", track="query", n=2):
            now["t"] += 5.0
            with tr_mod.span("front", track="query") as h:
                now["t"] += 10.0
            h.set_attrs(model_s=1.5, wall_model_drift=2.0)
            tr_mod.event("refine.l0", track="query", entering=7)
        tr.add_span("serve.front", track="unit:front", virtual_start_us=3.0,
                    virtual_end_us=9.0)
        tr_mod.event("index.insert", track="index", n=4)
    tr.spans.append(tr_mod.Span(sid=99, parent=None, name="wall-only"))
    return tr


def test_chrome_trace_and_jsonl_byte_equal_to_jax(tmp_path):
    tr = _same_spans(trace, {"t": 0.0})
    jtr = _same_spans(jtrace, {"t": 0.0})
    doc = export.chrome_trace(tr.spans)
    assert doc == jexport.chrome_trace(jtr.spans)
    assert doc["displayTimeUnit"] == "ms"
    meta = {e["args"]["name"] for e in doc["traceEvents"]
            if e["name"] == "thread_name"}
    assert meta == {"index", "query", "unit:front"}
    for e in doc["traceEvents"]:
        assert e["ph"] in ("M", "X", "i")
        if e["ph"] == "X":
            assert e["dur"] > 0 and e["ts"] >= 0
        if e["ph"] != "M":
            assert "sid" in e["args"] and "wall_model_drift" not in e["args"]
    assert "wall-only" not in {e["name"] for e in doc["traceEvents"]}
    for name, fn, jfn, kw in (
            ("chrome", export.write_chrome_trace,
             jexport.write_chrome_trace, {}),
            ("jsonl", export.write_jsonl, jexport.write_jsonl,
             {"include_wall": False})):
        a = fn(tr.spans, str(tmp_path / f"{name}_a"), **kw)
        b = jfn(jtr.spans, str(tmp_path / f"{name}_b"), **kw)
        assert open(a, "rb").read() == open(b, "rb").read()
    json.loads(open(tmp_path / "chrome_a").read())


# ------------------------------------------------- the traced query path


def _tree(spans):
    return [(s.name, s.track, s.parent) for s in spans]


@pytest.mark.parametrize("layout,plan", [
    ("static", dict()),
    ("static", dict(micro_batch=3)),
    ("static", dict(mode="baseline", micro_batch=3)),
    ("static", dict(shards=1)),
    ("tiered", dict(micro_batch=3)),
    ("streaming", dict(micro_batch=3)),
], ids=["static", "static-mb3", "baseline-mb3", "sharded", "tiered-mb3",
        "streaming-mb3"])
def test_traced_query_span_tree_matches_jax(ds, base, layout, plan):
    """The same plan, traced twice on a fresh handle in each package: the
    same span names, tracks and parents (compile miss, then hit)."""
    jidx, pidx = base
    wrap = {"static": (lambda i: i, lambda i: i),
            "tiered": (TieredIndex, JTieredIndex),
            "streaming": (lambda i: StreamingIndex(
                i, StreamingConfig(auto_compact=False)),
                lambda i: JStreamingIndex(
                    i, JStreamingConfig(auto_compact=False)))}[layout]
    db, jdb = Database(wrap[0](pidx)), JDatabase(wrap[1](jidx))
    tr, jtr = trace.Tracer(), jtrace.Tracer()
    with trace.use(tr):
        for _ in range(2):
            db.query(ds[1], plan=QueryPlan(backend="reference", **plan))
    with jtrace.use(jtr):
        for _ in range(2):
            jdb.query(jnp.asarray(ds[1]),
                      plan=JPlan(backend="reference", **plan))
    assert _tree(tr.spans) == _tree(jtr.spans)
    probes = tr.by_name("plan.compile")
    assert [p.attrs["cache_hit"] for p in probes] == [False, True]
    for sp, jsp in zip(tr.spans, jtr.spans):
        if sp.name.startswith("refine.l"):
            assert sp.attrs == jsp.attrs
        if sp.name == "execute":
            assert sp.attrs["ledger"] == jsp.attrs["ledger"]
            assert sp.attrs["model_total_s"] == pytest.approx(
                jsp.attrs["model_total_s"], rel=1e-12)


@pytest.mark.parametrize("layout", ["static", "tiered", "sharded"])
def test_traced_query_is_bit_equal_to_untraced(ds, base, layout):
    _, pidx = base
    index = TieredIndex(pidx, TieredConfig(hot_rows_frac=0.3,
                                           cold_rows_frac=0.3)) \
        if layout == "tiered" else pidx
    db = Database.wrap(index)
    plan = QueryPlan(backend="cuda", micro_batch=3,
                     shards=2 if layout == "sharded" else None)
    if layout == "tiered":
        db.query(ds[1], plan=plan)
        assert index.rebalance_tiers()["changed"]
    off = db.query(ds[1], plan=plan)
    tr, reg = trace.Tracer(), metrics.MetricsRegistry()
    with trace.use(tr), metrics.use(reg):
        on = db.query(ds[1], plan=plan)
    assert torch.equal(on.ids, off.ids)
    assert torch.equal(on.distances, off.distances)
    assert _ledger(on.cost) == _ledger(off.cost)
    ex = tr.by_name("execute")[0]
    assert ex.attrs["ledger"] == {k: list(v) for k, v in
                                  sorted(_ledger(on.cost).items())}
    if layout == "sharded":
        assert [s.name for s in tr.children(ex.sid)] == \
            ["front", "refine", "rerank"]
        return
    # every micro-batch: front, refine, rerank under execute
    assert [s.name for s in tr.children(ex.sid)] == \
        ["front", "refine", "rerank"] * 3
    flat = reg.flat()
    for stage in ("front", "refine", "rerank"):
        assert flat[f'fatrq_model_drift_ratio_count{{stage="{stage}"}}'] \
            == 3
    if layout == "tiered":
        assert "hot:hbm" in ex.attrs["ledger"]


# ----------------------------------- streaming mutations, tiered migration


def _flat_events(tr):
    return [(s.name, s.track, s.attrs) for s in tr.spans]


def test_streaming_mutation_metrics_and_events_match_jax(ds, base):
    jidx, pidx = base
    st = StreamingIndex(pidx, StreamingConfig(auto_compact=False))
    jst = JStreamingIndex(jidx, JStreamingConfig(auto_compact=False))
    out = []
    for pkg, idx, mmod, tmod in ((0, st, metrics, trace),
                                 (1, jst, jmetrics, jtrace)):
        reg, tr = mmod.MetricsRegistry(), tmod.Tracer()
        with mmod.use(reg):
            gids = idx.insert(ds[0][1200:1240])
            with tmod.use(tr):
                idx.delete(gids[:10])
                idx.insert(ds[0][1240:1250])
                idx.rebalance(2)
                idx.delete(np.arange(5))
                idx.compact()
        out.append((reg, tr))
    (reg, tr), (jreg, jtr) = out
    assert reg.flat() == jreg.flat()
    assert export.prometheus_text(reg) == jexport.prometheus_text(jreg)
    assert _flat_events(tr) == _flat_events(jtr)
    names = [s.name for s in tr.spans]
    assert names == ["index.delete", "index.insert", "index.compact",
                     "index.rebalance", "index.delete", "index.compact"]
    assert reg.flat()['streaming_mutations_total{op="insert"}'] == 2.0
    assert reg.flat()["streaming_tombstone_frac"] == 0.0
    assert "shard_imbalance" in tr.by_name("index.delete")[1].attrs


def test_tiered_rebalance_metrics_and_events_match_jax(ds, base):
    jidx, pidx = base
    cfg = dict(decay=0.5, hot_rows_frac=0.25, cold_rows_frac=0.2)
    ti, jti = TieredIndex(pidx, TieredConfig(**cfg)), JTieredIndex(
        jidx, JTieredConfig(**cfg))
    q = ds[0][:40] + 0.01
    out = []
    for idx, db, mmod, tmod, qq, plan in (
            (ti, Database.wrap(ti), metrics, trace, q, QueryPlan()),
            (jti, JDatabase.wrap(jti), jmetrics, jtrace, jnp.asarray(q),
             JPlan(k=5))):
        reg, tr = mmod.MetricsRegistry(), tmod.Tracer()
        with mmod.use(reg):
            db.query(qq, plan=plan)          # untraced: no wall-time drift
            with tmod.use(tr):
                first = idx.rebalance_tiers()
                again = idx.rebalance_tiers()
        out.append((reg, tr, first, again))
    (reg, tr, first, again), (jreg, jtr, jfirst, jagain) = out
    assert (first, again) == (jfirst, jagain)
    assert first["changed"] and not again["changed"]
    assert reg.flat() == jreg.flat()
    assert export.prometheus_text(reg) == jexport.prometheus_text(jreg)
    ev = [(s.name, s.attrs) for s in tr.spans if s.track == "index"]
    assert ev == [(s.name, s.attrs) for s in jtr.spans if s.track == "index"]
    assert [name for name, _ in ev] == ["index.rebalance_tiers"] * 2
    flat = reg.flat()
    assert sum(flat[f'tiered_rows{{tier="{t}"}}']
               for t in ("hot", "warm", "cold")) == 1200


# ------------------------------------------------- serving, end to end


def _requests(ds, n=24, seed=0, make=Request, wrap=np.asarray):
    """``tests/test_obs.py``'s trace: ~40 us mean inter-arrival, fast
    enough that batches queue behind the virtual pipeline units, which
    makes the front/refine overlap visible in the exported trace."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(40.0, size=n))
    pool = ds[1]
    picks = rng.integers(0, pool.shape[0], size=n)
    return [make(query=wrap(pool[picks[i]]),
                 tenant="busy" if i % 3 == 0 else "t0",
                 arrival_us=float(arrivals[i]), rid=i)
            for i in range(n)]


def _engine(index, tracer=None, backend="cuda"):
    return ServingEngine(index, plan=QueryPlan(backend=backend),
                         max_batch=4, max_wait_us=100.0,
                         qos={"busy": TenantQoS(rate_rps=2000.0, burst=2)},
                         cache=ResultCache(capacity=64), tracer=tracer)


def test_serving_bit_identical_with_tracing(ds, base):
    _, pidx = base
    r_off = _engine(pidx).run(_requests(ds))
    tr = trace.Tracer()
    r_on = _engine(pidx, tracer=tr).run(_requests(ds))
    assert len(r_off) == len(r_on) > 0
    for a, b in zip(r_off, r_on):
        assert a.rid == b.rid
        assert np.array_equal(a.ids, b.ids)
        assert np.array_equal(a.distances, b.distances)
        assert (a.done_us, a.admit_us, a.degraded, a.cache_hit) == \
            (b.done_us, b.admit_us, b.degraded, b.cache_hit)
    assert tr.spans


def test_serving_trace_exports_byte_identical(ds, base, tmp_path):
    """Two runs export the same wall-stripped JSONL and Chrome trace, and
    the ``reference`` backend's run exports JAX's engine's JSONL bytes."""
    jidx, pidx = base
    paths = []
    for run in range(2):
        tr = trace.Tracer()
        _engine(pidx, tracer=tr).run(_requests(ds))
        p = tmp_path / f"spans_{run}.jsonl"
        export.write_jsonl(tr.spans, str(p), include_wall=False)
        c = tmp_path / f"chrome_{run}.json"
        export.write_chrome_trace(tr.spans, str(c))
        paths.append((p.read_bytes(), c.read_bytes()))
    assert paths[0] == paths[1]
    tr, jtr = trace.Tracer(), jtrace.Tracer()
    _engine(pidx, tracer=tr, backend="reference").run(_requests(ds))
    JServingEngine(jidx, plan=JPlan(backend="reference"), max_batch=4,
                   max_wait_us=100.0,
                   qos={"busy": JTenantQoS(rate_rps=2000.0, burst=2)},
                   cache=JResultCache(capacity=64), tracer=jtr).run(
        _requests(ds, make=JRequest, wrap=jnp.asarray))
    a, b = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    export.write_jsonl(tr.spans, str(a), include_wall=False)
    jexport.write_jsonl(jtr.spans, str(b), include_wall=False)
    assert a.read_bytes() == b.read_bytes()


def test_chrome_trace_schema_and_overlap(ds, base):
    _, pidx = base
    tr = trace.Tracer()
    _engine(pidx, tracer=tr).run(_requests(ds))
    doc = export.chrome_trace(tr.spans)
    events = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    meta = [e for e in events if e["ph"] == "M"]
    assert {"process_name", "thread_name"} <= {e["name"] for e in meta}
    tids = {e["args"]["name"]: e["tid"] for e in meta
            if e["name"] == "thread_name"}
    assert {"sched", "unit:front", "unit:refine", "query"} <= set(tids)
    for e in events:
        assert e["ph"] in ("M", "X", "i")
        if e["ph"] == "X":
            assert e["dur"] > 0 and e["ts"] >= 0
        if e["ph"] != "M":
            assert "sid" in e["args"]
    json.dumps(doc)
    # the double buffer: some batch's front overlaps another batch's
    # refine on the virtual clock
    fronts = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e["name"] == "serve.front"]
    refines = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e["name"] == "serve.refine"]
    assert len(fronts) >= 2 and len(refines) >= 2
    assert any(f[0] < r[1] and r[0] < f[1]
               for f in fronts for r in refines), \
        "no front/refine overlap visible in the exported trace"


def test_serving_metrics_unified_flat_dict(ds, base):
    _, pidx = base
    tr = trace.Tracer()
    eng = _engine(pidx, tracer=tr)
    eng.run(_requests(ds))
    flat = eng.metrics()
    assert flat['serving_requests_total{tenant="busy"}'] > 0
    assert flat['serving_throttled_total{tenant="busy"}'] > 0
    assert flat['serving_stats{field="requests"}'] == eng.stats.requests
    assert flat['serving_stats{field="batches"}'] == eng.stats.batches
    assert flat['serving_cache{field="misses"}'] == eng.cache.stats.misses
    assert flat["serving_queue_wait_us_count"] > 0
    assert flat["serving_batch_occupancy_count"] == eng.stats.batches
    # the datapath's drift series landed in the ENGINE's registry
    assert flat['fatrq_model_drift_ratio_count{stage="refine"}'] > 0
    assert flat['fatrq_model_drift_ratio_count{stage="front"}'] > 0
    text = export.prometheus_text(eng.registry)
    for series in ("serving_queue_wait_us", "serving_batch_occupancy",
                   "serving_cache", "fatrq_model_drift_ratio",
                   "serving_stats"):
        assert series in text


def test_model_drift_only_when_traced(ds, base, monkeypatch):
    """Untraced, the engine observes no drift, reads no clock and
    synchronizes nothing."""
    _, pidx = base
    monkeypatch.setattr(trace, "time", _Boom())
    monkeypatch.setattr(executor, "_sync", _Boom())
    monkeypatch.setattr(torch.cuda, "synchronize", _Boom())
    eng = _engine(pidx)
    eng.run(_requests(ds))
    assert not any(k.startswith("fatrq_model_drift")
                   for k in eng.metrics())


def test_cache_events(ds, base):
    _, pidx = base
    tr = trace.Tracer()
    eng = _engine(pidx, tracer=tr)
    q0, q1 = ds[1][0], ds[1][1]
    # q1's dispatch retires q0's in-flight batch (the double buffer), so
    # q0's answer is cached by the time its repeat arrives at t=5000
    eng.run([Request(query=q0, arrival_us=0.0, rid=0),
             Request(query=q1, arrival_us=300.0, rid=1),
             Request(query=q0, arrival_us=5000.0, rid=2)])
    assert len(tr.by_name("cache.miss")) == 2
    assert len(tr.by_name("cache.hit")) == 1
    assert len(tr.by_name("serve.cache_hit")) == 1
