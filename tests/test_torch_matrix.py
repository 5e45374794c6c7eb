"""The port's closed capability matrix, executed end to end (the
counterpart of ``tests/test_matrix.py``).

Every (front, layout, backend) triple is taken from
``repro_torch.anns.registry``, not from a hard-coded list, so a front or
backend registered later lands in this sweep.  Each is planned through
``Database`` / ``QueryPlan`` and run; with two TRQ levels the
``reference`` and ``cuda`` backends give the same ids and ledger on every
front x layout, with live hot and cold lists and live delta pages, and
after a compaction; and traced, every stage that billed the ledger has a
span and every stage span billed the ledger.  On the CPU the ``cuda``
backend runs the kernels' plain versions; ``chip_smoke.py`` holds the
kernels against those on the card."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

from repro_torch.anns import (Database, PipelineConfig,  # noqa: E402
                              QueryPlan, StreamingConfig, StreamingIndex,
                              TieredConfig, TieredIndex, registry)
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

# tests/test_matrix.py's fixture sizes
CFG = dict(dim=32, pq_m=4, pq_k=32, nlist=16, nprobe=4, final_k=5,
           refine_budget=20)
SHARDS = 2


def _build(x, seed: int, levels: int = 1):
    return Database.build(x, PipelineConfig(**CFG, trq_levels=levels),
                          device="cpu",
                          generator=torch.Generator().manual_seed(seed)).index


@pytest.fixture(scope="module")
def ds():
    return make_dataset(n=1500, d=32, n_queries=6, k_gt=20, clusters=8,
                        generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def index(ds):
    return _build(ds.x, 1)


def _tiered(index, queries):
    """A tiered placement with live hot and cold lists (heat from one
    batch, then a rebalance), so hot scoring and cold billing run."""
    ti = TieredIndex(index, TieredConfig(hot_rows_frac=0.25,
                                         cold_rows_frac=0.25))
    Database.wrap(ti).query(queries, plan=QueryPlan(front="ivf", k=5))
    assert ti.rebalance_tiers()["changed"]
    return ti


@pytest.fixture(scope="module")
def layouts(ds, index):
    """One index per layout, with one TRQ level."""
    return {"static": index, "sharded": index,
            "streaming": StreamingIndex(index,
                                        StreamingConfig(auto_compact=False)),
            "tiered": _tiered(index, ds.queries)}


@pytest.fixture(scope="module")
def layouts_ml(ds):
    """One index per layout with two TRQ levels: a streaming generation
    with live delta pages (the per-level delta counters) and a tiered
    placement with live hot and cold lists (the per-level cold
    counters)."""
    index = _build(ds.x, 2, levels=2)
    st = StreamingIndex(_build(ds.x[:1200], 3, levels=2),
                        StreamingConfig(auto_compact=False))
    st.insert(ds.x[1200:])
    return {"static": index, "sharded": index, "streaming": st,
            "tiered": _tiered(index, ds.queries)}


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


def _triples():
    return list(itertools.product(registry.front_names(), registry.LAYOUTS,
                                  registry.backend_names()))


def _plan(front, layout, backend):
    return QueryPlan(front=front, backend=backend, k=5,
                     shards=SHARDS if layout == "sharded" else None)


def test_matrix_is_closed():
    """Every registered front declares every layout, and every triple
    validates."""
    for name in registry.front_names():
        assert registry._FRONTS[name].layouts == registry.LAYOUTS, name
    for front, layout, backend in _triples():
        registry.validate_combo(front, backend, layout)


@pytest.mark.parametrize("front,layout,backend", _triples())
def test_every_triple_plans_and_runs(ds, layouts, front, layout, backend):
    db = Database.wrap(layouts[layout])
    plan = _plan(front, layout, backend)
    rp = db.validate(plan)                 # no PlanError
    assert (rp.front, rp.backend) == (front, backend)
    res = db.query(ds.queries, plan=plan)
    assert tuple(res.ids.shape) == (ds.queries.shape[0], 5)
    assert bool((res.ids >= 0).all())
    assert bool(torch.isfinite(res.distances).all())
    assert res.cost.ledger, "a search must bill a non-empty ledger"


@pytest.mark.parametrize("front,layout", list(itertools.product(
    registry.front_names(), registry.LAYOUTS)))
def test_backend_parity_every_front_layout(ds, layouts_ml, front, layout):
    """``reference`` and ``cuda`` give the same ids and per-entry ledger
    on every front x layout with two TRQ levels."""
    db = Database.wrap(layouts_ml[layout])
    res = {b: db.query(ds.queries, plan=_plan(front, layout, b))
           for b in registry.backend_names()}
    a, b = res["reference"], res["cuda"]
    assert torch.equal(a.ids, b.ids)
    assert _ledger(a.cost) == _ledger(b.cost)
    if layout == "streaming":
        assert "delta:cxl" in a.cost.ledger       # delta pages were live
    if layout == "tiered" and front == "ivf":
        assert {"hot:hbm", "cold:ssd"} <= set(a.cost.ledger)


# ledger stage-key prefix → the span of the stage that billed it (hot:hbm
# is scored inside the rerank span; cold:ssd bills the refine path's
# residual stream at SSD rates)
_STAGE_OF = {"coarse": "front", "front": "front", "handoff": "refine",
             "refine": "refine", "delta": "refine", "hot": "rerank",
             "cold": "refine", "rerank": "rerank"}


@pytest.mark.parametrize("front,layout,backend", _triples())
def test_ledger_span_coverage_every_triple(ds, layouts, front, layout,
                                           backend):
    """Traced, every billed stage has a span (or, on the sharded layout,
    a fused stage event) and every stage span billed the ledger; the
    traced answer is the untraced one."""
    db = Database.wrap(layouts[layout])
    plan = _plan(front, layout, backend)
    tr = trace.Tracer()
    with trace.use(tr):
        res = db.query(ds.queries, plan=plan)
    span_names = {s.name for s in tr.spans}
    billed = set()
    for key in res.cost.ledger:
        stage = key.split(":", 1)[0]
        assert stage in _STAGE_OF, f"unmapped ledger stage {key!r}"
        billed.add(_STAGE_OF[stage])
    assert billed <= span_names, (
        f"ledger stages {sorted(billed - span_names)} have no span")
    for stage in ("front", "refine", "rerank"):
        if stage in span_names:
            assert stage in billed, f"{stage} span billed nothing"
    assert {"front", "refine", "rerank"} <= span_names
    untraced = db.query(ds.queries, plan=plan)
    assert torch.equal(untraced.ids, res.ids)
    assert torch.equal(untraced.distances, res.distances)
    assert _ledger(untraced.cost) == _ledger(res.cost)


def test_backend_parity_post_compact_streaming(ds):
    """After deletes, inserts and a ``compact()`` the two backends still
    give the same ids and ledger."""
    st = StreamingIndex(_build(ds.x[:1000], 4, levels=2),
                        StreamingConfig(auto_compact=False))
    st.insert(ds.x[1000:1400])
    st.delete(np.arange(0, 200))
    st.compact()
    assert st.n_delta_rows == 0 and st.n_tombstones == 0
    db = Database.wrap(st)
    res = {b: db.query(ds.queries, plan=QueryPlan(front="ivf", backend=b,
                                                  k=5))
           for b in registry.backend_names()}
    a, b = res["reference"], res["cuda"]
    assert torch.equal(a.ids, b.ids)
    assert _ledger(a.cost) == _ledger(b.cost)
