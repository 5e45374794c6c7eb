"""Every embedding width the JAX package indexes: the port at the backbones'
widths with JAX's ``pq_m = d // 8`` (D = 2048, M = 256 and D = 8192,
M = 1024, K = 256), where the kernels' per-query state no longer fits a
block's shared memory and the card runs their global forms.

A JAX build exported to the port answers with JAX's ids and ledger through
both backends, unsharded and (at D = 8192, where the card runs the bounds
kernel's global form) on 2 and 4 shards; each wrapper answers at the
shapes past its old limit, held to the JAX reference; and ``kernels.ops``
picks each kernel's form from the shapes alone.  The global forms
themselves are held against the shared forms and the plain versions on
the card by chip_smoke.py."""

import functools

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
from repro.anns import stages as jstages  # noqa: E402
from repro.anns.executor import fold_counts as jfold_counts  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ternary_refine import _kth_smallest  # noqa: E402
from repro.quant import pq as jpq  # noqa: E402
from repro_torch.anns import Database, PipelineConfig, QueryPlan  # noqa
from repro_torch.anns import make_sharded_executor  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import estimator as est_mod  # noqa: E402
from repro_torch.interop import index_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pq_adc as pq_adc_mod  # noqa: E402
from repro_torch.kernels import ternary_refine as tr  # noqa: E402

from test_torch_kernels import TOL, _trq_to_port  # noqa: E402
from test_torch_pipeline import export_jax_index  # noqa: E402

#: (D, M) of the backbones' widths at d // 8: M = 256 is past the ADC
#: kernel's shared LUT; D = 8192 also past the refine tables (G = 1639)
WIDE = [(2048, 256), (8192, 1024)]


def _clustered(rng, n, d, clusters=8):
    cents = rng.standard_normal((clusters, d)).astype(np.float32)
    pick = rng.integers(0, clusters, n)
    return (cents[pick] + 0.5 * rng.standard_normal((n, d))).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _wide_build(d: int, m: int):
    """A JAX build at (D, M), its export in the port, JAX's answers and the
    JAX index (built once a process: the sharded test takes D = 8192's
    again)."""
    rng = np.random.default_rng(d)
    x = _clustered(rng, 280, d)
    qs = _clustered(rng, 12, d)
    kw = dict(dim=d, pq_m=m, pq_k=256, nlist=8, nprobe=4, final_k=10,
              refine_budget=40)
    jidx = jbuild(jax.random.PRNGKey(1), jnp.asarray(x), JConfig(**kw))
    want = JDatabase.wrap(jidx).query(jnp.asarray(qs),
                                      plan=JPlan(backend="reference"))
    pidx = index_from_numpy(export_jax_index(jidx), PipelineConfig(**kw),
                            device="cpu")
    return d, m, pidx, qs, want, jidx


@pytest.fixture(scope="module", params=WIDE, ids=["d2048", "d8192"])
def wide(request):
    return _wide_build(*request.param)


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


def _tier_bytes(cost):
    out = {}
    for key, t in cost.ledger.items():
        tier = key.rsplit(":", 1)[-1]
        out[tier] = out.get(tier, 0) + t.bytes
    return out


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_wide_query_matches_jax(wide, backend):
    """``Database.query`` at (2048, 256) and (8192, 1024): JAX's ids and
    ledger, distances within f32 tolerance; the card would run ``pq_adc``
    (and at D = 8192 the fused kernel) in the global form."""
    d, m, pidx, qs, want, _ = wide
    g = -(-d // 5)
    assert ops.adc_form(m, 256) == "global"
    assert ops.refine_form(g) == ("global" if d == 8192 else "shared")
    got = Database.wrap(pidx).query(qs, plan=QueryPlan(backend=backend))
    assert got.plan.backend == backend
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=1e-5)
    assert _ledger(got.cost) == _ledger(want.cost)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_wide_sharded_query_matches_jax(backend, shards):
    """``QueryPlan(shards=S)`` at (8192, 1024), where the card runs the
    bounds kernel's global form on every shard: the unsharded JAX answer's
    ids, distances within f32 tolerance and per-tier bytes, and a ledger
    equal to the port's per-shard counts folded by the JAX package's own
    ``fold_counts`` + ``merge_parallel``."""
    from repro.anns.stages import fold_ivf_front_cost
    d, m, pidx, qs, want, jidx = _wide_build(*WIDE[1])
    assert ops.refine_form(-(-d // 5)) == "global"
    got = Database.wrap(pidx).query(
        qs, plan=QueryPlan(shards=shards, backend=backend))
    assert got.plan.backend == backend
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=1e-5)
    assert _tier_bytes(got.cost) == _tier_bytes(want.cost)
    ex = make_sharded_executor(pidx, shards=shards, backend=backend)
    _, _, shard_counts = ex._search(torch.from_numpy(qs))
    assert len(shard_counts) == shards
    jcosts = [jfold_counts(c, cost=None, config=jidx.config,
                           layout=jidx.layout,
                           front_fold=fold_ivf_front_cost)
              for c in shard_counts]
    folded = jcosts[0]
    for c in jcosts[1:]:
        folded.merge_parallel(c)
    assert _ledger(got.cost) == _ledger(folded)
    assert got.cost.breakdown() == folded.breakdown()


@pytest.mark.parametrize("m", [6, 256])
def test_pq_adc_past_the_shared_lut(m):
    """M = 6 (rows read as bytes) and M = 256 at K = 256 (the LUT read in
    place on the card) against JAX's ``adc_distances``."""
    rng = np.random.default_rng(m)
    n, nq, c = 300, 3, 70
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    lut = rng.random((nq, m, 256)).astype(np.float32)
    ids = rng.integers(0, n, (nq, c)).astype(np.int32)
    valid = rng.random((nq, c)) < 0.7
    got = pq_adc_mod.pq_adc(torch.from_numpy(codes), torch.from_numpy(ids),
                            torch.from_numpy(valid), torch.from_numpy(lut))
    for qi in range(nq):
        oracle = np.asarray(jpq.adc_distances(jnp.asarray(lut[qi]),
                                              jnp.asarray(codes)))
        np.testing.assert_allclose(got[qi].numpy()[valid[qi]],
                                   oracle[ids[qi]][valid[qi]], rtol=1e-5,
                                   atol=1e-5)
    assert bool(torch.isinf(got[torch.from_numpy(~valid)]).all())
    assert pq_adc_mod.row_path(m, 1 << 20) == ("byte" if m == 6 else "uint4")
    assert ops.adc_form(m, 256) == ("shared" if m == 6 else "global")


def _wide_refine_problem(g, levels, nq=2, c=48, n=96):
    """Random JAX TRQ codes at width G (D = 5G − 2) and candidates: codes,
    queries, ids, valid, d0."""
    from repro.core import calibration as jcal
    from repro.core import decomposition as jdec
    from repro.core import trq as jtrq
    rng = np.random.default_rng(g)
    f32 = lambda *s: jnp.asarray(rng.random(s).astype(np.float32))  # noqa
    codes = jtrq.TRQCodes(
        dim=5 * g - 2,
        levels=tuple(jtrq.TRQLevel(
            jnp.asarray(rng.integers(0, 243, (n, g)).astype(np.uint8)),
            f32(n) - 0.5, f32(n), f32(n)) for _ in range(levels)),
        scalars=jdec.RecordScalars(f32(n) * 2, f32(n) - 0.5, f32(n), f32(n)),
        model=jcal.CalibrationModel(jnp.asarray([1.0, 1.1, 0.95, 2.1]),
                                    jnp.asarray(0.3), jnp.asarray(0.05)))
    qs = rng.standard_normal((nq, codes.dim)).astype(np.float32) * 0.05
    ids = np.stack([rng.permutation(n)[:c] for _ in range(nq)]) \
        .astype(np.int32)
    valid = rng.random((nq, c)) > 0.2
    d0 = np.where(valid, rng.random((nq, c)) * 4 + 0.1, np.inf) \
        .astype(np.float32)
    return codes, qs, ids, valid, d0


@pytest.mark.parametrize("g", [1438, 1639])
def test_refine_wrappers_past_the_shared_tables(g):
    """The fused and bounds wrappers at G = 1438 (one past the shared
    tables) and G = 1639 (D = 8192), two levels, against JAX's reference
    backend: its alive chain and counts exactly, its estimates within
    tolerance; the bounds est equal to the fused est."""
    codes, qs, ids, valid, d0 = _wide_refine_problem(g, 2)
    assert ops.refine_form(g) == "global"
    est_r, level_alive = jstages._reference_refine(
        jnp.asarray(qs), jnp.asarray(d0), jnp.asarray(ids),
        jnp.asarray(valid), codes, k=5, bound="cauchy", z=3.0)
    pc = _trq_to_port(codes)
    stores = tr.RefineStores.from_trq(pc)
    args = (torch.from_numpy(qs), torch.from_numpy(ids),
            torch.from_numpy(d0), torch.from_numpy(valid))
    est, alive, counts = tr.ternary_refine_fused(stores, *args, None,
                                                 pc.model, k=5,
                                                 bound="cauchy", z=3.0)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(level_alive[-1]))
    for lv, a in enumerate(level_alive):
        np.testing.assert_array_equal(counts[:, lv].numpy(),
                                      np.asarray(a).sum(-1))
    np.testing.assert_allclose(est.numpy()[valid], np.asarray(est_r)[valid],
                               rtol=TOL, atol=TOL)
    b_est, lo, hi = tr.ternary_refine_fused_bounds(stores, *args, pc.model,
                                                   bound="cauchy", z=3.0)
    assert lo.shape == hi.shape == (2, 2, ids.shape[1])
    assert torch.equal(b_est[args[3]], est[args[3]])
    chain, _ = est_mod.alive_chain(lo, hi, args[3], 5)
    assert torch.equal(chain[-1], alive)


def test_prune_past_the_staged_slice():
    """C = 446,465, one slot past the shared form's staged slices: the
    prune wrapper against JAX's kth-smallest and mask."""
    c, k = 446_465, 10
    assert ops.prune_form(c) == "global"
    rng = np.random.default_rng(5)
    hi = rng.standard_normal((2, c)).astype(np.float32)
    lo = hi - rng.random((2, c)).astype(np.float32)
    alive = rng.random((2, c)) < 0.5
    counts = torch.zeros((2, 2), dtype=torch.int32)
    out = torch.zeros((2, c), dtype=torch.bool)
    tau = tr.ternary_refine_prune(torch.from_numpy(lo), torch.from_numpy(hi),
                                  torch.from_numpy(alive), None, counts, out,
                                  k=k)
    want_tau = np.array([float(_kth_smallest(
        jnp.where(jnp.asarray(a), jnp.asarray(h), jnp.inf), k))
        for h, a in zip(hi, alive)], np.float32)
    want = alive & (lo <= want_tau[:, None])
    np.testing.assert_array_equal(tau.numpy(), want_tau)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(counts[:, 0].numpy(), want.sum(-1))


@pytest.mark.parametrize("g", [504, 1639])
def test_level0_past_the_shared_tables(g):
    """``ops.refine_scores_batch`` and ``refine_scores`` at G = 504 (one
    past the shared pair tables) and G = 1639 against JAX's level-0 Pallas
    kernels (interpret mode), on bytes from all of 0..255."""
    from test_torch_level0 import TOL as L0_TOL, _problem
    assert ops.level0_form(g) == "global"
    args = _problem(np.random.default_rng(g), (2, 20), 5 * g - 1)
    want = jops.refine_scores_batch(*map(jnp.asarray, args), block_c=32)
    got = ops.refine_scores_batch(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=L0_TOL,
                               atol=L0_TOL)
    single = [a[0] if a.ndim > 1 else a for a in args[:7]] + list(args[7:])
    want1 = jops.refine_scores(*map(jnp.asarray, single), block_c=32)
    got1 = ops.refine_scores(*map(torch.from_numpy, single))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=L0_TOL,
                               atol=L0_TOL)


# (kernel form function, shapes, form): the last shape of each shared form
# and the first of each global one
@pytest.mark.parametrize("fn,shape,form", [
    ("adc_form", (218, 256), "shared"), ("adc_form", (219, 256), "global"),
    ("adc_form", (1024, 16), "shared"), ("adc_form", (96, 256), "shared"),
    ("refine_form", (1437,), "shared"), ("refine_form", (1438,), "global"),
    ("refine_form", (154,), "shared"),
    ("prune_form", (446_464,), "shared"), ("prune_form", (446_465,), "global"),
    ("level0_form", (503,), "shared"), ("level0_form", (504,), "global"),
    ("level0_form", (3277,), "global"), ("level0_form", (154,), "shared")])
def test_form_from_shapes(fn, shape, form):
    assert getattr(ops, fn)(*shape) == form


def test_scratch_and_the_level0_limit():
    """The global forms' scratch bytes (the prune's global form has none:
    its shared memory is the same at every C), the level-0 global
    form's sizing (its pair-table columns and row stages by chunks of
    passes, so its shared memory is the same at every G: the width it once
    stopped at, G = 3517 with one warp of whole rows, and far past it take
    16 warps) and a forced form: the global one anywhere, the shared one
    only where it fits."""
    assert ops.refine_scratch_bytes(64, 1639) == 64 * 37 * 1792 * 4
    assert ops.level0_scratch_bytes(64, 1639) == 64 * 37 * 1792 * 8
    assert not hasattr(ops, "prune_scratch_bytes")
    for c in (446_465, 750_080, 1_048_576, 8_388_608):
        assert ops.prune_form(c) == "global"
    assert ops.PRUNE_STREAM_SMEM == 50_448
    assert ops.PRUNE_STREAM_SMEM + 2224 <= ops.SMEM_LIMIT_BYTES
    assert not hasattr(ops, "LEVEL0_MAX_G")
    for g in (504, 1639, 3517, 3518, 20_000):
        assert ops.level0_form(g) == "global"
        plan = ops.level0_plan(g)
        assert (plan.warps, plan.passes, plan.smem_bytes) == (16, 1, 228_864)
        assert plan.chunks == ops.row_passes(g)
    assert ops.pick_form("x", "shared", None) == "shared"
    assert ops.pick_form("x", "shared", "global") == "global"
    with pytest.raises(ops.SharedMemoryBudgetError, match="x"):
        ops.pick_form("x", "global", "shared")
    with pytest.raises(ValueError, match="form"):
        ops.pick_form("x", "shared", "tiled")


def test_every_backbone_width_has_a_form():
    """No kernel refuses a backbone's retrieval width at d // 8 (K = 256):
    every one of the ten configurations' d_model selects a form."""
    widths = sorted({cfg.d_model for cfg in ARCHS.values()})
    assert widths[-1] == 8192
    for d in widths:
        g = -(-d // 5)
        forms = (ops.adc_form(d // 8, 256), ops.refine_form(g),
                 ops.level0_form(g))
        assert set(forms) <= set(ops.FORMS)
        assert ops.level0_plan(g).warps == 16
