"""The port's kernel modules on the CPU (their plain PyTorch versions) against
the JAX package's Pallas kernels in interpret mode and its jnp oracles.
The CUDA kernels themselves are compared with these plain versions on the
card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.anns import stages as jstages  # noqa: E402
from repro.core import trq as jtrq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.quant import pq as jpq  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import decomposition as dec  # noqa: E402
from repro_torch.core import estimator as est_mod  # noqa: E402
from repro_torch.core import trq  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import pq_adc as pq_adc_mod  # noqa: E402
from repro_torch.kernels import ternary_refine as tr  # noqa: E402

TOL = 3e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _trq_to_port(codes) -> trq.TRQCodes:
    sc, m = codes.scalars, codes.model
    return trq.TRQCodes(
        dim=codes.dim,
        levels=tuple(trq.TRQLevel(_t(lv.packed), _t(lv.proj), _t(lv.norm),
                                  _t(lv.rho)) for lv in codes.levels),
        scalars=dec.RecordScalars(_t(sc.delta_sq), _t(sc.cross), _t(sc.rho),
                                  _t(sc.norm)),
        model=cal.CalibrationModel(_t(m.w), _t(m.bias), _t(m.resid_std)))


def _refine_problem(seed, levels, n=400, d=24, nq=3, c=250):
    """A calibrated JAX TRQ problem, per-query candidate ids with some
    invalid slots and some delta-page rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cents = rng.standard_normal((8, d)).astype(np.float32)
    x_c = cents[((x[:, None] - cents[None]) ** 2).sum(-1).argmin(-1)]
    codes, _ = jtrq.encode_database(jnp.asarray(x), jnp.asarray(x_c),
                                    num_levels=levels)
    codes = jtrq.calibrate(
        codes, jnp.asarray(rng.standard_normal((64, d)).astype(np.float32)),
        jnp.asarray(x), jnp.asarray(x_c), jnp.asarray(rng.integers(0, n, 64)))
    qs = rng.standard_normal((nq, d)).astype(np.float32)
    ids = np.stack([rng.permutation(n)[:c] for _ in range(nq)]) \
        .astype(np.int32)
    valid = rng.random((nq, c)) > 0.1
    is_delta = rng.random((nq, c)) < 0.3
    d0 = ((x_c[ids] - qs[:, None]) ** 2).sum(-1).astype(np.float32)
    d0 = np.where(valid, d0, np.inf).astype(np.float32)
    return codes, qs, ids, valid, is_delta, d0


def _jax_fused(codes, qs, ids, valid, is_delta, d0, *, k, bound):
    sc, lv = codes.scalars, codes.levels
    j = jnp.asarray
    return jops.fused_refine_scores_batch(
        jnp.stack([v.packed[ids] for v in lv]), j(qs), j(d0),
        sc.delta_sq[ids], sc.cross[ids], sc.norm[ids], sc.rho[ids], j(valid),
        j(is_delta), jnp.stack([v.proj[ids] for v in lv]),
        jnp.stack([v.norm[ids] for v in lv]),
        jnp.stack([v.rho[ids] for v in lv]), codes.model.w, codes.model.bias,
        codes.model.resid_std, 3.0, k=k, bound=bound, block_c=64)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("bound", ["cauchy", "quantile"])
def test_refine_matches_pallas_kernel(levels, bound):
    codes, qs, ids, valid, is_delta, d0 = _refine_problem(levels * 7, levels)
    want = _jax_fused(codes, qs, ids, valid, is_delta, d0, k=5, bound=bound)
    pc = _trq_to_port(codes)
    est, alive, counts = tr.ternary_refine_fused(
        tr.RefineStores.from_trq(pc), torch.from_numpy(qs),
        torch.from_numpy(ids), torch.from_numpy(d0),
        torch.from_numpy(valid), torch.from_numpy(is_delta), pc.model, k=5,
        bound=bound, z=3.0)
    np.testing.assert_allclose(est.numpy(), np.asarray(want[0]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("bound", ["cauchy", "quantile"])
def test_refine_invalid_slots_take_zero_align_and_scalars(levels, bound):
    """With finite d0 on invalid slots: est = w0·d0 + bias there at every
    level; level 0's (lo, hi) is (d0, d0) (Cauchy, from est_raw) or
    est ∓ z·resid_std (quantile); deeper levels carry est with margin
    resid_std.  Valid slots, alive and counts stay the TPU kernel's."""
    codes, qs, ids, valid, is_delta, d0 = _refine_problem(levels * 11,
                                                          levels)
    rng = np.random.default_rng(levels)
    d0 = np.where(valid, d0, rng.random(d0.shape) * 9 + 0.5) \
        .astype(np.float32)
    want = _jax_fused(codes, qs, ids, valid, is_delta, d0, k=5, bound=bound)
    pc = _trq_to_port(codes)
    stores = tr.RefineStores.from_trq(pc)
    q, t_ids, t_d0, t_valid = (torch.from_numpy(a)
                               for a in (qs, ids, d0, valid))
    est, alive, counts = tr.ternary_refine_fused(
        stores, q, t_ids, t_d0, t_valid, torch.from_numpy(is_delta),
        pc.model, k=5, bound=bound, z=3.0)
    inv = ~valid
    w0, bias, rs = (np.float32(np.asarray(a).reshape(-1)[0]) for a in
                    (codes.model.w, codes.model.bias, codes.model.resid_std))
    e_inv = (w0 * d0 + bias).astype(np.float32)
    np.testing.assert_array_equal(est.numpy()[inv], e_inv[inv])
    np.testing.assert_allclose(est.numpy()[valid], np.asarray(want[0])[valid],
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[2]))
    params = ops.query_params(q, pc.model.w, pc.model.bias,
                              pc.model.resid_std, 3.0)
    per_level = list(tr._plain_levels(
        stores, ops.make_query_planes(q, stores.packed[0].shape[1]), params,
        t_ids, t_d0, t_valid, bound=bound))
    zr = np.float32(3.0) * rs
    for lv, (e, lo, hi) in enumerate(per_level):
        np.testing.assert_array_equal(e.numpy()[inv], e_inv[inv])
        if lv > 0:
            want_lo, want_hi = e_inv - rs, e_inv + rs
        elif bound == "cauchy":
            want_lo = want_hi = d0
        else:
            want_lo, want_hi = e_inv - zr, e_inv + zr
        np.testing.assert_array_equal(lo.numpy()[inv], want_lo[inv])
        np.testing.assert_array_equal(hi.numpy()[inv], want_hi[inv])


@pytest.mark.parametrize("levels", [1, 2])
def test_level_table_holds_sqrt_nonzero_count(levels):
    """The level table's 4th float is √max(k, 1) of each code row, k its
    nonzero trits as the plain version counts them, bit for bit."""
    codes, *_ = _refine_problem(levels, levels)
    pc = _trq_to_port(codes)
    stores = tr.RefineStores.from_trq(pc)
    for lv, level in enumerate(pc.levels):
        g = level.packed.shape[1]
        _, k = tr._dot_count(level.packed[None],
                             torch.zeros((1, 5, g)))
        want = torch.sqrt(torch.clamp(k[0].float(), min=1.0))
        assert torch.equal(stores.levels[lv][:, 3], want)
        assert torch.equal(stores.levels[lv][:, :3], torch.stack(
            [level.proj, level.norm, level.rho], dim=1).float())
    empty = torch.zeros((0, 7), dtype=torch.uint8)
    assert ops.sqrt_nonzero(empty).shape == (0,)


def _jax_bounds(codes, qs, ids, valid, is_delta, d0, *, bound):
    sc, lv = codes.scalars, codes.levels
    j = jnp.asarray
    return jops.fused_refine_bounds_batch(
        jnp.stack([v.packed[ids] for v in lv]), j(qs), j(d0),
        sc.delta_sq[ids], sc.cross[ids], sc.norm[ids], sc.rho[ids], j(valid),
        j(is_delta), jnp.stack([v.proj[ids] for v in lv]),
        jnp.stack([v.norm[ids] for v in lv]),
        jnp.stack([v.rho[ids] for v in lv]), codes.model.w, codes.model.bias,
        codes.model.resid_std, 3.0, bound=bound, block_c=64)


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("bound", ["cauchy", "quantile"])
def test_refine_bounds_matches_pallas_kernel(levels, bound):
    """The bounds kernel's plain version against the TPU bounds kernel on
    valid slots, and its intervals' alive chain against the fused kernel's
    alive mask and counts."""
    codes, qs, ids, valid, is_delta, d0 = _refine_problem(levels * 5,
                                                          levels)
    want = _jax_bounds(codes, qs, ids, valid, is_delta, d0, bound=bound)
    pc = _trq_to_port(codes)
    stores = tr.RefineStores.from_trq(pc)
    args = (torch.from_numpy(qs), torch.from_numpy(ids),
            torch.from_numpy(d0), torch.from_numpy(valid))
    est, lo, hi = tr.ternary_refine_fused_bounds(stores, *args, pc.model,
                                                 bound=bound, z=3.0)
    assert lo.shape == hi.shape == (ids.shape[0], levels, ids.shape[1])
    for got, ref in zip((est, lo.transpose(1, 2), hi.transpose(1, 2)),
                        (want[0], np.swapaxes(np.asarray(want[1]), 1, 2),
                         np.swapaxes(np.asarray(want[2]), 1, 2))):
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(ref)[valid],
                                   rtol=TOL, atol=TOL)
        assert np.isinf(got.numpy()[~valid]).all()
    delta = torch.from_numpy(is_delta)
    est_f, alive_f, counts_f = tr.ternary_refine_fused(
        stores, *args, delta, pc.model, k=5, bound=bound, z=3.0)
    assert torch.equal(est[args[3]], est_f[args[3]])
    level_alive, _ = est_mod.alive_chain(lo, hi, args[3], 5)
    assert torch.equal(level_alive[-1], alive_f)
    for lv, a in enumerate(level_alive):
        assert torch.equal(a.sum(-1, dtype=torch.int32), counts_f[:, lv])
        assert torch.equal((a & delta).sum(-1, dtype=torch.int32),
                           counts_f[:, levels + lv])


def _level0_problem(rng, shape, d):
    """Random packed codes (..., C, G) and per-candidate scalars (..., C)."""
    g = -(-d // 5)
    packed = rng.integers(0, 243, shape + (g,)).astype(np.uint8)
    q = rng.standard_normal(shape[:-1] + (d,)).astype(np.float32)
    d0, dsq, norm = (rng.random(shape).astype(np.float32) * 4 + 0.1
                     for _ in range(3))
    cross = rng.standard_normal(shape).astype(np.float32)
    rho = rng.random(shape).astype(np.float32)
    w = np.array([1.0, 1.1, 0.95, 2.1], np.float32)
    bias = np.array(0.3, np.float32)
    return packed, q, d0, dsq, cross, norm, rho, w, bias


@pytest.mark.parametrize("nq,c,d", [(3, 130, 63), (5, 512, 100),
                                    (1, 7, 11)])
def test_refine_scores_batch_matches_pallas_kernel(nq, c, d):
    args = _level0_problem(np.random.default_rng(nq * c), (nq, c), d)
    want = jops.refine_scores_batch(*map(jnp.asarray, args), block_c=64)
    got = ops.refine_scores_batch(*map(torch.from_numpy, args))
    assert got.shape == (nq, c, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("c,d", [(64, 65), (300, 768), (7, 5), (512, 100)])
def test_refine_scores_matches_pallas_kernel(c, d):
    args = _level0_problem(np.random.default_rng(c + d), (c,), d)
    want = jops.refine_scores(*map(jnp.asarray, args), block_c=64)
    got = ops.refine_scores(*map(torch.from_numpy, args))
    assert got.shape == (c, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("k", [1, 5, 400])
def test_refine_plain_matches_reference_backend(k):
    """The plain version's alive chain and counts are the reference
    backend's, including k above the candidate count."""
    codes, qs, ids, valid, _, d0 = _refine_problem(3, 2)
    est_r, level_alive = jstages._reference_refine(
        jnp.asarray(qs), jnp.asarray(d0), jnp.asarray(ids),
        jnp.asarray(valid), codes, k=k, bound="cauchy", z=3.0)
    pc = _trq_to_port(codes)
    stores = tr.RefineStores.from_trq(pc)
    q = torch.from_numpy(qs)
    est, alive, counts, trace = tr.refine_plain(
        stores, ops.make_query_planes(q, stores.packed[0].shape[1]),
        ops.query_params(q, pc.model.w, pc.model.bias, pc.model.resid_std,
                         3.0), torch.from_numpy(ids), torch.from_numpy(d0),
        torch.from_numpy(valid), None, k=k, bound="cauchy")
    np.testing.assert_array_equal(alive.numpy(), np.asarray(level_alive[-1]))
    for lv, a in enumerate(level_alive):
        np.testing.assert_array_equal(trace.alive[lv].numpy(), np.asarray(a))
        np.testing.assert_array_equal(counts[:, lv].numpy(),
                                      np.asarray(a).sum(-1))
    fin = np.asarray(valid)
    np.testing.assert_allclose(est.numpy()[fin], np.asarray(est_r)[fin],
                               rtol=TOL, atol=TOL)


def test_query_planes_match():
    q = np.random.default_rng(0).standard_normal((4, 23)).astype(np.float32)
    want = jax.vmap(lambda v: jref.make_query_planes(v, 5))(jnp.asarray(q))
    np.testing.assert_array_equal(
        ops.make_query_planes(torch.from_numpy(q), 5).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("c,m,k", [(128, 8, 16), (300, 16, 256),
                                   (77, 96, 256)])
def test_pq_adc_matches_pallas_and_jnp(c, m, k):
    rng = np.random.default_rng(c)
    codes = rng.integers(0, k, (c, m)).astype(np.uint8)
    lut = rng.random((m, k)).astype(np.float32)
    kernel = np.asarray(jops.adc_scores(jnp.asarray(codes), jnp.asarray(lut),
                                        block_c=64))
    oracle = np.asarray(jpq.adc_distances(jnp.asarray(lut),
                                          jnp.asarray(codes)))
    ids = rng.permutation(c)[None].astype(np.int32)
    valid = np.ones((1, c), bool)
    valid[0, ::7] = False
    got = pq_adc_mod.pq_adc(torch.from_numpy(codes), torch.from_numpy(ids),
                            torch.from_numpy(valid),
                            torch.from_numpy(lut)[None]).numpy()[0]
    want = np.where(valid[0], oracle[ids[0]], np.inf)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[valid[0]], kernel[ids[0]][valid[0]],
                               rtol=1e-5, atol=1e-5)


def test_adc_table_matches():
    from repro_torch.quant import pq
    rng = np.random.default_rng(2)
    books = rng.standard_normal((4, 16, 6)).astype(np.float32)
    q = rng.standard_normal((3, 24)).astype(np.float32)
    want = np.stack([np.asarray(jpq.adc_table(jpq.PQCodebook(
        jnp.asarray(books)), jnp.asarray(v))) for v in q])
    # same Σ (q_m − c_mk)² form; the Ds-term sum may round in another order
    np.testing.assert_allclose(
        pq.adc_table(pq.PQCodebook(torch.from_numpy(books)),
                     torch.from_numpy(q)).numpy(), want, rtol=1e-6,
        atol=1e-6)


def test_shared_memory_budget_named_error():
    big_lut = torch.zeros((1, 256, 256))
    with pytest.raises(ops.SharedMemoryBudgetError, match="pq_adc"):
        pq_adc_mod.pq_adc(torch.zeros((4, 256), dtype=torch.uint8),
                          torch.zeros((1, 2), dtype=torch.int32),
                          torch.ones((1, 2), dtype=torch.bool), big_lut)
    g = 12_000   # (37, 12,192) f32 tables: 1.8 MB, over the 227 KB a block
    #              has (and the level-0 kernel's 240 KB of planes)
    stores = tr.RefineStores(packed=(torch.zeros((2, g), dtype=torch.uint8),),
                             records=torch.zeros((2, 4)),
                             levels=(torch.zeros((2, 4)),), dim=5 * g)
    with pytest.raises(ops.SharedMemoryBudgetError, match="refine"):
        tr.ternary_refine_fused(
            stores, torch.zeros((1, 5 * g)), torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1, 2)), torch.ones((1, 2), dtype=torch.bool), None,
            cal.identity_model(), k=1, bound="cauchy", z=3.0)
    assert ops.check_smem_budget("fits", ops.adc_smem_bytes(96, 256)) == \
        96 * 256 * 4


def test_refine_smem_is_the_tables():
    """The multi-level kernels' shared memory is their (27 + 10, Gp) f32
    tables, Gp the columns a row's passes of 40 words address, rounded up
    to 32: 28,416 B up to G = 157.  The largest G that fits is 1,437; the
    level-0 kernel's planes fit far beyond."""
    assert ops.table_width(154) == ops.table_width(1) == 192
    assert ops.table_width(158) == 352
    assert ops.refine_smem_bytes(154) == 37 * 192 * 4
    fits = [g for g in (1437, 1438)
            if ops.refine_smem_bytes(g) <= ops.SMEM_LIMIT_BYTES]
    assert fits == [1437]
    g = 1438
    stores = tr.RefineStores(packed=(torch.zeros((2, g), dtype=torch.uint8),),
                             records=torch.zeros((2, 4)),
                             levels=(torch.zeros((2, 4)),), dim=5 * g)
    args = (stores, torch.zeros((1, 5 * g)),
            torch.zeros((1, 2), dtype=torch.int32), torch.zeros((1, 2)),
            torch.ones((1, 2), dtype=torch.bool))
    with pytest.raises(ops.SharedMemoryBudgetError, match="bounds"):
        tr.ternary_refine_fused_bounds(*args, cal.identity_model(),
                                       bound="cauchy", z=3.0)
    assert ops.check_smem_budget("level0", ops.level0_smem_bytes(g)) == \
        5 * g * 4 + 243 * 2


def test_require_rejects_what_the_kernels_do_not_take():
    t = torch.zeros((2, 3), dtype=torch.int32)
    build.require("ok", t, dtype=torch.int32, shape=(2, 3), device=t.device)
    with pytest.raises(TypeError):
        build.require("x", t, dtype=torch.int64, shape=(2, 3),
                      device=t.device)
    with pytest.raises(ValueError, match="shape"):
        build.require("x", t, dtype=torch.int32, shape=(3, 2),
                      device=t.device)
    with pytest.raises(ValueError, match="contiguous"):
        build.require("x", t.T, dtype=torch.int32, shape=(3, 2),
                      device=t.device)


def test_import_builds_nothing():
    """Importing the kernel modules on a host compiles and loads nothing."""
    assert not build._LIBS
    assert build.SOURCES == ("pq_adc", "ternary_refine")
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
