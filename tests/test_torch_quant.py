"""The port's baseline quantizers (``quant.rq``, ``quant.sq``), the
quantizers' error helpers and the last public helpers of ``core``,
``index`` and ``anns.registry``, against the JAX package's, on the CPU.

RQ is trained from JAX's own initial draws (each stage folds its level
into the key, then splits one key per subspace); codes must be equal,
codebooks and residuals within 1e-5 (float32 means summed in another
order).  SQ codes must be equal and ``lo``/``step`` within 1 ulp;
distortions within a relative 1e-5; ``estimate_q_dot_delta`` within 3e-5
through 1 to 3 levels of JAX's own codes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.anns import registry as jregistry  # noqa: E402
from repro.core import decomposition as jdec  # noqa: E402
from repro.core import trq as jtrq  # noqa: E402
from repro.core.packing import storage_bytes as jstorage  # noqa: E402
from repro.data import make_embeddings as jmake_embeddings  # noqa: E402
from repro.index import graph as jgraph  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.quant import pq as jpq  # noqa: E402
from repro.quant import quantization_error as jqerr  # noqa: E402
from repro.quant import rq as jrq  # noqa: E402
from repro.quant import sq as jsq  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.anns import PlanError, registry  # noqa: E402
from repro_torch.core.calibration import CalibrationModel  # noqa: E402
from repro_torch.core.decomposition import RecordScalars  # noqa: E402
from repro_torch.core.trq import TRQCodes, TRQLevel  # noqa: E402
from repro_torch.index import graph, ivf  # noqa: E402
from repro_torch.quant import kmeans, pq, quantization_error, rq, \
    sq  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _choice(key, n, k):
    return np.array(jax.random.choice(key, n, (k,), replace=False))


def _two_scale(seed, n=1200, d=16, k=8, spread=0.5, noise=0.02):
    """Clusters of clusters: every point a coarse centre, a fine offset
    and noise, so both RQ stages see separated clusters in every
    subspace."""
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((k, d)) * 4
    fine = rng.standard_normal((k, d)) * spread
    x = coarse[rng.integers(0, k, n)] + fine[rng.integers(0, k, n)] \
        + noise * rng.standard_normal((n, d))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def embs():
    return np.asarray(jmake_embeddings(jax.random.PRNGKey(0), 4000, 64,
                                       clusters=16))


# -------------------------------------------------------------------- RQ


def test_rq_matches_jax_draws():
    m, kk, levels = 4, 8, 2
    x = _two_scale(3)
    key = jax.random.PRNGKey(11)
    want, want_resid = jrq.train(key, jnp.asarray(x), m, kk, levels, iters=6)
    init = np.stack([np.stack([_choice(s, len(x), kk) for s in
                               jax.random.split(jax.random.fold_in(key, lv),
                                                m)])
                     for lv in range(levels)])
    got, resid = rq.train(_t(x), m, kk, levels, iters=6, init_idx=_t(init))
    for g, w in zip(got.stages, want.stages):
        np.testing.assert_allclose(g.codebooks.numpy(),
                                   np.asarray(w.codebooks), **TOL)
    np.testing.assert_allclose(resid.numpy(), np.asarray(want_resid), **TOL)
    codes = rq.encode(got, _t(x))
    assert codes.shape == (len(x), levels, m) and codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jrq.encode(want,
                                                        jnp.asarray(x))))
    jcodes = jnp.asarray(codes.numpy())
    for through in (1, 2):
        np.testing.assert_allclose(
            rq.decode(got, codes, through_level=through).numpy(),
            np.asarray(jrq.decode(want, jcodes, through_level=through)),
            **TOL)
    np.testing.assert_allclose(
        rq.adc_distances(got, _t(x[5]), codes).numpy(),
        np.asarray(jrq.adc_distances(want, jnp.asarray(x[5]), jcodes)),
        rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        rq.train(_t(x), m, kk, 3, iters=1, init_idx=_t(init))


def test_rq_levels_monotone(embs):
    """JAX's ``TestRQ.test_levels_monotone`` on the port."""
    gen = torch.Generator().manual_seed(7)
    x = _t(embs)
    init = torch.stack([torch.stack([kmeans.random_init(len(x), 32, gen)
                                     for _ in range(8)]) for _ in range(3)])
    rqc, resid = rq.train(x, 8, 32, 3, iters=8, init_idx=init)
    codes = rq.encode(rqc, x)
    assert codes.shape == (4000, 3, 8)
    errs = [float(((rq.decode(rqc, codes, through_level=lv) - x) ** 2)
                  .sum(-1).mean()) for lv in (1, 2, 3)]
    assert errs[1] < errs[0] and errs[2] < errs[1]
    assert float((resid ** 2).sum(-1).mean()) == pytest.approx(errs[-1],
                                                               rel=0.05)


# -------------------------------------------------------------------- SQ


@pytest.mark.parametrize("bits", [3, 4, 8])
def test_sq_matches_jax(embs, bits):
    x = embs[:500]
    want = jsq.sq_encode(jnp.asarray(x), bits)
    got = sq.sq_encode(_t(x), bits)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_max_ulp(got.lo.numpy(), np.asarray(want.lo), 1)
    np.testing.assert_array_max_ulp(got.step.numpy(), np.asarray(want.step),
                                    1)
    np.testing.assert_allclose(sq.sq_decode(got).numpy(),
                               np.asarray(jsq.sq_decode(want)), rtol=1e-6,
                               atol=1e-6)
    # JAX's TestSQ: the error shrinks with the bits
    err = float(((sq.sq_decode(got) - _t(x)) ** 2).mean())
    assert err < 1.0 / (1 << bits)
    if bits == 8:
        assert torch.equal(sq.int8_encode(_t(x)).codes, got.codes)


def test_sq_storage_model():
    for d, bits in ((768, 4), (768, 3), (768, 8), (100, 3)):
        assert sq.sq_bytes_per_record(d, bits) == \
            jsq.sq_bytes_per_record(d, bits)
    assert sq.sq_bytes_per_record(768, 4) == 384 + 8
    assert sq.sq_bytes_per_record(768, 3) == 288 + 8


# ---------------------------------------------------- distortion helpers


def test_quantization_and_reconstruction_error(embs):
    x = embs[:2000]
    cents = x[_choice(jax.random.PRNGKey(2), len(x), 16)]
    np.testing.assert_allclose(
        float(quantization_error(_t(x), _t(cents))),
        float(jqerr(jnp.asarray(x), jnp.asarray(cents))), rtol=1e-5)
    assert kmeans.quantization_error is quantization_error
    cb = jpq.train(jax.random.PRNGKey(4), jnp.asarray(x), m=8, k=16, iters=4)
    np.testing.assert_allclose(
        float(pq.reconstruction_error(pq.PQCodebook(_t(cb.codebooks)),
                                      _t(x))),
        float(jpq.reconstruction_error(cb, jnp.asarray(x))), rtol=1e-5)


# ------------------------------------------------------------------ core


def _port_codes(codes) -> TRQCodes:
    lv = tuple(TRQLevel(*(_t(getattr(level, f)) for f in
                          ("packed", "proj", "norm", "rho")))
               for level in codes.levels)
    sc = RecordScalars(*(_t(getattr(codes.scalars, f)) for f in
                         ("delta_sq", "cross", "rho", "norm")))
    model = CalibrationModel(*(_t(getattr(codes.model, f)) for f in
                               ("w", "bias", "resid_std")))
    return TRQCodes(dim=codes.dim, levels=lv, scalars=sc, model=model)


def test_estimate_q_dot_delta_matches_jax():
    rng = np.random.default_rng(30)
    x = rng.standard_normal((300, 96)).astype(np.float32)
    x_c = x + 0.2 * rng.standard_normal((300, 96)).astype(np.float32)
    jcodes, _ = jtrq.encode_database(jnp.asarray(x), jnp.asarray(x_c),
                                     num_levels=3)
    codes = _port_codes(jcodes)
    q = rng.standard_normal(96).astype(np.float32)
    idx = rng.integers(0, 300, 40)
    true = ((x - x_c) @ q)
    errs = []
    for lv in (1, 2, 3):
        want = np.asarray(jtrq.estimate_q_dot_delta(jnp.asarray(q), jcodes,
                                                    through_level=lv))
        got = core.estimate_q_dot_delta(_t(q), codes, through_level=lv)
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
        sub = core.estimate_q_dot_delta(_t(q), codes, _t(idx),
                                        through_level=lv)
        np.testing.assert_allclose(sub.numpy(), want[idx], rtol=3e-5,
                                   atol=3e-5)
        errs.append(float(((got.numpy() - true) ** 2).mean()))
    assert errs[1] < errs[0] and errs[2] < errs[1]
    np.testing.assert_allclose(
        core.estimate_q_dot_delta(_t(q), codes).numpy(),
        np.asarray(jtrq.estimate_q_dot_delta(jnp.asarray(q), jcodes)),
        rtol=3e-5, atol=3e-5)


def test_decomposition_helpers_match_jax():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((50, 32)).astype(np.float32)
    x_c = x + 0.3 * rng.standard_normal((50, 32)).astype(np.float32)
    q = rng.standard_normal(32).astype(np.float32)
    jsc = jdec.compute_scalars(jnp.asarray(x), jnp.asarray(x_c))
    sc = core.compute_scalars(_t(x), _t(x_c))
    d0 = ((q - x_c) ** 2).sum(-1)
    qd = (x - x_c) @ q
    np.testing.assert_allclose(
        core.exact_distance_sq(_t(q), _t(x)).numpy(),
        np.asarray(jdec.exact_distance_sq(jnp.asarray(q), jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        core.first_order(_t(d0), sc).numpy(),
        np.asarray(jdec.first_order(jnp.asarray(d0), jsc)), rtol=1e-6,
        atol=1e-5)
    exact = core.decomposed_distance_sq(_t(d0), sc, _t(qd))
    np.testing.assert_allclose(
        exact.numpy(), np.asarray(jdec.decomposed_distance_sq(
            jnp.asarray(d0), jsc, jnp.asarray(qd))), rtol=1e-6, atol=1e-5)
    # the identity: the decomposition with the true ⟨q, δ⟩ is ||x − q||²
    np.testing.assert_allclose(exact.numpy(), ((x - q) ** 2).sum(-1),
                               rtol=1e-4, atol=1e-4)


def test_storage_bytes():
    assert core.storage_bytes(768) == 162 == jstorage(768)
    for d in (1, 5, 96, 2048):
        assert core.storage_bytes(d, n_scalars=4) == jstorage(d, n_scalars=4)


@pytest.mark.parametrize("seed", range(6))
def test_brute_force_optimal_is_the_encoders_optimum(seed):
    from repro.core.ternary import brute_force_optimal as joracle
    d = 3 + seed
    delta = np.random.default_rng(seed).standard_normal(d).astype(np.float32)
    oracle = core.ternary.brute_force_optimal(delta)
    assert oracle.dtype == torch.int8
    np.testing.assert_array_equal(oracle.numpy(), np.asarray(joracle(delta)))
    e = _t(delta / np.linalg.norm(delta))
    ours = float(core.ternary_inner(core.ternary_encode(_t(delta)).code, e))
    assert ours == pytest.approx(float(core.ternary_inner(oracle, e)),
                                 rel=1e-6)
    with pytest.raises(ValueError):
        core.ternary.brute_force_optimal(np.zeros(13))


def test_refine_batch_is_one_level():
    rng = np.random.default_rng(32)
    q = _t(rng.standard_normal(16).astype(np.float32))
    x = rng.standard_normal((40, 16)).astype(np.float32)
    x_c = x + 0.2 * rng.standard_normal((40, 16)).astype(np.float32)
    codes = core.encode_database(_t(x), _t(x_c))
    sc = codes.scalars
    d0 = ((q - _t(x_c)) ** 2).sum(-1)
    trits = core.unpack_level(codes, 0)
    a = core.refine_batch(q, d0, sc, trits, codes.model, k=5)
    b = core.refine_level(q, d0, sc, trits, codes.model, k=5)
    for f in ("est", "lo", "alive", "tau"):
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_core_exports_match_jax():
    import repro.core as jcore
    assert sorted(core.__all__) == sorted(jcore.__all__)
    for name in core.__all__:
        assert hasattr(core, name), name


# ----------------------------------------------------------------- index


def test_probe_batch_matches_jax(embs):
    x = embs[:3000]
    key = jax.random.PRNGKey(8)
    jidx = jivf.build(key, jnp.asarray(x), 24)
    idx = ivf.IVFIndex(centroids=_t(jidx.centroids), lists=_t(jidx.lists),
                       list_len=_t(jidx.list_len))
    qs = embs[3000:3040]
    want = np.asarray(jivf.probe_batch(jidx, jnp.asarray(qs), nprobe=5))
    got = ivf.probe_batch(idx, _t(qs), nprobe=5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ivf.probe(idx, _t(qs[3]), nprobe=5).numpy(),
        np.asarray(jivf.probe(jidx, jnp.asarray(qs[3]), nprobe=5)))


def test_search_batch_matches_jax(embs):
    x, qs = embs[:1500], embs[3900:3916]
    jidx = jgraph.build(jnp.asarray(x), degree=8)
    beam = 16
    start = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (beam,), 0,
                                          len(x)))
    gidx = graph.GraphIndex(neighbors=_t(jidx.neighbors),
                            start=_t(start).int())
    want = np.asarray(jgraph.search_batch(jidx, jnp.asarray(x),
                                          jnp.asarray(qs), iters=10,
                                          beam=beam))
    got = graph.search_batch(gidx, _t(x), _t(qs), iters=10, beam=beam)
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------- registry


def test_front_and_backend_specs():
    for name in registry.front_names():
        spec = registry.front_spec(name)
        assert spec.name == name
        assert set(spec.layouts) == set(jregistry.front_spec(name).layouts)
    for name in registry.backend_names():
        assert registry.backend_spec(name).layouts == registry.LAYOUTS
    with pytest.raises(PlanError, match="front 'lsh'"):
        registry.front_spec("lsh")
    with pytest.raises(PlanError, match="backend 'pallas'"):
        registry.backend_spec("pallas")
    with pytest.raises(PlanError):
        registry.sharded_front("lsh")
