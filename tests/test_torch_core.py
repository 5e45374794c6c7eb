"""The port's core math (repro_torch.core) against the JAX package's, on the
same numpy inputs: packing bit-exact, ternary codes exact, estimator and
progressive search at the tolerance tests/test_kernels.py uses."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import calibration as jcal  # noqa: E402
from repro.core import decomposition as jdec  # noqa: E402
from repro.core import estimator as jest  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core import ternary as jtern  # noqa: E402
from repro.core import trq as jtrq  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import decomposition as dec  # noqa: E402
from repro_torch.core import estimator as est  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core import ternary  # noqa: E402
from repro_torch.core import trq  # noqa: E402

TOL = 3e-5   # f32 sums in another order (tests/test_kernels.py:201)


def _t(a):
    return torch.from_numpy(np.array(a))


def trq_to_port(codes) -> trq.TRQCodes:
    """A JAX TRQCodes as the port's, leaf by leaf."""
    sc, m = codes.scalars, codes.model
    return trq.TRQCodes(
        dim=codes.dim,
        levels=tuple(trq.TRQLevel(_t(lv.packed), _t(lv.proj), _t(lv.norm),
                                  _t(lv.rho)) for lv in codes.levels),
        scalars=dec.RecordScalars(_t(sc.delta_sq), _t(sc.cross), _t(sc.rho),
                                  _t(sc.norm)),
        model=cal.CalibrationModel(_t(m.w), _t(m.bias), _t(m.resid_std)))


def _problem(seed, n=300, d=40, n_cents=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cents = rng.standard_normal((n_cents, d)).astype(np.float32)
    assign = ((x[:, None] - cents[None]) ** 2).sum(-1).argmin(-1)
    return x, cents[assign]


@pytest.mark.parametrize("d", [5, 63, 768])
def test_pack_unpack_bit_exact(d):
    rng = np.random.default_rng(d)
    code = rng.integers(-1, 2, size=(17, d)).astype(np.int8)
    want = np.asarray(jpack.pack_ternary(jnp.asarray(code)))
    got = packing.pack_ternary(torch.from_numpy(code)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        packing.unpack_ternary(torch.from_numpy(got), d).numpy(),
        np.asarray(jpack.unpack_ternary(jnp.asarray(want), d)))
    np.testing.assert_array_equal(
        packing.unpack_ternary(torch.from_numpy(got), d).numpy(), code)
    assert packing.packed_size(d) == jpack.packed_size(d)


@pytest.mark.parametrize("ties", [False, True])
def test_ternary_encode_matches(ties):
    rng = np.random.default_rng(7)
    delta = rng.standard_normal((200, 64)).astype(np.float32)
    if ties:   # many equal magnitudes: the stable sort decides the code
        delta = np.round(delta * 2) / 2
        delta[:3] = 0.0
    want = jtern.ternary_encode(jnp.asarray(delta))
    got = ternary.ternary_encode(torch.from_numpy(delta))
    np.testing.assert_array_equal(got.code.numpy(), np.asarray(want.code))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_allclose(got.norm.numpy(), np.asarray(want.norm),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(want.rho),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ternary.reconstruct(got).numpy(), np.asarray(jtern.reconstruct(want)),
        rtol=1e-6, atol=1e-6)


def test_ternary_inner_matches():
    rng = np.random.default_rng(3)
    code = rng.integers(-1, 2, size=(50, 33)).astype(np.int8)
    q = rng.standard_normal(33).astype(np.float32)
    np.testing.assert_allclose(
        ternary.ternary_inner(torch.from_numpy(code),
                              torch.from_numpy(q)).numpy(),
        np.asarray(jtern.ternary_inner(jnp.asarray(code), jnp.asarray(q))),
        rtol=TOL, atol=TOL)


def test_compute_scalars_matches():
    x, x_c = _problem(1)
    want = jdec.compute_scalars(jnp.asarray(x), jnp.asarray(x_c))
    got = dec.compute_scalars(torch.from_numpy(x), torch.from_numpy(x_c))
    for f in ("delta_sq", "cross", "rho", "norm"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("levels", [1, 2])
def test_encode_database_matches(levels):
    x, x_c = _problem(2)
    want, _ = jtrq.encode_database(jnp.asarray(x), jnp.asarray(x_c),
                                   num_levels=levels)
    got = trq.encode_database(torch.from_numpy(x), torch.from_numpy(x_c),
                              num_levels=levels)
    for lw, lg in zip(want.levels, got.levels):
        np.testing.assert_array_equal(lg.packed.numpy(), np.asarray(lw.packed))
        for f in ("proj", "norm", "rho"):
            np.testing.assert_allclose(getattr(lg, f).numpy(),
                                       np.asarray(getattr(lw, f)),
                                       rtol=1e-5, atol=1e-5)


def _calibrated(seed, levels, n=300, d=40):
    """A JAX-encoded, JAX-calibrated problem plus the calibration inputs."""
    x, x_c = _problem(seed, n, d)
    codes, _ = jtrq.encode_database(jnp.asarray(x), jnp.asarray(x_c),
                                    num_levels=levels)
    rng = np.random.default_rng(seed + 100)
    qcal = rng.standard_normal((64, d)).astype(np.float32)
    pair = rng.integers(0, n, 64)
    jcodes = jtrq.calibrate(codes, jnp.asarray(qcal), jnp.asarray(x),
                            jnp.asarray(x_c), jnp.asarray(pair))
    return x, x_c, qcal, pair, jcodes


def test_calibrate_matches():
    x, x_c, qcal, pair, jcodes = _calibrated(4, 1)
    pcodes = trq.encode_database(torch.from_numpy(x), torch.from_numpy(x_c))
    got = trq.calibrate(pcodes, torch.from_numpy(qcal), torch.from_numpy(x),
                        torch.from_numpy(x_c), torch.from_numpy(pair)).model
    want = jcodes.model
    # float32 normal equations are ill-conditioned: w is held at 1e-3
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(float(got.bias), float(want.bias), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(float(got.resid_std), float(want.resid_std),
                               rtol=1e-3)
    feats = np.random.default_rng(0).standard_normal((20, 4)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        cal.predict(cal.identity_model(), torch.from_numpy(feats)).numpy(),
        np.asarray(jcal.predict(jcal.identity_model(), jnp.asarray(feats))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bound", ["cauchy", "quantile"])
def test_refine_level_matches(bound):
    x, x_c, _, _, jcodes = _calibrated(5, 1)
    pc = trq_to_port(jcodes)
    q = np.random.default_rng(9).standard_normal(x.shape[1]) \
        .astype(np.float32)
    d0 = ((q[None] - x_c) ** 2).sum(-1).astype(np.float32)
    codes = jtrq.unpack_level(jcodes, 0)
    want = jest.refine_level(jnp.asarray(q), jnp.asarray(d0),
                             jcodes.scalars, codes, jcodes.model, k=5,
                             bound=bound)
    got = est.refine_level(torch.from_numpy(q)[None],
                           torch.from_numpy(d0)[None],
                           pc.scalars.take(torch.arange(x.shape[0])[None]),
                           trq.unpack_level(pc, 0)[None], pc.model, k=5,
                           bound=bound)
    np.testing.assert_allclose(got.est[0].numpy(), np.asarray(want.est),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.lo[0].numpy(), np.asarray(want.lo),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got.tau[0]), float(want.tau), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got.alive[0].numpy(),
                                  np.asarray(want.alive))


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("bound", ["cauchy", "quantile"])
def test_progressive_search_matches(levels, bound):
    x, x_c, _, _, jcodes = _calibrated(10 + levels, levels)
    pc = trq_to_port(jcodes)
    rng = np.random.default_rng(levels)
    qs = rng.standard_normal((3, x.shape[1])).astype(np.float32)
    ids = np.stack([rng.permutation(x.shape[0])[:200] for _ in range(3)])
    d0 = ((x_c[ids] - qs[:, None]) ** 2).sum(-1).astype(np.float32)
    got, got_alive = trq.progressive_search(
        torch.from_numpy(qs), torch.from_numpy(d0), pc,
        torch.from_numpy(ids), k=5, bound=bound)
    for i in range(3):
        want, want_alive = jtrq.progressive_search(
            jnp.asarray(qs[i]), jnp.asarray(d0[i]), jcodes,
            jnp.asarray(ids[i]), k=5, bound=bound, collect_level_alive=True)
        np.testing.assert_allclose(got.est[i].numpy(), np.asarray(want.est),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.lo[i].numpy(), np.asarray(want.lo),
                                   rtol=TOL, atol=TOL)
        for a, b in zip(got_alive, want_alive):
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(b))


def test_pooled_k_smallest_matches():
    v = np.random.default_rng(1).standard_normal((4, 30)).astype(np.float32)
    v[0, 5:] = np.inf
    np.testing.assert_array_equal(
        est.pooled_k_smallest(torch.from_numpy(v), 7).numpy(),
        np.asarray(jest.pooled_k_smallest(jnp.asarray(v), 7)))
    assert jax.default_backend() == "cpu"
