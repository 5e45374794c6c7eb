"""The port's offline build (k-means, PQ, IVF, synthetic data) against the
JAX package's, fed the JAX package's own random draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as jsyn  # noqa: E402
from repro.index import ivf as jivf  # noqa: E402
from repro.quant.kmeans import assign as jassign  # noqa: E402
from repro.quant.kmeans import kmeans as jkmeans  # noqa: E402
from repro.quant import pq as jpq  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.index import ivf  # noqa: E402
from repro_torch.quant import kmeans, pq  # noqa: E402

CENT_TOL = 1e-5   # f32 means summed in another order


def _separated(seed, n=1500, d=16, k=6, spread=0.05):
    """Well-separated clusters (x, cluster ids): no assignment sits near a
    tie once every cluster holds one initial centroid."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 4
    ids = rng.integers(0, k, n)
    x = centers[ids] + spread * rng.standard_normal((n, d))
    return x.astype(np.float32), ids


def _choice(key, n, k):
    """The initial rows jax's k-means draws from ``key``."""
    return np.array(jax.random.choice(key, n, (k,), replace=False))


def _covering_key(ids, k, start=0):
    """The first PRNG key whose k-means draw seeds every cluster once."""
    for s in range(start, start + 1000):
        key = jax.random.PRNGKey(s)
        if len(set(ids[_choice(key, len(ids), k)])) == k:
            return key
    raise AssertionError("no covering key")


@pytest.mark.parametrize("k", [4, 6, 9])
def test_kmeans_matches_with_jax_draws(k):
    x, ids = _separated(k, k=k)
    key = _covering_key(ids, k)
    want = np.asarray(jkmeans(key, jnp.asarray(x), k, 10))
    got = kmeans.kmeans(torch.from_numpy(x), k, 10,
                        init_idx=torch.from_numpy(_choice(key, len(x), k)))
    np.testing.assert_allclose(got.numpy(), want, rtol=CENT_TOL,
                               atol=CENT_TOL)
    np.testing.assert_array_equal(
        kmeans.assign(torch.from_numpy(x), got).numpy(),
        np.asarray(jassign(jnp.asarray(x), jnp.asarray(want))))


def test_pq_train_encode_decode_match():
    m, kk = 4, 8
    x, _ = _separated(11, n=1200, d=16, k=8)
    key = jax.random.PRNGKey(3)
    want = jpq.train(key, jnp.asarray(x), m, kk, iters=8)
    inits = np.stack([_choice(s, len(x), kk)
                      for s in jax.random.split(key, m)])
    got = pq.train(torch.from_numpy(x), m, kk, iters=8,
                   init_idx=torch.from_numpy(inits))
    np.testing.assert_allclose(got.codebooks.numpy(),
                               np.asarray(want.codebooks), rtol=CENT_TOL,
                               atol=CENT_TOL)
    codes = pq.encode(got, torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jpq.encode(want, jnp.asarray(x))))
    np.testing.assert_allclose(
        pq.decode(got, codes).numpy(),
        np.asarray(jpq.decode(want, jnp.asarray(codes.numpy()))),
        rtol=CENT_TOL, atol=CENT_TOL)


def test_ivf_build_matches_with_jax_draws():
    nlist = 8
    x, ids = _separated(5, n=2000, d=16, k=nlist, spread=0.3)
    key = _covering_key(ids, nlist)
    want = jivf.build(key, jnp.asarray(x), nlist)
    got = ivf.build(torch.from_numpy(x), nlist,
                    init_idx=torch.from_numpy(_choice(key, len(x), nlist)))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=CENT_TOL,
                               atol=CENT_TOL)
    np.testing.assert_array_equal(got.lists.numpy(), np.asarray(want.lists))
    np.testing.assert_array_equal(got.list_len.numpy(),
                                  np.asarray(want.list_len))
    np.testing.assert_array_equal(
        ivf.assign_lists(got, torch.from_numpy(x[:50])).numpy(),
        np.asarray(jivf.assign_lists(want, jnp.asarray(x[:50]))))


@pytest.mark.parametrize("cap", [5, 40])
def test_fill_lists_exact(cap):
    ids = np.random.default_rng(cap).integers(0, 7, 120)
    want = jivf.fill_lists(ids, 7, cap)
    got = ivf.fill_lists(ids, 7, cap)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_make_dataset_ground_truth_is_brute_force():
    g = torch.Generator().manual_seed(3)
    ds = synthetic.make_dataset(n=2500, d=32, n_queries=12, k_gt=15,
                                clusters=8, generator=g)
    x = ds.x.double().numpy()
    q = ds.queries.double().numpy()
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    want = np.sort(d, axis=1)[:, :15]
    got = np.take_along_axis(d, ds.gt.numpy(), axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(x, axis=1), 1.0, atol=1e-5)
    assert ds.x.shape == (2500, 32) and ds.gt.shape == (12, 15)


def test_brute_force_topk_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3000, 24)).astype(np.float32)
    q = rng.standard_normal((70, 24)).astype(np.float32)
    want = np.asarray(jsyn.brute_force_topk(jnp.asarray(x), jnp.asarray(q),
                                            10))
    got = synthetic.brute_force_topk(torch.from_numpy(x),
                                     torch.from_numpy(q), 10).numpy()
    np.testing.assert_array_equal(got, want)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.make_dataset(n=100, d=8, n_queries=2, k_gt=3)
