"""The port's offline build (k-means, PQ, IVF, synthetic data) against the
JAX package's, fed the JAX package's own random draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

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


def _index_add_update(x, ids, k):
    """The centroid update as an ``index_add_`` segment sum (what
    ``kmeans._update`` did before it summed in a fixed order)."""
    b, n, d = x.shape
    flat = (ids + k * torch.arange(b)[:, None]).reshape(-1)
    sums = torch.zeros((b * k, d)).index_add_(0, flat, x.reshape(b * n, d))
    counts = torch.bincount(flat, minlength=b * k).float()
    return (sums / counts.clamp(min=1.0)[:, None]).reshape(b, k, d), \
        counts.reshape(b, k)


@pytest.mark.parametrize("b,n,d,k", [(1, 1000, 24, 9), (6, 777, 8, 32),
                                     (1, 5, 3, 40), (3, 4096, 16, 2)])
def test_update_matches_index_add(b, n, d, k):
    """The sorted segmented-sum update gives the ``index_add_`` means
    within f32 rounding of each member sum, the same counts, and 0 for an
    empty cluster (more clusters than rows; one cluster holding all)."""
    rng = np.random.default_rng(b * n)
    x = torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, k - 1, (b, n)))  # k−1 stays empty
    means, counts = kmeans._update(x, ids, k)
    want_means, want_counts = _index_add_update(x, ids, k)
    assert torch.equal(counts, want_counts)
    assert bool((counts[:, -1] == 0).all() and (means[:, -1] == 0).all())
    abs_sum = torch.zeros((b, k, d))
    for j in range(b):
        abs_sum[j].index_add_(0, ids[j], x[j].abs())
    tol = 4 * n * np.finfo(np.float32).eps * abs_sum / counts.clamp(
        min=1.0)[..., None]
    assert bool(((means - want_means).abs() <= tol).all())


def test_build_is_repeatable():
    """Two builds from one seed give equal index arrays: centroids,
    codebooks, PQ codes, lists and packed TRQ codes."""
    from repro_torch.anns import PipelineConfig, build
    x = synthetic.make_dataset(n=3000, d=64, n_queries=2, k_gt=5,
                               clusters=8,
                               generator=torch.Generator().manual_seed(0)).x
    cfg = PipelineConfig(dim=64, pq_m=8, pq_k=32, nlist=16, nprobe=4,
                         trq_levels=2)
    one, two = (build(x, cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
                for _ in range(2))
    for get in (lambda i: i.ivf.centroids, lambda i: i.codebook.codebooks,
                lambda i: i.pq_codes, lambda i: i.ivf.lists,
                lambda i: i.ivf.list_len,
                *(lambda i, lv=lv: i.trq.levels[lv].packed
                  for lv in range(2))):
        assert torch.equal(get(one), get(two))
