"""The prune's global form (``prune_kernel<true>``): one streaming pass over
each block's slice that keeps only candidate keys below the block's
running kth-smallest, merged by the cluster's select.

Held here on the CPU: the high-recall IVF search that reaches it on the
card (nprobe = nlist, every list probed) against JAX's on one exported
build, through ``make_executor(..., nprobe=...)`` in both packages; the
form the shapes select and its shared memory; and the candidate filter's
arithmetic,
emulated in numpy slot by slot as each block walks its tiles (the union
of the blocks' kept keys has the kth-smallest of every alive key, ties at
the running threshold dropped), against JAX's ``_kth_smallest``.  The
kernel itself is held against ``prune_plain`` and the shared form on the
card by chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.anns import PipelineConfig as JConfig  # noqa: E402
from repro.anns import build as jbuild  # noqa: E402
from repro.anns.executor import make_executor as jmake_executor  # noqa
from repro.data import make_dataset as jmake_dataset  # noqa: E402
from repro.kernels.ternary_refine import _kth_smallest  # noqa: E402
from repro_torch.anns import PipelineConfig  # noqa: E402
from repro_torch.anns.executor import make_executor  # noqa: E402
from repro_torch.interop import index_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from test_torch_pipeline import export_jax_index  # noqa: E402

NLIST = 16


@pytest.fixture(scope="module")
def high_nprobe():
    """A JAX build exported to the port, and JAX's reference answer with
    every list probed."""
    ds = jmake_dataset(jax.random.PRNGKey(0), n=3000, d=64, n_queries=16,
                       k_gt=20, clusters=8)
    kw = dict(dim=64, pq_m=8, pq_k=32, nlist=NLIST, nprobe=4, final_k=5,
              refine_budget=20)
    jidx = jbuild(jax.random.PRNGKey(1), ds.x, JConfig(**kw))
    ids, dists, cost = jmake_executor(jidx, backend="reference",
                                      nprobe=NLIST).execute(ds.queries)
    pidx = index_from_numpy(export_jax_index(jidx), PipelineConfig(**kw),
                            device="cpu")
    return pidx, np.array(ds.queries), (np.asarray(ids), np.asarray(dists),
                                        cost)


def _ledger(cost):
    return {k: (t.accesses, t.bytes) for k, t in cost.ledger.items()}


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_every_list_probed_matches_jax(high_nprobe, backend):
    """nprobe = nlist through ``make_executor``: JAX's reference ids and
    ledger, distances within f32 tolerance, from both of the port's
    backends (the card runs the prune's global form at the chip script's
    nprobe 256 on its 1M-row index; here C = nlist × cap)."""
    pidx, qs, (want_ids, want_d, want_cost) = high_nprobe
    ex = make_executor(pidx, backend=backend, nprobe=NLIST)
    assert ex.front.nprobe == NLIST
    ids, dists, cost = ex.execute(torch.from_numpy(qs))
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(dists.numpy(), want_d, rtol=1e-5, atol=1e-5)
    assert _ledger(cost) == _ledger(want_cost)
    assert cost.ledger["refine:cxl"].accesses == \
        qs.shape[0] * pidx.ivf.list_len.sum().item()


@pytest.mark.parametrize("c", [446_465, 750_080, 1_048_576, 8_388_608])
def test_prune_plan_is_the_same_at_every_c(c):
    """Past the shared form's 446,464 slots the prune runs its global form,
    which needs the same shared memory at every C (two stages of a
    4096-slot tile's hi, a 4352-key buffer, the compaction's 64 keys and
    count: ``ops.PRUNE_STREAM_SMEM``), under the block's limit beside its
    static 2,224 B: no C refuses it, where the shared form's staged slice
    would not fit."""
    assert ops.prune_form(c) == "global"
    assert ops.prune_smem_bytes(c) > ops.SMEM_LIMIT_BYTES
    assert ops.PRUNE_STREAM_SMEM == 2 * 4096 * 4 + (4352 + 64 + 4) * 4 \
        == 50_448
    assert ops.check_smem_budget("prune", ops.PRUNE_STREAM_SMEM + 2224) \
        <= ops.SMEM_LIMIT_BYTES
    assert ops.prune_form(446_464) == "shared"


def _order_keys(v: np.ndarray) -> np.ndarray:
    """order_key of the source: the float's bits made to sort as unsigned
    (-0 below +0, every NaN above +inf)."""
    b = v.astype(np.float32).view(np.uint32)
    key = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(v), np.uint32(0xffffffff), key)


def _key_value(key: int) -> np.float32:
    b = key & 0x7fffffff if key & 0x80000000 else ~key & 0xffffffff
    return np.array([b], np.uint32).view(np.float32)[0]


def _stream_tau(hi, alive, k: int, tile: int, buf: int,
                cluster: int = 8) -> np.float32:
    """The global form's τ for one query, slot by slot: each block of the
    cluster walks its slice (ceil(C / 8) rounded up to 32) in tiles,
    keeping alive keys below theta; a buffer past ``buf − tile`` keys is
    cut to its k smallest (those below the kth, then copies of it) and
    theta drops to the kth.  τ is the kth-smallest of the blocks' union,
    +inf when it holds fewer than k keys."""
    c = hi.shape[0]
    span = (-(-c // cluster) + 31) // 32 * 32
    keys = _order_keys(hi)
    union = []
    for r in range(cluster):
        theta, kept = 1 << 32, []
        for t0 in range(r * span, min(c, (r + 1) * span), tile):
            t1 = min(c, (r + 1) * span, t0 + tile)
            kept += [int(x) for x, a in zip(keys[t0:t1], alive[t0:t1])
                     if a and x < theta]
            if len(kept) > buf - tile:
                kth = sorted(kept)[k - 1]
                below = [x for x in kept if x < kth]
                kept = below + [kth] * (k - len(below))
                theta = kth
        union += kept
    if len(union) < k:
        return np.float32(np.inf)
    return _key_value(sorted(union)[k - 1])


def _order(rng, case: str, c: int, k: int):
    """(hi, alive) of one query: ``falling`` hi along the slots (every key
    passes the filter), ``rising``, ``equal`` (one value), ``ties`` (five
    values), ``few`` (k − 1 alive), ``random``."""
    hi = rng.standard_normal(c).astype(np.float32)
    alive = rng.random(c) < 0.6
    if case == "falling":
        hi = np.sort(hi)[::-1].copy()
        alive[:] = True
    elif case == "rising":
        hi = np.sort(hi)
    elif case == "equal":
        hi[:] = np.float32(0.25)
    elif case == "ties":
        hi = rng.integers(0, 5, c).astype(np.float32) / 4
    elif case == "few":
        alive[:] = False
        alive[rng.permutation(c)[:k - 1]] = True
    return hi, alive


def test_stream_filter_gives_tau():
    """The multiset argument the global form rests on: the kth-smallest of
    a multiset is the kth-smallest of the union of each part's k smallest,
    so dropping keys at or above a block's running kth-smallest (ties past
    k too) leaves τ as it was.  The filter's τ equals JAX's kth-smallest of
    the alive hi for each order of ``_order`` and k = 1, 10, 64, at the
    kernel's sizes (tiles of 4096, a 4352-key buffer; C = 100,000, so each
    block walks four tiles) and at a scaled-down tile of 96 with a buffer
    of 160 (many compactions a block)."""
    c, small = 100_000, slice(0, 9_000)
    for case in ("random", "falling", "rising", "equal", "ties", "few"):
        for k in (1, 10, 64):
            hi, alive = _order(np.random.default_rng(k), case, c, k)
            for part, tile, buf in ((slice(None), 4096, 4352),
                                    (small, 96, 160)):
                want = np.float32(_kth_smallest(jnp.where(
                    jnp.asarray(alive[part]), jnp.asarray(hi[part]),
                    jnp.inf), k))
                assert _stream_tau(hi[part], alive[part], k, tile, buf) \
                    == want, (case, k, tile)
