"""The fused refine kernel's pruning step (``ternary_refine_prune`` and its
plain version ``prune_plain``) against the JAX kernel's own: τ =
``_kth_smallest`` of the alive upper bounds, ``alive & (lo ≤ τ)`` and the
per-level counts (``repro.kernels.ternary_refine._fused_kernel``).  The
CUDA kernel itself is held against ``prune_plain`` on the card by
chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ternary_refine import _kth_smallest  # noqa: E402
from repro_torch.core.estimator import pooled_k_smallest  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ternary_refine as tr  # noqa: E402


def _bounds(rng, case: str, nq: int, c: int, k: int):
    """(lo, hi, alive) f32/f32/bool numpy arrays for one case.  Query 0
    has every slot alive, the last none; "ties" draws hi and lo from five
    values, so τ is duplicated and lo lands on it; "zeros" draws them from
    ±0 and ±1; "few" leaves k − 1 slots alive."""
    if case == "ties":
        hi = rng.integers(0, 5, (nq, c)).astype(np.float32) / 4
        lo = hi - rng.integers(0, 3, (nq, c)).astype(np.float32) / 4
    elif case == "zeros":
        pick = np.array([-0.0, 0.0, -1.0, 1.0], np.float32)
        hi = pick[rng.integers(0, 4, (nq, c))]
        lo = np.minimum(hi, pick[rng.integers(0, 4, (nq, c))])
    else:
        hi = rng.standard_normal((nq, c)).astype(np.float32)
        lo = hi - rng.random((nq, c)).astype(np.float32)
    alive = rng.random((nq, c)) < 0.6
    if case == "few":
        alive[:] = False
        for q in range(nq - 1):
            alive[q, rng.permutation(c)[:min(k - 1, c)]] = True
    alive[0] = case != "few"
    alive[-1] = False
    return lo, hi, alive


def _jax_prune(lo, hi, alive, is_delta, k):
    """One level of the JAX kernel's prune, query by query."""
    taus = np.array([float(_kth_smallest(
        jnp.where(jnp.asarray(a), jnp.asarray(h), jnp.inf), k))
        for h, a in zip(hi, alive)], np.float32)
    out = alive & (lo <= taus[:, None])
    delta = out & is_delta if is_delta is not None else np.zeros_like(out)
    return out, out.sum(-1), delta.sum(-1), taus


@pytest.mark.parametrize("delta", [False, True], ids=["nodelta", "delta"])
@pytest.mark.parametrize("case,c", [("mixed", 301), ("ties", 301),
                                    ("zeros", 37), ("few", 301),
                                    ("mixed", 37)])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_prune_plain_matches_jax_kernel(k, case, c, delta):
    """``prune_plain`` gives the JAX kernel's τ, mask and counts: C = 37
    and 301 (neither a multiple of 8 or 32; 37 is under k = 64, so every
    query has fewer than k alive slots and τ = +inf), duplicated hi at and
    around τ, ±0, fewer than k and no alive slots, delta rows or none."""
    rng = np.random.default_rng(k * 1000 + c + 7 * delta)
    lo, hi, alive = _bounds(rng, case, 5, c, k)
    is_delta = rng.random(alive.shape) < 0.4 if delta else None
    want = _jax_prune(lo, hi, alive, is_delta, k)
    got = tr.prune_plain(torch.from_numpy(lo), torch.from_numpy(hi),
                         torch.from_numpy(alive),
                         None if is_delta is None
                         else torch.from_numpy(is_delta), k=k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[1].dtype == got[2].dtype == torch.int32
    assert np.isinf(got[3].numpy()[-1])            # no alive slot


@pytest.mark.parametrize("tiles", [2, 8])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_tile_split_keeps_tau(tiles, k):
    """Split into tiles of +inf-padded upper bounds, each tile's k smallest
    pooled (``pooled_k_smallest(shard_dim=0)``) give the unsplit τ: every
    member of the global k smallest is among its tile's k smallest."""
    rng = np.random.default_rng(tiles * k)
    lo, hi, alive = _bounds(rng, "ties", 4, 301, k)
    masked = torch.where(torch.from_numpy(alive), torch.from_numpy(hi),
                         float("inf"))
    tile = -(-masked.shape[1] // tiles)
    padded = torch.nn.functional.pad(
        masked, (0, tile * tiles - masked.shape[1]), value=float("inf"))
    split = padded.reshape(4, tiles, tile).transpose(0, 1)
    want = pooled_k_smallest(masked, k)
    assert torch.equal(pooled_k_smallest(split, k, shard_dim=0), want)
    assert torch.equal(want, tr.prune_plain(
        torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(alive),
        None, k=k)[3])


def test_prune_wrapper_in_place_at_a_deeper_level():
    """As at the fused kernel's levels ≥ 1: the mask written over the
    alive buffer it reads, the counts into their level's two columns of a
    (Q, 2L) tensor and nothing else."""
    rng = np.random.default_rng(3)
    lo, hi, alive = (torch.from_numpy(a) for a in
                     _bounds(rng, "mixed", 4, 301, 10))
    is_delta = torch.from_numpy(rng.random((4, 301)) < 0.4)
    want = tr.prune_plain(lo, hi, alive, is_delta, k=10)
    counts = torch.full((4, 6), -7, dtype=torch.int32)
    buf = alive.clone()
    tau = tr.ternary_refine_prune(lo, hi, buf, is_delta, counts, buf, k=10,
                                  level=1)
    assert torch.equal(buf, want[0]) and torch.equal(tau, want[3])
    assert torch.equal(counts[:, 1], want[1])
    assert torch.equal(counts[:, 4], want[2])
    assert bool((counts[:, [0, 2, 3, 5]] == -7).all())


def test_prune_wrapper_rejects_what_the_kernel_does_not_take():
    """k outside [1, 64] and a level outside the counts; a C whose block
    slices overflow shared memory (446,464 slots per query fit) answers,
    in the global form on the card."""
    lo = hi = torch.zeros((1, 8))
    alive = torch.ones((1, 8), dtype=torch.bool)
    counts = torch.zeros((1, 2), dtype=torch.int32)
    for k in (0, tr.MAX_K + 1):
        with pytest.raises(ValueError, match="k="):
            tr.ternary_refine_prune(lo, hi, alive, None, counts, alive, k=k)
    with pytest.raises(ValueError, match="level"):
        tr.ternary_refine_prune(lo, hi, alive, None, counts, alive, k=1,
                                level=1)
    fits = 446_464
    assert ops.prune_smem_bytes(fits) <= ops.SMEM_LIMIT_BYTES \
        < ops.prune_smem_bytes(fits + 1)
    assert [ops.prune_form(c) for c in (fits, fits + 1)] == \
        ["shared", "global"]
    big = torch.zeros((1, fits + 1))
    out = torch.zeros_like(big, dtype=torch.bool)
    tau = tr.ternary_refine_prune(big, big, big == 0, None, counts, out, k=10)
    assert bool(out.all()) and int(counts[0, 0]) == fits + 1
    assert float(tau[0]) == 0.0
    alive = big[:, :fits] == 0
    tau = tr.ternary_refine_prune(big[:, :fits], big[:, :fits], alive, None,
                                  counts, alive, k=10)
    assert int(counts[0, 0]) == fits and float(tau[0]) == 0.0
