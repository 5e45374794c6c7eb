"""The level-0 scoring entry points (``ops.refine_scores_batch`` /
``refine_scores``, kernels ``ternary_refine_batch`` / ``ternary_refine``)
against the JAX package's Pallas kernels in interpret mode on code bytes
drawn from all of 0..255: a byte y >= 243 decodes as its five low trits,
y - 243, in both.  Also the decode the CUDA kernel's tables implement
(T27[y % 27] + T9[y / 27], row 9 equal to row 0, each entry paired with
its digits' nonzero-trit count) against JAX's digit-by-digit decode, and
the kernel's shared-memory layout (``ops.level0_smem_bytes``).  The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ternary_refine import _block_align  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ternary_refine as tr  # noqa: E402

TOL = 2e-5   # the level-0 kernels' tolerance (chip_smoke.LEVEL0_TOL)


def _problem(rng, shape, d):
    """Packed codes (..., C, G) with bytes from 0..255, some of them
    243..255, and per-candidate scalars (..., C)."""
    g = -(-d // 5)
    packed = rng.integers(0, 256, shape + (g,)).astype(np.uint8)
    flat = packed.reshape(-1)
    flat[::7] = rng.integers(243, 256, flat[::7].size)
    q = rng.standard_normal(shape[:-1] + (d,)).astype(np.float32)
    d0, dsq, norm = (rng.random(shape).astype(np.float32) * 4 + 0.1
                     for _ in range(3))
    cross = rng.standard_normal(shape).astype(np.float32)
    rho = rng.random(shape).astype(np.float32)
    w = np.array([1.0, 1.1, 0.95, 2.1], np.float32)
    bias = np.array(0.3, np.float32)
    return packed, q, d0, dsq, cross, norm, rho, w, bias


# (Q, C, D): G = 1 at D = 1 and 5, Q = 1, C under and over a 32-slot chunk
@pytest.mark.parametrize("nq,c,d", [(3, 130, 63), (1, 7, 5), (2, 33, 1),
                                    (4, 200, 768), (1, 64, 65)])
def test_refine_scores_batch_every_byte(nq, c, d):
    args = _problem(np.random.default_rng(nq * c + d), (nq, c), d)
    assert (args[0] >= 243).any()
    want = jops.refine_scores_batch(*map(jnp.asarray, args), block_c=64)
    got = ops.refine_scores_batch(*map(torch.from_numpy, args))
    assert got.shape == (nq, c, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("c,d", [(64, 65), (300, 768), (7, 1), (33, 5),
                                 (130, 63)])
def test_refine_scores_every_byte(c, d):
    args = _problem(np.random.default_rng(c * d + 1), (c,), d)
    assert (args[0] >= 243).any()
    want = jops.refine_scores(*map(jnp.asarray, args), block_c=64)
    got = ops.refine_scores(*map(torch.from_numpy, args))
    assert got.shape == (c, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _pair_tables(planes):
    """The level-0 kernel's tables for planes (5, G) in float64, as
    load_pair_tables builds them (without their zero columns): T27 and T9
    partial dots, and each row's count of nonzero trits."""
    r = np.arange(27)
    digits = [(r // 3 ** i) % 3 - 1 for i in range(3)]
    t27 = sum(d[:, None] * planes[i] for i, d in enumerate(digits))
    k27 = sum(d != 0 for d in digits)
    r = np.arange(10)
    digits = [r % 3 - 1, (r // 3) % 3 - 1]
    t9 = sum(d[:, None] * planes[3 + i] for i, d in enumerate(digits))
    k9 = sum(d != 0 for d in digits)
    return t27, k27, t9, k9


@pytest.mark.parametrize("g", [1, 13, 154])
def test_pair_tables_decode_every_byte_as_jax(g):
    """Row y of the (256, G) codes holds byte y in every column: the pair
    tables' sums (T27[y % 27] + T9[y / 27]) give JAX's align = Σ c·q / √k."""
    planes = np.random.default_rng(g).standard_normal((5, g))
    t27, k27, t9, k9 = _pair_tables(planes)
    y = np.arange(256)
    dot = (t27[y % 27] + t9[y // 27]).sum(-1)
    k = (k27[y % 27] + k9[y // 27]) * g
    got = dot / np.sqrt(np.maximum(k, 1))
    rows = jnp.asarray(np.repeat(y[:, None], g, 1).astype(np.int32))
    want = np.asarray(_block_align(rows, jnp.asarray(planes, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t9[9], t9[0])     # y >= 243 acts as y - 243
    assert k9[9] == k9[0]


@pytest.mark.parametrize("g", [1, 7, 154])
def test_nonzero_count_every_byte(g):
    """The plain version's nonzero-trit count and the level table's
    √max(k, 1) on bytes 0..255 equal JAX's digit-by-digit count."""
    rows = np.random.default_rng(g).integers(0, 256, (300, g)) \
        .astype(np.uint8)
    rows[:, 0] = np.arange(300) % 256
    ones = np.ones((5, g), np.float32)
    _, k = tr._dot_count(torch.from_numpy(rows)[None],
                         torch.from_numpy(ones)[None])
    digits = np.stack([(rows.astype(np.int64) // 3 ** i) % 3 - 1
                       for i in range(5)])
    np.testing.assert_array_equal(k[0].numpy(), (digits ** 2).sum((0, 2)))
    assert torch.equal(ops.sqrt_nonzero(torch.from_numpy(rows)),
                       torch.sqrt(torch.clamp(k[0].float(), min=1.0)))


# (G, warps per block, bytes): 16 warps at most; 220,160 B at G = 154
@pytest.mark.parametrize("g,warps,nbytes", [(1, 16, 63_488),
                                            (20, 16, 82_944),
                                            (154, 16, 220_160),
                                            (158, 11, 222_816),
                                            (503, 1, 232_416)])
def test_level0_smem_is_pair_tables_and_stages(g, warps, nbytes):
    """The level-0 kernel holds one query's T27/T9 tables as (f32, int32)
    pairs and two stages per warp of 32 code rows (with room for the words
    a row's passes read past the last one, and an offset below 16)."""
    stage = (32 * g + 160 * ops.row_passes(g) + 16 + 15) // 16 * 16
    assert ops.level0_stage_bytes(g) == stage
    assert ops.level0_table_bytes(g) == 2 * ops.refine_smem_bytes(g) == \
        37 * ops.table_width(g) * 8
    assert ops.level0_warps(g) == warps
    assert ops.level0_smem_bytes(g) == nbytes == \
        ops.level0_table_bytes(g) + 2 * warps * stage
    assert ops.check_smem_budget("level0", nbytes) == nbytes
    with pytest.raises(ops.SharedMemoryBudgetError, match="level0"):
        ops.check_smem_budget("level0", ops.level0_smem_bytes(504))


@pytest.mark.parametrize("entry", ["refine_scores_batch", "refine_scores",
                                   "ternary_refine_batch", "ternary_refine"])
def test_level0_wrappers_raise_past_the_budget(entry):
    """G = 503 fits the shared form; at G = 504 even one warp does not fit
    beside the pair tables, and the global form (tables in scratch, staged
    back by pass chunks) takes it: both answer.  The global form's shared
    memory does not grow with G, so no width makes the card's form raise."""
    for g, form in ((503, "shared"), (504, "global")):
        args = [torch.from_numpy(a) for a in
                _problem(np.random.default_rng(g), (1, 3), 5 * g)]
        if entry in ("refine_scores", "ternary_refine"):
            args = [a[0] if a.ndim > 1 else a for a in args[:7]] + args[7:]
        packed, q, *cols, w, bias = args
        if entry.startswith("refine"):
            call = lambda: getattr(ops, entry)(packed, q, *cols, w,  # noqa
                                               bias)
        else:
            batch = entry == "ternary_refine_batch"
            planes, params, scalars = ops.level0_inputs(
                q if batch else q[None], g, *cols, w, bias)
            call = lambda: getattr(tr, entry)(  # noqa: E731
                packed, planes if batch else planes[0], scalars, params)
        assert ops.level0_form(g) == form
        assert call().shape == packed.shape[:-1] + (3,)
    assert ops.level0_form(100_000) == "global"
    assert ops.level0_plan(100_000).smem_bytes <= ops.SMEM_LIMIT_BYTES
