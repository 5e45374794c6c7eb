"""The chunk plans of the redesigned global forms: ``pq_adc``'s LUT staged by
chunks of subspaces (``ops.adc_plan``), the fused and bounds kernels'
refine tables staged by column chunks of whole passes (``ops.refine_plan``,
``ops.bounds_plan``), and the level-0 kernel's pair tables and code rows
staged by the same pass chunks (``ops.level0_plan``).

A plan is chosen from the shapes alone, before the launch, so it is held
here on the CPU: at every backbone width at the JAX package's
``pq_m = d // 8`` (and a few odd M), the ADC chunks cover subspaces
0 … M−1 once and in order and fit a block; the refine and level-0 chunks
are whole passes in order, hold every table column that ``row_dot`` /
``level0_row`` addresses for their passes at every byte offset of a row,
and fit a block (beside the per-lane partial sums, or beside 16 warps'
row stages).  The kernels themselves are held against the shared forms
and the plain versions on the card by chip_smoke.py."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)        # xdist workers share the cores

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pq_adc as pq_adc_mod  # noqa: E402

#: the backbones' embedding widths (``configs.ARCHS``' d_model values)
WIDTHS = (1024, 1536, 2048, 2560, 4096, 6144, 8192)
#: M of the ADC plans: every width's d // 8, the chip script's edge M =
#: 1024 and odd M (past the shared LUT, a chunk boundary, a 16-byte tail)
ADC_M = sorted({d // 8 for d in WIDTHS} | {1024, 96, 219, 220, 333, 1025,
                                            6, 64, 65})
#: G of the refine plans: every width's ceil(d / 5), the first global G and
#: the chip script's edge G
REFINE_G = sorted({-(-d // 5) for d in WIDTHS} | {1437, 1438, 1639, 1, 13,
                                                   3517})


def _adc_spans(plan, m: int) -> list[tuple[int, int]]:
    """Subspaces [m0, m1) of each chunk, as the kernel walks them (chunk c
    from c · subspaces, the last cut at M)."""
    return [(m0, min(m, m0 + plan.subspaces))
            for m0 in range(0, m, plan.subspaces)]


def _refine_spans(plan, g: int) -> list[tuple[int, int]]:
    """Passes [p0, p1) of each chunk, as the kernel walks them."""
    total = ops.row_passes(g)
    return [(p0, min(total, p0 + plan.passes))
            for p0 in range(0, total, plan.passes)]


def _refine_columns(plan, g: int) -> list[tuple[int, int]]:
    """Table columns [c0, c1) the kernel stages for each chunk: from
    160 p0, ``plan.width`` of them, within the table's width."""
    return [(160 * p0, min(ops.table_width(g), 160 * p0 + plan.width))
            for p0, _ in _refine_spans(plan, g)]


@pytest.mark.parametrize("m", ADC_M)
def test_adc_plan_covers_every_subspace_once(m):
    plan = ops.adc_plan(m, 256)
    spans = _adc_spans(plan, m)
    assert len(spans) == plan.chunks
    assert [s for a, b in spans for s in range(a, b)] == list(range(m))
    assert all(b - a == plan.subspaces for a, b in spans[:-1])
    assert 0 < spans[-1][1] - spans[-1][0] <= plan.subspaces
    # every chunk but a lone one starts a 16-byte load of a code row; a
    # row's chunk fits the kernel's 64-byte register chunk (kRing)
    if plan.chunks > 1:
        assert plan.subspaces % 16 == 0
    assert plan.subspaces <= 64
    buffers = 2 if plan.chunks > 1 else 1
    assert plan.smem_bytes == buffers * plan.subspaces * 256 * 4 \
        + 4096 * 2 + 16 * 4
    assert plan.smem_bytes <= ops.SMEM_LIMIT_BYTES


def test_adc_plan_at_the_wide_shapes():
    """M = 1024 and 256 (K = 256): 16 and 4 chunks of 64 subspaces, two
    buffers of 64 KiB beside the list and the counts; a plan that cannot
    fit a block raises."""
    assert ops.adc_plan(1024, 256) == ops.AdcPlan(64, 16, 139_328)
    assert ops.adc_plan(256, 256) == ops.AdcPlan(64, 4, 139_328)
    assert _adc_spans(ops.adc_plan(96, 256), 96) == [(0, 64), (64, 96)]
    assert ops.adc_plan(1024, 16).smem_bytes == 2 * 64 * 16 * 4 + 8256
    with pytest.raises(ops.SharedMemoryBudgetError, match="pq_adc"):
        ops.adc_plan(1024, 512)


def _row_dot_columns(g: int, p: int, off: int) -> set[int]:
    """Table columns ``row_dot`` reads in pass p of a row whose first byte
    is byte ``off`` of its word: each lane's words base + sub + 8 s
    (clamped to the row's last word), every byte j of a word in column
    4 w + 4 − off + j; none if the row ends before the pass."""
    last = (off + g - 1) >> 2
    base = 40 * p
    if base > last:
        return set()
    return {4 * min(base + w, last) + 4 - off + j
            for w in range(40) for j in range(4)}


@pytest.mark.parametrize("g", REFINE_G)
def test_refine_plan_stages_every_column_row_dot_reads(g):
    plan = ops.refine_plan(g)
    total = ops.row_passes(g)
    spans = _refine_spans(plan, g)
    assert len(spans) == plan.chunks
    # whole passes, in order, each once
    assert [p for a, b in spans for p in range(a, b)] == list(range(total))
    assert all(b - a == plan.passes for a, b in spans[:-1])
    assert 1 <= plan.passes <= total
    # every pass a row reaches at some byte offset
    assert max(p for p in range(total) for off in range(4)
               if _row_dot_columns(g, p, off)) == total - 1
    for (p0, p1), (c0, c1) in zip(spans, _refine_columns(plan, g)):
        assert c0 == 160 * p0 and c1 - c0 <= plan.width
        assert c1 <= ops.table_width(g) and (c1 - c0) % 4 == 0
        for p in range(p0, p1):
            for off in range(4):
                cols = _row_dot_columns(g, p, off)
                assert not cols or (c0 <= min(cols) and max(cols) < c1), \
                    (g, p, off)
    assert plan.width == ops.chunk_width(plan.passes)
    assert plan.width % 32 == 0
    assert plan.smem_bytes == 37 * plan.width * 4 + 1024 * 8 * 4
    assert plan.smem_bytes <= ops.SMEM_LIMIT_BYTES


def test_refine_plan_at_the_wide_width():
    """G = 1639 (D = 8192): 11 passes in 4 chunks of 3 (the last 2), 512
    columns a chunk and 32 KB of partial sums, 108,544 B: two blocks on an
    SM's 228 KB, where 4 passes a chunk (132,224 B) would leave one."""
    plan = ops.refine_plan(1639)
    assert plan == ops.RefinePlan(passes=3, chunks=4, width=512,
                                  smem_bytes=108_544)
    assert _refine_spans(plan, 1639) == [(0, 3), (3, 6), (6, 9), (9, 11)]
    assert ops.refine_chunk_bytes(4) == 132_224
    assert 2 * (plan.smem_bytes + 1024) <= 233_472 < 2 * (132_224 + 1024)
    # one pass: a single chunk of the whole (narrow) row
    assert ops.refine_plan(154) == ops.RefinePlan(1, 1, 192, 61_184)


def test_launched_plan_checks_the_launch():
    """The wrappers record a global launch's plan only if the launch asked
    for the plan's shared memory; a CPU call launches nothing."""
    plan = ops.adc_plan(1024, 256)
    assert ops.launched_plan("pq_adc", plan, plan.smem_bytes) is plan
    with pytest.raises(RuntimeError, match="plan"):
        ops.launched_plan("pq_adc", plan, plan.smem_bytes - 4)
    before = pq_adc_mod.last_plan
    codes = torch.zeros((4, 1024), dtype=torch.uint8)
    ids = torch.zeros((1, 3), dtype=torch.int32)
    out = pq_adc_mod.pq_adc(codes, ids, torch.ones((1, 3), dtype=torch.bool),
                            torch.ones((1, 1024, 256)))
    assert torch.equal(out, torch.full((1, 3), 1024.0))
    assert pq_adc_mod.last_plan is before


@pytest.mark.parametrize("levels", [1, 2, 3, 8])
@pytest.mark.parametrize("g", REFINE_G)
def test_bounds_plan_stages_every_column_row_dot_reads(g, levels):
    """The bounds kernel's global form walks the score launch's column
    chunks once per level: the same passes, columns and shared bytes at
    every L (so each chunk holds every column ``row_dot`` reads), and its
    levels."""
    plan, score = ops.bounds_plan(g, levels), ops.refine_plan(g)
    assert (plan.passes, plan.chunks, plan.width, plan.smem_bytes) == (
        score.passes, score.chunks, score.width, score.smem_bytes)
    assert plan.levels == levels
    for (p0, p1), (c0, c1) in zip(_refine_spans(plan, g),
                                  _refine_columns(plan, g)):
        for p in range(p0, p1):
            for off in range(4):
                cols = _row_dot_columns(g, p, off)
                assert not cols or (c0 <= min(cols) and max(cols) < c1)
    assert plan.smem_bytes <= ops.SMEM_LIMIT_BYTES


def test_bounds_plan_levels():
    """G = 1639: 3 passes a chunk, two blocks an SM at any L; L outside
    1 … 8 (the kernel's ``kMaxLevels``) raises."""
    assert ops.bounds_plan(1639, 1) == ops.BoundsPlan(3, 4, 512, 108_544, 1)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="levels"):
            ops.bounds_plan(1639, bad)


def _level0_row_columns(g: int, p: int, off: int) -> set[int]:
    """Pair-table columns ``level0_row`` reads in pass p of a row whose
    first byte is byte ``off`` of its word: every pass of the row's
    ``row_passes``, each lane's words 40 p + sub + 8 s unclamped (bytes
    outside the row are masked to a zero-scoring byte but still looked
    up), byte j of word w in column 4 w + 4 − off + j."""
    return {4 * (40 * p + w) + 4 - off + j
            for w in range(40) for j in range(4)}


@pytest.mark.parametrize("g", REFINE_G)
def test_level0_plan_stages_every_column_level0_row_reads(g):
    plan = ops.level0_plan(g)
    total = ops.row_passes(g)
    spans = _refine_spans(plan, g)
    assert len(spans) == plan.chunks
    assert [p for a, b in spans for p in range(a, b)] == list(range(total))
    for (p0, p1), (c0, c1) in zip(spans, _refine_columns(plan, g)):
        assert c0 == 160 * p0 and c1 - c0 <= plan.width
        assert c1 <= ops.table_width(g) and (c1 - c0) % 2 == 0
        for p in range(p0, p1):
            for off in range(4):
                cols = _level0_row_columns(g, p, off)
                assert c0 <= min(cols) and max(cols) < c1, (g, p, off)
        # a row's staged words for these passes (40 a pass) fit its slot
        # from an offset below 8
        assert 4 + 4 * 40 * (p1 - p0) <= ops.level0_slot_bytes(plan.passes)
    assert plan.width == ops.chunk_width(plan.passes)
    assert plan.smem_bytes == ops.level0_chunk_bytes(plan.passes,
                                                     plan.warps) == \
        37 * plan.width * 8 + 2 * plan.warps * 32 * (160 * plan.passes + 8)
    assert plan.smem_bytes <= ops.SMEM_LIMIT_BYTES
    # the backbones' widths (and every other) take 16 warps a block
    assert plan.warps == 16


def test_level0_plan_at_the_wide_width():
    """G = 1639: 11 passes in chunks of 1, 192 columns of pair tables
    (56,832 B) beside 16 warps' two stages of 32 × 168 B (172,032 B),
    228,864 B; 2 passes a chunk would leave room for 6 warps, 3 for 2."""
    plan = ops.level0_plan(1639)
    assert plan == ops.Level0Plan(passes=1, chunks=11, width=192, warps=16,
                                  smem_bytes=228_864)
    assert 37 * ops.chunk_width(1) * 8 == 56_832
    assert 37 * ops.chunk_width(2) * 8 == 104_192
    most = {p: max(w for w in range(1, 17)
                   if ops.level0_chunk_bytes(p, w) <= ops.SMEM_LIMIT_BYTES)
            for p in (1, 2, 3)}
    assert most == {1: 16, 2: 6, 3: 2}
