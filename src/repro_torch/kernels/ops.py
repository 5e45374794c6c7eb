"""Input assembly for the kernels, the choice of each kernel's form and the
level-0 scoring entry points.

The refine kernels read a query as 5 digit planes of (G,) floats (byte g's
digit i holds dim 5g+i), one parameter row per query, and per-record
scalars gathered by candidate id from (N, 4) tables built once per index.
They turn the planes into per-query tables of partial dot products in
shared memory (``refine_smem_bytes``, ``level0_smem_bytes``).
``refine_scores_batch`` / ``refine_scores`` keep the JAX package's
signatures (``repro.kernels.ops``): they assemble those inputs from
per-candidate arrays and run the level-0 kernel.

Each kernel has two forms.  The ``"shared"`` form keeps its per-query
state (the ADC LUT, the refine tables, the prune's staged keys) in shared
memory; where the shapes need more than a block has, the ``"global"``
form runs the same arithmetic with that state in device memory, or with
none, and gives the same bits.  ``*_form`` picks the form from the shapes
alone, before any launch; ``*_scratch_bytes`` is a global form's scratch.
The global forms of ``pq_adc``, of the fused kernel's score launch, of the
bounds kernel and of the level-0 kernel stage that state back into shared
memory a chunk at a time: the ADC LUT by chunks of subspaces
(``adc_plan``), the refine tables by column chunks of whole passes
(``refine_plan``, ``bounds_plan``), the level-0 pair tables and a warp's
code rows by the same pass chunks (``level0_plan``).  The prune's global
form keeps nothing in device memory: each block streams its slice of the
bounds once and keeps only a buffer of candidate keys below its running
kth-smallest (``PRUNE_STREAM_SMEM``, the same shared memory at every C).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.packing import POW3, TRITS_PER_BYTE
from repro_torch.device import row_sum
from repro_torch.kernels import ternary_refine as _kernels

#: shared memory one block may use on Hopper (227 KB; above 48 KB only as
#: dynamic shared memory after the opt-in attribute)
SMEM_LIMIT_BYTES = 232_448


class SharedMemoryBudgetError(ValueError):
    """A kernel's shapes need more shared memory than one block can have."""


def check_smem_budget(what: str, nbytes: int) -> int:
    """Raise ``SharedMemoryBudgetError`` unless ``nbytes`` fits one block."""
    if nbytes > SMEM_LIMIT_BYTES:
        raise SharedMemoryBudgetError(
            f"{what}: needs {nbytes} bytes of shared memory per block, over "
            f"Hopper's {SMEM_LIMIT_BYTES}-byte limit")
    return nbytes


FORMS = ("shared", "global")


def _form(nbytes: int) -> str:
    """The shared form where its ``nbytes`` fit one block, else global."""
    return "shared" if nbytes <= SMEM_LIMIT_BYTES else "global"


def pick_form(what: str, form: str, forced: str | None) -> str:
    """``form``, the one the shapes select, unless a caller that holds the
    two forms against each other names one (``forced``); the shared form
    only where it fits."""
    if forced is None:
        return form
    if forced not in FORMS:
        raise ValueError(f"{what}: form {forced!r} is not one of {FORMS}")
    if forced == "shared" and form != "shared":
        raise SharedMemoryBudgetError(
            f"{what}: the shared form does not fit these shapes")
    return forced


#: slots per block and warps per block of the ADC kernel (kTile and kWarps
#: in ``csrc/pq_adc.cu``)
_ADC_TILE, _ADC_WARPS = 4096, 16


def adc_smem_bytes(m: int, k: int) -> int:
    """The ADC kernel holds one query's (M, K) f32 LUT, its tile's list of
    valid slot offsets (uint16 each) and one valid count per warp."""
    return m * k * 4 + _ADC_TILE * 2 + _ADC_WARPS * 4


def adc_form(m: int, k: int) -> str:
    """``"shared"`` where the LUT fits a block (M ≤ 218 at K = 256), else
    ``"global"``: the caller's (Q, M, K) LUT staged in chunks
    (``adc_plan``), so the global form needs no scratch."""
    return _form(adc_smem_bytes(m, k))


#: the subspaces of one LUT chunk of the ADC kernel's global form (kRing
#: in the source: a thread holds two rows' chunks of this many bytes, and
#: the next two, in registers)
_ADC_RING_SUBSPACES = 64


@dataclass(frozen=True)
class AdcPlan:
    """How the ADC kernel's global form stages one query's LUT: chunks of
    ``subspaces`` subspaces (the last may have fewer), two buffers of
    (subspaces, K) f32 in turn where there are several chunks."""

    subspaces: int
    chunks: int
    smem_bytes: int


def adc_plan(m: int, k: int) -> AdcPlan:
    """The global form's LUT chunks at M, K: 64 subspaces a chunk (a
    multiple of 16, so each chunk starts a 16-byte load of a code row), or
    M where M ≤ 64.  Its shared memory (the buffers, the list and the
    counts: 139,328 B at K = 256) must fit a block, else
    ``SharedMemoryBudgetError``."""
    mc = min(m, _ADC_RING_SUBSPACES)
    buffers = 2 if mc < m else 1
    nbytes = buffers * mc * k * 4 + _ADC_TILE * 2 + _ADC_WARPS * 4
    check_smem_budget(f"pq_adc global form at M={m} K={k}", nbytes)
    return AdcPlan(subspaces=mc, chunks=-(-m // mc), smem_bytes=nbytes)


#: 32-bit words a lane group of the multi-level kernels reads per pass
#: over a code row (8 lanes × 5; kPassWords in the source)
_PASS_WORDS = 40


def row_passes(g: int) -> int:
    """Passes of ``_PASS_WORDS`` words that cover a row of g bytes at any
    byte alignment (row_passes in the source)."""
    return -(-((g + 6) // 4) // _PASS_WORDS)


def table_width(g: int) -> int:
    """Columns of the refine kernels' partial-dot tables: byte g sits in
    column g + 4, after 4 zero columns for the lead bytes of a row's first
    aligned word and before zero columns up to the last column the row's
    passes address (4 per word + 4), rounded up to 32 banks."""
    return -(-(4 * _PASS_WORDS * row_passes(g) + 4) // 32) * 32


def refine_smem_bytes(g: int) -> int:
    """The refine kernels (fused, bounds and level 0) hold one query's f32
    tables T27 (27 rows: digits 0-2 of a byte) and T9 (10 rows: digits 3-4
    of y / 27, row 9 for byte values 243-255), each ``table_width`` wide;
    the planes are read from device memory while building them."""
    return (27 + 10) * table_width(g) * 4


def refine_form(g: int) -> str:
    """The fused and bounds kernels' form: ``"shared"`` up to G = 1437,
    else ``"global"`` (a small kernel writes each query's tables once per
    call to scratch; the fused kernel's score launch and the bounds kernel
    stage them back a column chunk at a time, ``refine_plan`` and
    ``bounds_plan``)."""
    return _form(refine_smem_bytes(g))


def refine_scratch_bytes(q: int, g: int) -> int:
    """The global form's scratch: Q queries' tables, ``refine_smem_bytes``
    each."""
    return q * refine_smem_bytes(g)


#: table columns one pass of a row spans (4 per word), the score kernel's
#: slots per block and lanes per candidate (kSlotTile and kGroup)
_PASS_COLS, _SLOT_TILE, _GROUP = 4 * _PASS_WORDS, 1024, 8
#: the chunked score kernel's per-lane partial sums: one f32 per lane of
#: every candidate a block may score
_PARTIAL_BYTES = _SLOT_TILE * _GROUP * 4
#: shared memory of one SM, of which the runtime keeps 1 KB per block, and
#: the blocks of the chunked score kernel an SM is to hold
_SM_SMEM_BYTES, _BLOCK_RESERVED, _SCORE_BLOCKS = 233_472, 1024, 2
#: most passes of a chunk: a row's words for all of them are loaded at once
#: (kSpanPasses in the source)
_SPAN_PASSES = 3


def chunk_width(passes: int) -> int:
    """Table columns staged for a chunk of ``passes`` passes: the passes'
    160 columns each and the 4 that a word's offset shifts a row's bytes
    by, rounded up to 32 banks (chunk_width in the source)."""
    return -(-(_PASS_COLS * passes + 4) // 32) * 32


def refine_chunk_bytes(passes: int) -> int:
    """Shared memory of the chunked score kernel: T27 and T9 over
    ``chunk_width(passes)`` columns and the partial sums."""
    return (27 + 10) * chunk_width(passes) * 4 + _PARTIAL_BYTES


@dataclass(frozen=True)
class RefinePlan:
    """How the fused kernel's global score launch stages one query's
    tables: chunks of ``passes`` whole passes (the last may have fewer),
    each chunk's columns [160 p0, 160 p0 + ``width``) of the 37 rows."""

    passes: int
    chunks: int
    width: int
    smem_bytes: int


def _most_passes(g: int, fits) -> int:
    """The most passes a chunk for which ``fits(passes)`` holds, at least 1
    and at most the row's passes and ``_SPAN_PASSES``."""
    p = 1
    while p < min(row_passes(g), _SPAN_PASSES) and fits(p + 1):
        p += 1
    return p


def refine_plan(g: int) -> RefinePlan:
    """The fused kernel's global-form chunks at width g: as many passes a
    chunk as keep two blocks on an SM (3 at G = 1639: 4 chunks, 108,544
    B), at least 1 and at most the row's passes and ``_SPAN_PASSES``.
    Raises ``SharedMemoryBudgetError`` if even one pass does not fit a
    block."""
    room = _SM_SMEM_BYTES // _SCORE_BLOCKS - _BLOCK_RESERVED
    p = _most_passes(g, lambda n: refine_chunk_bytes(n) <= room)
    nbytes = check_smem_budget(f"ternary_refine_fused global form at G={g}",
                               refine_chunk_bytes(p))
    return RefinePlan(passes=p, chunks=-(-row_passes(g) // p),
                      width=chunk_width(p), smem_bytes=nbytes)


@dataclass(frozen=True)
class BoundsPlan:
    """How the bounds kernel's global form stages one query's tables: the
    fused score launch's column chunks (``refine_plan``), walked once per
    level for each tile of slots (``levels`` times), each slot's running
    estimate carried from level to level in the kernel's est output."""

    passes: int
    chunks: int
    width: int
    smem_bytes: int
    levels: int


def bounds_plan(g: int, levels: int) -> BoundsPlan:
    """The bounds kernel's global-form chunks at width g and L levels: the
    score launch's (3 passes a chunk at G = 1639, 108,544 B, two blocks an
    SM) at every L, since a level's chunks need the same shared memory.
    Raises ``ValueError`` outside 1 ≤ L ≤ the kernel's levels."""
    if not 1 <= levels <= _kernels.MAX_LEVELS:
        raise ValueError(f"bounds_plan: {levels} levels outside [1, "
                         f"{_kernels.MAX_LEVELS}]")
    plan = refine_plan(g)
    return BoundsPlan(passes=plan.passes, chunks=plan.chunks,
                      width=plan.width, smem_bytes=plan.smem_bytes,
                      levels=levels)


def launched_plan(what: str, plan, nbytes: int):
    """``plan`` once a launch has asked for ``nbytes`` of shared memory,
    which must be the plan's (the source sizes its buffers on its own)."""
    if nbytes != plan.smem_bytes:
        raise RuntimeError(f"{what}: the launch took {nbytes} bytes of "
                           f"shared memory, its plan {plan.smem_bytes}")
    return plan


#: slots of a level-0 warp's chunk and most warps of a level-0 block
#: (kL0Rows and kL0MaxWarps in the source)
_L0_ROWS, _L0_MAX_WARPS = 32, 16


def level0_table_bytes(g: int) -> int:
    """The level-0 kernel's T27 and T9 tables: ``refine_smem_bytes``'s, each
    entry a pair (partial dot f32, nonzero trits int32)."""
    return 2 * refine_smem_bytes(g)


def level0_stage_bytes(g: int) -> int:
    """One level-0 warp's stage in the shared form: its chunk's 32 whole
    code rows at an offset below 16 with room for the words the last row's
    passes read past them, rounded up to 16."""
    return (_L0_ROWS * g + 4 * _PASS_WORDS * row_passes(g) + 16 + 15) \
        // 16 * 16


def level0_warps(g: int) -> int:
    """Warps of a level-0 block in the shared form: as many
    double-buffered stages as fit beside the tables, at most 16 (below 1:
    the shared form does not fit; 2 at G = 410)."""
    room = SMEM_LIMIT_BYTES - level0_table_bytes(g)
    return min(_L0_MAX_WARPS, room // (2 * level0_stage_bytes(g)))


def level0_smem_bytes(g: int) -> int:
    """The level-0 kernel's shared form holds one query's pair tables
    (``level0_table_bytes``) and two stages per warp (``level0_warps``, at
    least one): 220,160 B with 16 warps at G = 154.  Past G = 503 even one
    warp does not fit beside the tables, and the global form
    (``level0_plan``) runs."""
    return (level0_table_bytes(g)
            + 2 * max(1, level0_warps(g)) * level0_stage_bytes(g))


def level0_form(g: int) -> str:
    """``"shared"`` where the pair tables and one warp's two stages fit a
    block (G ≤ 503), else ``"global"``: the pair tables in scratch
    (``pair_tables_kernel``), staged back with each warp's code rows by
    chunks of whole passes (``level0_plan``), which fit at every G."""
    return "shared" if level0_warps(g) >= 1 else "global"


#: bytes a code row's staged words may start past an 8-byte boundary (the
#: level-0 global form copies them 8 bytes at a time; kL0Slack)
_L0_SLACK = 8


def level0_slot_bytes(passes: int) -> int:
    """One code row's slot in a level-0 global-form stage: its words for a
    chunk of ``passes`` passes (160 bytes a pass) from an offset below 8
    (level0_slot in the source)."""
    return 4 * _PASS_WORDS * passes + _L0_SLACK


def level0_chunk_bytes(passes: int, warps: int) -> int:
    """Shared memory of the level-0 global form: the pair tables over
    ``chunk_width(passes)`` columns (8 bytes an entry) and two stages of 32
    row slots per warp."""
    return (27 + 10) * chunk_width(passes) * 8 \
        + 2 * warps * _L0_ROWS * level0_slot_bytes(passes)


@dataclass(frozen=True)
class Level0Plan:
    """How the level-0 kernel's global form stages one query's pair tables
    and each warp's 32 code rows: chunks of ``passes`` whole passes (the
    last may have fewer), each chunk's columns [160 p0, 160 p0 + ``width``)
    of the 37 rows beside two stages a warp of the rows' words for those
    passes, ``warps`` warps a block."""

    passes: int
    chunks: int
    width: int
    warps: int
    smem_bytes: int


def level0_plan(g: int) -> Level0Plan:
    """The level-0 global form's chunks at width g: the most warps (16),
    then the most passes a chunk that keep them (1 at every G: 192 columns
    and 16 x 2 stages of 32 x 168 B, 228,864 B).  Its shared memory does
    not grow with G, so every width has a plan."""
    warps = _L0_MAX_WARPS
    p = _most_passes(g, lambda n: level0_chunk_bytes(n, warps)
                     <= SMEM_LIMIT_BYTES)
    nbytes = check_smem_budget(f"level0 global form at G={g}",
                               level0_chunk_bytes(p, warps))
    return Level0Plan(passes=p, chunks=-(-row_passes(g) // p),
                      width=chunk_width(p), warps=warps, smem_bytes=nbytes)


def level0_scratch_bytes(q: int, g: int) -> int:
    """The global form's scratch: Q queries' pair tables."""
    return q * level0_table_bytes(g)


#: blocks per query in the prune's cluster, and its static shared memory
#: (kPruneCluster and sizeof(PruneShared) in the source)
_PRUNE_CLUSTER, _PRUNE_STATIC = 8, 2224
#: the prune's global form's dynamic shared memory, the same at every C:
#: two stages of a 4096-slot tile's hi (32,768 B), a 4352-key candidate
#: buffer, the compaction's kMaxK = 64 keys and its count (kPruneStages,
#: kPruneTile, kPruneBuf and kMaxK in the source): 50,448 B, four blocks an
#: SM beside the static 2,224 B
PRUNE_STREAM_SMEM = 2 * 4096 * 4 + (4352 + 64 + 4) * 4
check_smem_budget("prune global form", PRUNE_STREAM_SMEM + _PRUNE_STATIC)


def prune_smem_bytes(c: int) -> int:
    """The prune's shared form holds each block's slice of ceil(C / 8)
    slots, rounded up to 32, as one uint32 key and one alive bit per slot,
    beside its digit counts and reduction scratch: C up to 8 × 55,808 =
    446,464 fits."""
    span = (-(-c // _PRUNE_CLUSTER) + 31) // 32 * 32
    return span * 4 + span // 8 + _PRUNE_STATIC


def prune_form(c: int) -> str:
    """``"shared"`` up to C = 446,464, else ``"global"``: each block
    streams its slice once and keeps only candidate keys
    (``PRUNE_STREAM_SMEM`` of shared memory), at any C."""
    return _form(prune_smem_bytes(c))


def make_query_planes(q: torch.Tensor, g: int) -> torch.Tensor:
    """q (Q, D) → digit planes (Q, 5, G)."""
    pad = g * TRITS_PER_BYTE - q.shape[-1]
    qp = torch.nn.functional.pad(q.float(), (0, pad))
    return qp.reshape(q.shape[0], g, TRITS_PER_BYTE).transpose(1, 2) \
        .contiguous()


def query_params(q: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 resid_std: torch.Tensor, z: float) -> torch.Tensor:
    """(Q, 8) f32 rows [||q||, w0..w3, bias, z·resid_std, resid_std]."""
    nq = q.shape[0]
    rs = resid_std.float().reshape(1)
    qf = q.float()
    head = torch.sqrt(row_sum(qf * qf))[:, None]   # the same bits in any Q
    tail = torch.cat([w.float(), bias.float().reshape(1), z * rs, rs])
    return torch.cat([head, tail.expand(nq, 7)], dim=1).contiguous()


def record_table(scalars) -> torch.Tensor:
    """(N, 4) f32 [||δ||², ⟨x_c,δ⟩, ||δ||, rho] from ``RecordScalars``."""
    return torch.stack([scalars.delta_sq, scalars.cross, scalars.norm,
                        scalars.rho], dim=1).float().contiguous()


#: nonzero trits of each byte value 0..255, the five low trits as the TPU
#: kernels decode them (a byte y >= 243 counts as y - 243)
_NONZERO = tuple(sum((y // p) % 3 != 1 for p in POW3) for y in range(256))
#: code rows per step of ``sqrt_nonzero`` (bounds its int64 index copy)
_COUNT_ROWS = 1 << 16


def sqrt_nonzero(packed: torch.Tensor) -> torch.Tensor:
    """(N,) f32 √max(k, 1) of packed codes (N, G), k a row's nonzero trits:
    the divisor of align = Σ c·q / √k, as the kernels round it
    (``sqrtf(fmaxf((float)k, 1.f))``)."""
    lut = torch.tensor(_NONZERO, dtype=torch.int32, device=packed.device)
    k = torch.cat([lut[part.long()].sum(-1)
                   for part in packed.split(_COUNT_ROWS)])
    return torch.sqrt(torch.clamp(k.float(), min=1.0))


def level_table(level) -> torch.Tensor:
    """(N, 4) f32 [proj, norm, rho, √max(k, 1)] from a ``TRQLevel``, k the
    nonzero trits of each code row (``sqrt_nonzero``)."""
    return torch.stack([level.proj.float(), level.norm.float(),
                        level.rho.float(), sqrt_nonzero(level.packed)],
                       dim=1).contiguous()


def level0_inputs(q, g, d0, delta_sq, cross, norm, rho, w, bias):
    """Planes (Q, 5, G), params (Q, 8) [||q||, w0..w3, bias, 0, 0] and
    scalars (Q, C, 5) [d0, ||δ||², ⟨x_c,δ⟩, ||δ||, rho]."""
    # a zero resid_std leaves the two trailing parameters 0
    params = query_params(q, w, bias, torch.zeros(1, device=q.device), 0.0)
    scalars = torch.stack([d0, delta_sq, cross, norm, rho], dim=-1)
    return make_query_planes(q, g), params, scalars.float().contiguous()


def refine_scores_batch(packed: torch.Tensor, q: torch.Tensor,
                        d0: torch.Tensor, delta_sq: torch.Tensor,
                        cross: torch.Tensor, norm: torch.Tensor,
                        rho: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """Level-0 refine of a query micro-batch → (Q, C, 3) [est, est_raw,
    margin].  packed (Q, C, G) per-query gathered codes, q (Q, D), the
    per-record scalars (Q, C); calibration w (4,) and bias are shared."""
    g = packed.shape[-1]
    planes, params, scalars = level0_inputs(q, g, d0, delta_sq, cross,
                                             norm, rho, w, bias)
    return _kernels.ternary_refine_batch(packed.contiguous(), planes,
                                         scalars, params)


def refine_scores(packed: torch.Tensor, q: torch.Tensor, d0: torch.Tensor,
                  delta_sq: torch.Tensor, cross: torch.Tensor,
                  norm: torch.Tensor, rho: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """``refine_scores_batch`` for one query: packed (C, G), q (D,), the
    scalars (C,) → (C, 3)."""
    g = packed.shape[-1]
    planes, params, scalars = level0_inputs(
        q.reshape(1, -1), g, d0, delta_sq, cross, norm, rho, w, bias)
    return _kernels.ternary_refine(packed.contiguous(), planes[0], scalars,
                                   params)
