// FaTRQ refinement scoring over a query micro-batch: the multi-level kernel
// with on-card pruning, its bounds-emitting form for the sharded layout, and
// the level-0 scoring kernel over gathered code rows.
//
// The two multi-level entry points (fatrq_refine_level, fatrq_refine_bounds)
// share their per-candidate device code (load_tables, chunk_dot, level0,
// deeper), so a candidate's estimate is the same sequence of float
// operations in each; --fmad=false keeps every multiply and add rounded
// apart.
//
// fatrq_refine_level replaces src/repro/kernels/ternary_refine.py::
// ternary_refine_fused (Pallas).  The TPU kernel keeps five (C,) f32 arrays
// of one query in VMEM across all levels; at the main path's C = nprobe*cap
// ~ 46,900 that is ~940 KB, four times the 227 KB a Hopper block can have.
// So the running estimate and the certified bounds live in device memory,
// and each level runs as:
//
//  * score_kernel, grid (ceil(C/kSlotTile), Q), 1024 slots per block.  The
//    block first builds one query's partial-dot tables in shared memory
//    from its (5, G) digit planes (load_tables): T27[r][g] = the dot of
//    digits 0-2 of byte value r with dims 5g..5g+2, and T9[r][g] that of
//    digits 3-4, so a byte y scores as T27[y % 27][g] + T9[y / 27][g]: two
//    lookups and two adds instead of five multiply-adds.  The tables are
//    (27 + 10) x Gp floats (28,416 B up to G = 157), byte g in column g + 4
//    with zero columns around the row, Gp rounded up to 32 banks.  Each warp
//    then walks the tile 32 slots at a time: it reads their ids, d0 and
//    valid flags coalesced (the next 32's before it scores these), ballots
//    the valid flags, and scores only the set bits, four candidates at a
//    time on lane groups of 8 (chunk_dot).  A group reads its code row BY ID
//    from the (N, G) level store (what the far-memory tier serves; no
//    (Q, C, G) gathered copy is made) as the aligned 32-bit words that cover
//    it, all issued before any use and one round ahead (while the group
//    scores its current row); the lead and tail bytes of those words fall
//    on zero table columns.  At step b the lanes of group j look up the
//    byte whose column is = b + j (mod 4), so the warp's 32 lookups hit 32
//    banks.  Three shuffles reduce a group; the lane holding the slot takes
//    the dot, divides by the record's sqrt(max(k, 1)) (the level table's 4th
//    float, built once per index, so no trit count is taken per byte), and
//    the warp writes its 32 est / lo / hi coalesced.  An invalid slot reads
//    no code row or scalar: it takes align and its scalars as 0 (est =
//    w0*d0 + bias; deeper levels carry est with margin resid_std).
//  * prune_kernel: tau = kth-smallest hi among the alive candidates (+inf
//    when fewer than k are alive), alive &= lo <= tau, and the survivor
//    count plus its delta-page share to counts[q, level] and
//    counts[q, L + level].  A thread-block cluster of kPruneCluster = 8
//    blocks (the portable cluster size) per query, grid (8, Q): 512 blocks
//    at the main path's Q = 64, every SM busy.  Each block reads its slice
//    of ceil(C / 8) slots (rounded up to 32) once: alive_in as 16-byte
//    vectors and hi as float4 only where a vector holds an alive slot
//    (1-byte loads where C % 16 != 0 or a pointer is not 16-byte aligned),
//    keeps the slice's alive flags as bits and the alive slots' hi as
//    order-preserving uint32 keys in shared memory, compacted.  tau is the
//    kth-smallest key over the cluster, found by a radix select of 4 passes
//    of 8 bits: each block counts its keys' next digit under the prefix
//    found so far in shared memory, and after a cluster barrier every block
//    sums the 8 blocks' counts through distributed shared memory and picks
//    the digit where the running count reaches the rank still sought.
//    Every block reaches the same tau from the same counts, with no scratch
//    or atomics in device memory; a value over the multiset, so ties are
//    not ordered.  Then each block reads lo as float4 where a vector holds
//    an alive slot, writes alive_out as 16-byte vectors, and the cluster's
//    counts meet in block 0's shared memory, which stores them (and tau,
//    when asked) with plain stores.  At levels >= 1 alive_in and alive_out
//    are one buffer: a slot's flag is read by the thread that later writes
//    it, before the first cluster barrier, and written after the last.
//
//    Why this design: the first port of this step ran one block per query
//    (64 of 132 SMs), each thread inserting its slots' hi into a k-long
//    list on the stack, one dependent load at a time, then k rounds of a
//    block arg-min: bound by latency at ~4% of its bound.  The alternative, two launches
//    over (tiles, Q) merging each tile's k smallest through a (Q, tiles, k)
//    scratch, needs a second launch and a scratch buffer; the cluster does
//    the merge on chip in one launch.  Bound: bytes, 1 B of alive_in and of
//    alive_out per slot and 4 B each of hi and lo per alive slot (~13.5 MB
//    at the main path's shapes, ~0.004 ms at 3.35 TB/s).  The staged slice
//    caps this shared form at C = 8 x 55,808 = 446,464 slots per query
//    (ops.prune_smem_bytes); past it the global form below runs.
//
// Bound: device-memory bytes.  Level 0 reads per candidate slot a 4 B id,
// 4 B d0 and 1 B valid (+1 B delta flag), and per distinct record its G
// code bytes and 16 B of scalars (~0.04 ms at the main path's shapes).  The
// function needs about 2G adds per valid slot with a (G, 243) table of
// partial dot products, one lookup per byte; that table (~190 KB with its
// zero columns) leaves one block per SM and timed slower than the split
// tables here (refine_variants.py).  What sets this kernel's pace is the
// latency of each warp's chain of row loads, not bytes or operations.
//
// Every valid candidate is scored at every level, as on the TPU; only
// survivors count, so the counts equal the reference's.
//
// fatrq_refine_bounds replaces ternary_refine.py::ternary_refine_fused_bounds
// (Pallas), the sharded layout's refine: the pruning thresholds are pooled
// across shards, so the kernel applies no mask and emits every level's
// certified (lo, hi).  With no pruning nothing depends across levels but a
// candidate's running estimate, so one launch walks all L levels
// (bounds_kernel: the same tiles, tables and chunk_dot per level, est in
// the register of the lane holding the slot, codes and level scalars read
// by id from the per-level stores).  Invalid slots get est = lo = hi =
// +inf: the alive chain starts from the valid mask, so they never reach a
// threshold.  In the sharded layout most of each shard's slots are invalid
// (~92% at 4 shards of the 1M x 768 index: list padding, and lists another
// shard owns); they cost a coalesced read and write each.  Bound: bytes,
// as above, times L levels of code rows, plus the (Q, L, C) lo/hi it
// writes.
//
// fatrq_refine_level0 replaces ternary_refine.py::ternary_refine_batch and
// ternary_refine (Pallas; the second is the first with Q = 1): level-0
// est / est_raw / margin from code rows already gathered per slot, a
// (Q, C, G) tensor, and per-slot scalars (Q, C, 5).  Bound: bytes.  It reads
// every gathered row and its five scalars once and writes three floats
// per slot (~0.17 ms for the main path's 64 x 46,880 slots at G = 154).
// The first port scored one slot per warp, decoding a byte at a time and
// counting trits digit by digit, about 50 lane instructions per code byte:
// bound by issue at ~12% of the byte bound.  level0_kernel scores a byte
// with two 8-byte lookups and about 12 lane instructions: T27 and T9 as in
// chunk_dot (the same columns and partial dots, bit for bit), each entry
// paired with the nonzero trits of its digits, so the count needs no
// decode or lookup of its own (load_pair_tables: 56,832 B at G = 154).
// Each block holds one query's tables at a time and up to 16 warps (as
// many as shared memory holds: 16 at G = 154, 220,160 B, one block per
// SM).  The grid is one block per SM, each taking an equal run of the
// Q x C / 32 chunks of 32 consecutive slots (a run that crosses into the
// next query rebuilds the tables), so every SM is busy at Q = 64 and at
// Q = 1.  Each warp walks its own chunks, double-buffered: a chunk's rows
// are one contiguous span of 32 G bytes, copied to the warp's stage with
// 16-byte cp.async (bytes before the first 16-byte boundary and after the
// last with byte loads, so any base or C G works) one chunk ahead of the
// one it scores.  Lane groups of 8 score the rows four at a time from the
// stage as aligned words; the bytes of a word outside the row are replaced
// by 121 (every trit 0), which scores and counts 0.  The 8 rounds' partial
// sums of a group meet in one reduce-scatter, lane i takes slot i's dot
// and count and its five scalars (read from device memory while the rows
// are scored), and the warp writes the chunk's 3 x 32 outputs as three
// coalesced spans.  What sets its pace is the shared-memory pipe: 85
// lookup wavefronts per 4 rows of a warp (refine_variants.py).  A byte
// y >= 243 scores and counts as y - 243, as the TPU kernels decode it.
//
// Global forms.  Every kernel above keeps some per-query state in shared
// memory, which caps its shapes: the multi-level tables at G = 1437, the
// prune's staged slice at C = 446,464, the level-0 pair tables beside one
// warp's two stages at G = 503.  Past those (the JAX package indexes any
// width: G = 1639 at D = 8192) each runs a global form, picked by the host
// from the shapes alone before the launch (ops.refine_form, prune_form,
// level0_form), a template flag, kGlobal, and gives the shared form's
// bits.  The refine and level-0 global forms keep that state in a device
// scratch buffer the wrapper allocates and stage it back into shared
// memory a chunk at a time where the kernel looks it up (the chunk plan
// comes from the host, and the launch reports its shared bytes, which must
// be the plan's); the prune's global form keeps no per-slot state at all:
//
//  * tables_kernel writes each query's T27/T9 tables once per call with
//    load_tables into a (Q, 37, Gp) f32 buffer (pair_tables_kernel the
//    level-0 pair tables into a (Q, 37, Gp) float2 one).  The fused call
//    and the bounds call build them once for all of their levels.
//  * score_kernel<true> (score_chunked) stages those tables back into
//    shared memory by column chunks of P whole passes (ops.refine_plan: the
//    most passes, at most kSpanPasses = 3, that keep two blocks on an SM;
//    P = 3 and 4 chunks at G = 1639, 108,544 B a block).  A chunk holds the
//    37 rows over columns [160 p0, 160 p0 + chunk_width(P)): its passes'
//    160 columns each and the 3 that a word's offset shifts into, which are
//    the only columns row_dot addresses for those passes at any offset,
//    copied from the scratch with 16-byte cp.async.  For each chunk every
//    warp walks its slots as the shared form does (the same ballot, so the
//    same rows on the same lane groups in the same rounds), scores only the
//    chunk's passes of each valid row (row_dot_span) and carries each
//    lane's partial sum to the next chunk in shared memory (one f32 per
//    lane of every candidate of the tile, 32 KB).  A lane's partial is
//    row_dot's sequence of adds cut at pass boundaries, so after the last
//    chunk the three shuffles reduce the same floats to the same dot; only
//    then are level0 / deeper and the outputs taken.
//
//    The lookups now cost no L1/L2 trip, so each group's chain of row loads
//    sets the pace: a group loads all of a row's words for the chunk at
//    once (load_span, 15 a lane at P = 3), and its next row's before it
//    scores the current one, across the warp's 32-slot steps and across a
//    chunk's barrier (step_dot: one stream of rows a warp).  128 registers
//    and 108,544 B hold two blocks (16 warps) an SM; 3 passes a chunk time
//    faster than 2 and 1 (wide_variants.py).  Copying the tables (265,216 B
//    a query at G = 1639) rather than building them in each block keeps
//    the block's issue slots for the lookups: 74 blocks a query would each
//    rebuild them.
//  * bounds_kernel<true> runs score_chunked<true> once per level of the
//    tile: each level stages the tables' chunks again (they are the same
//    for every level: L stagings a tile, from L2) and writes its lo / hi
//    row of the (Q, L, C) outputs, +inf on invalid slots.  A slot's running
//    estimate goes from level to level through the est output, written and
//    read back by the one thread that holds the slot at every level, so the
//    shared memory (and two blocks an SM) is the score launch's at any L
//    (ops.bounds_plan).  At each level the adds are chunk_dot's cut at pass
//    boundaries and level0 / deeper take the same floats as the shared
//    form, so lo, hi and est are bounds_kernel<false>'s bit for bit.  The
//    other design, all levels inside each chunk, would keep L partials a
//    lane: 32 KB x L of shared memory.
//  * level0_kernel<..., true> (level0_chunked) stages the pair tables and
//    each warp's code rows by the same pass chunks (ops.level0_plan: 1 pass
//    a chunk, 16 warps a block at every G, 228,864 B): a block walks its
//    run of one query's 32-slot chunks in tiles of one chunk a warp; for
//    each chunk of passes it copies the tables' 37 x chunk_width(P) float2
//    columns (56,832 B at P = 1) from the scratch, while each warp copies
//    its chunk's 32 rows' words for those passes (160 B a pass) into one of
//    its two stages with 8-byte cp.async (stage_rows: a row's slot starts
//    at its first word's offset mod 8; a unit holding the chunk's first or
//    last byte is copied byte by byte, so any base works), one step ahead.
//    A lane's 8 (dot, count) partials stay in registers from chunk to
//    chunk, the adds of level0_row cut at pass boundaries (level0_span), so
//    after the last chunk the reduce-scatter, the holder shuffle, level0
//    and the three coalesced output spans give the shared form's bits.
//    The shared memory does not grow with G, so the kernel takes any width.
//    The tile is one chunk a warp because a longer one would keep the
//    partials in shared memory (1 KB a chunk of 32 rows), which 16 warps'
//    stages leave no room for; each tile restages the whole table from L2
//    (11 x 56,832 B at G = 1639, with the columns the chunks share) for
//    16 x 32 rows (839,168 B of codes).
//  * prune_kernel<true> streams each block's slice once, in tiles of
//    4096 slots (prune_stream), and keeps only a candidate filter in
//    shared memory: a key buffer of kPruneBuf = 4352 keys, and theta, the
//    block's running kth-smallest key.  A key below theta joins the
//    buffer; a key at or above it cannot be among the slice's k smallest
//    and is dropped.  When the buffer may not hold the next tile's keys,
//    a block-local radix select (block_kth: the cluster select's 4 passes
//    over this block's counts) keeps its k smallest and lowers theta to
//    their kth.  The kth-smallest of a multiset is the kth-smallest of the
//    union of each part's k smallest, so the cluster's select over the 8
//    buffers gives the shared form's tau, and the union holds fewer than
//    k keys only where fewer than k slots are alive.  alive_in is read as
//    16-byte vectors a tile ahead in registers, hi as float4 only where a
//    vector holds an alive slot, copied by cp.async into two stages a tile
//    ahead of the keys it yields (walk_tiles); the mask phase walks the
//    slice again the same way, alive_in read again and lo staged as hi
//    was (a thread reads a unit's flags, and the next tile's, before it
//    writes the unit), so the shared memory (50,448 B,
//    ops.PRUNE_STREAM_SMEM) is the same at every C, nothing is staged in
//    device memory, and four blocks fit an SM.  With slots in random
//    order theta falls fast (after the first tile ~k of every n keys
//    pass), so a block compacts once or twice; with hi falling along the
//    slice every key passes and every tile compacts.  Bound: bytes, as
//    the shared form's.  Staging the slice's keys in device memory
//    instead would read them back in each of the 4 radix passes (~198 MB
//    a micro-batch at Q = 64, C = 750,080, four times the L2).

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kScoreThreads = 256;  // 8 warps
constexpr int kSlotTile = 1024;     // slots per multi-level scoring block
constexpr int kPruneCluster = 8;    // blocks per query in the prune
constexpr int kPruneThreads = 256;
constexpr int kPruneWarps = kPruneThreads / 32;
constexpr int kRadixBins = 256;     // 8-bit digits, 4 passes
constexpr int kMaxK = 64;           // largest top-k the pruning step keeps
// the prune's global form: a thread's 16-slot unit of a tile, the tile's
// slots, its stages of hi, and the keys the block's buffer holds (a
// tile's beside those kept)
constexpr int kPruneUnit = 16;
constexpr int kPruneTile = kPruneThreads * kPruneUnit;
constexpr int kPruneStages = 2;
constexpr int kPruneBuf = kPruneTile + 256;
constexpr int kMaxLevels = 8;       // levels the bounds kernel walks
constexpr int kGroup = 8;           // lanes scoring one candidate
constexpr int kWords = 5;           // code words a lane loads before use
constexpr int kT9Rows = 10;         // T9 rows: y / 27 for y in 0..255
constexpr unsigned kFull = 0xffffffffu;

struct LevelStores {
  const uint8_t* packed[kMaxLevels];  // per level (N, G)
  const float4* lvl[kMaxLevels];  // per level (N,) [proj, norm, rho, sqrt k]
};

struct Level0 {
  float est, raw, margin;
};

// One query's parameter row [||q||, w0..w3, bias, z * resid_std,
// resid_std], held in registers for a whole block.
struct Params {
  float qn, w0, w1, w2, w3, bias, zr, rs;
};

__device__ __forceinline__ Params load_params(const float* p) {
  return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
}

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// Level 0 (the TPU kernels' _score_block): record scalars ||d||^2,
// <x_c,d>, ||d||, rho and the coarse distance dz.
__device__ __forceinline__ Level0 level0(float align, const Params& p,
                                         float dz, float dsq, float cross,
                                         float norm, float rho) {
  const float e_align = align / fmaxf(p.qn, 1e-30f);
  const float d_ip = -2.f * norm * rho * align;
  Level0 r;
  r.est = p.w0 * dz + p.w1 * d_ip + p.w2 * dsq + p.w3 * cross + p.bias;
  r.raw = dz + dsq + 2.f * cross + d_ip;
  r.margin = 2.f * p.qn * norm * sqrtf(clamp01(1.f - e_align * e_align)) *
             sqrtf(clamp01(1.f - rho * rho));
  return r;
}

// Level 0's certified interval.
__device__ __forceinline__ void level0_bounds(const Level0& r,
                                              const Params& p, int quantile,
                                              float* l, float* h) {
  if (quantile) {
    *l = r.est - p.zr;
    *h = r.est + p.zr;
  } else {
    *l = r.raw - r.margin;
    *h = r.raw + r.margin;
  }
}

// Level l >= 1: est -= 2 proj align, margin 2 ||q|| ||d_rem|| + resid_std.
__device__ __forceinline__ float deeper(float est, float align, float4 v,
                                        const Params& p, float* l, float* h) {
  const float e = est - 2.f * v.x * align;
  const float rem = v.y * sqrtf(clamp01(1.f - v.z * v.z));
  const float marg = 2.f * p.qn * rem + p.rs;
  *l = e - marg;
  *h = e + marg;
  return e;
}

// Words a lane group reads per row pass (8 lanes x kWords each), and the
// passes a row of G bytes at any byte alignment needs.
constexpr int kPassWords = kGroup * kWords;

__host__ __device__ __forceinline__ int row_passes(int G) {
  return ((G + 6) / 4 + kPassWords - 1) / kPassWords;
}

// Width of the partial-dot tables: byte g in column g + 4, zero columns
// before the row and after it up to the last column a pass can address
// (4 kPassWords per pass + 4), rounded up to 32 banks (ops.table_width in
// the Python wrapper).
__host__ __device__ __forceinline__ int table_width(int G) {
  return (4 * kPassWords * row_passes(G) + 4 + 31) / 32 * 32;
}

// One query's tables into shared memory, from its (5, G) digit planes in
// device memory: T27 (27, Gp) at s_t, T9 (kT9Rows, Gp) after it.  Row r of
// T27 holds, per byte column, d0 p0 + d1 p1 + d2 p2 for the digits
// d_i = (r / 3^i) % 3 - 1; row r of T9 holds d3 p3 + d4 p4 for the digits
// (r % 3, (r / 3) % 3) - 1.  A byte y >= 243 takes row y / 27 = 9, equal
// to row 0, so it scores as y - 243: the five low trits, as the TPU kernels
// decode it.  Ends with __syncthreads().
__device__ __forceinline__ float t27_value(int r, const float* pl) {
  return (float)(r % 3 - 1) * pl[0] + (float)(r / 3 % 3 - 1) * pl[1] +
         (float)(r / 9 - 1) * pl[2];
}

__device__ __forceinline__ float t9_value(int r, const float* pl) {
  return (float)(r % 3 - 1) * pl[3] + (float)(r / 3 % 3 - 1) * pl[4];
}

// A byte column's five plane values (0 outside the row).
__device__ __forceinline__ bool column_planes(float* pl, const float* qplanes,
                                              int G, int col) {
  const int g = col - 4;
  const bool in = g >= 0 && g < G;
#pragma unroll
  for (int i = 0; i < 5; ++i) pl[i] = in ? qplanes[i * G + g] : 0.f;
  return in;
}

__device__ __forceinline__ void load_tables(float* s_t, const float* qplanes,
                                            int G, int gp) {
  float* t9 = s_t + 27 * gp;
  for (int col = threadIdx.x; col < gp; col += blockDim.x) {
    float pl[5];
    const bool in = column_planes(pl, qplanes, G, col);
#pragma unroll
    for (int r = 0; r < 27; ++r)
      s_t[r * gp + col] = in ? t27_value(r, pl) : 0.f;
#pragma unroll
    for (int r = 0; r < kT9Rows; ++r) {
      const float v = t9_value(r, pl);
      t9[r * gp + col] = in ? v : 0.f;
    }
  }
  __syncthreads();
}

// The global form's tables: each query's, by one block, into device memory
// in load_tables' layout ((Q, 27 + kT9Rows, Gp) f32).
__global__ void tables_kernel(const float* __restrict__ qplanes,  // (Q, 5, G)
                              float* __restrict__ tables, int G) {
  const int gp = table_width(G);
  load_tables(tables + (size_t)blockIdx.x * (27 + kT9Rows) * gp,
              qplanes + (size_t)blockIdx.x * 5 * G, G, gp);
}

__device__ __forceinline__ float lds(const char* s_b, uint32_t byte_ofs) {
  return *reinterpret_cast<const float*>(s_b + byte_ofs);
}

// One code row as a lane of its group reads it: the aligned 32-bit words
// that cover the row, lane sub taking words sub, sub + 8, ... (kWords per
// pass); a word past the row's last is read as the last one again and
// falls on zero table columns.  v holds the first pass, loaded ahead of
// its use.
struct RowWords {
  const uint32_t* words;
  int off, last;  // row address mod 4; last word holding a row byte
  uint32_t v[kWords];
};

__device__ __forceinline__ void load_row(RowWords& r, const uint8_t* row,
                                         int G, int sub) {
  r.off = (int)(reinterpret_cast<uintptr_t>(row) & 3);
  r.words = reinterpret_cast<const uint32_t*>(row - r.off);
  r.last = (r.off + G - 1) >> 2;
#pragma unroll
  for (int s = 0; s < kWords; ++s)
    r.v[s] = __ldg(r.words + min(sub + kGroup * s, r.last));
}

// Sum over one row of T27[y % 27][g] + T9[y / 27][g] (= c.q) on lane sub of
// lane group grp; the caller reduces the group's partial sums.
__device__ __forceinline__ float row_dot(const RowWords& r, const char* s_b,
                                         uint32_t gp4, int grp, int sub) {
  // Byte j of word w sits in column 4w + 4 - off + j.  At step b a lane
  // takes the byte whose column is = b + grp (mod 4): the 8 lanes of a
  // group then hit 8 banks of one residue class, the 4 groups 4 classes.
  uint32_t sel[4], c27[4], c9[4];  // byte selector, byte offsets of w = sub
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = (b + grp + r.off) & 3;
    sel[b] = 0x4440u | (uint32_t)j;
    c27[b] = 4u * (uint32_t)(4 * sub + 4 - r.off + j);
    c9[b] = c27[b] + 27u * gp4;
  }
  uint32_t v[kWords];
#pragma unroll
  for (int s = 0; s < kWords; ++s) v[s] = r.v[s];
  float acc = 0.f;
  for (int base = 0;;) {
    const uint32_t pass = 16u * (uint32_t)base;
#pragma unroll
    for (int s = 0; s < kWords; ++s) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t y = __byte_perm(v[s], 0u, sel[b]);
        const uint32_t top = __umulhi(y, 159072863u);  // y / 27, y < 256
        const uint32_t col = pass + 16u * kGroup * s;
        acc += lds(s_b, y * gp4 - top * (27u * gp4) + c27[b] + col) +
               lds(s_b, top * gp4 + c9[b] + col);
      }
    }
    base += kPassWords;
    if (base > r.last) break;
#pragma unroll
    for (int s = 0; s < kWords; ++s)
      v[s] = __ldg(r.words + min(base + sub + kGroup * s, r.last));
  }
  return acc;
}

// Lane of the grp-th set bit of rest (-1 if none), and rest less its 4
// lowest set bits.
__device__ __forceinline__ int nth_bit(unsigned rest, int grp) {
  for (int i = 0; i < grp; ++i) rest &= rest - 1u;
  return __ffs(rest) - 1;
}

__device__ __forceinline__ unsigned drop4(unsigned rest) {
  for (int i = 0; i < 4; ++i) rest &= rest - 1u;
  return rest;
}

// c.q of every valid slot among a warp's 32 (lane i holds slot i's code
// row id; ballot flags the valid ones): the set bits are scored four at a
// time, the k-th of a round by lane group k, each group loading its next
// round's row before it scores this one; each dot goes back to the lane
// that holds its slot (0 in the other lanes).
__device__ __forceinline__ float chunk_dot(const uint8_t* packed, int id,
                                           unsigned ballot, const char* s_b,
                                           int G, uint32_t gp4, int lane) {
  const int grp = lane / kGroup, sub = lane % kGroup;
  const bool mine = (ballot >> lane) & 1u;
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  float dot = 0.f;
  unsigned rest = ballot;
  int src = nth_bit(rest, grp);
  RowWords cur = {};
  {
    const int cid = __shfl_sync(kFull, id, src < 0 ? 0 : src);
    if (src >= 0) load_row(cur, packed + (size_t)cid * G, G, sub);
  }
  for (int round = 0; rest != 0u; ++round) {
    const unsigned next_rest = drop4(rest);
    const int next_src = nth_bit(next_rest, grp);
    const int next_id = __shfl_sync(kFull, id, next_src < 0 ? 0 : next_src);
    RowWords next = cur;
    if (next_src >= 0) load_row(next, packed + (size_t)next_id * G, G, sub);
    float acc = src < 0 ? 0.f : row_dot(cur, s_b, gp4, grp, sub);
    acc += __shfl_xor_sync(kFull, acc, 4);
    acc += __shfl_xor_sync(kFull, acc, 2);
    acc += __shfl_xor_sync(kFull, acc, 1);
    const float got = __shfl_sync(kFull, acc, (rank & 3) * kGroup);
    if (mine && (rank >> 2) == round) dot = got;
    cur = next;
    src = next_src;
    rest = next_rest;
  }
  return dot;
}

// ---- the score launch's global form: the tables by column chunks

constexpr int kPassCols = 4 * kPassWords;  // table columns a pass spans
constexpr int kTileIters = kSlotTile / kScoreThreads;  // a warp's steps
constexpr int kSpanPasses = 3;  // most passes of a chunk (ops.refine_plan)

// Columns staged for a chunk of P passes: the passes' kPassCols each and
// the 4 that a word's offset shifts a row's bytes by, rounded up to 32 banks
// (ops.chunk_width).
__host__ __device__ __forceinline__ int chunk_width(int P) {
  return (kPassCols * P + 4 + 31) / 32 * 32;
}

// Shared memory of the chunked score kernel: T27 and T9 over
// chunk_width(P) columns, then one partial sum per lane of every candidate
// of the tile (kSlotTile x kGroup f32; ops.refine_chunk_bytes).
size_t chunk_smem(int P) {
  return ((size_t)(27 + kT9Rows) * chunk_width(P) +
          (size_t)kSlotTile * kGroup) *
         sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Columns [c0, c0 + n) of one query's 37 table rows (row stride gp in
// device memory, 16-byte aligned; n a multiple of 4) to shared memory at
// row stride gw, by the whole block as one cp.async group.
__device__ __forceinline__ void stage_tables(float* s_t, const float* tq,
                                             int gp, int gw, int c0, int n) {
  const int per_row = n / 4;
  for (int i = threadIdx.x; i < (27 + kT9Rows) * per_row; i += blockDim.x) {
    const int r = i / per_row, u = i - r * per_row;
    cp_async16(s_t + r * gw + 4 * u, tq + (size_t)r * gp + c0 + 4 * u);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One code row's words for every pass of a chunk [p0, p1), p1 - p0 <=
// kSpanPasses, as row_dot reads them (lane sub: words 40 p + sub + 8 s,
// clamped to the row's last word), all issued at once.
struct SpanWords {
  const uint32_t* words;
  int off, last;  // row address mod 4; last word holding a row byte
  uint32_t v[kSpanPasses][kWords];
};

__device__ __forceinline__ void load_span(SpanWords& r, const uint8_t* row,
                                          int G, int sub, int p0, int p1) {
  r.off = (int)(reinterpret_cast<uintptr_t>(row) & 3);
  r.words = reinterpret_cast<const uint32_t*>(row - r.off);
  r.last = (r.off + G - 1) >> 2;
#pragma unroll
  for (int i = 0; i < kSpanPasses; ++i) {
#pragma unroll
    for (int s = 0; s < kWords; ++s)
      r.v[i][s] = p0 + i < p1 ? __ldg(r.words +
                                      min(kPassWords * (p0 + i) + sub +
                                              kGroup * s,
                                          r.last))
                              : 0u;
  }
}

// row_dot over passes [p0, p1) of a row (r: their words) on tables staged
// from column kPassCols * p0 at gw4 bytes a row: sum, the lane's partial
// over the passes before p0, gets these passes' lookups added in row_dot's
// order (a pair T27 + T9 first, then onto the sum; a pass only while its
// first word is in the row, as row_dot stops), so a lane's partial after
// the row's last chunk is row_dot's, bit for bit.
__device__ __forceinline__ float row_dot_span(const SpanWords& r,
                                              const char* s_c, uint32_t gw4,
                                              int grp, int sub, int p0,
                                              int p1, float sum) {
  uint32_t pick[4], o27[4], o9[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = (b + grp + r.off) & 3;  // row_dot's bank spread
    pick[b] = 0x4440u | (uint32_t)j;
    o27[b] = 4u * (uint32_t)(4 * sub + 4 - r.off + j);
    o9[b] = o27[b] + 27u * gw4;
  }
#pragma unroll
  for (int i = 0; i < kSpanPasses; ++i) {
    if (p0 + i < p1 && kPassWords * (p0 + i) <= r.last) {
#pragma unroll
      for (int s = 0; s < kWords; ++s) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t y = __byte_perm(r.v[i][s], 0u, pick[b]);
          const uint32_t y27 = __umulhi(y, 159072863u);  // y / 27
          const uint32_t at = 16u * (uint32_t)(kPassWords * i) +
                              16u * kGroup * s;
          const float pair = lds(s_c, y * gw4 - y27 * (27u * gw4) + o27[b] +
                                          at) +
                             lds(s_c, y27 * gw4 + o9[b] + at);
          sum += pair;
        }
      }
    }
  }
  return sum;
}

// A lane group's place in the warp's stream of rows: the row it scores
// next (src: the lane holding its slot, -1 if none) and its words.
struct RowStream {
  SpanWords cur;
  int src;
};

// The group's first row of a step (passes [p0, p1)) into s.
__device__ __forceinline__ void stream_first(RowStream& s,
                                             const uint8_t* packed,
                                             unsigned ball, int id, int G,
                                             int grp, int sub, int p0,
                                             int p1) {
  s.src = nth_bit(ball, grp);
  const int cid = __shfl_sync(kFull, id, s.src < 0 ? 0 : s.src);
  if (s.src >= 0) load_span(s.cur, packed + (size_t)cid * G, G, sub, p0, p1);
}

// chunk_dot over passes [p0, p1) of one step (ball, id: its slots; s: its
// first row, loaded): the same rows on the same lane groups in the same
// rounds (the ballot fixes them), each lane's partial carried in from
// part[32 round] (p0 > 0) and, until the row's last chunk (fin), back
// there; at fin the group reduces its partials as chunk_dot does and each
// dot goes back to the lane holding its slot.  Each round loads the
// group's next row before it scores this one: in the last round, the next
// step's first row (nball, nid over [np0, np1); np0 < 0: none), so s is
// left holding it.
__device__ __forceinline__ float step_dot(RowStream& s, const uint8_t* packed,
                                          unsigned ball, int id,
                                          unsigned nball, int nid, int np0,
                                          int np1, const char* s_c, int G,
                                          uint32_t gw4, int lane, int p0,
                                          int p1, bool fin, float* part) {
  const int grp = lane / kGroup, sub = lane % kGroup;
  const bool mine = (ball >> lane) & 1u;
  const int rank = __popc(ball & ((1u << lane) - 1u));
  float dot = 0.f;
  if (ball == 0u) {  // no row here: the next step's first one
    if (np0 >= 0) stream_first(s, packed, nball, nid, G, grp, sub, np0, np1);
    return dot;
  }
  unsigned rest = ball;
  for (int round = 0; rest != 0u; ++round) {
    const unsigned next_rest = drop4(rest);
    RowStream next = s;
    if (next_rest != 0u)
      stream_first(next, packed, next_rest, id, G, grp, sub, p0, p1);
    else if (np0 >= 0)
      stream_first(next, packed, nball, nid, G, grp, sub, np0, np1);
    float acc = 0.f;
    if (s.src >= 0) {
      acc = row_dot_span(s.cur, s_c, gw4, grp, sub, p0, p1,
                         p0 > 0 ? part[32 * round] : 0.f);
      if (!fin) part[32 * round] = acc;
    }
    if (fin) {
      acc += __shfl_xor_sync(kFull, acc, 4);
      acc += __shfl_xor_sync(kFull, acc, 2);
      acc += __shfl_xor_sync(kFull, acc, 1);
      const float got = __shfl_sync(kFull, acc, (rank & 3) * kGroup);
      if (mine && (rank >> 2) == round) dot = got;
    }
    s = next;
    rest = next_rest;
  }
  return dot;
}

// A warp's view of one 32-slot chunk: slot c = c0 + lane of query q.  The
// next chunk's is loaded before the current one is scored.
struct Chunk {
  bool in, v;  // slot inside the tile; slot valid
  int id;      // code row (read for every slot inside the tile)
  float x;     // d0 (level 0) or the running est (deeper levels)
};

__device__ __forceinline__ Chunk load_chunk(const int32_t* ids,
                                            const float* xs,
                                            const uint8_t* valid,
                                            size_t row, int c, int end) {
  Chunk k;
  k.in = c < end;
  k.v = k.in && valid[row + c];
  k.id = k.in ? ids[row + c] : 0;
  k.x = k.in ? xs[row + c] : 0.f;
  return k;
}

// The tile of kSlotTile slots a block walks, 32 at a time per warp.
__device__ __forceinline__ int tile_end(int C) {
  return min(C, (int)(blockIdx.x + 1) * kSlotTile);
}

__device__ __forceinline__ int warp_first(int lane) {
  return (int)blockIdx.x * kSlotTile + (int)(threadIdx.x - lane);
}

// One level of the score launch's global form (the header's column
// chunks): chunk by chunk the block stages the chunk's table columns, then
// every warp walks its slots as the shared form does (its steps: 32 slots
// each, kTileIters of them), scoring only the chunk's passes of each valid
// row; after the last chunk it writes est / lo / hi.  A warp's rows form
// one stream over its steps and the chunks: each group loads its next row
// (the next step's first, across a chunk's barrier too) before it scores
// its current one.  kBounds: the bounds kernel's level `level` of L, lo/hi
// (Q, L, C) with +inf on invalid slots, est +inf there after the last
// level; a slot's running estimate is carried from level to level in est,
// read back by the thread that wrote it.
template <bool kBounds>
__device__ __forceinline__ void score_chunked(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ ids,
    const float* __restrict__ d0, const uint8_t* __restrict__ valid,
    const float4* __restrict__ rec, const float4* __restrict__ lvl,
    const float* __restrict__ params, float* est, float* __restrict__ lo,
    float* __restrict__ hi, const float* __restrict__ tables, int C, int G,
    int level, int L, int quantile, int P, float* s_t) {
  const int q = blockIdx.y, gp = table_width(G), gw = chunk_width(P);
  const int passes = row_passes(G);
  float* s_part = s_t + (27 + kT9Rows) * gw;  // (warp, step, round, lane)
  const float* tq = tables + (size_t)q * (27 + kT9Rows) * gp;
  const Params p = load_params(params + (size_t)q * 8);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kGroup, sub = lane % kGroup;
  const int end = tile_end(C), first = warp_first(lane);
  // the warp's steps that hold slots of the tile
  const int steps = max(0, min(kTileIters,
                               (end - first + kScoreThreads - 1) /
                                   kScoreThreads));
  const size_t row = (size_t)q * C;
  // lo / hi of this level: (Q, C), or (Q, L, C) in the bounds kernel
  const size_t orow = kBounds ? ((size_t)q * L + level) * C : row;
  const bool last = level == L - 1;
  const float* xs = level == 0 ? d0 : est;  // what a slot carries in
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const char* s_c = reinterpret_cast<const char*>(s_t);
  Chunk k = load_chunk(ids, xs, valid, row, first + lane, end);
  unsigned ball = __ballot_sync(kFull, k.v);
  RowStream rs = {};
  rs.src = -1;
  if (steps > 0) stream_first(rs, packed, ball, k.id, G, grp, sub, 0,
                              min(passes, P));
  for (int p0 = 0; p0 < passes; p0 += P) {
    const int p1 = min(passes, p0 + P);
    const bool fin = p1 == passes;
    __syncthreads();  // no warp still reads the last chunk's columns
    stage_tables(s_t, tq, gp, gw, kPassCols * p0,
                 min(gw, gp - kPassCols * p0));
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int it = 0; it < steps; ++it) {
      const int c = first + it * kScoreThreads + lane;
      // the next step: this chunk's next 32 slots, or the next chunk's first
      const bool more = it + 1 < steps;
      const int np0 = more ? p0 : fin ? -1 : p1;
      const Chunk next =
          np0 >= 0 ? load_chunk(ids, xs, valid, row,
                                more ? c + kScoreThreads : first + lane, end)
                   : k;
      const unsigned nball = np0 >= 0 ? __ballot_sync(kFull, next.v) : 0u;
      const float4 l4 = fin && k.v ? lvl[k.id] : zero;  // [proj, norm, rho,
                                                        //  sqrt k]
      const float4 r4 = fin && k.v && level == 0 ? rec[k.id] : zero;
      const float dot = step_dot(
          rs, packed, ball, k.id, nball, next.id, np0,
          min(passes, np0 + P), s_c, G, 4u * gw, lane, p0, p1, fin,
          s_part + (warp * kTileIters + it) * 8 * 32 + lane);
      if (fin && k.in) {
        const size_t slot = row + c;
        const float align = k.v ? dot / l4.w : 0.f;
        float e, l, h;
        if (level == 0) {  // r4 = [||d||^2, <x_c,d>, ||d||, rho]
          const Level0 s0 = level0(align, p, k.x, r4.x, r4.y, r4.z, r4.w);
          e = s0.est;
          level0_bounds(s0, p, quantile, &l, &h);
        } else {
          e = deeper(k.x, align, l4, p, &l, &h);
        }
        if (kBounds && !k.v) {
          l = h = INFINITY;
          if (last) e = INFINITY;
        }
        est[slot] = e;
        lo[orow + c] = l;
        hi[orow + c] = h;
      }
      k = next;
      ball = nball;
    }
  }
}

// kGlobal: the tables of the query come from device memory (tables_kernel),
// staged chunk_passes passes at a time (score_chunked).
template <bool kGlobal>
__global__ void score_kernel(const uint8_t* __restrict__ packed,   // (N, G)
                             const int32_t* __restrict__ ids,      // (Q, C)
                             const float* __restrict__ d0,         // (Q, C)
                             const uint8_t* __restrict__ valid,    // (Q, C)
                             const float* __restrict__ qplanes,    // (Q, 5, G)
                             const float4* __restrict__ rec,       // (N,)
                             const float4* __restrict__ lvl,       // (N,)
                             const float* __restrict__ params,     // (Q, 8)
                             float* est,  // (Q, C), read at deeper levels
                             float* __restrict__ lo,
                             float* __restrict__ hi,
                             const float* __restrict__ tables,  // or null
                             int C, int G, int level, int quantile,
                             int chunk_passes) {
  extern __shared__ float s_t[];  // T27 (27, Gp), T9 (kT9Rows, Gp)
  if constexpr (kGlobal) {
    score_chunked<false>(packed, ids, d0, valid, rec, lvl, params, est, lo,
                         hi, tables, C, G, level, 1, quantile, chunk_passes,
                         s_t);
  } else {
    const int q = blockIdx.y, gp = table_width(G);
    load_tables(s_t, qplanes + (size_t)q * 5 * G, G, gp);

    const Params p = load_params(params + (size_t)q * 8);
    const char* s_b = reinterpret_cast<const char*>(s_t);
    const int lane = threadIdx.x & 31, end = tile_end(C);
    const size_t row = (size_t)q * C;
    const float* xs = level == 0 ? d0 : est;  // what a slot carries in
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    Chunk k = load_chunk(ids, xs, valid, row, warp_first(lane) + lane, end);
    for (int c0 = warp_first(lane); c0 < end; c0 += kScoreThreads) {
      const Chunk next =
          load_chunk(ids, xs, valid, row, c0 + kScoreThreads + lane, end);
      const float4 l4 = k.v ? lvl[k.id] : zero;  // [proj, norm, rho, sqrt k]
      const float4 r4 = k.v && level == 0 ? rec[k.id] : zero;
      const float dot = chunk_dot(packed, k.id, __ballot_sync(kFull, k.v),
                                  s_b, G, 4u * gp, lane);
      if (k.in) {
        const size_t slot = row + c0 + lane;
        const float align = k.v ? dot / l4.w : 0.f;
        float e, l, h;
        if (level == 0) {  // r4 = [||d||^2, <x_c,d>, ||d||, rho]
          const Level0 s0 = level0(align, p, k.x, r4.x, r4.y, r4.z, r4.w);
          e = s0.est;
          level0_bounds(s0, p, quantile, &l, &h);
        } else {
          e = deeper(k.x, align, l4, p, &l, &h);
        }
        est[slot] = e;
        lo[slot] = l;
        hi[slot] = h;
      }
      k = next;
    }
  }
}

// st is read in place from the launch's parameter space (__grid_constant__),
// so indexing it by level makes no local copy.  kGlobal: the tables of the
// query come from device memory (tables_kernel), staged chunk_passes
// passes at a time for each level in turn (score_chunked<true>).
template <bool kGlobal>
__global__ void bounds_kernel(const __grid_constant__ LevelStores st,
                              const int32_t* __restrict__ ids,      // (Q, C)
                              const float* __restrict__ d0,         // (Q, C)
                              const uint8_t* __restrict__ valid,    // (Q, C)
                              const float* __restrict__ qplanes,    // (Q, 5, G)
                              const float4* __restrict__ rec,       // (N,)
                              const float* __restrict__ params,     // (Q, 8)
                              float* __restrict__ est,              // (Q, C)
                              float* __restrict__ lo,               // (Q, L, C)
                              float* __restrict__ hi,
                              const float* __restrict__ tables,  // or null
                              int C, int G, int L, int quantile,
                              int chunk_passes) {
  extern __shared__ float s_t[];  // T27 (27, Gp), T9 (kT9Rows, Gp)
  if constexpr (kGlobal) {
    for (int lv = 0; lv < L; ++lv)
      score_chunked<true>(st.packed[lv], ids, d0, valid, rec, st.lvl[lv],
                          params, est, lo, hi, tables, C, G, lv, L, quantile,
                          chunk_passes, s_t);
  } else {
    const int q = blockIdx.y, gp = table_width(G);
    load_tables(s_t, qplanes + (size_t)q * 5 * G, G, gp);

    const Params p = load_params(params + (size_t)q * 8);
    const char* s_b = reinterpret_cast<const char*>(s_t);
    const int lane = threadIdx.x & 31, end = tile_end(C);
    const size_t row = (size_t)q * C;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    Chunk k = load_chunk(ids, d0, valid, row, warp_first(lane) + lane, end);
    for (int c0 = warp_first(lane); c0 < end; c0 += kScoreThreads) {
      const Chunk next =
          load_chunk(ids, d0, valid, row, c0 + kScoreThreads + lane, end);
      const unsigned ballot = __ballot_sync(kFull, k.v);
      const size_t lvl0 = (size_t)q * L * C + c0 + lane;  // lo/hi at level 0
      const float4 r4 = k.v ? rec[k.id] : zero;
      float e = 0.f;
      for (int lv = 0; lv < L; ++lv) {
        const float4 l4 = k.v ? st.lvl[lv][k.id] : zero;
        const float dot =
            chunk_dot(st.packed[lv], k.id, ballot, s_b, G, 4u * gp, lane);
        const float align = k.v ? dot / l4.w : 0.f;
        float l, h;
        if (lv == 0) {
          const Level0 s0 = level0(align, p, k.x, r4.x, r4.y, r4.z, r4.w);
          e = s0.est;
          level0_bounds(s0, p, quantile, &l, &h);
        } else {
          e = deeper(e, align, l4, p, &l, &h);
        }
        if (k.in) {
          lo[lvl0 + (size_t)lv * C] = k.v ? l : INFINITY;
          hi[lvl0 + (size_t)lv * C] = k.v ? h : INFINITY;
        }
      }
      if (k.in) est[row + c0 + lane] = k.v ? e : INFINITY;
      k = next;
    }
  }
}

// ---- level 0 over gathered rows (fatrq_refine_level0)

constexpr int kL0Rows = 32;      // rows of one warp's chunk: one per lane
constexpr int kL0MaxWarps = 16;  // warps of a level-0 block
constexpr int kSmemLimit = 232448;  // dynamic shared memory one block may use
constexpr uint32_t kZeroBytes = 0x79797979u;  // 121: all five trits 0

// Bytes of one warp's stage: a chunk's 32 rows at an offset below 16 and
// room for the words the last row's passes read past the chunk.
__host__ __device__ __forceinline__ int level0_stage_bytes(int G) {
  return (kL0Rows * G + 4 * kPassWords * row_passes(G) + 16 + 15) / 16 * 16;
}

// One query's T27 and T9 tables of (partial dot, nonzero trits) pairs.
long level0_table_bytes(int G) {
  return (long)sizeof(float2) * (27 + kT9Rows) * table_width(G);
}

// The shared form's tables and every warp's two stages.
size_t level0_smem(int G, int warps) {
  return (size_t)(level0_table_bytes(G) + 2L * warps * level0_stage_bytes(G));
}

// Warps of a shared-form level-0 block: as many as the shared memory
// holds, up to kL0MaxWarps (< 1: G too wide for the shared form).
int level0_warps(int G) {
  return (int)std::min((long)kL0MaxWarps,
                       (kSmemLimit - level0_table_bytes(G)) /
                           (2L * level0_stage_bytes(G)));
}

// ---- the level-0 global form: rows and pair tables by pass chunks

constexpr int kL0Slack = 8;  // a row's staged words start below this offset

// Bytes of one row's slot in a global-form stage: the row's words for a
// chunk of P passes (kPassWords each) from an offset below kL0Slack
// (ops.level0_slot_bytes).
__host__ __device__ __forceinline__ int level0_slot(int P) {
  return 4 * kPassWords * P + kL0Slack;
}

// Shared memory of the global form: the pair tables over chunk_width(P)
// columns, then two stages of kL0Rows slots per warp
// (ops.level0_chunk_bytes).
size_t level0_chunk_smem(int P, int warps) {
  return (size_t)(27 + kT9Rows) * chunk_width(P) * sizeof(float2) +
         (size_t)2 * warps * kL0Rows * level0_slot(P);
}

// One query's level-0 tables: the T27 and T9 of load_tables, each entry a
// pair (the same partial dot, bit for bit; the nonzero trits among the
// row's digits, as an int), so one 8-byte lookup gives a byte's share of
// both c.q and k.  Ends with __syncthreads().
__device__ __forceinline__ void load_pair_tables(float2* s_t,
                                                 const float* qplanes, int G,
                                                 int gp) {
  float2* t9 = s_t + 27 * gp;
  for (int col = threadIdx.x; col < gp; col += blockDim.x) {
    float pl[5];
    const bool in = column_planes(pl, qplanes, G, col);
#pragma unroll
    for (int r = 0; r < 27; ++r) {
      const int k = (r % 3 != 1) + (r / 3 % 3 != 1) + (r / 9 != 1);
      s_t[r * gp + col] =
          make_float2(in ? t27_value(r, pl) : 0.f, __int_as_float(k));
    }
#pragma unroll
    for (int r = 0; r < kT9Rows; ++r) {
      const int k = (r % 3 != 1) + (r / 3 % 3 != 1);
      t9[r * gp + col] =
          make_float2(in ? t9_value(r, pl) : 0.f, __int_as_float(k));
    }
  }
  __syncthreads();
}

// The level-0 global form's pair tables: each query's, by one block, into
// device memory in load_pair_tables' layout ((Q, 27 + kT9Rows, Gp) float2).
__global__ void pair_tables_kernel(const float* __restrict__ qplanes,
                                   float2* __restrict__ tables, int G) {
  const int gp = table_width(G);
  load_pair_tables(tables + (size_t)blockIdx.x * (27 + kT9Rows) * gp,
                   qplanes + (size_t)blockIdx.x * 5 * G, G, gp);
}

__device__ __forceinline__ float2 lds2(const char* s_b, uint32_t byte_ofs) {
  return *reinterpret_cast<const float2*>(s_b + byte_ofs);
}

// Bytes [src, src + len) to shared memory at dst + (src mod 16), dst 16-byte
// aligned, by the calling warp: the 16-byte-aligned body with cp.async, the
// head and tail (under 16 bytes each) with byte loads.
__device__ __forceinline__ void stage_span(uint8_t* dst, const uint8_t* src,
                                           int len, int lane) {
  const int a = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min(len, (16 - a) & 15);
  const int body = (len - head) >> 4;
  for (int i = lane; i < head; i += 32) dst[a + i] = __ldg(src + i);
  for (int u = lane; u < body; u += 32)
    cp_async16(dst + a + head + 16 * u, src + head + 16 * u);
  for (int i = head + 16 * body + lane; i < len; i += 32)
    dst[a + i] = __ldg(src + i);
}

// The bytes of a word to keep when t of them (from byte 0) are in the row.
__device__ __forceinline__ uint32_t row_keep(int t) {
  return t >= 4 ? ~0u : t <= 0 ? 0u : ~0u >> (32 - 8 * t);
}

// A lane's byte selectors and table offsets for rows whose first byte is
// byte `off` of its word (the words and columns of row_dot), the bytes it
// keeps of the row's first word and of its first pass's words, and the
// row bytes from its own first word on (room).
struct Level0Lane {
  uint32_t sel[4], c27[4], c9[4];
  uint32_t lead, tail[kWords];
  int room;
};

__device__ __forceinline__ Level0Lane level0_lane(int off, int grp, int sub,
                                                  int G, uint32_t gp8) {
  Level0Lane ln;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    // column = b + grp + 2 (sub / 4) (mod 4): an 8-byte lookup is served
    // per half-warp, and the 16 lanes of groups 2h and 2h + 1 then take 16
    // columns that differ mod 16, 16 distinct bank pairs
    const int j = (b + grp + 2 * (sub >> 2) + off) & 3;
    const int col = 4 * sub + 4 - off + j;
    ln.sel[b] = 0x4440u | (uint32_t)j;
    ln.c27[b] = 8u * (uint32_t)col;
    ln.c9[b] = ln.c27[b] + 27u * gp8;
  }
  ln.lead = sub == 0 ? ~0u << (8 * off) : ~0u;
  ln.room = G + off - 4 * sub;
#pragma unroll
  for (int s = 0; s < kWords; ++s)
    ln.tail[s] = row_keep(ln.room - 4 * kGroup * s);
  return ln;
}

// Bytes outside the row (outside `keep`) become 121, which scores 0 and
// counts 0 in every column.
__device__ __forceinline__ uint32_t keep_bytes(uint32_t v, uint32_t keep) {
  return (v & keep) | (kZeroBytes & ~keep);
}

// Lane sub's kWords words of pass ps of a row (words: the pass's first),
// its bytes outside the row masked.
template <bool kOnePass>
__device__ __forceinline__ void level0_words(uint32_t (&v)[kWords],
                                             const uint32_t* words,
                                             const Level0Lane& ln, int ps,
                                             int sub) {
#pragma unroll
  for (int s = 0; s < kWords; ++s) v[s] = words[sub + kGroup * s];
  if (ps == 0) v[0] = keep_bytes(v[0], ln.lead);
#pragma unroll
  for (int s = 0; s < kWords; ++s)
    v[s] = keep_bytes(v[s], kOnePass ? ln.tail[s]
                                     : row_keep(ln.room - 4 * kPassWords * ps -
                                                4 * kGroup * s));
}

// One pass of a row (v: lane sub's words) onto the lane's (c.q, nonzero
// trits) partial, the pass's table columns from byte `pass` of s_b (row
// stride gp8 bytes): two 8-byte lookups per byte.
__device__ __forceinline__ void level0_pass(const uint32_t (&v)[kWords],
                                            const Level0Lane& ln,
                                            const char* s_b, uint32_t gp8,
                                            uint32_t pass, float& acc,
                                            int& kc) {
#pragma unroll
  for (int s = 0; s < kWords; ++s) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t y = __byte_perm(v[s], 0u, ln.sel[b]);
      const uint32_t top = __umulhi(y, 159072863u);  // y / 27, y < 256
      const uint32_t col = pass + 32u * kGroup * s;
      const float2 t27 =
          lds2(s_b, y * gp8 - top * (27u * gp8) + ln.c27[b] + col);
      const float2 t9 = lds2(s_b, top * gp8 + ln.c9[b] + col);
      acc += t27.x + t9.x;
      kc += __float_as_int(t27.y) + __float_as_int(t9.y);
    }
  }
}

// (c.q, nonzero trits) over one staged row on lane sub of its group: the
// same words and columns as row_dot, two 8-byte lookups per byte; the
// caller reduces the group's partial sums.
template <bool kOnePass>
__device__ __forceinline__ void level0_row(const uint32_t* words,
                                           const Level0Lane& ln,
                                           const char* s_b, uint32_t gp8,
                                           int passes, int sub, float* dot,
                                           int* cnt) {
  float acc = 0.f;
  int kc = 0;
  const int np = kOnePass ? 1 : passes;
  for (int ps = 0; ps < np; ++ps) {
    uint32_t v[kWords];
    level0_words<kOnePass>(v, words + kPassWords * ps, ln, ps, sub);
    level0_pass(v, ln, s_b, gp8,
                kOnePass ? 0u : 32u * kPassWords * (uint32_t)ps, acc, kc);
  }
  *dot = acc;
  *cnt = kc;
}

// level0_row over passes [p0, p1) of a row (words: its staged words from
// pass p0 on) on pair tables staged from column kPassCols * p0 at gw8 bytes
// a row, onto the lane's partials acc and kc: the same adds in the same
// order, so after the row's last chunk they are level0_row's, bit for bit.
template <bool kOnePass>
__device__ __forceinline__ void level0_span(const uint32_t* words,
                                            const Level0Lane& ln,
                                            const char* s_c, uint32_t gw8,
                                            int p0, int p1, int sub,
                                            float& acc, int& kc) {
  for (int ps = p0; ps < p1; ++ps) {
    uint32_t v[kWords];
    level0_words<kOnePass>(v, words + kPassWords * (ps - p0), ln, ps, sub);
    level0_pass(v, ln, s_c, gw8, 32u * kPassWords * (uint32_t)(ps - p0), acc,
                kc);
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// The words of passes [p0, p1) of a chunk's n rows of G bytes (contiguous
// from src) to a warp's stage, row r's in slot r (slot bytes each) from
// the offset its first word has mod 8, by the calling warp: the 8-byte
// units inside the chunk's bytes with cp.async, a unit that holds its
// first or last byte byte by byte (so any base works), none past them (a
// row's bytes outside the row are masked when it is scored).
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src,
                                           int n, int G, int p0, int p1,
                                           int slot, int lane) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src);
  const uintptr_t hi = lo + (uintptr_t)n * G;
  const int units = 4 * kPassWords / 8 * (p1 - p0) + 1;  // a row's
  int r = 0, u = lane;
  while (u >= units) {
    u -= units;
    ++r;
  }
  while (r < n) {
    const uintptr_t g = ((lo + (uintptr_t)r * G) & ~(uintptr_t)7) +
                        4 * kPassWords * p0 + 8 * u;
    uint8_t* d = dst + r * slot + 8 * u;
    if (g >= lo && g + 8 <= hi) {
      cp_async8(d, reinterpret_cast<const void*>(g));
    } else if (g < hi && g + 8 > lo) {
      for (int t = 0; t < 8; ++t)
        if (g + t >= lo && g + t < hi)
          d[t] = __ldg(reinterpret_cast<const uint8_t*>(g + t));
    }
    u += 32;
    while (u >= units) {
      u -= units;
      ++r;
    }
  }
}

// Sums of a lane group's partials v[0..7] (one per round of rows):
// halving across lanes sub ^ 4, ^ 2, ^ 1, lane sub keeps round sub's sum.
template <typename T>
__device__ __forceinline__ T group_reduce_scatter(T (&v)[8], int sub) {
#pragma unroll
  for (int h = 4; h >= 1; h >>= 1) {
    const bool up = sub & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const T send = up ? v[i] : v[i + h];
      const T keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, h);
    }
  }
  return v[0];
}

// The chunk's 3n outputs (slot c0 + lane's est / raw / margin in r0 of
// lane i = the slot's, i < n) as three coalesced 128-byte spans.
__device__ __forceinline__ void level0_out(float* o, const Level0& r0,
                                           const int (&osrc)[3],
                                           const int (&ocomp)[3], int n,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float e = __shfl_sync(kFull, r0.est, osrc[j]);
    const float w = __shfl_sync(kFull, r0.raw, osrc[j]);
    const float m = __shfl_sync(kFull, r0.margin, osrc[j]);
    if (lane + 32 * j < 3 * n)
      o[lane + 32 * j] = ocomp[j] == 0 ? e : ocomp[j] == 1 ? w : m;
  }
}

// After a chunk's rows are scored (acc, cnt: lane (grp, sub)'s partials of
// rows 4 rd + grp): each row's dot and count to lane i = its row, level 0
// from the slot's scalars sv, and the outputs.
__device__ __forceinline__ void level0_finish(
    float (&acc)[kL0Rows / 4], int (&cnt)[kL0Rows / 4], const float (&sv)[5],
    const Params& p, float* o, const int (&osrc)[3], const int (&ocomp)[3],
    int n, int lane) {
  const int sub = lane % kGroup;
  // lane (grp, sub) sums row 4 sub + grp; lane i takes row i
  const int holder = (lane & 3) * kGroup + (lane >> 2);
  const float dot = __shfl_sync(kFull, group_reduce_scatter(acc, sub), holder);
  const int kc = __shfl_sync(kFull, group_reduce_scatter(cnt, sub), holder);
  const float align = dot / sqrtf(fmaxf((float)kc, 1.f));
  level0_out(o, level0(align, p, sv[0], sv[1], sv[2], sv[3], sv[4]), osrc,
             ocomp, n, lane);
}

// The global form (the header's level-0 pass chunks): the block walks its
// run of one query's 32-slot chunks in tiles of one chunk a warp; for each
// tile, chunk of passes by chunk of passes, it stages the pair tables'
// columns for those passes from the scratch pair_tables_kernel filled,
// while each warp's stage gets its chunk's rows' words for the same passes
// (stage_rows), one step ahead: the next chunk of passes' or the next
// tile's first.  A lane's partials (acc, cnt) stay in registers from chunk
// to chunk; after the last the chunk's outputs are taken as the shared
// form takes them (the output lanes as in level0_kernel).
template <bool kOnePass>
__device__ __forceinline__ void level0_chunked(
    const uint8_t* __restrict__ packed, const float* __restrict__ scal,
    const float* __restrict__ params, float* __restrict__ out,
    const float2* __restrict__ tables, int Q, int C, int G, int P,
    float2* s_t2) {
  const int gp = table_width(G), gw = chunk_width(P), slot = level0_slot(P);
  const int passes = row_passes(G), npc = (passes + P - 1) / P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kGroup, sub = lane % kGroup;
  const int warps = blockDim.x >> 5;
  const uint32_t gw8 = 8u * gw;
  const int stage = kL0Rows * slot;
  uint8_t* s_stage = reinterpret_cast<uint8_t*>(s_t2 + (27 + kT9Rows) * gw) +
                     (size_t)warp * 2 * stage;
  const char* s_c = reinterpret_cast<const char*>(s_t2);
  const int nchunks = (C + kL0Rows - 1) / kL0Rows;
  const long total = (long)Q * nchunks;
  const long end = total * (blockIdx.x + 1) / gridDim.x;
  for (long seg = total * blockIdx.x / gridDim.x; seg < end;) {
    const int q = (int)(seg / nchunks);
    const long left = end - (long)q * nchunks;  // chunks of q onward
    const int c_hi = left < nchunks ? (int)left : nchunks;
    const int k0 = (int)(seg - (long)q * nchunks);  // the run's first
    seg = (long)q * nchunks + c_hi;
    const size_t qrow = (size_t)q * C;
    const float* tq = reinterpret_cast<const float*>(
        tables + (size_t)q * (27 + kT9Rows) * gp);
    const int tiles = (c_hi - k0 + warps - 1) / warps;
    // the rows of tile t's chunk of this warp, passes [P pc, P pc + P),
    // to stage buffer buf (an empty cp.async group where there are none)
    auto issue = [&](int t, int pc, int buf) {
      const int k = k0 + t * warps + warp;
      if (t < tiles && k < c_hi) {
        const int c0 = k * kL0Rows;
        stage_rows(s_stage + buf * stage, packed + (qrow + c0) * G,
                   min(kL0Rows, C - c0), G, P * pc, min(passes, P * pc + P),
                   slot, lane);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    issue(0, 0, 0);
    int it = 0;  // this run's steps: (tile, chunk of passes)
    for (int t = 0; t < tiles; ++t) {
      const int k = k0 + t * warps + warp;
      const int c0 = k * kL0Rows;
      const int n = k < c_hi ? min(kL0Rows, C - c0) : 0;
      const int a =
          n > 0 ? (int)(reinterpret_cast<uintptr_t>(packed + (qrow + c0) * G) &
                        15)
                : 0;
      const Level0Lane ln = level0_lane((a + grp * G) & 3, grp, sub, G, gw8);
      float acc[kL0Rows / 4];
      int cnt[kL0Rows / 4];
#pragma unroll
      for (int rd = 0; rd < kL0Rows / 4; ++rd) {
        acc[rd] = 0.f;
        cnt[rd] = 0;
      }
      for (int pc = 0; pc < npc; ++pc, ++it) {
        const int p0 = P * pc, p1 = min(passes, p0 + P);
        __syncthreads();  // no warp still reads the last columns
        stage_tables(reinterpret_cast<float*>(s_t2), tq, 2 * gp, 2 * gw,
                     2 * kPassCols * p0, 2 * min(gw, gp - kPassCols * p0));
        if (pc + 1 < npc)
          issue(t, pc + 1, (it + 1) & 1);
        else
          issue(t + 1, 0, (it + 1) & 1);
        // all but the group just issued: this step's rows and columns
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncthreads();
        const uint8_t* cur = s_stage + (it & 1) * stage;
#pragma unroll
        for (int rd = 0; rd < kL0Rows / 4; ++rd) {
          const int r = 4 * rd + grp;
          // row r's words from the offset its first one has mod 8
          if (r < n)
            level0_span<kOnePass>(
                reinterpret_cast<const uint32_t*>(cur + r * slot +
                                                  ((a + r * G) & 4)),
                ln, s_c, gw8, p0, p1, sub, acc[rd], cnt[rd]);
        }
      }
      if (n > 0) {
        // the query's parameters, the slots' scalars and the output lanes
        // only now, so that the chunks of passes keep their registers
        float sv[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
        if (lane < n) {
#pragma unroll
          for (int i = 0; i < 5; ++i)
            sv[i] = __ldg(scal + (qrow + c0 + lane) * 5 + i);
        }
        int osrc[3], ocomp[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          osrc[j] = (lane + 32 * j) / 3;
          ocomp[j] = lane + 32 * j - 3 * osrc[j];
        }
        level0_finish(acc, cnt, sv, load_params(params + (size_t)q * 8),
                      out + (qrow + c0) * 3, osrc, ocomp, n, lane);
      }
    }
  }
}

// (minimum 1 block per SM: without it ptxas held the kernel to 64
// registers, which serialised its table lookups)
template <bool kOnePass, bool kGlobal = false>
__global__ void __launch_bounds__(kL0MaxWarps * 32, 1)
    level0_kernel(const uint8_t* __restrict__ packed,  // (Q, C, G)
                  const float* __restrict__ qplanes,   // (Q, 5, G)
                  const float* __restrict__ scal,      // (Q, C, 5)
                  const float* __restrict__ params,    // (Q, 8)
                  float* __restrict__ out,             // (Q, C, 3)
                  const float2* __restrict__ tables,   // or null
                  int Q, int C, int G, int chunk_passes) {
  // the pair tables T27 and T9 (in the global form: a chunk of their
  // columns), then two stages per warp
  extern __shared__ __align__(16) float2 s_t2[];
  if constexpr (kGlobal) {
    level0_chunked<kOnePass>(packed, scal, params, out, tables, Q, C, G,
                             chunk_passes, s_t2);
    return;
  }
  const int lane = threadIdx.x & 31;
  // output float f = lane + 32 j of a chunk is component f % 3 of row f / 3
  int osrc[3], ocomp[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    osrc[j] = (lane + 32 * j) / 3;
    ocomp[j] = lane + 32 * j - 3 * osrc[j];
  }
  const int gp = table_width(G), passes = row_passes(G);
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kGroup, sub = lane % kGroup;
  const int warps = blockDim.x >> 5;
  const uint32_t gp8 = 8u * gp;
  const int stage = level0_stage_bytes(G);
  uint8_t* s_stage = reinterpret_cast<uint8_t*>(s_t2) +
                     (27 + kT9Rows) * gp8 + (size_t)warp * 2 * stage;
  const char* s_b = reinterpret_cast<const char*>(s_t2);
  const int nchunks = (C + kL0Rows - 1) / kL0Rows;
  // this block's share of the Q x nchunks chunks, in order: a run of one
  // query's chunks, or the end of one query's and the start of the next
  const long total = (long)Q * nchunks;
  const long end = total * (blockIdx.x + 1) / gridDim.x;
  for (long seg = total * blockIdx.x / gridDim.x; seg < end;) {
    const int q = (int)(seg / nchunks);
    const long left = end - (long)q * nchunks;  // chunks of q onward
    const int c_hi = left < nchunks ? (int)left : nchunks;
    int k = (int)(seg - (long)q * nchunks) + warp;  // this warp's first
    seg = (long)q * nchunks + c_hi;
    const size_t qrow = (size_t)q * C;
    // a warp's chunks k, k + warps, ...: each staged one chunk ahead
    auto issue = [&](int chunk, uint8_t* buf) {
      const int c0 = chunk * kL0Rows;
      stage_span(buf, packed + (qrow + c0) * G, min(kL0Rows, C - c0) * G,
                 lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    __syncthreads();  // no warp still reads the last query's tables
    if (k < c_hi) issue(k, s_stage);
    load_pair_tables(s_t2, qplanes + (size_t)q * 5 * G, G, gp);
    const Params p = load_params(params + (size_t)q * 8);

    for (int it = 0; k < c_hi; k += warps, ++it) {
      const uint8_t* cur = s_stage + (it & 1) * stage;
      if (k + warps < c_hi) {
        issue(k + warps, s_stage + ((it + 1) & 1) * stage);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncwarp();  // every lane's copies of this chunk have landed

      const int c0 = k * kL0Rows, n = min(kL0Rows, C - c0);
      // slot c0 + lane's [d0, ||d||^2, <x_c,d>, ||d||, rho], read while
      // the rows are scored
      float sv[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (lane < n) {
#pragma unroll
        for (int i = 0; i < 5; ++i)
          sv[i] = __ldg(scal + (qrow + c0 + lane) * 5 + i);
      }
      const int a =
          (int)(reinterpret_cast<uintptr_t>(packed + (qrow + c0) * G) & 15);
      // row r = 4 rd + grp starts at byte a + r G of the stage, so its
      // offset in its word is the same in every round
      const Level0Lane ln = level0_lane((a + grp * G) & 3, grp, sub, G, gp8);
      float acc[kL0Rows / 4];
      int cnt[kL0Rows / 4];
#pragma unroll
      for (int rd = 0; rd < kL0Rows / 4; ++rd) {
        const int r = 4 * rd + grp;
        acc[rd] = 0.f;
        cnt[rd] = 0;
        if (r < n)
          level0_row<kOnePass>(
              reinterpret_cast<const uint32_t*>(cur + ((a + r * G) & ~3)),
              ln, s_b, gp8, passes, sub, &acc[rd], &cnt[rd]);
      }
      __syncwarp();  // the stage is read; the next issue may overwrite it
      level0_finish(acc, cnt, sv, p, out + (qrow + c0) * 3, osrc, ocomp, n,
                    lane);
    }
  }
}

// order-preserving key of a float: -0 sorts below +0, every NaN above +inf
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  if (v != v) return 0xffffffffu;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// bit i set where byte i of v is nonzero
__device__ __forceinline__ uint32_t nonzero_bits(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t nz = __vcmpne4(w[j], 0u);  // 0xff in each nonzero byte
    m |= ((nz & 1u) | ((nz >> 7) & 2u) | ((nz >> 14) & 4u) |
          ((nz >> 21) & 8u)) << (4 * j);
  }
  return m;
}

// 4 bits to 4 bytes of 0 or 1
__device__ __forceinline__ uint32_t bit_bytes(uint32_t m) {
  return (m & 1u) | ((m & 2u) << 7) | ((m & 4u) << 14) | ((m & 8u) << 21);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Slots per block of a query's cluster: ceil(C / 8) rounded up to 32, so
// a block's bit words and 16-slot vectors never straddle two blocks.
__host__ __device__ __forceinline__ int prune_span(int C) {
  return ((C + kPruneCluster - 1) / kPruneCluster + 31) / 32 * 32;
}

// Dynamic shared memory of the prune's shared form: the slice's keys and
// alive bits.
size_t prune_dynamic_smem(int C) {
  const size_t span = (size_t)prune_span(C);
  return span * sizeof(uint32_t) + span / 8;
}

// The global form's dynamic shared memory, the same at every C
// (ops.PRUNE_STREAM_SMEM): kPruneStages stages of a tile's hi as float4
// [stage][j][thread], the key buffer, the keys below a compaction's kth
// and their count.
constexpr size_t kPruneStageFloats = (size_t)4 * 4 * kPruneThreads;
size_t prune_stream_smem() {
  return kPruneStages * kPruneStageFloats * sizeof(float) +
         (size_t)(kPruneBuf + kMaxK + 4) * sizeof(uint32_t);
}

struct PruneShared {
  uint32_t hist[2][kRadixBins];  // this block's digit counts, two passes
  uint32_t wsum[kPruneWarps];    // per-warp totals of the digit scan
  int wcnt[kPruneWarps], wdcnt[kPruneWarps];
  int ccnt[kPruneCluster], cdcnt[kPruneCluster];  // block 0: the cluster's
  int nkeys, total, digit, remain;
};

// Inclusive sum over a warp.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// A warp's keys (count n each, in lane order) appended to the compacted
// key list; returns the first index of this lane's keys.
__device__ __forceinline__ int reserve_keys(PruneShared& sh, int n,
                                            int lane) {
  const int incl = warp_scan(n, lane);
  int first = 0;
  if (lane == 31) first = atomicAdd(&sh.nkeys, incl);
  return __shfl_sync(kFull, first, 31) + incl - n;
}

// The kth-smallest (1 <= k <= nk) of this block's nk keys: the cluster
// select's 4 passes of 8 bits over this block's digit counts alone.  Its
// digit pick repeats the cluster select's: one helper called by both
// timed the shared form's prune 2.7% slower on an H100.
__device__ uint32_t block_kth(PruneShared& sh, const uint32_t* keys, int nk,
                              int k) {
  static_assert(kPruneThreads == kRadixBins, "a thread a digit");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t prefix = 0, pmask = 0;
  int remain = k;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    uint32_t* hist = sh.hist[pass & 1];
    hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < nk; i += kPruneThreads) {
      const uint32_t key = keys[i];
      if ((key & pmask) == prefix)
        atomicAdd(&hist[(key >> shift) & 0xffu], 1u);
    }
    __syncthreads();
    const int tot = (int)hist[tid];
    int incl = warp_scan(tot, lane);
    if (lane == 31) sh.wsum[warp] = (uint32_t)incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += (int)sh.wsum[w];
    if (incl - tot < remain && remain <= incl) {
      sh.digit = tid;
      sh.remain = remain - (incl - tot);
    }
    __syncthreads();
    prefix |= (uint32_t)sh.digit << shift;
    pmask |= 0xffu << shift;
    remain = sh.remain;
  }
  return prefix;
}

// Keep the k smallest of the block's nk buffered keys: those below their
// kth-smallest, then copies of it up to k (ties past k dropped); returns
// the kth, the block's new theta.
__device__ uint32_t compact_keys(PruneShared& sh, uint32_t* keys,
                                 uint32_t* below, int* nbelow, int nk,
                                 int k) {
  const int tid = threadIdx.x;
  const uint32_t kth = block_kth(sh, keys, nk, k);
  if (tid == 0) *nbelow = 0;
  __syncthreads();
  for (int i = tid; i < nk; i += kPruneThreads)
    if (keys[i] < kth) below[atomicAdd(nbelow, 1)] = keys[i];  // < k of them
  __syncthreads();
  if (tid < k) keys[tid] = tid < *nbelow ? below[tid] : kth;
  if (tid == 0) sh.nkeys = k;
  __syncthreads();
  return kth;
}

// The global form's walk over this thread's 16-slot units of a block's
// slice of n slots (n % 16 == 0, 16-byte aligned rows), tile by tile: at
// tile t the unit t * kPruneThreads + tid.  Its alive flags are read a
// tile ahead in registers, the floats of src (hi or lo) where its vector
// holds an alive slot are copied by cp.async a tile ahead of their use
// into the stages (float4 j at st + 4 j kPruneThreads), and visit(u, m,
// st) runs once tile t's have landed (u < 0 past the slice; m the unit's
// alive bits).  Each thread copies and reads only its own stage
// cells, so the stages need no barrier; a unit's flags are read (and
// the next tile's) before visit may write it.
template <typename Visit>
__device__ __forceinline__ void walk_tiles(const uint8_t* alive_in,
                                           const float* __restrict__ src,
                                           size_t row, int n, float* s_st,
                                           Visit visit) {
  const int tid = threadIdx.x;
  const int units = n / kPruneUnit;
  const int tiles = (units + kPruneThreads - 1) / kPruneThreads;
  const uint4* a4 = reinterpret_cast<const uint4*>(alive_in + row);
  const float* f = src + row;
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  auto stage = [&](int t, uint32_t m) {
    const int u = t * kPruneThreads + tid;
    float* st = s_st + (t % kPruneStages) * kPruneStageFloats + 4 * tid;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((m >> (4 * j)) & 0xfu)
        cp_async16(st + j * 4 * kPruneThreads, f + 16 * u + 4 * j);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  uint32_t m_cur = nonzero_bits(tid < units ? a4[tid] : none);
  stage(0, m_cur);
  uint4 a_next = kPruneThreads + tid < units ? a4[kPruneThreads + tid]
                                             : none;
  for (int t = 0; t < tiles; ++t) {
    const uint32_t m_next = nonzero_bits(a_next);
    stage(t + 1, m_next);  // its stage was read at tile t - 1
    const int u2 = (t + 2) * kPruneThreads + tid;
    a_next = u2 < units ? a4[u2] : none;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile t's
    const int u = t * kPruneThreads + tid;
    visit(u < units ? u : -1, m_cur,
          s_st + (t % kPruneStages) * kPruneStageFloats + 4 * tid);
    m_cur = m_next;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The global form's one pass over a block's slice of n slots: every alive
// slot's key is taken once, tile by tile (kPruneTile slots, a 16-slot
// unit a thread), and only the keys below theta, the block's running
// kth-smallest (above every key until the block has kept k), go to the
// key buffer.  Once the buffer may not hold another tile's keys it is
// compacted to its k smallest (compact_keys) and theta drops to their
// kth.  A key equal to theta is dropped: the buffer always holds the k
// smallest keys of the slots read so far (as a multiset), and the
// kth-smallest of a multiset is the kth-smallest of the union of each
// part's k smallest, so the cluster's select over the 8 buffers gives the
// shared form's tau; the union holds fewer than k keys only where fewer
// than k slots are alive.  With 16-byte vectors (vec) the units come
// through walk_tiles, hi staged; else 1-byte loads, slot j of a thread's
// tile at j * kPruneThreads + tid.  Leaves the buffer's count in
// sh.nkeys.
__device__ void prune_stream(PruneShared& sh, uint32_t* s_dyn,
                             const float* __restrict__ hi,
                             const uint8_t* alive_in, size_t row, int n,
                             int k, int vec) {
  const int tid = threadIdx.x, lane = tid & 31;
  float* s_st = reinterpret_cast<float*>(s_dyn);
  uint32_t* keys = s_dyn + kPruneStages * kPruneStageFloats;
  uint32_t* below = keys + kPruneBuf;
  int* nbelow = reinterpret_cast<int*>(below + kMaxK);
  uint64_t theta = 1ull << 32;
  // this thread's keys of one tile below theta, bits pm of its 16 slots
  // (key_of(j): slot j's key, read again), to the buffer; then, once every
  // thread's are in, a compaction where the next tile's might not fit
  auto append = [&](uint32_t pm, auto key_of) {
    if (__any_sync(kFull, pm)) {
      int at = reserve_keys(sh, __popc(pm), lane);
      for (uint32_t b = pm; b != 0; b &= b - 1)
        keys[at++] = key_of(__ffs(b) - 1);
    }
    __syncthreads();
    const int nk = sh.nkeys;
    __syncthreads();  // every thread has the count before the next appends
    if (nk > kPruneBuf - kPruneTile)
      theta = compact_keys(sh, keys, below, nbelow, nk, k);
  };
  if (vec) {
    walk_tiles(alive_in, hi, row, n, s_st,
               [&](int, uint32_t m, const float* st) {
      uint32_t pm = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((m >> (4 * j)) & 0xfu) {
          const float4 v =
              *reinterpret_cast<const float4*>(st + j * 4 * kPruneThreads);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (order_key(lane_of(v, i)) < theta) pm |= 1u << (4 * j + i);
        }
      }
      append(pm & m, [&](int j) {
        return order_key(st[(j >> 2) * 4 * kPruneThreads + (j & 3)]);
      });
    });
  } else {
    const int tiles = (n + kPruneTile - 1) / kPruneTile;
    for (int t = 0; t < tiles; ++t) {
      const size_t base = row + (size_t)t * kPruneTile + tid;
      uint32_t pm = 0;
#pragma unroll
      for (int j = 0; j < kPruneUnit; ++j) {
        const int i = t * kPruneTile + j * kPruneThreads + tid;
        if (i < n && alive_in[row + i] && order_key(hi[row + i]) < theta)
          pm |= 1u << j;
      }
      append(pm, [&](int j) {
        return order_key(hi[base + (size_t)j * kPruneThreads]);
      });
    }
  }
}

// The mask of one 16-slot vector u whose alive flags are the bits m:
// alive_out = alive && lo <= tau as one 16-byte store, lo's float4 j
// from lo4(j), taken only where it holds an alive slot; adds its
// survivors and their delta-page share to cnt and dcnt.
template <typename Lo4>
__device__ __forceinline__ void mask_vector(
    Lo4 lo4, uint8_t* alive_out, const uint8_t* __restrict__ is_delta,
    size_t row, int u, uint32_t m, float tau, int& cnt, int& dcnt) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if ((m >> (4 * j)) & 0xfu) {
      const float4 l = lo4(j);
      out |= ((uint32_t)(l.x <= tau) | (uint32_t)(l.y <= tau) << 1 |
              (uint32_t)(l.z <= tau) << 2 | (uint32_t)(l.w <= tau) << 3)
             << (4 * j);
    }
  }
  out &= m;
  *reinterpret_cast<uint4*>(alive_out + row + 16 * u) =
      make_uint4(bit_bytes(out & 0xfu), bit_bytes((out >> 4) & 0xfu),
                 bit_bytes((out >> 8) & 0xfu), bit_bytes(out >> 12));
  cnt += __popc(out);
  if (is_delta != nullptr && out)
    dcnt += __popc(out & nonzero_bits(__ldg(
                reinterpret_cast<const uint4*>(is_delta + row + 16 * u))));
}

// (no __launch_bounds__: with it ptxas capped this kernel at 32 registers
// and spilled one to the stack)
template <bool kGlobal>
__global__ void __cluster_dims__(kPruneCluster, 1, 1)
    prune_kernel(const float* __restrict__ lo,           // (Q, C)
                 const float* __restrict__ hi,
                 const uint8_t* alive_in,                // (Q, C)
                 uint8_t* alive_out,                     // may alias
                 const uint8_t* __restrict__ is_delta,   // or null
                 int32_t* __restrict__ counts,           // (Q, 2L)
                 float* __restrict__ tau_out,            // (Q,) or null
                 int C, int k, int level, int L, int vec) {
  // the shared form: alive keys, then the alive bits; the global form:
  // prune_stream's stages and key buffer
  extern __shared__ __align__(16) uint32_t s_dyn[];
  __shared__ PruneShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = prune_span(C);
  uint32_t* s_key = kGlobal ? s_dyn + kPruneStages * kPruneStageFloats
                            : s_dyn;
  const int s0 = rank * span;
  const int n = max(0, min(C, s0 + span) - s0);  // this block's slots
  const size_t row = (size_t)blockIdx.y * C + s0;
  uint32_t* s_bits = s_key + span;

  if (tid == 0) sh.nkeys = 0;
  for (int i = tid; i < kRadixBins; i += kPruneThreads) sh.hist[0][i] = 0;
  __syncthreads();

  if constexpr (kGlobal) {
    prune_stream(sh, s_dyn, hi, alive_in, row, n, k, vec);
    sh.hist[0][tid] = 0;  // the compactions' counts
  } else if (vec) {
    // stage: alive bits and the alive slots' keys
    const int units = n / 16;
    for (int u0 = warp * 32; u0 < units; u0 += kPruneThreads) {
      const int u = u0 + lane;
      uint32_t m = 0;
      float4 h[4];
      if (u < units) {
        m = nonzero_bits(
            *reinterpret_cast<const uint4*>(alive_in + row + 16 * u));
        const float4* h4 = reinterpret_cast<const float4*>(hi + row + 16 * u);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[j] = (m >> (4 * j)) & 0xfu ? __ldg(h4 + j)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        reinterpret_cast<uint16_t*>(s_bits)[u] = (uint16_t)m;
      }
      int at = reserve_keys(sh, __popc(m), lane);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if ((m >> j) & 1u) s_key[at++] = order_key(lane_of(h[j / 4], j % 4));
    }
  } else {
    for (int b = warp * 32; b < n; b += kPruneThreads) {
      const int i = b + lane;
      const bool a = i < n && alive_in[row + i];
      const float h = a ? hi[row + i] : 0.f;
      const uint32_t m = __ballot_sync(kFull, a);
      if (lane == 0) s_bits[b / 32] = m;
      const int at = reserve_keys(sh, a, lane);
      if (a) s_key[at] = order_key(h);
    }
  }
  __syncthreads();

  // radix select of the kth-smallest key over the cluster
  const int nk = sh.nkeys;
  uint32_t prefix = 0, pmask = 0;
  int remain = k;
  bool fewer = false;  // fewer than k alive slots: tau = +inf
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    uint32_t* hist = sh.hist[pass & 1];
    for (int i = tid; i < nk; i += kPruneThreads) {
      const uint32_t key = s_key[i];
      const bool take = (key & pmask) == prefix;
      // one shared-memory atomic per key: timed faster on the card than
      // adding a warp's equal digits first (__match_any_sync or a ballot)
      if (take) atomicAdd(&hist[(key >> shift) & 0xffu], 1u);
    }
    cluster.sync();  // every block's counts of this digit are final
    int tot = 0, incl = 0;
    if (tid < kRadixBins) {
#pragma unroll
      for (int r = 0; r < kPruneCluster; ++r)
        tot += (int)cluster.map_shared_rank(hist, r)[tid];
      // the other buffer: its last remote reads preceded this barrier
      sh.hist[(pass + 1) & 1][tid] = 0;
      incl = warp_scan(tot, lane);
      if (lane == 31) sh.wsum[warp] = (uint32_t)incl;
    }
    __syncthreads();
    if (tid < kRadixBins) {
      for (int w = 0; w < warp; ++w) incl += (int)sh.wsum[w];
      if (pass == 0 && tid == kRadixBins - 1) sh.total = incl;
      if (incl - tot < remain && remain <= incl) {
        sh.digit = tid;
        sh.remain = remain - (incl - tot);
      }
    }
    __syncthreads();
    if (pass == 0 && sh.total < k) {
      fewer = true;
      break;
    }
    prefix |= (uint32_t)sh.digit << shift;
    pmask |= 0xffu << shift;
    remain = sh.remain;
  }
  const float tau = fewer ? INFINITY : key_value(prefix);

  // mask: alive_out = alive_in && lo <= tau, with the counts; the global
  // form reads alive_in again (a thread reads a unit's flags, and the next
  // tile's, before it writes the unit), its lo staged as hi was
  int cnt = 0, dcnt = 0;
  if (vec) {
    if constexpr (kGlobal) {
      walk_tiles(alive_in, lo, row, n, reinterpret_cast<float*>(s_dyn),
                 [&](int u, uint32_t m, const float* st) {
        if (u >= 0)
          mask_vector(
              [&](int j) {
                return *reinterpret_cast<const float4*>(
                    st + j * 4 * kPruneThreads);
              },
              alive_out, is_delta, row, u, m, tau, cnt, dcnt);
      });
    } else {
      const int units = n / 16;
      for (int u = tid; u < units; u += kPruneThreads) {
        const float4* l4 = reinterpret_cast<const float4*>(lo + row + 16 * u);
        mask_vector([&](int j) { return __ldg(l4 + j); }, alive_out,
                    is_delta, row, u,
                    reinterpret_cast<const uint16_t*>(s_bits)[u], tau, cnt,
                    dcnt);
      }
    }
  } else {
    for (int i = tid; i < n; i += kPruneThreads) {
      const bool a = kGlobal ? alive_in[row + i] != 0
                             : (s_bits[i / 32] >> (i % 32)) & 1u;
      const bool o = a && lo[row + i] <= tau;
      alive_out[row + i] = (uint8_t)o;
      cnt += o;
      if (is_delta != nullptr && o) dcnt += is_delta[row + i] != 0;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, off);
    dcnt += __shfl_xor_sync(kFull, dcnt, off);
  }
  if (lane == 0) {
    sh.wcnt[warp] = cnt;
    sh.wdcnt[warp] = dcnt;
  }
  __syncthreads();
  if (tid == 0) {
    int a = 0, d = 0;
    for (int w = 0; w < kPruneWarps; ++w) {
      a += sh.wcnt[w];
      d += sh.wdcnt[w];
    }
    cluster.map_shared_rank(sh.ccnt, 0)[rank] = a;
    cluster.map_shared_rank(sh.cdcnt, 0)[rank] = d;
  }
  cluster.sync();  // block 0 holds every block's counts; no remote access
                   // follows, so every block may exit
  if (rank == 0 && tid == 0) {
    int a = 0, d = 0;
    for (int r = 0; r < kPruneCluster; ++r) {
      a += sh.ccnt[r];
      d += sh.cdcnt[r];
    }
    counts[(size_t)blockIdx.y * 2 * L + level] = a;
    counts[(size_t)blockIdx.y * 2 * L + L + level] = d;
    if (tau_out != nullptr) tau_out[blockIdx.y] = tau;
  }
}

// Opt a kernel in to its dynamic shared memory.
template <typename Kernel>
size_t opt_in(Kernel kernel, size_t smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  return smem;
}

// The multi-level kernels' T27 and T9 tables.
template <typename Kernel>
size_t tables_smem(Kernel kernel, int G) {
  return opt_in(kernel,
                (size_t)(27 + kT9Rows) * table_width(G) * sizeof(float));
}

// The prune's dynamic shared bytes at C in its form, opted in: the shared
// form's staged slice, or the global form's stages and key buffer.
size_t prune_smem(bool global, int C) {
  return global ? opt_in(prune_kernel<true>, prune_stream_smem())
                : opt_in(prune_kernel<false>, prune_dynamic_smem(C));
}

// The prune over one level's (lo, hi): k in [1, kMaxK]; global picks the
// global form (C past the shared form's staged slice, ops.prune_form).
cudaError_t launch_prune(const void* lo, const void* hi, const void* alive_in,
                         void* alive_out, const void* is_delta, void* counts,
                         void* tau, bool global, int Q, int C, int k,
                         int level, int L, cudaStream_t s) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(lo) |
                        reinterpret_cast<uintptr_t>(hi) |
                        reinterpret_cast<uintptr_t>(alive_in) |
                        reinterpret_cast<uintptr_t>(alive_out) |
                        reinterpret_cast<uintptr_t>(is_delta);
  const int vec = C % 16 == 0 && (any & 15) == 0;
  const auto kernel = global ? prune_kernel<true> : prune_kernel<false>;
  kernel<<<dim3(kPruneCluster, Q), kPruneThreads, prune_smem(global, C),
           s>>>(static_cast<const float*>(lo), static_cast<const float*>(hi),
                static_cast<const uint8_t*>(alive_in),
                static_cast<uint8_t*>(alive_out),
                static_cast<const uint8_t*>(is_delta),
                static_cast<int32_t*>(counts), static_cast<float*>(tau), C, k,
                level, L, vec);
  return cudaGetLastError();
}

}  // namespace

// The global forms' tables of Q queries from their (Q, 5, G) planes: the
// multi-level kernels' f32 tables (pairs = 0, (Q, 37, Gp) floats) or the
// level-0 kernel's pair tables (pairs = 1, (Q, 37, Gp) float2).
extern "C" int fatrq_refine_tables(const void* qplanes, void* tables, int Q,
                                   int G, int pairs, void* stream) {
  if (Q == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs)
    pair_tables_kernel<<<Q, kScoreThreads, 0, s>>>(
        static_cast<const float*>(qplanes), static_cast<float2*>(tables), G);
  else
    tables_kernel<<<Q, kScoreThreads, 0, s>>>(
        static_cast<const float*>(qplanes), static_cast<float*>(tables), G);
  return (int)cudaGetLastError();
}

// tables: null (the shared form) or the query's tables built by
// fatrq_refine_tables, staged chunk_passes passes at a time (the global
// form, ops.refine_plan); prune_global: the prune's global form; smem_out
// (may be null) receives the score launch's dynamic shared bytes.
extern "C" int fatrq_refine_level(
    const void* packed, const void* ids, const void* d0, const void* valid,
    const void* qplanes, const void* rec, const void* lvl,
    const void* params, const void* alive_in, const void* is_delta, void* est,
    void* lo, void* hi, void* alive_out, void* counts, const void* tables,
    int prune_global, int Q, int C, int G, int level, int L, int k,
    int quantile, int chunk_passes, int* smem_out, void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const bool global = tables != nullptr;
  if (global && (chunk_passes < 1 || chunk_passes > kSpanPasses ||
                 chunk_smem(chunk_passes) > kSmemLimit))
    return (int)cudaErrorInvalidValue;
  const auto kernel = global ? score_kernel<true> : score_kernel<false>;
  const size_t smem = global ? opt_in(kernel, chunk_smem(chunk_passes))
                             : tables_smem(kernel, G);
  if (smem_out != nullptr) *smem_out = (int)smem;
  if (Q == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((C + kSlotTile - 1) / kSlotTile, Q);
  kernel<<<grid, kScoreThreads, smem, s>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int32_t*>(ids),
      static_cast<const float*>(d0), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(qplanes),
      static_cast<const float4*>(rec), static_cast<const float4*>(lvl),
      static_cast<const float*>(params), static_cast<float*>(est),
      static_cast<float*>(lo), static_cast<float*>(hi),
      static_cast<const float*>(tables), C, G, level, quantile, chunk_passes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_prune(lo, hi, alive_in, alive_out, is_delta, counts,
                           nullptr, prune_global, Q, C, k, level, L, s);
}

// The prune alone on given (lo, hi): tau (Q,) is written where not null;
// global as prune_global in fatrq_refine_level.
extern "C" int fatrq_refine_prune(const void* lo, const void* hi,
                                  const void* alive_in, void* alive_out,
                                  const void* is_delta, void* counts,
                                  void* tau, int global, int Q, int C, int k,
                                  int level, int L, void* stream) {
  if (k < 1 || k > kMaxK || level < 0 || level >= L)
    return (int)cudaErrorInvalidValue;
  if (Q == 0 || C == 0) return (int)cudaGetLastError();
  return (int)launch_prune(lo, hi, alive_in, alive_out, is_delta, counts, tau,
                           global, Q, C, k, level, L,
                           static_cast<cudaStream_t>(stream));
}

// The prune kernel's registers, local (stack) bytes, static shared bytes
// and cluster width in either form, as the runtime reports them, its
// dynamic shared bytes at C and the clusters of 8 the card holds at once
// with those bytes.
extern "C" int fatrq_prune_attributes(int global, int C, int* out) {
  const auto kernel = global ? prune_kernel<true> : prune_kernel<false>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  const size_t smem = prune_smem(global, C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kPruneCluster, 1024);
  cfg.blockDim = dim3(kPruneThreads);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.requiredClusterWidth;
  out[4] = (int)smem;
  out[5] = clusters;
  return (int)err;
}

// packed / lvl: host arrays of L device pointers (the per-level stores);
// tables and chunk_passes as in fatrq_refine_level (ops.bounds_plan);
// smem_out (may be null) receives the launch's dynamic shared bytes.
extern "C" int fatrq_refine_bounds(
    const void* const* packed, const void* const* lvl, const void* ids,
    const void* d0, const void* valid, const void* qplanes, const void* rec,
    const void* params, void* est, void* lo, void* hi, const void* tables,
    int Q, int C, int G, int L, int quantile, int chunk_passes,
    int* smem_out, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  const bool global = tables != nullptr;
  if (global && (chunk_passes < 1 || chunk_passes > kSpanPasses ||
                 chunk_smem(chunk_passes) > kSmemLimit))
    return (int)cudaErrorInvalidValue;
  const auto kernel = global ? bounds_kernel<true> : bounds_kernel<false>;
  const size_t smem = global ? opt_in(kernel, chunk_smem(chunk_passes))
                             : tables_smem(kernel, G);
  if (smem_out != nullptr) *smem_out = (int)smem;
  if (Q == 0 || C == 0) return (int)cudaGetLastError();
  LevelStores st = {};
  for (int lv = 0; lv < L; ++lv) {
    st.packed[lv] = static_cast<const uint8_t*>(packed[lv]);
    st.lvl[lv] = static_cast<const float4*>(lvl[lv]);
  }
  dim3 grid((C + kSlotTile - 1) / kSlotTile, Q);
  kernel<<<grid, kScoreThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const int32_t*>(ids), static_cast<const float*>(d0),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(qplanes),
      static_cast<const float4*>(rec), static_cast<const float*>(params),
      static_cast<float*>(est), static_cast<float*>(lo),
      static_cast<float*>(hi), static_cast<const float*>(tables), C, G, L,
      quantile, chunk_passes);
  return (int)cudaGetLastError();
}

// The level-0 kernel for width G: one pass over a row's words or several;
// the shared form or (global) the global form.
using Level0Kernel = void (*)(const uint8_t*, const float*, const float*,
                              const float*, float*, const float2*, int, int,
                              int, int);

Level0Kernel level0_for(int G, bool global) {
  if (global)
    return row_passes(G) == 1 ? level0_kernel<true, true>
                              : level0_kernel<false, true>;
  return row_passes(G) == 1 ? level0_kernel<true> : level0_kernel<false>;
}

// A level-0 launch's warps per block and dynamic shared bytes: the shared
// form's from G, the global form's from its plan (chunk_passes passes a
// chunk and `warps` warps, ops.level0_plan); false where they do not fit.
bool level0_size(int G, bool global, int chunk_passes, int warps, int* w,
                 size_t* smem) {
  if (G < 1) return false;
  if (global) {
    *w = warps;
    *smem = level0_chunk_smem(chunk_passes, warps);
    return chunk_passes >= 1 && chunk_passes <= kSpanPasses && warps >= 1 &&
           warps <= kL0MaxWarps && *smem <= (size_t)kSmemLimit;
  }
  *w = level0_warps(G);
  *smem = level0_smem(G, *w);
  return *w >= 1;
}

// tables: null (the shared form) or the queries' pair tables built by
// fatrq_refine_tables (the global form, staged by the plan chunk_passes /
// warps); smem_out (may be null) receives the launch's dynamic shared
// bytes.
extern "C" int fatrq_refine_level0(const void* packed, const void* qplanes,
                                   const void* scal, const void* params,
                                   void* out, const void* tables, int Q,
                                   int C, int G, int chunk_passes, int warps,
                                   int* smem_out, void* stream) {
  const bool global = tables != nullptr;
  int w = 0;
  size_t smem = 0;
  if (!level0_size(G, global, chunk_passes, warps, &w, &smem))
    return Q == 0 || C == 0 ? (int)cudaGetLastError()
                            : (int)cudaErrorInvalidValue;
  const Level0Kernel kernel = level0_for(G, global);
  opt_in(kernel, smem);
  if (smem_out != nullptr) *smem_out = (int)smem;
  if (Q == 0 || C == 0) return (int)cudaGetLastError();
  // every resident block busy, each with a share of the Q x C / 32 chunks
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * w,
                                                smem);
  const long chunks = (long)Q * ((C + kL0Rows - 1) / kL0Rows);
  const int blocks = (int)std::max(1L, std::min((long)sms * per_sm, chunks));
  kernel<<<blocks, 32 * w, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const float*>(qplanes), static_cast<const float*>(scal),
      static_cast<const float*>(params), static_cast<float*>(out),
      static_cast<const float2*>(tables), Q, C, G, chunk_passes);
  return (int)cudaGetLastError();
}

// The level-0 kernel for width G in either form (the global form's plan
// as in fatrq_refine_level0): its registers, local (stack) bytes, warps
// per block, dynamic shared memory and resident blocks per SM.
extern "C" int fatrq_level0_attributes(int G, int global, int chunk_passes,
                                       int warps, int* out) {
  int w = 0;
  size_t smem = 0;
  if (!level0_size(G, global, chunk_passes, warps, &w, &smem))
    return (int)cudaErrorInvalidValue;
  const Level0Kernel kernel = level0_for(G, global);
  opt_in(kernel, smem);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        32 * w, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = w;
  out[3] = (int)smem;
  out[4] = per_sm;
  return (int)err;
}

extern "C" const char* fatrq_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
