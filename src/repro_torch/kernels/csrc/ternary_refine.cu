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
//  * prune_kernel, one block per query: tau = kth-smallest hi among the
//    alive candidates (each thread keeps its k smallest, then k rounds of a
//    block-wide arg-min pick the global kth value, which is tie-invariant),
//    alive &= lo <= tau, and the survivor count plus its delta-page share go
//    to counts[q, level] and counts[q, L + level].
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
// (Q, C, G) tensor, and per-slot scalars (Q, C, 5).  It scores one slot per
// warp (warp_align over the planes in shared memory).  It reads every
// gathered row and its five scalars once, so it is bound by those bytes
// (~0.17 ms for the main path's 64 x 46,880 slots at G = 154).

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kScoreThreads = 256;  // 8 warps
constexpr int kTile = 256;          // candidates per level-0 scoring block
constexpr int kSlotTile = 1024;     // slots per multi-level scoring block
constexpr int kPruneThreads = 512;
constexpr int kMaxK = 64;           // largest top-k the pruning step keeps
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

// One query's (5, G) digit planes and the byte -> 5-trit table into shared
// memory; ends with __syncthreads().
__device__ __forceinline__ void load_query(float* s_planes, uint16_t* s_tab,
                                           const float* qplanes, int G) {
  for (int i = threadIdx.x; i < 5 * G; i += blockDim.x)
    s_planes[i] = qplanes[i];
  for (int y = threadIdx.x; y < 243; y += blockDim.x) {
    int t = y, v = 0;
    for (int i = 0; i < 5; ++i) {
      v |= (t % 3) << (2 * i);
      t /= 3;
    }
    s_tab[y] = (uint16_t)v;
  }
  __syncthreads();
}

// sum c.q / sqrt k over one packed code row, reduced across the warp (every
// lane returns the value)
__device__ __forceinline__ float warp_align(const uint8_t* row,
                                            const uint16_t* s_tab,
                                            const float* s_planes, int G,
                                            int lane) {
  float acc = 0.f;
  int kc = 0;
  for (int g = lane; g < G; g += 32) {
    const int t = s_tab[row[g]];
    float part = 0.f;
    for (int i = 0; i < 5; ++i) {
      const int dig = ((t >> (2 * i)) & 3) - 1;
      part += (float)dig * s_planes[i * G + g];
      kc += dig * dig;
    }
    acc += part;
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
    kc += __shfl_xor_sync(0xffffffffu, kc, off);
  }
  return acc / sqrtf(fmaxf((float)kc, 1.f));
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
// d_i = (r / 3^i) % 3 - 1; row r of T9 holds d3 p3 + d4 p4 for r = 0..8 and
// zeros in row 9 (for bytes 243..255, which only words outside a row can
// hold).  Ends with __syncthreads().
__device__ __forceinline__ void load_tables(float* s_t, const float* qplanes,
                                            int G, int gp) {
  float* t9 = s_t + 27 * gp;
  for (int col = threadIdx.x; col < gp; col += blockDim.x) {
    const int g = col - 4;
    const bool in = g >= 0 && g < G;
    float pl[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) pl[i] = in ? qplanes[i * G + g] : 0.f;
#pragma unroll
    for (int r = 0; r < 27; ++r) {
      const float v = (float)(r % 3 - 1) * pl[0] +
                      (float)(r / 3 % 3 - 1) * pl[1] +
                      (float)(r / 9 - 1) * pl[2];
      s_t[r * gp + col] = in ? v : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kT9Rows; ++r) {
      const float v = (float)(r % 3 - 1) * pl[3] + (float)(r / 3 - 1) * pl[4];
      t9[r * gp + col] = in && r < 9 ? v : 0.f;
    }
  }
  __syncthreads();
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
                             int C, int G, int level, int quantile) {
  extern __shared__ float s_t[];  // T27 (27, Gp), T9 (kT9Rows, Gp)
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

// st is read in place from the launch's parameter space (__grid_constant__),
// so indexing it by level makes no local copy.
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
                              int C, int G, int L, int quantile) {
  extern __shared__ float s_t[];  // T27 (27, Gp), T9 (kT9Rows, Gp)
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

__global__ void level0_kernel(const uint8_t* __restrict__ packed,  // (Q, C, G)
                              const float* __restrict__ qplanes,   // (Q, 5, G)
                              const float* __restrict__ scal,      // (Q, C, 5)
                              const float* __restrict__ params,    // (Q, 8)
                              float* __restrict__ out,             // (Q, C, 3)
                              int C, int G) {
  extern __shared__ float s_planes[];  // (5, G)
  __shared__ uint16_t s_tab[243];
  const int q = blockIdx.y;
  load_query(s_planes, s_tab, qplanes + (size_t)q * 5 * G, G);

  const Params p = load_params(params + (size_t)q * 8);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c_end = min(C, (int)(blockIdx.x + 1) * kTile);

  for (int c = blockIdx.x * kTile + warp; c < c_end;
       c += kScoreThreads / 32) {
    const size_t slot = (size_t)q * C + c;
    const float align =
        warp_align(packed + slot * G, s_tab, s_planes, G, lane);
    if (lane == 0) {
      const float* s = scal + slot * 5;  // [d0, ||d||^2, <x_c,d>, ||d||, rho]
      const Level0 r = level0(align, p, s[0], s[1], s[2], s[3], s[4]);
      out[slot * 3 + 0] = r.est;
      out[slot * 3 + 1] = r.raw;
      out[slot * 3 + 2] = r.margin;
    }
  }
}

__global__ void prune_kernel(const float* __restrict__ lo,          // (Q, C)
                             const float* __restrict__ hi,
                             const uint8_t* alive_in,              // (Q, C)
                             uint8_t* alive_out,                   // may alias
                             const uint8_t* __restrict__ is_delta, // or null
                             int32_t* __restrict__ counts,         // (Q, 2L)
                             int C, int k, int level, int L) {
  __shared__ float s_val[32];
  __shared__ int s_who[32];
  __shared__ float s_tau;
  __shared__ int s_win;
  __shared__ int s_cnt[32], s_dcnt[32];
  const int q = blockIdx.x;
  const size_t base = (size_t)q * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  // this thread's k smallest alive upper bounds, ascending
  float top[kMaxK];
  for (int j = 0; j < k; ++j) top[j] = INFINITY;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    if (!alive_in[base + c]) continue;
    const float v = hi[base + c];
    if (!(v < top[k - 1])) continue;
    int j = k - 1;
    while (j > 0 && top[j - 1] > v) {
      top[j] = top[j - 1];
      --j;
    }
    top[j] = v;
  }

  // k rounds of block-wide arg-min over the threads' list heads
  int head = 0;
  float tau = INFINITY;
  for (int r = 0; r < k; ++r) {
    float v = head < k ? top[head] : INFINITY;
    int who = threadIdx.x;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int ow = __shfl_xor_sync(0xffffffffu, who, off);
      if (ov < v || (ov == v && ow < who)) {
        v = ov;
        who = ow;
      }
    }
    if (lane == 0) {
      s_val[warp] = v;
      s_who[warp] = who;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < nwarps ? s_val[lane] : INFINITY;
      who = lane < nwarps ? s_who[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int ow = __shfl_xor_sync(0xffffffffu, who, off);
        if (ov < v || (ov == v && ow < who)) {
          v = ov;
          who = ow;
        }
      }
      if (lane == 0) {
        s_tau = v;
        s_win = who;
      }
    }
    __syncthreads();
    tau = s_tau;
    if ((int)threadIdx.x == s_win) ++head;
  }

  int cnt = 0, dcnt = 0;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int a = alive_in[base + c] && (lo[base + c] <= tau);
    alive_out[base + c] = (uint8_t)a;
    cnt += a;
    if (is_delta != nullptr) dcnt += a && is_delta[base + c];
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    dcnt += __shfl_xor_sync(0xffffffffu, dcnt, off);
  }
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_dcnt[warp] = dcnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0, b = 0;
    for (int w = 0; w < nwarps; ++w) {
      a += s_cnt[w];
      b += s_dcnt[w];
    }
    counts[(size_t)q * 2 * L + level] = a;
    counts[(size_t)q * 2 * L + L + level] = b;
  }
}

// Opt a kernel in to its dynamic shared memory.
template <typename Kernel>
size_t opt_in(Kernel kernel, size_t smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  return smem;
}

// The level-0 kernel's (5, G) planes.
template <typename Kernel>
size_t planes_smem(Kernel kernel, int G) {
  return opt_in(kernel, (size_t)5 * G * sizeof(float));
}

// The multi-level kernels' T27 and T9 tables.
template <typename Kernel>
size_t tables_smem(Kernel kernel, int G) {
  return opt_in(kernel,
                (size_t)(27 + kT9Rows) * table_width(G) * sizeof(float));
}

}  // namespace

extern "C" int fatrq_refine_level(
    const void* packed, const void* ids, const void* d0, const void* valid,
    const void* qplanes, const void* rec, const void* lvl,
    const void* params, const void* alive_in, const void* is_delta, void* est,
    void* lo, void* hi, void* alive_out, void* counts, int Q, int C, int G,
    int level, int L, int k, int quantile, void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (Q == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = tables_smem(score_kernel, G);
  dim3 grid((C + kSlotTile - 1) / kSlotTile, Q);
  score_kernel<<<grid, kScoreThreads, smem, s>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int32_t*>(ids),
      static_cast<const float*>(d0), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(qplanes),
      static_cast<const float4*>(rec), static_cast<const float4*>(lvl),
      static_cast<const float*>(params), static_cast<float*>(est),
      static_cast<float*>(lo), static_cast<float*>(hi), C, G, level,
      quantile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  prune_kernel<<<Q, kPruneThreads, 0, s>>>(
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const uint8_t*>(alive_in),
      static_cast<uint8_t*>(alive_out),
      static_cast<const uint8_t*>(is_delta), static_cast<int32_t*>(counts),
      C, k, level, L);
  return (int)cudaGetLastError();
}

// packed / lvl: host arrays of L device pointers (the per-level stores).
extern "C" int fatrq_refine_bounds(
    const void* const* packed, const void* const* lvl, const void* ids,
    const void* d0, const void* valid, const void* qplanes, const void* rec,
    const void* params, void* est, void* lo, void* hi, int Q, int C, int G,
    int L, int quantile, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (Q == 0 || C == 0) return (int)cudaGetLastError();
  LevelStores st = {};
  for (int lv = 0; lv < L; ++lv) {
    st.packed[lv] = static_cast<const uint8_t*>(packed[lv]);
    st.lvl[lv] = static_cast<const float4*>(lvl[lv]);
  }
  const size_t smem = tables_smem(bounds_kernel, G);
  dim3 grid((C + kSlotTile - 1) / kSlotTile, Q);
  bounds_kernel<<<grid, kScoreThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const int32_t*>(ids), static_cast<const float*>(d0),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(qplanes),
      static_cast<const float4*>(rec), static_cast<const float*>(params),
      static_cast<float*>(est), static_cast<float*>(lo),
      static_cast<float*>(hi), C, G, L, quantile);
  return (int)cudaGetLastError();
}

extern "C" int fatrq_refine_level0(const void* packed, const void* qplanes,
                                   const void* scal, const void* params,
                                   void* out, int Q, int C, int G,
                                   void* stream) {
  if (Q == 0 || C == 0) return (int)cudaGetLastError();
  const size_t smem = planes_smem(level0_kernel, G);
  dim3 grid((C + kTile - 1) / kTile, Q);
  level0_kernel<<<grid, kScoreThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const float*>(qplanes), static_cast<const float*>(scal),
      static_cast<const float*>(params), static_cast<float*>(out), C, G);
  return (int)cudaGetLastError();
}

extern "C" const char* fatrq_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
