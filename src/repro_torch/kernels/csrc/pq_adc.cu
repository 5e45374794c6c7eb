// PQ asymmetric-distance (ADC) scoring for a query micro-batch, valid
// slots only.
//
// Replaces src/repro/kernels/pq_adc.py::pq_adc (Pallas; on the TPU the
// lookup is a one-hot x LUT product because the TPU has no fast gather) and
// the jnp stages.adc_score it stands for: d(c) = sum_m lut[q, m, code[id, m]]
// for every valid slot c of query q, +inf for every invalid one.
//
// Bound: device-memory bytes.  The function reads each slot's 1 B valid
// flag and writes its 4 B distance, reads a 4 B id and one M-byte code row
// per valid slot (each distinct row once at best) and each query's
// (M, K) f32 LUT once: ~0.025 ms for the main path's 64 x 46,880 slots
// (~940k valid, ~575k distinct rows) at M = 96, K = 256, against ~90 M
// float adds, which the float32 rate covers in 1.4 us.  The shared-memory
// LUT gathers come next: with K = 256 entry (m, code) sits in bank
// code mod 32, so a warp's 32 lookups of one subspace land in random banks,
// about 3.5 wavefronts per request, ~0.04 ms at those shapes on 132 SMs at
// ~1.8 GHz.  A layout that spreads a warp's lookups over the banks needs the
// lanes of a warp at different subspaces in one instruction, and so a
// per-lane summation order, which point 3 below forbids.  chip_smoke.py
// times the kernel on an all-zero code store (every lookup of an
// instruction at one address: no conflict) to measure what the conflicts
// cost.  On the H100 they cost little: what sets the pace is the rows, read
// by id at random, 32 rows per warp load instruction, whose sectors are
// reused from L1 (a row's 16-byte halves of one sector, and rows that
// several queries probe).  Hence one block of 512 threads per SM: its
// ~107 KB of shared memory leaves ~124 KB of L1, where two blocks would
// leave ~28 KB.
//
// Design, grid (ceil(C / kTile), Q), kThreads threads, one block per SM:
//
//  1. Valid slots only.  Each warp reads its kWarpSlots of the tile's valid
//     flags coalesced, 32 per round, ballots them, and writes +inf to the
//     invalid slots in the same round; those read no id and no code row.
//     The warps' counts give each warp its base in a block-wide list of the
//     valid slots' tile offsets (uint16) in shared memory, in slot order.
//     A block whose tile has no valid slot returns there, before touching
//     the LUT.
//  2. Code rows as wide loads, issued together.  Thread t scores list
//     entries t, t + kThreads, ...; it reads a row as M/16 uint4 loads
//     where M % 16 == 0 and the store is 16-byte aligned (the wrapper
//     checks and picks), else as M/4 32-bit words, up to kChunk bytes in
//     registers at once, all issued before use.  The next candidate's first
//     chunk is loaded before the current one is scored.
//  3. One summation order per code row: one accumulator, m = 0, 1, ..., M-1,
//     whatever the slot, tile, lane or load path, so shard-local and global
//     scoring of a row give the same bits (--fmad=false has no bearing:
//     only adds).
//  4. The LUT copy is overlapped: once the block knows it has work, every
//     thread starts its part of the (M, K) f32 copy into shared memory with
//     cp.async (16-byte pieces where M*K % 4 == 0 and the LUT is 16-byte
//     aligned, else 4-byte ones), then writes the list and issues its first
//     row's loads, and only then waits for the copy.  The copy is not
//     started before the flag scan, because a tile with no valid slot must
//     not load it, and a block walks one tile: walking several serialises
//     each tile's ramp-up behind the last one's tail.
//  5. The dynamic shared-memory opt-in is set once per process (the
//     first call), to the largest a block may have.
//  6. Any M, any store: where M % 4 != 0 or the store is not 4-byte
//     aligned (rows at id * M then start at any byte), a row is read with
//     byte loads packed into the same 32-bit words, and the last word's
//     missing bytes are not looked up: the same lookups in the same order
//     (kBytes).
//
// Shared memory: the LUT (M*K*4 B, 96 KiB at M = 96, K = 256), the list
// (kTile * 2 B) and the warps' counts: ops.adc_smem_bytes.  Where the LUT
// does not fit (M > 218 at K = 256: every backbone width from 2048 on at
// the JAX package's pq_m = d / 8), the global form (kGlobal) stages it in
// chunks of Mc subspaces (ops.adc_plan: Mc = 64, 16 chunks at M = 1024), a
// ring of two Mc x K f32 buffers beside the list and the counts (139,328 B
// at K = 256):
//
//  * After the flag scan, every thread starts chunk 0's copy with cp.async
//    (as point 4), then reads its rows' ids once: thread t owns list entries
//    t, t + kThreads, ..., at most kTile / kThreads = 8 rows, and keeps one
//    running sum per row in registers across the chunks.
//  * Chunk c: the thread waits for chunk c's copy, one barrier (every thread
//    has finished chunk c - 1, so its buffer is free), then chunk c + 1's
//    copy starts into it and the thread scores chunk c of its rows from
//    shared memory, two rows at a time: the next pair's bytes [m0, m0 + Mc)
//    are loaded before the current pair is scored, and after a chunk's last
//    pair the next chunk's first pair, so the rows' loads run on across the
//    barrier.  Each row adds m = m0, m0 + 1, ... to its own sum, so a row's
//    sum still runs m = 0 ... M - 1 with one accumulator: the shared form's
//    bits (point 3).
//  * Mc is a multiple of 16 (so every chunk starts a uint4 of the row) and
//    at most kRing = 64: two pairs of 64-byte chunks in registers leave room
//    for the 8 sums under the 128 registers a thread of a 512-thread block
//    may have.  A chunk of 64 bytes is two whole sectors of a row at
//    M % 32 == 0, and the ring leaves ~90 KB of the SM's 228 KB to L1 for
//    the rows' sectors.  64 subspaces time faster than 32 and 48
//    (wide_variants.py).
//  * The LUT comes from L2 once per block and chunk: Q x ceil(C / kTile)
//    copies of it a call (1.27 GB at wide_8192, 19 tiles x 64 queries x
//    1 MiB), overlapped with the scoring of the chunk before.
//  * What sets its pace (wide_variants.py times copies of this source,
//    chip_smoke.py the kernel on an all-zero code store, where every lookup
//    of an instruction reads one address): at wide_8192 the LUT copies
//    after the first cost ~4%, the rows' loads after the first pair ~24%,
//    the lookups' bank conflicts ~15%.  The rest is the lookups and adds
//    themselves: each row's M adds are one dependent chain in subspace
//    order (point 3), and a thread holds ~2.8 rows there.  So a larger
//    tile, or a cluster sharing each LUT chunk, would cut only the copies'
//    few percent.
//
// The host picks the form from M and K (ops.adc_form) and the chunk plan
// from M and K (ops.adc_plan) before the launch; the plan passes Mc.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;  // 16 warps, one block per SM
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;    // slots per block
constexpr int kWarpSlots = kTile / kWarps;  // 256, 8 rounds of 32
constexpr int kRounds = kWarpSlots / 32;
constexpr int kChunk = 96;     // row bytes a thread holds in registers
constexpr int kChunkWords = kChunk / 4;
constexpr int kRing = 64;      // most subspaces of a global-form LUT chunk
constexpr int kSmemOptIn = 232448;  // Hopper's per-block maximum
constexpr unsigned kFull = 0xffffffffu;

// Up to 4 kW bytes of one code row, as 32-bit words: kChunk bytes in the
// shared form (Chunk), kRing in the global form's LUT ring (RingChunk).
template <int kW>
struct Words {
  uint32_t w[kW];
};
using Chunk = Words<kChunkWords>;
using RingChunk = Words<kRing / 4>;

// Bytes [b0, b0 + nb) of a row (nb a multiple of 4, or of 16 when vec),
// every load issued before any use.
template <int kW>
__device__ __forceinline__ void load_chunk(Words<kW>& c, const uint8_t* row,
                                           int b0, int nb, bool vec) {
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(row + b0);
#pragma unroll
    for (int j = 0; j < kW / 4; ++j) {
      if (16 * j < nb) {
        const uint4 v = __ldg(p + j);
        c.w[4 * j + 0] = v.x;
        c.w[4 * j + 1] = v.y;
        c.w[4 * j + 2] = v.z;
        c.w[4 * j + 3] = v.w;
      }
    }
  } else {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + b0);
#pragma unroll
    for (int j = 0; j < kW; ++j)
      if (4 * j < nb) c.w[j] = __ldg(p + j);
  }
}

// Bytes [b0, b0 + nb) of a row at any address and any nb, one byte load
// each, packed little-endian into the words load_chunk gives (bytes past
// nb left 0 and never looked up).
template <int kW>
__device__ __forceinline__ void load_chunk_bytes(Words<kW>& c,
                                                 const uint8_t* row, int b0,
                                                 int nb) {
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (4 * j < nb) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * j + b < nb)
          w |= (uint32_t)__ldg(row + b0 + 4 * j + b) << (8 * b);
      c.w[j] = w;
    }
  }
}

// Adds the chunk's nb lookups, subspaces m0, m0 + 1, ..., to s in order
// (kBytes: nb need not be a multiple of 4); l is the shared LUT, or the
// global form's chunk of it (m0 = 0 there).
template <bool kBytes, int kW>
__device__ __forceinline__ float score_chunk(const Words<kW>& c, float s,
                                             const float* s_lut, int m0,
                                             int nb, int K) {
  const float* l = s_lut + (size_t)m0 * K;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (4 * j < nb) {
      const uint32_t v = c.w[j];
      s += l[v & 0xffu];
      if (!kBytes || 4 * j + 1 < nb) s += l[K + ((v >> 8) & 0xffu)];
      if (!kBytes || 4 * j + 2 < nb) s += l[2 * K + ((v >> 16) & 0xffu)];
      if (!kBytes || 4 * j + 3 < nb) s += l[3 * K + (v >> 24)];
      l += 4 * K;
    }
  }
  return s;
}

// A row's chunk by the path the wrapper picked (kBytes: byte loads).
template <bool kBytes, int kW>
__device__ __forceinline__ void load_row_chunk(Words<kW>& c,
                                               const uint8_t* row, int b0,
                                               int nb, bool vec) {
  if (kBytes)
    load_chunk_bytes(c, row, b0, nb);
  else
    load_chunk(c, row, b0, nb, vec);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool wide) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n floats from src to dst in shared memory by the whole block, as one
// cp.async group: 16-byte pieces where n % 4 == 0 and src is 16-byte
// aligned (dst always is), else 4-byte ones.
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int n) {
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
      cp_async(dst + i, src + i, true);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      cp_async(dst + i, src + i, false);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Row bytes [m0, m0 + nb) of a thread's rows 2 pr and 2 pr + 1 (those it
// has) into a and b.
template <bool kBytes>
__device__ __forceinline__ void load_pair(RingChunk& a, RingChunk& b,
                                          const uint8_t* codes,
                                          const int (&rid)[kTile / kThreads],
                                          int pr, int mine, int M, int m0,
                                          int nb, bool wide) {
#pragma unroll
  for (int i = 0; i < kTile / kThreads; i += 2) {
    if (i == 2 * pr) {  // pr is a loop counter: one branch survives
      if (i < mine)
        load_row_chunk<kBytes>(a, codes + (size_t)rid[i] * M, m0, nb, wide);
      if (i + 1 < mine)
        load_row_chunk<kBytes>(b, codes + (size_t)rid[i + 1] * M, m0, nb,
                               wide);
    }
  }
}

// The global form's scoring (the header's chunk ring): thread t's rows are
// list entries t + r kThreads, r < kRows, scored in pairs; its chunk-0
// copy is in flight.
template <bool kBytes>
__device__ __forceinline__ void score_ring(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ ids,
    const float* lq, float* __restrict__ out, size_t row,
    const uint16_t* s_list, float* s_ring, int total, int M, int K, int mc,
    bool wide) {
  constexpr int kRows = kTile / kThreads;
  const int chunks = (M + mc - 1) / mc;
  const int ring = mc * K;  // floats a buffer
  const int mine = total > (int)threadIdx.x
                       ? (total - (int)threadIdx.x + kThreads - 1) / kThreads
                       : 0;
  int rid[kRows];
  float sum[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    rid[r] = r < mine ? ids[row + s_list[threadIdx.x + r * kThreads]] : 0;
    sum[r] = 0.f;
  }
  RingChunk a, b;  // the pair of rows scored next
  load_pair<kBytes>(a, b, codes, rid, 0, mine, M, 0, min(M, mc), wide);
  for (int ch = 0; ch < chunks; ++ch) {
    const int m0 = ch * mc, nb = min(M - m0, mc);
    const int m1 = m0 + mc, nb1 = min(M - m1, mc);  // the next chunk's
    cp_async_wait_all();
    __syncthreads();  // chunk ch landed; chunk ch - 1's buffer is free
    if (ch + 1 < chunks)
      copy_floats(s_ring + ((ch + 1) & 1) * ring, lq + (size_t)m1 * K,
                  nb1 * K);
    const float* l = s_ring + (ch & 1) * ring;
#pragma unroll
    for (int pr = 0; pr < kRows / 2; ++pr) {
      if (2 * pr < mine) {
        // the next pair's bytes go out first: this chunk's, or the next
        // chunk's first pair after this chunk's last
        RingChunk next_a = a, next_b = b;
        if (2 * pr + 2 < mine)
          load_pair<kBytes>(next_a, next_b, codes, rid, pr + 1, mine, M, m0,
                            nb, wide);
        else if (ch + 1 < chunks)
          load_pair<kBytes>(next_a, next_b, codes, rid, 0, mine, M, m1, nb1,
                            wide);
        sum[2 * pr] = score_chunk<kBytes>(a, sum[2 * pr], l, 0, nb, K);
        if (2 * pr + 1 < mine)
          sum[2 * pr + 1] =
              score_chunk<kBytes>(b, sum[2 * pr + 1], l, 0, nb, K);
        a = next_a;
        b = next_b;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < mine) out[row + s_list[threadIdx.x + r * kThreads]] = sum[r];
}

template <bool kGlobal, bool kBytes>
__global__ void __launch_bounds__(kThreads, 1)
    adc_kernel(const uint8_t* __restrict__ codes,  // (N, M)
               const int32_t* __restrict__ ids,    // (Q, C)
               const uint8_t* __restrict__ valid,  // (Q, C)
               const float* __restrict__ lut,      // (Q, M, K)
               float* __restrict__ out,            // (Q, C)
               int C, int M, int K, int vec, int mc) {
  extern __shared__ float4 s_mem[];
  // the LUT (M, K), or the global form's ring of two (mc, K) chunks (one
  // where a single chunk covers M)
  float* s_lut = reinterpret_cast<float*>(s_mem);
  const int lut_floats =
      kGlobal ? (mc < M ? 2 : 1) * mc * K : M * K;
  uint16_t* s_list =
      reinterpret_cast<uint16_t*>(s_lut + lut_floats);  // (kTile,)
  int* s_cnt = reinterpret_cast<int*>(s_list + kTile);  // (kWarps,)

  const int q = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile0 = blockIdx.x * kTile, n_in = min(C - tile0, kTile);
  const size_t row = (size_t)q * C + tile0;
  const int w0 = warp * kWarpSlots;

  // 1. the tile's flags, +inf to its invalid slots
  unsigned ball[kRounds];
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int c = w0 + 32 * r + lane;
    const bool in = c < n_in;
    const bool v = in && valid[row + c];
    ball[r] = __ballot_sync(kFull, v);
    cnt += __popc(ball[r]);
    if (in && !v) out[row + c] = INFINITY;
  }
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = s_cnt[w];
    base += w < warp ? n : 0;
    total += n;
  }
  if (total == 0) return;  // the whole block: no LUT, no rows

  // 4. start the LUT copy (the global form: its first chunk)
  const float* lq = lut + (size_t)q * M * K;
  if constexpr (kGlobal) {
    copy_floats(s_lut, lq, min(mc, M) * K);
  } else {
    const int mk = M * K;
    if ((mk & 3) == 0 && (reinterpret_cast<uintptr_t>(lq) & 15) == 0) {
      for (int i = 4 * threadIdx.x; i < mk; i += 4 * kThreads)
        cp_async(s_lut + i, lq + i, true);
    } else {
      for (int i = threadIdx.x; i < mk; i += kThreads)
        cp_async(s_lut + i, lq + i, false);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // the valid slots' offsets, in slot order
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if ((ball[r] >> lane) & 1u)
      s_list[base + __popc(ball[r] & below)] =
          (uint16_t)(w0 + 32 * r + lane);
    base += __popc(ball[r]);
  }
  __syncthreads();

  const bool wide = vec != 0;
  if constexpr (kGlobal) {
    score_ring<kBytes>(codes, ids, lq, out, row, s_list, s_lut, total, M, K,
                       mc, wide);
  } else {
    // 2. the first row's loads go out before the wait for the LUT
    const int first = min(M, kChunk);
    int i = threadIdx.x;
    int slot = 0;
    const uint8_t* row_cur = codes;
    Chunk cur;
    if (i < total) {
      slot = s_list[i];
      row_cur = codes + (size_t)ids[row + slot] * M;
      load_row_chunk<kBytes>(cur, row_cur, 0, first, wide);
    }
    cp_async_wait_all();
    __syncthreads();

    for (; i < total; i += kThreads) {
      const int i_next = i + kThreads;
      int slot_next = 0;
      const uint8_t* row_next = codes;
      Chunk next;
      if (i_next < total) {
        slot_next = s_list[i_next];
        row_next = codes + (size_t)ids[row + slot_next] * M;
        load_row_chunk<kBytes>(next, row_next, 0, first, wide);
      }
      // 3. one accumulator, subspaces in order
      float s = score_chunk<kBytes>(cur, 0.f, s_lut, 0, first, K);
      for (int b0 = kChunk; b0 < M; b0 += kChunk) {  // rows beyond kChunk
        const int nb = min(M - b0, kChunk);
        Chunk more;
        load_row_chunk<kBytes>(more, row_cur, b0, nb, wide);
        s = score_chunk<kBytes>(more, s, s_lut, b0, nb, K);
      }
      out[row + slot] = s;
      cur = next;
      slot = slot_next;
      row_cur = row_next;
    }
  }
}

// Dynamic shared memory of one block: the LUT (shared form) or the ring of
// mc-subspace chunks (global form, two buffers where mc < M), the list and
// the warps' counts (ops.adc_smem_bytes, ops.adc_plan).
size_t adc_smem(bool global, int M, int K, int mc) {
  const size_t lut = global ? (size_t)(mc < M ? 2 : 1) * mc * K : (size_t)M * K;
  return lut * sizeof(float) + kTile * sizeof(uint16_t) + kWarps * sizeof(int);
}

// One form and row path of the kernel.  The dynamic shared-memory opt-in
// is set once per process for each (the first call).
template <bool kGlobal, bool kBytes>
int launch_adc(const void* codes, const void* ids, const void* valid,
               const void* lut, void* out, int Q, int C, int M, int K,
               int vec, int mc, size_t smem, cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      adc_kernel<kGlobal, kBytes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (opt_in != cudaSuccess) return (int)opt_in;
  if (C == 0 || Q == 0) return (int)cudaGetLastError();
  dim3 grid((C + kTile - 1) / kTile, Q);
  adc_kernel<kGlobal, kBytes><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(lut),
      static_cast<float*>(out), C, M, K, vec, mc);
  return (int)cudaGetLastError();
}

}  // namespace

// path: 0 words, 1 16-byte loads, 2 bytes (pq_adc.row_path); global: the
// LUT staged in chunks of mc subspaces (ops.adc_form, ops.adc_plan; mc is
// M, or a multiple of 16, at most kRing); smem_out (may be null) receives the
// dynamic shared bytes the launch asked for.
extern "C" int fatrq_pq_adc(const void* codes, const void* ids,
                            const void* valid, const void* lut, void* out,
                            int Q, int C, int M, int K, int path, int global,
                            int mc, int* smem_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = path == 1;
  if (global && (mc < 1 || mc > kRing || (mc < M && mc % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = adc_smem(global != 0, M, K, mc);
  if (smem > (size_t)kSmemOptIn) return (int)cudaErrorInvalidValue;
  if (smem_out != nullptr) *smem_out = (int)smem;
  if (path == 2)
    return global ? launch_adc<true, true>(codes, ids, valid, lut, out, Q, C,
                                           M, K, vec, mc, smem, s)
                  : launch_adc<false, true>(codes, ids, valid, lut, out, Q,
                                            C, M, K, vec, mc, smem, s);
  return global ? launch_adc<true, false>(codes, ids, valid, lut, out, Q, C,
                                          M, K, vec, mc, smem, s)
                : launch_adc<false, false>(codes, ids, valid, lut, out, Q, C,
                                           M, K, vec, mc, smem, s);
}

extern "C" const char* fatrq_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
