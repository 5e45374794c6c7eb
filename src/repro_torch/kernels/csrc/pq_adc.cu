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
// the JAX package's pq_m = d / 8), the global form (kGlobal) reads each
// lookup straight from the caller's (Q, M, K) LUT with __ldg instead of
// copying it: the same adds in the same order, so the same bits, with the
// LUT served from L1 and the 50 MB L2 (1 MiB a query at M = 1024).  The
// host picks the form from M and K (ops.adc_form) before the launch.

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
constexpr int kSmemOptIn = 232448;  // Hopper's per-block maximum
constexpr unsigned kFull = 0xffffffffu;

// Up to kChunk bytes of one code row, as 32-bit words.
struct Chunk {
  uint32_t w[kChunkWords];
};

// Bytes [b0, b0 + nb) of a row (nb a multiple of 4, or of 16 when vec),
// every load issued before any use.
__device__ __forceinline__ void load_chunk(Chunk& c, const uint8_t* row,
                                           int b0, int nb, bool vec) {
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(row + b0);
#pragma unroll
    for (int j = 0; j < kChunk / 16; ++j) {
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
    for (int j = 0; j < kChunkWords; ++j)
      if (4 * j < nb) c.w[j] = __ldg(p + j);
  }
}

// Bytes [b0, b0 + nb) of a row at any address and any nb, one byte load
// each, packed little-endian into the words load_chunk gives (bytes past
// nb left 0 and never looked up).
__device__ __forceinline__ void load_chunk_bytes(Chunk& c, const uint8_t* row,
                                                 int b0, int nb) {
#pragma unroll
  for (int j = 0; j < kChunkWords; ++j) {
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

// One LUT entry: from shared memory, or (kGlobal) from device memory.
template <bool kGlobal>
__device__ __forceinline__ float lut_at(const float* l, int i) {
  if constexpr (kGlobal)
    return __ldg(l + i);
  else
    return l[i];
}

// Adds the chunk's nb lookups, subspaces m0, m0 + 1, ..., to s in order
// (kBytes: nb need not be a multiple of 4).
template <bool kGlobal, bool kBytes>
__device__ __forceinline__ float score_chunk(const Chunk& c, float s,
                                             const float* s_lut, int m0,
                                             int nb, int K) {
  const float* l = s_lut + (size_t)m0 * K;
#pragma unroll
  for (int j = 0; j < kChunkWords; ++j) {
    if (4 * j < nb) {
      const uint32_t v = c.w[j];
      s += lut_at<kGlobal>(l, v & 0xffu);
      if (!kBytes || 4 * j + 1 < nb)
        s += lut_at<kGlobal>(l, K + ((v >> 8) & 0xffu));
      if (!kBytes || 4 * j + 2 < nb)
        s += lut_at<kGlobal>(l, 2 * K + ((v >> 16) & 0xffu));
      if (!kBytes || 4 * j + 3 < nb)
        s += lut_at<kGlobal>(l, 3 * K + (v >> 24));
      l += 4 * K;
    }
  }
  return s;
}

// A row's chunk by the path the wrapper picked (kBytes: byte loads).
template <bool kBytes>
__device__ __forceinline__ void load_row_chunk(Chunk& c, const uint8_t* row,
                                               int b0, int nb, bool vec) {
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

template <bool kGlobal, bool kBytes>
__global__ void __launch_bounds__(kThreads, 1)
    adc_kernel(const uint8_t* __restrict__ codes,  // (N, M)
               const int32_t* __restrict__ ids,    // (Q, C)
               const uint8_t* __restrict__ valid,  // (Q, C)
               const float* __restrict__ lut,      // (Q, M, K)
               float* __restrict__ out,            // (Q, C)
               int C, int M, int K, int vec) {
  extern __shared__ float4 s_mem[];
  float* s_lut = reinterpret_cast<float*>(s_mem);  // (M, K); none if global
  uint16_t* s_list =
      reinterpret_cast<uint16_t*>(s_lut + (kGlobal ? 0 : M * K));  // (kTile,)
  int* s_cnt = reinterpret_cast<int*>(s_list + kTile);            // (kWarps,)

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

  // 4. start the LUT copy (the global form reads the LUT in place)
  const float* lq = lut + (size_t)q * M * K;
  const int mk = M * K;
  if (!kGlobal) {
    if ((mk & 3) == 0 && (reinterpret_cast<uintptr_t>(lq) & 15) == 0) {
      for (int i = 4 * threadIdx.x; i < mk; i += 4 * kThreads)
        cp_async(s_lut + i, lq + i, true);
    } else {
      for (int i = threadIdx.x; i < mk; i += kThreads)
        cp_async(s_lut + i, lq + i, false);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const float* l_src = kGlobal ? lq : s_lut;

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

  // 2. the first row's loads go out before the wait for the LUT
  const bool wide = vec != 0;
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
  if (!kGlobal) {
    cp_async_wait_all();
    __syncthreads();
  }

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
    float s = score_chunk<kGlobal, kBytes>(cur, 0.f, l_src, 0, first, K);
    for (int b0 = kChunk; b0 < M; b0 += kChunk) {  // rows beyond kChunk
      const int nb = min(M - b0, kChunk);
      Chunk more;
      load_row_chunk<kBytes>(more, row_cur, b0, nb, wide);
      s = score_chunk<kGlobal, kBytes>(more, s, l_src, b0, nb, K);
    }
    out[row + slot] = s;
    cur = next;
    slot = slot_next;
    row_cur = row_next;
  }
}

// One form and row path of the kernel.  The dynamic shared-memory opt-in
// is set once per process for each (the first call).
template <bool kGlobal, bool kBytes>
int launch_adc(const void* codes, const void* ids, const void* valid,
               const void* lut, void* out, int Q, int C, int M, int K,
               int vec, cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      adc_kernel<kGlobal, kBytes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (opt_in != cudaSuccess) return (int)opt_in;
  if (C == 0 || Q == 0) return (int)cudaGetLastError();
  const size_t smem = (kGlobal ? 0 : (size_t)M * K * sizeof(float)) +
                      kTile * sizeof(uint16_t) + kWarps * sizeof(int);
  dim3 grid((C + kTile - 1) / kTile, Q);
  adc_kernel<kGlobal, kBytes><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(lut),
      static_cast<float*>(out), C, M, K, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// path: 0 words, 1 16-byte loads, 2 bytes (pq_adc.row_path); global: the
// LUT read in place (ops.adc_form).
extern "C" int fatrq_pq_adc(const void* codes, const void* ids,
                            const void* valid, const void* lut, void* out,
                            int Q, int C, int M, int K, int path, int global,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = path == 1;
  if (path == 2)
    return global ? launch_adc<true, true>(codes, ids, valid, lut, out, Q, C,
                                           M, K, vec, s)
                  : launch_adc<false, true>(codes, ids, valid, lut, out, Q,
                                            C, M, K, vec, s);
  return global ? launch_adc<true, false>(codes, ids, valid, lut, out, Q, C,
                                          M, K, vec, s)
                : launch_adc<false, false>(codes, ids, valid, lut, out, Q, C,
                                           M, K, vec, s);
}

extern "C" const char* fatrq_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
