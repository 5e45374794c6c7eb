// FaTRQ refinement scoring over a query micro-batch: the multi-level kernel
// with on-card pruning, its bounds-emitting form for the sharded layout, and
// the level-0 scoring kernel over gathered code rows.
//
// All four entry points share the per-candidate device code below
// (load_query, warp_align, level0, deeper), so a candidate's estimate is the
// same sequence of float operations in each; --fmad=false keeps every
// multiply and add rounded apart.
//
// fatrq_refine_level replaces src/repro/kernels/ternary_refine.py::
// ternary_refine_fused (Pallas).  The TPU kernel keeps five (C,) f32 arrays
// of one query in VMEM across all levels; at the main path's C = nprobe*cap
// ~ 46,900 that is ~940 KB, four times the 227 KB a Hopper block can have.
// So the running estimate and the certified bounds live in device memory,
// and each level runs as:
//
//  * score_kernel, grid (ceil(C/kTile), Q): one warp per candidate.  The
//    warp reads the candidate's packed code row BY ID from the (N, G) level
//    store (what the far-memory tier serves; no (Q, C, G) gathered copy is
//    ever made), decodes each byte through a 243-entry byte -> 5-trit table
//    in shared memory, dots the trits with the query's (5, G) digit planes
//    (also in shared memory) and reduces across the warp.  Lane 0 gathers
//    the record's scalars by id and writes est / lo / hi.
//  * prune_kernel, one block per query: tau = kth-smallest hi among the
//    alive candidates (each thread keeps its k smallest, then k rounds of a
//    block-wide arg-min pick the global kth value, which is tie-invariant),
//    alive &= lo <= tau, and the survivor count plus its delta-page share go
//    to counts[q, level] and counts[q, L + level].
//
// Bound: device-memory bytes.  Level 0 reads per candidate slot a 4 B id,
// 4 B d0 and 1 B valid (+1 B delta flag), and per distinct record its G
// code bytes and 16 B of scalars (~0.04 ms at the main path's shapes).  The
// function needs about 2G adds per slot: a per-query (G, 243) table of
// partial dot products (~150 KB, fits shared memory) scores a byte's five
// trits in one lookup, and a 243-entry table gives its nonzero count
// (~0.015 ms).  This kernel does a multiply and an add per trit instead
// (2*5G per slot), and one warp per candidate spends most of its time on
// byte loads, shared-memory plane reads and a shuffle reduction.
//
// Every candidate is scored at every level, as on the TPU; only survivors
// count, so the counts equal the reference's.
//
// fatrq_refine_bounds replaces ternary_refine.py::ternary_refine_fused_bounds
// (Pallas), the sharded layout's refine: the pruning thresholds are pooled
// across shards, so the kernel applies no mask and emits every level's
// certified (lo, hi).  With no pruning nothing depends across levels but a
// candidate's running estimate, so one launch walks all L levels per
// candidate (bounds_kernel: one warp per candidate, est in a register,
// codes and level scalars read by id from the per-level stores).  Invalid
// slots are skipped and get est = lo = hi = +inf: the alive chain starts
// from the valid mask, so they never reach a threshold.  In the sharded
// layout most of each shard's slots are invalid (~92% at 4 shards of the
// 1M x 768 index: list padding, and lists another shard owns), and the
// skip spares their scoring.  Bound: bytes, as above, times L levels of
// code rows, plus the (Q, L, C) lo/hi it writes.
//
// fatrq_refine_level0 replaces ternary_refine.py::ternary_refine_batch and
// ternary_refine (Pallas; the second is the first with Q = 1): level-0
// est / est_raw / margin from code rows already gathered per slot, a
// (Q, C, G) tensor, and per-slot scalars (Q, C, 5).  It reads every
// gathered row and its five scalars once, so it is bound by those bytes
// (~0.17 ms for the main path's 64 x 46,880 slots at G = 154).

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kScoreThreads = 256;  // 8 warps
constexpr int kTile = 256;          // candidates per scoring block
constexpr int kPruneThreads = 512;
constexpr int kMaxK = 64;           // largest top-k the pruning step keeps
constexpr int kMaxLevels = 8;       // levels the bounds kernel walks

struct LevelStores {
  const uint8_t* packed[kMaxLevels];  // per level (N, G)
  const float4* lvl[kMaxLevels];      // per level (N,) [proj, norm, rho, 0]
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

__global__ void score_kernel(const uint8_t* __restrict__ packed,   // (N, G)
                             const int32_t* __restrict__ ids,      // (Q, C)
                             const float* __restrict__ d0,         // (Q, C)
                             const float* __restrict__ qplanes,    // (Q, 5, G)
                             const float4* __restrict__ rec,       // (N,)
                             const float4* __restrict__ lvl,       // (N,)
                             const float* __restrict__ params,     // (Q, 8)
                             float* __restrict__ est,              // (Q, C)
                             float* __restrict__ lo,
                             float* __restrict__ hi,
                             int C, int G, int level, int quantile) {
  extern __shared__ float s_planes[];  // (5, G)
  __shared__ uint16_t s_tab[243];      // byte -> 5 base-3 digits, 2 bits each
  const int q = blockIdx.y;
  load_query(s_planes, s_tab, qplanes + (size_t)q * 5 * G, G);

  const Params p = load_params(params + (size_t)q * 8);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c_end = min(C, (int)(blockIdx.x + 1) * kTile);

  for (int c = blockIdx.x * kTile + warp; c < c_end;
       c += kScoreThreads / 32) {
    const size_t slot = (size_t)q * C + c;
    const int id = ids[slot];
    const float align =
        warp_align(packed + (size_t)id * G, s_tab, s_planes, G, lane);
    if (lane == 0) {
      float e, l, h;
      if (level == 0) {
        const float4 r = rec[id];  // [||d||^2, <x_c,d>, ||d||, rho]
        const Level0 s = level0(align, p, d0[slot], r.x, r.y, r.z, r.w);
        e = s.est;
        level0_bounds(s, p, quantile, &l, &h);
      } else {
        e = deeper(est[slot], align, lvl[id], p, &l, &h);
      }
      est[slot] = e;
      lo[slot] = l;
      hi[slot] = h;
    }
  }
}

__global__ void bounds_kernel(LevelStores st,
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
    const size_t lvl0 = (size_t)q * L * C + c;  // lo/hi at level 0
    if (!valid[slot]) {                         // warp-uniform
      if (lane == 0) {
        est[slot] = INFINITY;
        for (int lv = 0; lv < L; ++lv) {
          lo[lvl0 + (size_t)lv * C] = INFINITY;
          hi[lvl0 + (size_t)lv * C] = INFINITY;
        }
      }
      continue;
    }
    const int id = ids[slot];
    float align =
        warp_align(st.packed[0] + (size_t)id * G, s_tab, s_planes, G, lane);
    float e, l, h;
    {
      const float4 r = rec[id];
      const Level0 s = level0(align, p, d0[slot], r.x, r.y, r.z, r.w);
      e = s.est;
      level0_bounds(s, p, quantile, &l, &h);
    }
    if (lane == 0) {
      lo[lvl0] = l;
      hi[lvl0] = h;
    }
    for (int lv = 1; lv < L; ++lv) {
      align = warp_align(st.packed[lv] + (size_t)id * G, s_tab, s_planes, G,
                         lane);
      e = deeper(e, align, st.lvl[lv][id], p, &l, &h);
      if (lane == 0) {
        lo[lvl0 + (size_t)lv * C] = l;
        hi[lvl0 + (size_t)lv * C] = h;
      }
    }
    if (lane == 0) est[slot] = e;
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

// Opt a scoring kernel in to the (5, G) planes' dynamic shared memory.
template <typename Kernel>
size_t planes_smem(Kernel kernel, int G) {
  const size_t smem = (size_t)5 * G * sizeof(float);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  return smem;
}

}  // namespace

extern "C" int fatrq_refine_level(
    const void* packed, const void* ids, const void* d0, const void* qplanes,
    const void* rec, const void* lvl, const void* params,
    const void* alive_in, const void* is_delta, void* est, void* lo, void* hi,
    void* alive_out, void* counts, int Q, int C, int G, int level, int L,
    int k, int quantile, void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (Q == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = planes_smem(score_kernel, G);
  dim3 grid((C + kTile - 1) / kTile, Q);
  score_kernel<<<grid, kScoreThreads, smem, s>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int32_t*>(ids),
      static_cast<const float*>(d0), static_cast<const float*>(qplanes),
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
  const size_t smem = planes_smem(bounds_kernel, G);
  dim3 grid((C + kTile - 1) / kTile, Q);
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
