// FaTRQ progressive refinement over a query micro-batch, one TRQ level per
// call: a scoring launch, then a pruning launch.
//
// Replaces src/repro/kernels/ternary_refine.py::ternary_refine_fused
// (Pallas).  The TPU kernel keeps five (C,) f32 arrays of one query in VMEM
// across all levels; at the main path's C = nprobe*cap ~ 46,900 that is
// ~940 KB, four times the 227 KB a Hopper block can have.  So the running
// estimate and the certified bounds live in device memory, and each level
// runs as:
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

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kScoreThreads = 256;  // 8 warps
constexpr int kTile = 256;          // candidates per scoring block
constexpr int kPruneThreads = 512;
constexpr int kMaxK = 64;           // largest top-k the pruning step keeps

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
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
  for (int i = threadIdx.x; i < 5 * G; i += blockDim.x)
    s_planes[i] = qplanes[(size_t)q * 5 * G + i];
  for (int y = threadIdx.x; y < 243; y += blockDim.x) {
    int t = y, v = 0;
    for (int i = 0; i < 5; ++i) {
      v |= (t % 3) << (2 * i);
      t /= 3;
    }
    s_tab[y] = (uint16_t)v;
  }
  __syncthreads();

  const float* p = params + (size_t)q * 8;
  const float qn = p[0], w0 = p[1], w1 = p[2], w2 = p[3], w3 = p[4];
  const float bias = p[5], zr = p[6], rs = p[7];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c_end = min(C, (int)(blockIdx.x + 1) * kTile);

  for (int c = blockIdx.x * kTile + warp; c < c_end;
       c += kScoreThreads / 32) {
    const size_t slot = (size_t)q * C + c;
    const int id = ids[slot];
    const uint8_t* row = packed + (size_t)id * G;
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
    if (lane == 0) {
      const float align = acc / sqrtf(fmaxf((float)kc, 1.f));  // sum c.q / sqrt k
      float e, l, h;
      if (level == 0) {
        const float4 r = rec[id];  // [||d||^2, <x_c,d>, ||d||, rho]
        const float dz = d0[slot];
        const float e_align = align / fmaxf(qn, 1e-30f);
        const float d_ip = -2.f * r.z * r.w * align;
        e = w0 * dz + w1 * d_ip + w2 * r.x + w3 * r.y + bias;
        if (quantile) {
          l = e - zr;
          h = e + zr;
        } else {
          const float raw = dz + r.x + 2.f * r.y + d_ip;
          const float margin = 2.f * qn * r.z * sqrtf(clamp01(1.f - e_align * e_align)) *
                               sqrtf(clamp01(1.f - r.w * r.w));
          l = raw - margin;
          h = raw + margin;
        }
      } else {
        const float4 v = lvl[id];  // [proj, norm, rho, 0]
        e = est[slot] - 2.f * v.x * align;
        const float rem = v.y * sqrtf(clamp01(1.f - v.z * v.z));
        const float marg = 2.f * qn * rem + rs;
        l = e - marg;
        h = e + marg;
      }
      est[slot] = e;
      lo[slot] = l;
      hi[slot] = h;
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
  const size_t smem = (size_t)5 * G * sizeof(float);
  cudaFuncSetAttribute(score_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
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

extern "C" const char* fatrq_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
