// PQ asymmetric-distance (ADC) scoring for a query micro-batch.
//
// Replaces src/repro/kernels/pq_adc.py::pq_adc (Pallas; on the TPU the
// lookup is a one-hot x LUT product because the TPU has no fast gather).
// Here the gather is native: one block loads one query's (M, K) f32 LUT into
// shared memory (96 KiB at M=96, K=256, above the 48 KB default, hence the
// opt-in attribute) and each thread scores candidates, reading its code row
// BY CANDIDATE ID from the (N, M) code store and summing M shared-memory
// lookups.  Invalid slots get +inf (this fuses stages.adc_score's mask).
//
// Bound: device-memory bytes.  Per candidate it reads a 4 B id, a 1 B valid
// flag and M code bytes and writes a 4 B distance; the LUT is reused from
// shared memory.  A block walks a tile of kTile candidates so the LUT load
// (M*K*4 bytes from L2) is amortised over thousands of candidates.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 4096;   // candidates per block

__global__ void adc_kernel(const uint8_t* __restrict__ codes,    // (N, M)
                           const int32_t* __restrict__ ids,      // (Q, C)
                           const uint8_t* __restrict__ valid,    // (Q, C)
                           const float* __restrict__ lut,        // (Q, M, K)
                           float* __restrict__ out,              // (Q, C)
                           int C, int M, int K) {
  extern __shared__ float s_lut[];
  const int q = blockIdx.y;
  const float* lq = lut + (size_t)q * M * K;
  for (int i = threadIdx.x; i < M * K; i += blockDim.x) s_lut[i] = lq[i];
  __syncthreads();

  const int c_end = min(C, (int)(blockIdx.x + 1) * kTile);
  for (int c = blockIdx.x * kTile + threadIdx.x; c < c_end; c += blockDim.x) {
    const size_t slot = (size_t)q * C + c;
    // M % 4 == 0 and a 4-byte aligned store (the wrapper checks both), so
    // each code row is read as M / 4 words
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(codes + (size_t)ids[slot] * M);
    float s = 0.f;
    for (int j = 0; j < M / 4; ++j) {
      uint32_t v = w[j];
      const int m = 4 * j;
      s += s_lut[(m + 0) * K + (v & 0xff)];
      s += s_lut[(m + 1) * K + ((v >> 8) & 0xff)];
      s += s_lut[(m + 2) * K + ((v >> 16) & 0xff)];
      s += s_lut[(m + 3) * K + (v >> 24)];
    }
    out[slot] = valid[slot] ? s : INFINITY;
  }
}

}  // namespace

extern "C" int fatrq_pq_adc(const void* codes, const void* ids,
                            const void* valid, const void* lut, void* out,
                            int Q, int C, int M, int K, void* stream) {
  const size_t smem = (size_t)M * K * sizeof(float);
  cudaFuncSetAttribute(adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((C + kTile - 1) / kTile, Q);
  if (C > 0 && Q > 0) {
    adc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(ids),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(lut),
        static_cast<float*>(out), C, M, K);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fatrq_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
