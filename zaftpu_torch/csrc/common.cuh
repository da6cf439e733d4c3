// Shared helpers for the zaftpu_torch kernels.
//
// Every kernel is plain CUDA C++ for sm_90a with a C entry point that takes
// raw device pointers and the caller's stream, launches, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ZT_EXPORT extern "C" __attribute__((visibility("default")))

namespace zt {

constexpr int kThreads = 256;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline unsigned int grid_1d(long long work, int per_block) {
  long long blocks = (work + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  // Grid-stride loops cover work beyond this many blocks.
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  return static_cast<unsigned int>(blocks);
}

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// One shared-memory slice of a register-tiled FP32 GEMM:
//   acc[i][j] += sum_kk As[kk][ty*TM + i] * Bs[kk][nb*BN + tx*4 + jj]
// for j = nb*4 + jj. The slice's BK products are summed into a fresh
// partial (started by a multiply, then FMAs) before joining acc, so a long
// contraction is summed in two levels: BK-long runs, then one add per
// slice. A single running sum over a 2048-long contraction cost about 9 dB
// of STFT round-trip SNR on the H100.
template <int BK, int TM, int NB, int BN, int LDA, int LDB>
__device__ __forceinline__ void slice_fma(const float (*As)[LDA],
                                          const float (*Bs)[LDB], int ty,
                                          int tx, float (&acc)[TM][4 * NB]) {
  float p[TM][4 * NB];
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM];
    float b[4 * NB];
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&As[kk][ty * TM + i]);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float4 v =
          *reinterpret_cast<const float4*>(&Bs[kk][nb * BN + tx * 4]);
      b[nb * 4] = v.x;
      b[nb * 4 + 1] = v.y;
      b[nb * 4 + 2] = v.z;
      b[nb * 4 + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < 4 * NB; ++j) {
        p[i][j] = kk == 0 ? a[i] * b[j] : fmaf(a[i], b[j], p[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) acc[i][j] += p[i][j];
  }
}

}  // namespace zt
