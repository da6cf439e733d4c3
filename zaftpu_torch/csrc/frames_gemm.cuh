// The main loop the analysis kernels share (fused.cu: frames_rfft,
// frames_op and frames_rfft_full; melfused.cu: spec_rows and mel_rows;
// cqtslab.cu: cqt_magnitudes): one block's tile of
//   acc[i][c*4 + j] += sum_w frame[t][w] * ops[c][w][f]
// for frames t = t0 + ty*TM + i and operator columns f = f0 + tx*4 + j of
// each of the NC stacked components, where frame t is
// sig[t*step .. t*step + WL) times the window (WIN) or as it is (!WIN).
//
// Bound: FP32 arithmetic (NC x 2 x WL FLOP per frame and column; exactness
// forbids the TF32 tensor cores). Design: a register-tiled SIMT GEMM. A
// 256-thread block owns 64 frames x 64 columns of each component and walks
// WL in slices of 16. Per slice it builds the windowed frame tile in shared
// memory directly from the signal (16-byte loads where the hop and pointers
// allow), so frames never reach device memory, and stages the NC operator
// tiles beside it; each thread accumulates a 4 x 4 tile of every component
// from the same A values (zt::slice_fma, which also sums the contraction in
// two levels for accuracy). At 64 frames a block the NC x 16 accumulators
// keep a thread under 128 registers, so two blocks share an SM; 128-frame
// blocks needed ~210 registers and measured 7% slower on the H100 (PERF.md).
// The next slice's loads are in flight while the current one is computed,
// from pointers fixed once per block, and shared memory is double-buffered,
// so one barrier per slice suffices. The operator is padded to whole 64-
// column tiles with zero columns, so its loads need no masks; it stays in
// L2 across blocks. Ragged T is masked at the frame loads.
#pragma once

#include "common.cuh"

namespace zt {
namespace frames {

constexpr int BM = 64;        // frames per block
constexpr int BN = 64;        // operator columns per component per block
constexpr int BK = 16;        // window samples per shared-memory slice
constexpr int TM = BM / 16;   // frames per thread
constexpr int AV = BM / 64;   // 16-byte frame loads per thread
constexpr int APAD = 4;       // keeps the transposed A stores off one bank

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// The signal rows and the window can be read as 16-byte vectors: step, WL
// and the batch stride divisible by 4 and both pointers aligned (a null
// window, which is never read, counts as aligned).
inline bool vec_ok(const void* sig, const void* win, long long sig_len,
                   int WL, int step) {
  return step % 4 == 0 && WL % 4 == 0 && sig_len % 4 == 0 &&
         aligned16(sig) && aligned16(win);
}

// Adds this block's tile to acc (which the caller zeroes). sb: the batch
// item's signal; ops: NC components of (WL, FP) rows, component c at
// ops + c * comp_stride, FP a multiple of BN; win is not read unless WIN.
// Ends with a barrier, so the caller may reuse shared memory after it.
template <bool VEC, int NC, bool WIN = true>
__device__ __forceinline__ void tile(const float* __restrict__ sb,
                                     const float* __restrict__ win,
                                     const float* __restrict__ ops,
                                     long long comp_stride, int T, int WL,
                                     int step, int FP, int t0, int f0,
                                     float (&acc)[TM][4 * NC]) {
  __shared__ __align__(16) float As[2][BK][BM + APAD];
  __shared__ __align__(16) float Bs[2][BK][NC * BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);  // 16 column groups of 4
  const int ty = tid / (BN / 4);  // 16 row groups of TM frames

  // Frame-tile loads. VEC: AV float4 per thread, frames ar + 64j, samples
  // ak..ak+3 of the slice. Scalar: TM floats, frames sr + 16i, sample sk
  // of the slice.
  const int ar = tid / 4;
  const int ak = (tid % 4) * 4;
  const int sr = tid / BK;
  const int sk = tid % BK;
  const float* ap = sb + (long long)(t0 + (VEC ? ar : sr)) * step +
                    (VEC ? ak : sk);
  bool av[AV];
#pragma unroll
  for (int j = 0; j < AV; ++j) av[j] = t0 + ar + 64 * j < T;
  // Operator-tile loads: row bk of the slice, columns bc..bc+3 of each
  // component.
  const int bk = tid / (BN / 4);
  const int bc = (tid % (BN / 4)) * 4;
  const float* bp = ops + (long long)bk * FP + f0 + bc;

  float4 ra[AV];
  float rs[TM];
  float4 rb[NC];
  auto load = [&](int k0) {
    if constexpr (VEC) {
      const int w = k0 + ak;
      float4 wv = zero4();
      if constexpr (WIN) {
        if (w < WL) wv = *reinterpret_cast<const float4*>(win + w);
      }
#pragma unroll
      for (int j = 0; j < AV; ++j) {
        if (w < WL && av[j]) {
          const float4 x =
              *reinterpret_cast<const float4*>(ap + 64LL * j * step + k0);
          ra[j] = WIN ? mul4(x, wv) : x;
        } else {
          ra[j] = zero4();
        }
      }
    } else {
      const int w = k0 + sk;
      float wv = 0.f;
      if constexpr (WIN) {
        if (w < WL) wv = win[w];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (w < WL && t0 + sr + 16 * i < T) {
          const float x = ap[16LL * i * step + k0];
          rs[i] = WIN ? x * wv : x;
        } else {
          rs[i] = 0.f;
        }
      }
    }
    if (k0 + bk < WL) {
      const float* row = bp + (long long)k0 * FP;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        rb[c] = *reinterpret_cast<const float4*>(row + c * comp_stride);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) rb[c] = zero4();
    }
  };
  auto store = [&](int s) {
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < AV; ++j) {
        const int m = ar + 64 * j;
        As[s][ak][m] = ra[j].x;
        As[s][ak + 1][m] = ra[j].y;
        As[s][ak + 2][m] = ra[j].z;
        As[s][ak + 3][m] = ra[j].w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) As[s][sk][sr + 16 * i] = rs[i];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      *reinterpret_cast<float4*>(&Bs[s][bk][c * BN + bc]) = rb[c];
    }
  };

  const int slices = ceil_div(WL, BK);
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) load((s + 1) * BK);
    slice_fma<BK, TM, NC, BN, BM + APAD, NC * BN>(As[cur], Bs[cur], ty, tx,
                                                  acc);
    if (s + 1 < slices) store(cur ^ 1);
    __syncthreads();
  }
}

}  // namespace frames
}  // namespace zt
