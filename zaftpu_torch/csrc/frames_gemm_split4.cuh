// The split4 twin of frames_gemm.cuh's main loop (fused.cu: frames_rfft,
// frames_op, frames_rfft_full and frames_matmul2 under
// ZAFTPU_PRECISION=split4): the same block tile and the same output
// contract, acc[i][c*4 + j] += sum_w frame[t][w] * ops[c][w][f] for frames
// t = t0 + ty*TM + i and columns f = f0 + tx*4 + j, so the kernels' stores
// serve both tiles; the sum is the split4 scheme of split4.cuh.
//
// Replaces the _kernel_split4 bodies of zaftpu/pallas/fused.py (:241 for
// frames_rfft and frames_op, :174 for the full spectrum, :216 for the
// two-output kernel), which split the VMEM frame block in the kernel and
// run four MXU passes against a host-presplit bf16 operator.
//
// Bound: bf16 tensor-core arithmetic, 4 passes x NC x 2 x WL FLOP per frame
// and column: at WL 2048 and 1,025 bins 868 GFLOP per 600-s segment for
// the rDFT, 0.88 ms at the H100's 989 TFLOP/s dense bf16 rate (the exact
// kernels' FP32 bound is 3.24 ms). Design: per 16-sample slice the block
// builds the 64-frame windowed tile in float32 from the signal, as the
// exact tile does (sig x win rounded in FP32 before the split, as in
// zaftpu), splits each value once into bf16 hi and lo in shared memory, and
// stages the presplit operator's hi and lo rows beside it with 16-byte
// loads; the warps then run mma.sync through ldmatrix (split4.cuh), the
// next slice's loads in flight, shared memory double-buffered. At the end
// the fragments pass through shared memory into the exact tile's thread
// layout. A first kernel: no wgmma, TMA or warp specialisation yet.
#pragma once

#include "frames_gemm.cuh"
#include "split4.cuh"

namespace zt {
namespace frames {

// Adds this block's tile to acc (which the caller zeroes), as tile() does,
// by P bf16 passes (split4.cuh). ops: the presplit stack (2, NC, WL, FP)
// bf16, hi then lo, component c of half h at ops + (h * NC + c) *
// comp_stride; FP a multiple of BN. At P = 1 neither the frames' nor the
// operator's lo halves are staged. Ends with a barrier.
template <bool VEC, int NC, bool WIN = true, int P = 4>
__device__ __forceinline__ void tile_split4(
    const float* __restrict__ sb, const float* __restrict__ win,
    const __nv_bfloat16* __restrict__ ops, long long comp_stride, int T,
    int WL, int step, int FP, int t0, int f0, float (&acc)[TM][4 * NC]) {
  using zt::s4::bf16;
  using zt::s4::LDA;
  using zt::s4::LDB;
  static_assert(BM == zt::s4::BM && BN == zt::s4::BN && BK == zt::s4::BK,
                "the split4 tile shares the exact tile's shape");
  constexpr int CPAD = 4;
  constexpr int A_BYTES = 2 * 2 * BM * LDA * 2;       // [stage][half][m][k]
  constexpr int B_BYTES = 2 * 2 * NC * BK * LDB * 2;  // [stage][half][c][k][n]
  constexpr int C_BYTES = BM * (NC * BN + CPAD) * 4;  // the final restage
  constexpr int BYTES =
      A_BYTES + B_BYTES > C_BYTES ? A_BYTES + B_BYTES : C_BYTES;
  __shared__ __align__(16) unsigned char smem[BYTES];
  auto& As = *reinterpret_cast<bf16(*)[2][2][BM][LDA]>(smem);
  auto& Bs = *reinterpret_cast<bf16(*)[2][2][NC][BK][LDB]>(smem + A_BYTES);
  auto& Cs = *reinterpret_cast<float(*)[BM][NC * BN + CPAD]>(smem);

  const int tid = threadIdx.x;
  // Frame-tile loads as in tile(). VEC: one float4 per thread, frame ar,
  // samples ak..ak+3 of the slice. Scalar: TM floats, frames sr + 16i,
  // sample sk.
  const int ar = tid / 4;
  const int ak = (tid % 4) * 4;
  const int sr = tid / BK;
  const int sk = tid % BK;
  const float* ap = sb + (long long)(t0 + (VEC ? ar : sr)) * step +
                    (VEC ? ak : sk);
  const bool av = t0 + ar < T;
  // Operator loads: NC 16-byte chunks per thread; chunk q = tid + 256 j is
  // 8 columns (q % 8) of slice row (q / 8) % 16 of half / component q / 128.
  const bf16* bp[NC];
  int brow[NC];
  bool bneed[NC];  // chunk j is a hi half, or P > 1
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int q = tid + kThreads * j;
    const int hc = q >> 7;
    bneed[j] = P > 1 || hc < NC;
    brow[j] = (q >> 3) & 15;
    bp[j] = ops + (long long)hc * comp_stride + (long long)brow[j] * FP + f0 +
            (q & 7) * 8;
  }

  float4 ra;
  float rs[TM];
  uint4 rb[NC];
  auto load = [&](int k0) {
    if constexpr (VEC) {
      const int w = k0 + ak;
      float4 wv = zero4();
      if constexpr (WIN) {
        if (w < WL) wv = *reinterpret_cast<const float4*>(win + w);
      }
      if (w < WL && av) {
        const float4 x = *reinterpret_cast<const float4*>(ap + k0);
        ra = WIN ? mul4(x, wv) : x;
      } else {
        ra = zero4();
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
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      rb[j] = bneed[j] && k0 + brow[j] < WL
                  ? *reinterpret_cast<const uint4*>(bp[j] + (long long)k0 * FP)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&](int s) {
    if constexpr (VEC) {
      uint2 hi, lo;
      if constexpr (P == 1) {
        hi = zt::s4::hi4v(ra);
      } else {
        zt::s4::split4v(ra, hi, lo);
        *reinterpret_cast<uint2*>(&As[s][1][ar][ak]) = lo;
      }
      *reinterpret_cast<uint2*>(&As[s][0][ar][ak]) = hi;
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if constexpr (P == 1) {
          As[s][0][sr + 16 * i][sk] = __float2bfloat16_rn(rs[i]);
        } else {
          zt::s4::split1(rs[i], As[s][0][sr + 16 * i][sk],
                         As[s][1][sr + 16 * i][sk]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int q = tid + kThreads * j;
      const int hc = q >> 7;
      if (bneed[j]) {
        *reinterpret_cast<uint4*>(
            &Bs[s][hc / NC][hc % NC][brow[j]][(q & 7) * 8]) = rb[j];
      }
    }
  };

  zt::s4::Frag<NC> hh, cr;
  zt::s4::zero<NC>(hh);
  zt::s4::zero<NC>(cr);
  const int slices = ceil_div(WL, BK);
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) load((s + 1) * BK);
    zt::s4::slice<NC, P>(As[cur], Bs[cur], hh, cr);
    if (s + 1 < slices) store(cur ^ 1);
    __syncthreads();
  }

  // Restage cr + hh from the mma fragments into the exact tile's layout.
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          Cs[zt::s4::frag_row(m, r)][c * BN + zt::s4::frag_col(n, r)] =
              cr[c][m][n][r] + hh[c][m][n][r];
        }
  __syncthreads();
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 v =
          *reinterpret_cast<const float4*>(&Cs[ty * TM + i][c * BN + tx * 4]);
      acc[i][c * 4] += v.x;
      acc[i][c * 4 + 1] += v.y;
      acc[i][c * 4 + 2] += v.z;
      acc[i][c * 4 + 3] += v.w;
    }
  }
  __syncthreads();
}

}  // namespace frames
}  // namespace zt
