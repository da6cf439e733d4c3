// The mixed-radix Stockham passes of an M-point complex FFT in shared
// memory, shared by the forward real FFT (rfft.cu) and the inverse real
// FFT + overlap-add (irfft.cu).
//
// A 256-thread block transforms up to kElems complex values at once: the
// FFTs of fpb consecutive M-point rows between two shared-memory buffers
// (16 KB each), one barrier per pass, in the plan the host gives (Plan,
// kernels/rfft.radices): radix 4 while it fits in M's power-of-two part,
// one radix-2 pass when that part's log2 is odd, then the radix-3, -5 and
// -7 passes. Pass p with sub-transform length ns reads v[s] = in[j + s *
// M/R], multiplies v[s] (s > 0) by the twiddle W_N^(s k N/(ns R)), k = j mod
// ns, runs the R-point DFT and writes y[s] to out[(j - k) R + k + s ns].
// The odd radices are direct R-point DFTs over the sums and differences of
// mirrored inputs, with cos and sin of 2 pi k / R read from the twiddle
// table (W_N^(k N/R)). After the last pass the buffer holds FFT_M of each
// row in natural order. The twiddles W_N^j = exp(-2 pi i j / N), j < N,
// N = 2M, are one host table (float64 math rounded once to float32,
// kernels/rfft.py), read through the read-only cache. Every product and
// sum is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn), so
// nothing is contracted into an FMA and the passes do the plain version's
// float32 operations (kernels/rfft.py: _stage) in its order.
#pragma once

#include "common.cuh"

namespace zt {

constexpr int kElems = 2048;  // complex values a block transforms

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y)),
                     __fadd_rn(__fmul_rn(a.x, w.y), __fmul_rn(a.y, w.x)));
}

// The passes of an M-point FFT: n4 radix-4 passes, then n2 (0 or 1)
// radix-2, n3 radix-3, n5 radix-5 and n7 radix-7 passes.
struct Plan {
  int n4, n2, n3, n5, n7;
};

// One radix-R Stockham pass over the fpb rows of the block (M points
// each): sub-transforms of length ns grow to R ns.
template <int R>
__device__ __forceinline__ void stage(const float2* __restrict__ src,
                                      float2* __restrict__ dst,
                                      const float2* __restrict__ tw, int m,
                                      int fpb, int ns, int n) {
  const int q = m / R;             // butterflies per row
  const int stride = n / (ns * R);  // twiddle index step: N / (ns R)
  // Odd R: cos and sin of 2 pi k / R, from W_N^(k N/R) = (cos, -sin).
  float c[R], sn[R];
  if constexpr (R % 2 == 1) {
#pragma unroll
    for (int k = 1; k < R; ++k) {
      const float2 w = __ldg(tw + k * (n / R));
      c[k] = w.x;
      sn[k] = -w.y;
    }
  }
  for (int b = threadIdx.x; b < fpb * q; b += blockDim.x) {
    const int f = b / q;
    const int j = b - f * q;
    const int k = j % ns;
    const float2* in = src + f * m + j;
    float2 v[R];
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = in[s * q];
#pragma unroll
    for (int s = 1; s < R; ++s) {
      v[s] = cmul(v[s], __ldg(tw + s * k * stride));
    }
    float2 y[R];
    if constexpr (R == 4) {
      const float2 t0 = cadd(v[0], v[2]);
      const float2 t1 = csub(v[0], v[2]);
      const float2 t2 = cadd(v[1], v[3]);
      const float2 d = csub(v[1], v[3]);  // t3 = -i d
      y[0] = cadd(t0, t2);
      y[1] = make_float2(__fadd_rn(t1.x, d.y), __fsub_rn(t1.y, d.x));
      y[2] = csub(t0, t2);
      y[3] = make_float2(__fsub_rn(t1.x, d.y), __fadd_rn(t1.y, d.x));
    } else if constexpr (R == 2) {
      y[0] = cadd(v[0], v[1]);
      y[1] = csub(v[0], v[1]);
    } else {
      // a_p = v_p + v_{R-p}, b_p = v_p - v_{R-p}; y_0 = v_0 + sum a_p; for
      // t = 1..H: A = v_0 + sum_p a_p cos(2 pi p t / R), B = sum_p b_p
      // sin(2 pi p t / R), y_t = A - i B, y_{R-t} = A + i B; sums in p
      // order (kernels/rfft.py: _odd_butterfly).
      constexpr int H = (R - 1) / 2;
      float2 a[H + 1], d[H + 1];
#pragma unroll
      for (int p = 1; p <= H; ++p) {
        a[p] = cadd(v[p], v[R - p]);
        d[p] = csub(v[p], v[R - p]);
      }
      y[0] = v[0];
#pragma unroll
      for (int p = 1; p <= H; ++p) y[0] = cadd(y[0], a[p]);
#pragma unroll
      for (int t = 1; t <= H; ++t) {
        float2 sa = v[0];
        float2 sb = make_float2(__fmul_rn(d[1].x, sn[t]),
                                __fmul_rn(d[1].y, sn[t]));
#pragma unroll
        for (int p = 1; p <= H; ++p) {
          const int kk = p * t % R;
          sa = make_float2(__fadd_rn(sa.x, __fmul_rn(a[p].x, c[kk])),
                           __fadd_rn(sa.y, __fmul_rn(a[p].y, c[kk])));
          if (p > 1) {
            sb = make_float2(__fadd_rn(sb.x, __fmul_rn(d[p].x, sn[kk])),
                             __fadd_rn(sb.y, __fmul_rn(d[p].y, sn[kk])));
          }
        }
        y[t] = make_float2(__fadd_rn(sa.x, sb.y), __fsub_rn(sa.y, sb.x));
        y[R - t] = make_float2(__fsub_rn(sa.x, sb.y), __fadd_rn(sa.y, sb.x));
      }
    }
    float2* out = dst + f * m + (j - k) * R + k;
#pragma unroll
    for (int s = 0; s < R; ++s) out[s * ns] = y[s];
  }
}

// `count` radix-R passes from buf[cur], one barrier after each.
template <int R>
__device__ __forceinline__ void passes(float2 (*buf)[kElems], int& cur,
                                       const float2* __restrict__ tw, int m,
                                       int fpb, int& ns, int n, int count) {
  for (int i = 0; i < count; ++i) {
    stage<R>(buf[cur], buf[cur ^ 1], tw, m, fpb, ns, n);
    cur ^= 1;
    ns *= R;
    __syncthreads();
  }
}

// Every pass of the plan over the fpb rows in buf[cur]; on return buf[cur]
// holds their FFTs, after a barrier.
__device__ __forceinline__ void fft_rows(float2 (*buf)[kElems], int& cur,
                                         const float2* __restrict__ tw, int m,
                                         int fpb, int n, const Plan& plan) {
  int ns = 1;
  passes<4>(buf, cur, tw, m, fpb, ns, n, plan.n4);
  passes<2>(buf, cur, tw, m, fpb, ns, n, plan.n2);
  passes<3>(buf, cur, tw, m, fpb, ns, n, plan.n3);
  passes<5>(buf, cur, tw, m, fpb, ns, n, plan.n5);
  passes<7>(buf, cur, tw, m, fpb, ns, n, plan.n7);
}

// The plan of an M-point FFT (kernels/rfft.py: radices), or false when M
// has a prime factor above 7.
inline bool make_plan(int m, Plan* plan) {
  const int primes[4] = {2, 3, 5, 7};
  int count[8] = {0};
  for (int r : primes) {
    while (m % r == 0) {
      m /= r;
      ++count[r];
    }
  }
  *plan = Plan{count[2] / 2, count[2] % 2, count[3], count[5], count[7]};
  return m == 1;
}

// An even window N in [16, 2 kElems] whose half is 7-smooth, with its plan
// (kernels/rfft.py: fits).
inline bool fft_fits(int n, Plan* plan) {
  return n >= 16 && n <= 2 * kElems && n % 2 == 0 && make_plan(n / 2, plan);
}

inline bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
}

}  // namespace zt
