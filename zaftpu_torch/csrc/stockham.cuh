// The mixed-radix Stockham passes of an M-point complex FFT in shared
// memory, shared by the forward real FFT (rfft.cu) and the inverse real
// FFT + overlap-add (irfft.cu).
//
// A 256-thread block transforms up to kElems complex values at once (the
// stores and the inverse off the static path up to kMaxElems, in dynamic
// shared memory): the FFTs of fpb consecutive M-point rows between two
// shared-memory buffers (16 KB each at kElems), one barrier per pass, with
// the twiddle table of W_n for any n that M divides (n = 2M for the real
// FFT's half-length transform), in the plan the host gives (Plan,
// kernels/rfft.radices): radix 4 while it fits in M's power-of-two part,
// one radix-2 pass when that part's log2 is odd, then the radix-3, -5 and
// -7 passes, then one pass for each prime factor from 11 to kMaxPrime,
// ascending. Pass p with sub-transform length ns reads v[s] = in[j + s *
// M/R], multiplies v[s] (s > 0) by the twiddle W_N^(s k N/(ns R)), k = j mod
// ns, runs the R-point DFT and writes y[s] to out[(j - k) R + k + s ns].
// The odd radices are direct R-point DFTs over the sums and differences of
// mirrored inputs, with cos and sin of 2 pi k / R read from the twiddle
// table (W_N^(k N/R)). After the last pass the buffer holds FFT_M of each
// row in natural order. The twiddles W_N^j = exp(-2 pi i j / N), j < N
// (N = 2M, or N = M for the stores' packed and Bluestein rows), are one
// host table (float64 math rounded once to float32,
// kernels/rfft.py), read through the read-only cache. Every product and
// sum is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn), so
// nothing is contracted into an FMA and the passes do the plain version's
// float32 operations (kernels/rfft.py: _stage) in its order.
//
// The radices up to 7 are templates that hold a butterfly's R values in
// registers. A prime p from 11 to 127 is a runtime value (prime_stage): R
// values a thread do not scale to p = 127, so its work item is one output
// pair (y_t, y_{p-t}) of one butterfly, after a sub-pass that applies the
// twiddles in place.
#pragma once

#include "common.cuh"

namespace zt {

constexpr int kElems = 2048;  // complex values a block transforms
// Output samples a block of the inverse kernels (irfft.cu, mdct.cu) owns in
// its shared-memory accumulator: 2 N_max.
constexpr int kSpan = 4 * kElems;
constexpr int kMaxPrime = 127;  // the largest prime factor of M a pass takes
// Passes of a prime above 7: 11^3 = 1331 <= kElems and 11^4 > kMaxElems.
constexpr int kMaxPrimes = 3;
// The largest row a dynamic-shared-memory block transforms (rfft_any and
// irfft_any, off the static path).
constexpr int kMaxElems = 8192;

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
// radix-2, n3 radix-3, n5 radix-5 and n7 radix-7 passes, then np passes of
// the primes p[0] <= p[1] <= p[2] from 11 to kMaxPrime.
struct Plan {
  int n4, n2, n3, n5, n7;
  int np;
  int p[kMaxPrimes];
};

// The R-point DFT of v into y, the butterfly of a radix-R Stockham pass
// after its twiddle products. Odd R reads cos and sin of 2 pi k / R from c
// and sn (index 1..R-1); even R ignores them.
template <int R>
__device__ __forceinline__ void dft(const float2 (&v)[R],
                                    const float (&c)[R],
                                    const float (&sn)[R], float2 (&y)[R]) {
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
}

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
    dft<R>(v, c, sn, y);
    float2* out = dst + f * m + (j - k) * R + k;
#pragma unroll
    for (int s = 0; s < R; ++s) out[s * ns] = y[s];
  }
}

// Two buffers of `stride` values each from `base` (dynamic shared memory),
// indexed as a float2 (*)[kElems] is: buf[i] for i = 0, 1.
struct Buffers {
  float2* base;
  int stride;
  __device__ __forceinline__ float2* operator[](int i) const {
    return base + i * stride;
  }
};

// `count` radix-R passes from buf[cur], one barrier after each; buf[0] and
// buf[1] are the two buffers (float2 (*)[kElems] in the static blocks,
// Buffers in dynamic shared memory).
template <int R, class Buf>
__device__ __forceinline__ void passes(Buf buf, int& cur,
                                       const float2* __restrict__ tw, int m,
                                       int fpb, int& ns, int n, int count) {
  for (int i = 0; i < count; ++i) {
    stage<R>(buf[cur], buf[cur ^ 1], tw, m, fpb, ns, n);
    cur ^= 1;
    ns *= R;
    __syncthreads();
  }
}

// One radix-p Stockham pass for a prime p from 11 to kMaxPrime, in two
// steps with a barrier between them. First every input v[s], s > 0, is
// multiplied by its twiddle in place in src (the plain version's products;
// src is not read again after the pass), unless the pass is the first (ns
// = 1), whose twiddles are all W^0 = 1 and which the plain version does
// not multiply either. Then a work item (t, f, j) forms output t of
// butterfly j of row f, t = 0..H, H = (p-1)/2: y_0 = v_0 + a_1 + ... +
// a_H, or for t >= 1 A = v_0 + sum_u a_u cos(2 pi u t / p), B = sum_u b_u
// sin(2 pi u t / p), y_t = A - i B and y_{p-t} = A + i B, with a_u = v_u +
// v_{p-u}, b_u = v_u - v_{p-u} and every sum in u order (kernels/rfft.py:
// _odd_butterfly). Items run j fastest, so a warp reads consecutive inputs
// and one cos/sin pair (W_N^(kk N/p), kk = u t mod p) at a time. The u
// loops are unrolled by 4, so an item's shared loads of four terms are in
// flight together.
//
// On an H100 at WL 1102 (passes 19, 29) the twiddles applied inline by
// each item (2H products an item, no sub-pass) ran 8-25% slower, skipping
// the first pass's sub-pass 9-12% faster and the unrolling 4-6% faster
// (scripts/torch_ab.py, PERF.md).
__device__ __forceinline__ void prime_stage(float2* __restrict__ src,
                                            float2* __restrict__ dst,
                                            const float2* __restrict__ tw,
                                            int m, int fpb, int ns, int n,
                                            int p) {
  const int q = m / p;              // butterflies per row
  const int stride = n / (ns * p);  // twiddle index step: N / (ns p)
  const int rest = m - q;           // inputs of a row with s > 0
  if (ns > 1) {
    for (int e = threadIdx.x; e < fpb * rest; e += blockDim.x) {
      const int f = e / rest;
      const int r = e - f * rest + q;  // r = j + s q, s >= 1
      const int s = r / q;
      const int j = r - s * q;
      float2* v = src + f * m + r;
      *v = cmul(*v, __ldg(tw + s * (j % ns) * stride));
    }
    __syncthreads();
  }
  const int h = (p - 1) / 2;
  const int rows = fpb * q;   // butterflies of the block
  const int cstep = n / p;    // W_N^(kk N/p) = (cos, -sin)(2 pi kk / p)
  for (int b = threadIdx.x; b < (h + 1) * rows; b += blockDim.x) {
    const int t = b / rows;
    const int i = b - t * rows;
    const int f = i / q;
    const int j = i - f * q;
    const int k = j % ns;
    const float2* in = src + f * m + j;
    float2* out = dst + f * m + (j - k) * p + k;
    float2 sa = in[0];
    if (t == 0) {
#pragma unroll 4
      for (int u = 1; u <= h; ++u) {
        sa = cadd(sa, cadd(in[u * q], in[(p - u) * q]));
      }
      out[0] = sa;
      continue;
    }
    float2 sb = make_float2(0.f, 0.f);
    int kk = 0;
#pragma unroll 4
    for (int u = 1; u <= h; ++u) {
      kk += t;
      if (kk >= p) kk -= p;
      const float2 w = __ldg(tw + kk * cstep);
      const float c = w.x;
      const float sn = -w.y;
      const float2 x = in[u * q];
      const float2 z = in[(p - u) * q];
      const float2 a = cadd(x, z);
      const float2 d = csub(x, z);
      sa = make_float2(__fadd_rn(sa.x, __fmul_rn(a.x, c)),
                       __fadd_rn(sa.y, __fmul_rn(a.y, c)));
      const float2 db = make_float2(__fmul_rn(d.x, sn), __fmul_rn(d.y, sn));
      sb = u == 1 ? db : make_float2(__fadd_rn(sb.x, db.x),
                                     __fadd_rn(sb.y, db.y));
    }
    out[t * ns] = make_float2(__fadd_rn(sa.x, sb.y), __fsub_rn(sa.y, sb.x));
    out[(p - t) * ns] =
        make_float2(__fsub_rn(sa.x, sb.y), __fadd_rn(sa.y, sb.x));
  }
}

// Every pass of the plan over the fpb rows of m values in buf[cur], with
// the twiddle table of W_n (m divides n); on return buf[cur] holds their
// FFTs, after a barrier.
template <class Buf>
__device__ __forceinline__ void fft_rows(Buf buf, int& cur,
                                         const float2* __restrict__ tw, int m,
                                         int fpb, int n, const Plan& plan) {
  int ns = 1;
  passes<4>(buf, cur, tw, m, fpb, ns, n, plan.n4);
  passes<2>(buf, cur, tw, m, fpb, ns, n, plan.n2);
  passes<3>(buf, cur, tw, m, fpb, ns, n, plan.n3);
  passes<5>(buf, cur, tw, m, fpb, ns, n, plan.n5);
  passes<7>(buf, cur, tw, m, fpb, ns, n, plan.n7);
  for (int i = 0; i < plan.np; ++i) {
    prime_stage(buf[cur], buf[cur ^ 1], tw, m, fpb, ns, n, plan.p[i]);
    cur ^= 1;
    ns *= plan.p[i];
    __syncthreads();
  }
}

// Bluestein's chirp z-transform after its first forward passes, over the
// `rows` rows of L = P values in buf[cur] (each row the FFT of its chirped,
// zero-padded input): times the table B, conjugated, the forward passes
// again, then the first M values of each row conjugated and times conj c
// (kernels/rfft.py: bluestein_plain); a barrier after each step.
template <class Buf>
__device__ __forceinline__ void bluestein_tail(
    Buf buf, int& cur, const float2* __restrict__ tw,
    const float2* __restrict__ chirp, const float2* __restrict__ big, int L,
    int M, int rows, const Plan& plan) {
  for (int e = threadIdx.x; e < rows * L; e += blockDim.x) {
    const float2 y = cmul(buf[cur][e], __ldg(big + e % L));
    buf[cur][e] = make_float2(y.x, -y.y);
  }
  __syncthreads();
  fft_rows(buf, cur, tw, L, rows, L, plan);
  for (int e = threadIdx.x; e < rows * M; e += blockDim.x) {
    const int r = e / M;
    const int k = e - r * M;
    float2* z = buf[cur] + r * L + k;
    *z = cmul(make_float2(z->x, -z->y), __ldg(chirp + k));
  }
  __syncthreads();
}

// The plan of an M-point FFT (kernels/rfft.py: radices), or false when M
// has a prime factor above kMaxPrime (or more than kMaxPrimes primes above
// 7, which no M <= kMaxElems has).
inline bool make_plan(int m, Plan* plan) {
  const int primes[4] = {2, 3, 5, 7};
  int count[8] = {0};
  for (int r : primes) {
    while (m % r == 0) {
      m /= r;
      ++count[r];
    }
  }
  Plan out{count[2] / 2, count[2] % 2, count[3], count[5], count[7], 0,
           {0, 0, 0}};
  // Odd trial divisors from 11: a composite one never divides what is left.
  for (int r = 11; r <= kMaxPrime && m > 1; r += 2) {
    while (m % r == 0) {
      if (out.np == kMaxPrimes) return false;
      m /= r;
      out.p[out.np++] = r;
    }
  }
  *plan = out;
  return m == 1;
}

// An even window N in [16, 2 kElems] whose half has no prime factor above
// kMaxPrime, with its plan (kernels/rfft.py: fits).
inline bool fft_fits(int n, Plan* plan) {
  return n >= 16 && n <= 2 * kElems && n % 2 == 0 && make_plan(n / 2, plan);
}

// How rfft.cu's rfft_any and irfft.cu's irfft_any transform a window that
// fft_fits refuses: an odd N as one complex N-point FFT a frame, an even N
// by its even/odd packing (M = N/2 points); the values a row holds (M, or P
// under Bluestein), the rows of a block and the plan. P is the caller's
// Bluestein length (kernels/rfft.bluestein_length), 0 when the passes take
// M; false when the window or P does not fit. A block holds as many rows
// as fit in the smallest of 2,048, 4,096 and 8,192 values that holds one,
// and allocates only those rows.
struct AnyPlan {
  bool odd, blue;
  int L, rows, cap;
  Plan plan;
};

inline bool any_plan(int n, int P, AnyPlan* a) {
  if (n < 16 || n > 2 * kElems) return false;
  a->odd = n % 2 == 1;
  const int M = a->odd ? n : n / 2;
  a->blue = !make_plan(M, &a->plan);
  if (a->blue ? (P < 2 * M - 1 || P > kMaxElems || !make_plan(P, &a->plan))
              : P != 0) {
    return false;
  }
  a->L = a->blue ? P : M;
  a->cap = a->L <= kElems       ? kElems
           : a->L <= 2 * kElems ? 2 * kElems
                                : kMaxElems;
  a->rows = a->cap / a->L;
  return true;
}

// The inverse kernels' first frame whose N samples reach output position p
// at this hop: max(0, ceil((p - N + 1) / step)).
__device__ inline long long first_frame(long long p, int n, int step) {
  const long long a = p - n + 1;
  return a <= 0 ? 0 : (a + step - 1) / step;
}

inline bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
}

}  // namespace zt
