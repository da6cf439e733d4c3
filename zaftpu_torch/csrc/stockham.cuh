// The mixed-radix Stockham passes of an M-point complex FFT in shared
// memory: fft_rows, which the real FFT's stores off the static path
// (rfft.cu: rfft_any), the inverse real FFT + overlap-add (irfft.cu) and
// the fast MDCT (mdct.cu) run, and static_fft (below), the same passes
// regrouped for the real FFT's static path (rfft.cu: rfft_kernel).
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
//
// No pass uses the tensor cores: a TF32 or bf16 product (wgmma, mma.sync)
// would change the float32 products and sums that the plain version rounds
// one at a time, and an FFT's few operations a value leave these kernels
// bound by shared memory and latency, not by arithmetic.
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

// ---------------------------------------------------------------------------
// The static real FFT's passes (rfft.cu: rfft_kernel only). The same
// butterflies, twiddle products and sums as fft_rows, in the same order, so
// every value is bit-equal to it and to kernels/rfft.py's plain version;
// what changes is where the values live between passes and how a thread
// finds its indices.
//  - Steps: two consecutive passes of radices R1 and R2 (4 then 4, 4 then
//    2, 3 then 3) run as one step in registers. A thread takes group g of
//    row f and reads the R1 R2 values in[g + t G], G = M / (R1 R2), t = s2 +
//    R2 u: the inputs u of the first pass's butterflies s2 = 0..R2-1 (all
//    with k = g mod ns, so one set of R1 - 1 twiddles), whose outputs s are
//    input s2 of the second pass's butterfly s (k2 = s ns + k); it writes
//    out[(g - k) R1 R2 + k + (s + R1 s3) ns]. Any other pass is a step of
//    its own (R2 = 1). At M = 1,024 (WL 2048) the five radix-4 passes take
//    three steps, three round trips through shared memory.
//  - The first step reads its values straight from the signal (the
//    framing: z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1]); a plan whose first
//    pass is a prime above 7 frames into shared memory first.
//  - A prime pass p from 11 to kRegPrime = 31 runs in registers: a work
//    item takes one butterfly and either the real or the imaginary halves
//    of its outputs (the two use disjoint halves of every sum), twiddles
//    its inputs as it loads them and forms a_u and b_u once, then every
//    sum in u order (kernels/rfft.py: _odd_butterfly) with cos and sin of
//    2 pi (u t mod p) / p at offsets known at compile time in a shared
//    table. Such a plan runs a kernel of its own (REG), so the registers
//    this takes do not cost the other plans their occupancy.
//  - A prime from 37 to kMaxPrime: a work item takes kTile outputs t (and
//    their mirrors p - t) of one butterfly and reads its p inputs once,
//    adding each a_u and b_u to its kTile sums in u order; items run
//    tile-major, so a warp reads one cos/sin pair at a time. It multiplies
//    its inputs by their twiddles (ns > 1) as it reads them: the sub-pass's
//    products, repeated by each of a butterfly's tiles.
//  - No runtime division: every quotient comes from a Divmod, a multiplier
//    the host computes (kernels/rfft.divmod_multiplier).
//  - Twiddles from per-pass tables after W_N in the table (the host's
//    gather, kernels/rfft._pass_tables): pass (R, ns) holds W_N^(s k N/(ns
//    R)) at (s - 1) ns + k, so neighbouring threads read neighbouring
//    entries.
//  - Shared memory padded by one value in 16 (pad): the first step's
//    writes, R1 R2 values apart across threads, hit distinct banks.

// Division of a non-negative x by d, for d x < 2^32: mul = floor(2^32 / d)
// + 1 (0 for d = 1), x / d = umulhi(x, mul).
struct Divmod {
  unsigned mul;
  __device__ __forceinline__ int div(int x) const {
    return mul ? (int)__umulhi((unsigned)x, mul) : x;
  }
};

inline Divmod make_divmod(int d) {
  return Divmod{d == 1 ? 0u : (unsigned)((1ull << 32) / (unsigned)d + 1)};
}

// Shared-memory slot of value i: one pad value after every 16.
constexpr int kPadElems = kElems + kElems / 16;
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

constexpr int kMaxSteps = 8;
constexpr int kTile = 4;  // outputs t of a prime butterfly an item sums
constexpr int kRegPrime = 31;  // the largest prime pass held in registers

// One step: passes of radices r1 and r2 (r2 = 1: one pass; r1 above 7: a
// prime pass), entered at sub-transform length ns, their tables at tw1 and
// tw2 (in float2s from the table's start); cs1 and cs2 = N / r1 and N / r2
// (W_N^(k cs) = (cos, -sin)(2 pi k / r)). items: work items of a block;
// span: groups G = M / (r1 r2) of a row, or a prime pass's butterflies of
// the block, fpb q (items = tiles fpb q, a tile kTile outputs t); q = M /
// r1; a prime up to kRegPrime: items = 2 fpb q, its cos and sin at cso in
// the block's shared table.
struct Step {
  int r1, r2, ns, tw1, tw2, cs1, cs2, items, span, q, cso;
  Divmod by_span, by_ns, by_q;
};

// The static path's plan at window N: M = N/2, fpb rows a block, the
// steps (kernels/rfft.radices' passes, paired).
struct StaticPlan {
  int m, fpb, steps, cs;  // cs: entries of the shared cos/sin table
  Divmod by_m, by_f;  // M and M + 1
  Step step[kMaxSteps];
};

// The plan of an even window fft_fits takes, or false.
inline bool static_plan(int n, StaticPlan* sp) {
  Plan plan;
  if (!fft_fits(n, &plan)) return false;
  int r[24], cnt = 0;
  const int counts[5] = {plan.n4, plan.n2, plan.n3, plan.n5, plan.n7};
  const int radix[5] = {4, 2, 3, 5, 7};
  for (int i = 0; i < 5; ++i) {
    for (int j = 0; j < counts[i]; ++j) r[cnt++] = radix[i];
  }
  for (int i = 0; i < plan.np; ++i) r[cnt++] = plan.p[i];
  int off[24], ns[24];
  for (int i = 0, o = n, x = 1; i < cnt; ++i) {
    off[i] = o;
    ns[i] = x;
    o += (r[i] - 1) * x;
    x *= r[i];
  }
  StaticPlan out{};
  out.m = n / 2;
  out.fpb = kElems / out.m;
  out.by_m = make_divmod(out.m);
  out.by_f = make_divmod(out.m + 1);
  for (int i = 0; i < cnt;) {
    if (out.steps == kMaxSteps) return false;
    const bool pair = i + 1 < cnt &&
                      ((r[i] == 4 && (r[i + 1] == 4 || r[i + 1] == 2)) ||
                       (r[i] == 3 && r[i + 1] == 3));
    Step& st = out.step[out.steps++];
    st.r1 = r[i];
    st.r2 = pair ? r[i + 1] : 1;
    st.ns = ns[i];
    st.tw1 = off[i];
    st.tw2 = pair ? off[i + 1] : 0;
    st.cs1 = n / st.r1;
    st.cs2 = n / st.r2;
    st.q = out.m / st.r1;
    if (st.r1 > kRegPrime) {
      st.span = out.fpb * st.q;
      st.items = ceil_div((st.r1 + 1) / 2, kTile) * st.span;
    } else if (st.r1 > 7) {
      st.span = out.fpb * st.q;
      st.items = 2 * st.span;
      st.cso = out.cs;
      out.cs += st.r1;
    } else {
      st.span = out.m / (st.r1 * st.r2);
      st.items = out.fpb * st.span;
    }
    st.by_span = make_divmod(st.span);
    st.by_ns = make_divmod(st.ns);
    st.by_q = make_divmod(st.q);
    i += pair ? 2 : 1;
  }
  *sp = out;
  return true;
}

// The block's frames in the signal: row f is frame t0 + f (zeros from T
// on); vec: 8-byte signal and window loads.
struct Frames {
  const float* sig;
  const float* win;
  long long t0;
  int T, step, vec;
};

// Values z[g + t G], t < R, of row f from the signal (SIG) or from src.
template <int R, bool SIG>
__device__ __forceinline__ void load_group(const float2* src, const Frames& fr,
                                           int f, int base, int g, int G,
                                           float2 (&v)[R]) {
  if constexpr (SIG) {
    const long long t = fr.t0 + f;
    if (t >= fr.T) {
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = make_float2(0.f, 0.f);
      return;
    }
    const float* p = fr.sig + t * fr.step;
    if (fr.vec) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int m = g + i * G;
        const float2 x = __ldg(reinterpret_cast<const float2*>(p) + m);
        const float2 w = __ldg(reinterpret_cast<const float2*>(fr.win) + m);
        v[i] = make_float2(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y));
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int m = 2 * (g + i * G);
        v[i] = make_float2(__fmul_rn(__ldg(p + m), __ldg(fr.win + m)),
                           __fmul_rn(__ldg(p + m + 1), __ldg(fr.win + m + 1)));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = src[pad(base + g + i * G)];
  }
}

// cos and sin of 2 pi k / R (k = 1..R-1) for an odd R's butterfly.
template <int R>
__device__ __forceinline__ void odd_constants(const float2* __restrict__ tab,
                                              int cs, float (&c)[R],
                                              float (&sn)[R]) {
  if constexpr (R % 2 == 1) {
#pragma unroll
    for (int k = 1; k < R; ++k) {
      const float2 w = __ldg(tab + k * cs);
      c[k] = w.x;
      sn[k] = -w.y;
    }
  }
}

// One step of radices R1 then R2 (R2 = 1: one pass) over the block's rows.
template <int R1, int R2, bool SIG>
__device__ __forceinline__ void fused_step(const float2* src, const Frames& fr,
                                           float2* dst,
                                           const float2* __restrict__ tab,
                                           int M, const Step& st) {
  constexpr int R = R1 * R2;
  const int G = st.span;
  const int ns = st.ns;
  float c1[R1], sn1[R1], c2[R2], sn2[R2];
  odd_constants<R1>(tab, st.cs1, c1, sn1);
  odd_constants<R2>(tab, st.cs2, c2, sn2);
  for (int it = threadIdx.x; it < st.items; it += blockDim.x) {
    const int f = st.by_span.div(it);
    const int g = it - f * G;
    const int a = st.by_ns.div(g);
    const int k = g - a * ns;
    const int base = f * M;
    float2 v[R];
    load_group<R, SIG>(src, fr, f, base, g, G, v);
    float2 w1[R1];
#pragma unroll
    for (int u = 1; u < R1; ++u) {
      w1[u] = __ldg(tab + st.tw1 + (u - 1) * ns + k);
    }
    float2 y[R];  // output s of the first pass's butterfly s2: y[s2 R1 + s]
#pragma unroll
    for (int s2 = 0; s2 < R2; ++s2) {
      float2 x[R1], o[R1];
      x[0] = v[s2];
#pragma unroll
      for (int u = 1; u < R1; ++u) x[u] = cmul(v[s2 + R2 * u], w1[u]);
      dft<R1>(x, c1, sn1, o);
#pragma unroll
      for (int s = 0; s < R1; ++s) y[s2 * R1 + s] = o[s];
    }
    const int out0 = a * R * ns + k;
    if constexpr (R2 == 1) {
#pragma unroll
      for (int s = 0; s < R1; ++s) dst[pad(base + out0 + s * ns)] = y[s];
    } else {
      const int ns2 = ns * R1;
#pragma unroll
      for (int s = 0; s < R1; ++s) {
        float2 x[R2], o[R2];
        x[0] = y[s];
#pragma unroll
        for (int s3 = 1; s3 < R2; ++s3) {
          x[s3] = cmul(y[s3 * R1 + s],
                       __ldg(tab + st.tw2 + (s3 - 1) * ns2 + s * ns + k));
        }
        dft<R2>(x, c2, sn2, o);
#pragma unroll
        for (int s3 = 0; s3 < R2; ++s3) {
          dst[pad(base + out0 + (s + R1 * s3) * ns)] = o[s3];
        }
      }
    }
  }
}

// One prime pass p = st.r1 from 37 to kMaxPrime over the block's rows. An
// item takes outputs t0..t0+kTile-1 (those from 1 to h, and y_0 in the
// first tile) of butterfly j of row f.
__device__ __forceinline__ void prime_step(const float2* src, float2* dst,
                                           const float2* __restrict__ tab,
                                           int M, const Step& st) {
  const int p = st.r1;
  const int h = (p - 1) / 2;
  const int q = st.q;
  const int ns = st.ns;
  const int rows = st.span;
  for (int it = threadIdx.x; it < st.items; it += blockDim.x) {
    const int tile = st.by_span.div(it);
    const int t0 = tile * kTile;
    const int b = it - tile * rows;
    const int f = st.by_q.div(b);
    const int j = b - f * q;
    const int k = j - st.by_ns.div(j) * ns;
    const int row = f * M;
    const int base = row + j;
    const int out0 = row + (j - k) * p + k;
    const float2 v0 = src[pad(base)];
    float2 y0 = v0;
    float2 sa[kTile], sb[kTile];
    int kk[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      sa[i] = v0;
      sb[i] = make_float2(0.f, 0.f);
      kk[i] = 0;
    }
    for (int u = 1; u <= h; ++u) {
      float2 x = src[pad(base + u * q)];
      float2 z = src[pad(base + (p - u) * q)];
      if (ns > 1) {
        x = cmul(x, __ldg(tab + st.tw1 + (u - 1) * ns + k));
        z = cmul(z, __ldg(tab + st.tw1 + (p - u - 1) * ns + k));
      }
      const float2 a = cadd(x, z);
      const float2 d = csub(x, z);
      if (t0 == 0) y0 = cadd(y0, a);
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const int t = t0 + i;
        if (t < 1 || t > h) continue;
        kk[i] += t;
        if (kk[i] >= p) kk[i] -= p;
        const float2 w = __ldg(tab + kk[i] * st.cs1);
        const float c = w.x;
        const float sn = -w.y;
        sa[i] = make_float2(__fadd_rn(sa[i].x, __fmul_rn(a.x, c)),
                            __fadd_rn(sa[i].y, __fmul_rn(a.y, c)));
        const float2 db = make_float2(__fmul_rn(d.x, sn), __fmul_rn(d.y, sn));
        sb[i] = u == 1 ? db : make_float2(__fadd_rn(sb[i].x, db.x),
                                          __fadd_rn(sb[i].y, db.y));
      }
    }
    if (t0 == 0) dst[pad(out0)] = y0;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int t = t0 + i;
      if (t < 1 || t > h) continue;
      dst[pad(out0 + t * ns)] = make_float2(__fadd_rn(sa[i].x, sb[i].y),
                                            __fsub_rn(sa[i].y, sb[i].x));
      dst[pad(out0 + (p - t) * ns)] = make_float2(__fsub_rn(sa[i].x, sb[i].y),
                                                  __fadd_rn(sa[i].y, sb[i].x));
    }
  }
}

// A compiler barrier: loads are not hoisted across it, which bounds the
// registers an unrolled prime butterfly keeps live (at 64 registers the
// kernel spilled 1,256 bytes without it, 36 with one every fourth input).
__device__ __forceinline__ void hold() { asm volatile("" ::: "memory"); }

// One prime pass P from 11 to kRegPrime over the block's rows, in
// registers: an item takes one butterfly and one half of every output,
// the real parts (part 0: a_u = Re v_u + Re v_{P-u}, b_u = Im v_u - Im
// v_{P-u}, the sums Re A and Im B of each t) or the imaginary ones (part
// 1: Im a_u, Re b_u, Im A, Re B), which use disjoint halves of the sums.
// It multiplies its inputs by their twiddles as it loads them (ns > 1;
// both parts make the same products), and reads cos and sin of 2 pi kk /
// P from cs (kk = u t mod P, known at compile time).
template <int P>
__device__ __forceinline__ void prime_reg_step(const float2* src, float2* dst,
                                               const float2* __restrict__ tab,
                                               const float2* cs, int M,
                                               const Step& st) {
  constexpr int H = (P - 1) / 2;
  const int q = st.q;
  const int ns = st.ns;
  const int rows = st.span;
  for (int it = threadIdx.x; it < st.items; it += blockDim.x) {
    const int part = it >= rows;
    const int b = it - part * rows;
    const int f = st.by_q.div(b);
    const int j = b - f * q;
    const int k = j - st.by_ns.div(j) * ns;
    const int row = f * M;
    const int base = row + j;
    const float2 v0 = src[pad(base)];
    float a[H + 1], e[H + 1];
    float y0 = part ? v0.y : v0.x;
#pragma unroll
    for (int u = 1; u <= H; ++u) {
      float2 x = src[pad(base + u * q)];
      float2 z = src[pad(base + (P - u) * q)];
      if (ns > 1) {
        x = cmul(x, __ldg(tab + st.tw1 + (u - 1) * ns + k));
        z = cmul(z, __ldg(tab + st.tw1 + (P - u - 1) * ns + k));
      }
      a[u] = part ? __fadd_rn(x.y, z.y) : __fadd_rn(x.x, z.x);
      e[u] = part ? __fsub_rn(x.x, z.x) : __fsub_rn(x.y, z.y);
      y0 = __fadd_rn(y0, a[u]);
      if (u % 4 == 0) hold();
    }
    float* out = reinterpret_cast<float*>(dst) + part;
    const int out0 = row + (j - k) * P + k;
    out[2 * pad(out0)] = y0;
#pragma unroll
    for (int t = 1; t <= H; ++t) {
      float sa = part ? v0.y : v0.x;
      float sb = 0.f;
#pragma unroll
      for (int u = 1; u <= H; ++u) {
        const float2 w = cs[u * t % P];
        sa = __fadd_rn(sa, __fmul_rn(a[u], w.x));
        const float db = __fmul_rn(e[u], -w.y);
        sb = u == 1 ? db : __fadd_rn(sb, db);
      }
      const float sum = __fadd_rn(sa, sb);
      const float dif = __fsub_rn(sa, sb);
      out[2 * pad(out0 + t * ns)] = part ? dif : sum;
      out[2 * pad(out0 + (P - t) * ns)] = part ? sum : dif;
      hold();
    }
  }
}

// Step st from src (or the signal, SIG) into dst.
// REG: the plan has primes up to kRegPrime (StaticPlan::cs > 0).
template <bool SIG, bool REG>
__device__ __forceinline__ void run_step(const float2* src, const Frames& fr,
                                         float2* dst,
                                         const float2* __restrict__ tab,
                                         const float2* cs, int M,
                                         const Step& st) {
  switch (st.r1 * 8 + st.r2) {
    case 4 * 8 + 4: fused_step<4, 4, SIG>(src, fr, dst, tab, M, st); break;
    case 4 * 8 + 2: fused_step<4, 2, SIG>(src, fr, dst, tab, M, st); break;
    case 3 * 8 + 3: fused_step<3, 3, SIG>(src, fr, dst, tab, M, st); break;
    case 4 * 8 + 1: fused_step<4, 1, SIG>(src, fr, dst, tab, M, st); break;
    case 2 * 8 + 1: fused_step<2, 1, SIG>(src, fr, dst, tab, M, st); break;
    case 3 * 8 + 1: fused_step<3, 1, SIG>(src, fr, dst, tab, M, st); break;
    case 5 * 8 + 1: fused_step<5, 1, SIG>(src, fr, dst, tab, M, st); break;
    case 7 * 8 + 1: fused_step<7, 1, SIG>(src, fr, dst, tab, M, st); break;
    default:
      if constexpr (!SIG && !REG) prime_step(src, dst, tab, M, st);
      if constexpr (!SIG && REG) {
        switch (st.r1) {
          case 11: prime_reg_step<11>(src, dst, tab, cs + st.cso, M, st); break;
          case 13: prime_reg_step<13>(src, dst, tab, cs + st.cso, M, st); break;
          case 17: prime_reg_step<17>(src, dst, tab, cs + st.cso, M, st); break;
          case 19: prime_reg_step<19>(src, dst, tab, cs + st.cso, M, st); break;
          case 23: prime_reg_step<23>(src, dst, tab, cs + st.cso, M, st); break;
          case 29: prime_reg_step<29>(src, dst, tab, cs + st.cso, M, st); break;
          case 31: prime_reg_step<31>(src, dst, tab, cs + st.cso, M, st); break;
          default: prime_step(src, dst, tab, M, st);
        }
      }
  }
}

// The M-point FFTs of the block's fpb frames (each windowed and packed as
// z[m] = x[2m] + i x[2m+1]) by the steps of `plan`, between buf[0] and
// buf[1] (padded); sp: a shared copy of the plan that thread 0 writes
// here; cs: the shared cos/sin table of the primes up to kRegPrime (W_N^(kk
// N/p), kk < p, at each step's cso), written here. Returns the buffer that
// holds them, after a barrier. REG as in run_step.
template <bool REG>
__device__ __forceinline__ int static_fft(float2 (*buf)[kPadElems],
                                          StaticPlan& sp, float2* cs,
                                          const StaticPlan& plan,
                                          const float2* __restrict__ tab,
                                          const Frames& fr) {
  const int M = plan.m;
  if (threadIdx.x == 0) sp = plan;
#pragma unroll
  for (int i = 0; i < kMaxSteps; ++i) {
    const Step& st = plan.step[i];
    if (REG && i < plan.steps && st.r1 > 7 && st.r1 <= kRegPrime) {
      for (int kk = threadIdx.x; kk < st.r1; kk += blockDim.x) {
        cs[st.cso + kk] = __ldg(tab + kk * st.cs1);
      }
    }
  }
  const Step& s0 = plan.step[0];
  int i = 1;
  if (s0.r1 > 7) {
    for (int e = threadIdx.x; e < plan.fpb * M; e += blockDim.x) {
      const int f = plan.by_m.div(e);
      const int m = e - f * M;
      float2 v[1];
      load_group<1, true>(nullptr, fr, f, 0, m, 0, v);
      buf[0][pad(e)] = v[0];
    }
    i = 0;
  } else {
    run_step<true, REG>(nullptr, fr, buf[0], tab, cs, M, s0);
  }
  __syncthreads();
  int cur = 0;
  for (; i < sp.steps; ++i) {
    run_step<false, REG>(buf[cur], fr, buf[cur ^ 1], tab, cs, M, sp.step[i]);
    cur ^= 1;
    __syncthreads();
  }
  return cur;
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
