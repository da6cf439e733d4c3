// The mixed-radix Stockham passes of an M-point complex FFT, regrouped into
// register steps between two shared-memory buffers: static_fft, which the
// real FFT (rfft.cu: rfft_kernel), the inverse real FFT + overlap-add
// (irfft.cu: irfft_kernel) and the fast MDCT and IMDCT (mdct.cu) run on
// the static path, and any_fft, which rfft_any and irfft_any run off it,
// each reading its first step's values from its own source (the signal,
// the spectrum, the folded frame, the coefficients, or Bluestein's first
// FFT).
//
// A 256-thread block transforms up to kElems complex values at once (the
// stores and the inverse off the static path up to kMaxElems, in dynamic
// shared memory): the FFTs of fpb consecutive M-point rows, with the
// twiddle table of W_n for any n that M divides (n = 2M for the real FFT's
// half-length transform and the MDCT's quarter-length one), in the plan
// the host gives (Plan, kernels/rfft.radices): radix 4 while it fits in
// M's power-of-two part, one radix-2 pass when that part's log2 is odd,
// then the radix-3, -5 and -7 passes, then one pass for each prime factor
// from 11 to kMaxPrime, ascending. Pass p with sub-transform length ns
// reads v[s] = in[j + s * M/R], multiplies v[s] (s > 0) by the twiddle
// W_N^(s k N/(ns R)), k = j mod ns, runs the R-point DFT and writes y[s]
// to out[(j - k) R + k + s ns]. The odd radices are direct R-point DFTs
// over the sums and differences of mirrored inputs, with cos and sin of 2
// pi k / R read from the twiddle table (W_N^(k N/R)); a prime above 7 in
// the first pass (ns = 1) skips its twiddle products, which are all by W^0
// = 1. After the last pass the buffer holds FFT_M of each row in natural
// order. The twiddles W_N^j = exp(-2 pi i j / N), j < N (N = 2M, or N = M
// for the stores' packed and Bluestein rows), are one host table (float64
// math rounded once to float32, kernels/rfft.py), read through the
// read-only cache. Every product and sum is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn), so nothing is contracted into an FMA
// and the steps do the plain version's float32 operations (kernels/rfft.py:
// _stage) in its order.
//
// No pass uses the tensor cores: a TF32 or bf16 product (wgmma, mma.sync)
// would change the float32 products and sums that the plain version rounds
// one at a time, and an FFT's few operations a value leave these kernels
// bound by shared memory and latency, not by arithmetic.
#pragma once

#include "common.cuh"

namespace zt {

constexpr int kElems = 2048;  // complex values a block transforms
// The most output samples a block of the inverse kernels (irfft.cu, mdct.cu)
// owns in its shared-memory accumulator (span_for): 2 N_max.
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

// Two buffers of `stride` values each from `base` (dynamic shared memory),
// indexed as a float2 (*)[kElems] is: buf[i] for i = 0, 1.
struct Buffers {
  float2* base;
  int stride;
  __device__ __forceinline__ float2* operator[](int i) const {
    return base + i * stride;
  }
};

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

// ---------------------------------------------------------------------------
// The steps (rfft.cu: rfft_kernel and rfft_any; irfft.cu: irfft_kernel and
// irfft_any, whose first steps read the spectrum; mdct.cu: mdct_kernel and
// imdct_ola_kernel, whose first steps read the folded frame and the
// coefficients). The butterflies, twiddle products and sums of the passes
// above in their order, so every value is bit-equal to kernels/rfft.py's
// plain version (_stage, pass by pass); what changes is where the values
// live between passes and how a thread finds its indices.
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

// The steps of an M-point FFT (kernels/rfft.radices' passes, paired) over
// fpb rows a block: M = N/2 on the static path at window N (static_plan),
// the FFT's or Bluestein's length off it (any_plan).
struct StaticPlan {
  int m, fpb, steps, cs;  // cs: entries of the shared cos/sin table
  Divmod by_m, by_f;  // M and M + 1
  Step step[kMaxSteps];
};

// The steps of an m-point FFT (make_plan's passes, paired) with the
// twiddle table of W_n (m divides n) and the per-pass tables from tw0 (in
// float2s from the table's start), fpb rows of m values a block; false when
// m has a prime factor above kMaxPrime or the steps do not fit. single_first:
// the first pass is a step of its own, never paired with the next (irfft.cu's
// first step reads each pair of mirrored inputs once; mdct.cu's forward
// spreads its signal reads over twice the threads).
inline bool steps_plan(int m, int n, int tw0, int fpb, bool single_first,
                       StaticPlan* sp) {
  Plan plan;
  if (!make_plan(m, &plan)) return false;
  int r[24], cnt = 0;
  const int counts[5] = {plan.n4, plan.n2, plan.n3, plan.n5, plan.n7};
  const int radix[5] = {4, 2, 3, 5, 7};
  for (int i = 0; i < 5; ++i) {
    for (int j = 0; j < counts[i]; ++j) r[cnt++] = radix[i];
  }
  for (int i = 0; i < plan.np; ++i) r[cnt++] = plan.p[i];
  int off[24], ns[24];
  for (int i = 0, o = tw0, x = 1; i < cnt; ++i) {
    off[i] = o;
    ns[i] = x;
    o += (r[i] - 1) * x;
    x *= r[i];
  }
  StaticPlan out{};
  out.m = m;
  out.fpb = fpb;
  out.by_m = make_divmod(out.m);
  out.by_f = make_divmod(out.m + 1);
  for (int i = 0; i < cnt;) {
    if (out.steps == kMaxSteps) return false;
    const bool pair = (i > 0 || !single_first) && i + 1 < cnt &&
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

// The plan of an even window fft_fits takes (M = N/2 points, the table W_N
// and its per-pass tables after it, kElems / M rows a block), or false;
// single_first as in steps_plan.
inline bool static_plan(int n, StaticPlan* sp, bool single_first = false) {
  Plan plan;
  return fft_fits(n, &plan) &&
         steps_plan(n / 2, n, n, kElems / (n / 2), single_first, sp);
}

// How rfft.cu's rfft_any and irfft.cu's irfft_any transform a window that
// fft_fits refuses: an odd N as one complex N-point FFT a frame, an even N
// by its even/odd packing (M = N/2 points); L, the values a row holds (M,
// or P under Bluestein: P is the caller's Bluestein length,
// kernels/rfft.bluestein_length, 0 when the passes take M); as many rows as
// fit in the smallest of 2,048, 4,096 and 8,192 values that holds one;
// stride, the float2s of one padded buffer of those rows; the steps
// of the L-point FFT (steps_plan: the table W_L, its per-pass tables after
// the store tables, kernels/rfft.kernel_tables, tw0 entries from W_L's
// start); by_h and by_f divide by F + 1 and F, F = N/2 rounded down. False
// when the window or P does not fit, or when a Bluestein plan's first step
// is not two radix-4 passes (the only first step its kernels build) or it
// holds a prime from 11 to kRegPrime (they have no register-prime variant):
// no bluestein_length from 16 to 4,096 does either.
struct AnyPlan {
  bool odd, blue;
  int M, L, rows, stride;
  StaticPlan sp;
  Divmod by_h, by_f;
};

// Float2s of a padded buffer of x values (pad(x - 1) < the result).
inline int padded_len(int x) { return x + (x >> 4) + 1; }

inline bool any_plan(int n, int P, AnyPlan* a) {
  if (n < 16 || n > 2 * kElems) return false;
  Plan plan;
  a->odd = n % 2 == 1;
  a->M = a->odd ? n : n / 2;
  a->blue = !make_plan(a->M, &plan);
  if (a->blue ? (P < 2 * a->M - 1 || P > kMaxElems) : P != 0) return false;
  a->L = a->blue ? P : a->M;
  const int cap = a->L <= kElems       ? kElems
                  : a->L <= 2 * kElems ? 2 * kElems
                                       : kMaxElems;
  a->rows = cap / a->L;
  a->stride = padded_len(a->rows * a->L);
  // The store tables: W_N, then under Bluestein W_P, conj c (M) and B (P).
  const int tw0 = a->blue ? 2 * P + a->M : n;
  if (!steps_plan(a->L, a->L, tw0, a->rows, false, &a->sp)) return false;
  if (a->blue && (a->sp.step[0].r1 != 4 || a->sp.step[0].r2 != 4 ||
                  a->sp.cs != 0)) {
    return false;
  }
  a->by_h = make_divmod(n / 2 + 1);
  a->by_f = make_divmod(n / 2);
  return true;
}

// The block's frames in the signal: row f is frame t0 + f (zeros from T
// on); vec: 8-byte signal and window loads. The first step's source of its
// values (static_fft's Src; irfft.cu has another, the spectrum's).
struct Frames {
  const float* sig;
  const float* win;
  long long t0;
  int T, step, vec;

  // Values z[g + i G], i < R, of row f: the windowed frame packed as z[m]
  // = x[2m] w[2m] + i x[2m+1] w[2m+1].
  template <int R>
  __device__ __forceinline__ void load(int f, int g, int G,
                                       float2 (&v)[R]) const {
    const long long t = t0 + f;
    if (t >= T) {
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = make_float2(0.f, 0.f);
      return;
    }
    const float* p = sig + t * step;
    if (vec) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int m = g + i * G;
        const float2 x = __ldg(reinterpret_cast<const float2*>(p) + m);
        const float2 w = __ldg(reinterpret_cast<const float2*>(win) + m);
        v[i] = make_float2(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y));
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int m = 2 * (g + i * G);
        v[i] = make_float2(__fmul_rn(__ldg(p + m), __ldg(win + m)),
                           __fmul_rn(__ldg(p + m + 1), __ldg(win + m + 1)));
      }
    }
  }
};

// Values z[g + t G], t < R, of row f from the source (SIG: in.load) or
// from src.
template <int R, bool SIG, class Src>
__device__ __forceinline__ void load_group(const float2* src, const Src& in,
                                           int f, int base, int g, int G,
                                           float2 (&v)[R]) {
  if constexpr (SIG) {
    in.template load<R>(f, g, G, v);
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
template <int R1, int R2, bool SIG, class Src>
__device__ __forceinline__ void fused_step(const float2* src, const Src& fr,
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

// Step st from src (or the source fr, SIG) into dst.
// REG: the plan has primes up to kRegPrime (StaticPlan::cs > 0).
template <bool SIG, bool REG, class Src>
__device__ __forceinline__ void run_step(const float2* src, const Src& fr,
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

// The shared cos/sin table of the plan's primes up to kRegPrime (W_N^(kk
// N/p), kk < p, at each step's cso); REG as in run_step.
template <bool REG>
__device__ __forceinline__ void prime_table(float2* cs, const StaticPlan& plan,
                                            const float2* __restrict__ tab) {
#pragma unroll
  for (int i = 0; i < kMaxSteps; ++i) {
    const Step& st = plan.step[i];
    if (REG && i < plan.steps && st.r1 > 7 && st.r1 <= kRegPrime) {
      for (int kk = threadIdx.x; kk < st.r1; kk += blockDim.x) {
        cs[st.cso + kk] = __ldg(tab + kk * st.cs1);
      }
    }
  }
}

// The M-point FFTs of the block's fpb rows by the steps of `plan`, between
// buf[0] and buf[1] (padded), the first step reading its values from the
// source fr and writing buf[start] (a plan whose first pass is a prime
// above 7 has fr's values stored in buf[start] first); sp and cs: the
// plan's shared copy and the primes' cos/sin table (prime_table), both
// written before the call. Returns the buffer that holds the FFTs, after a
// barrier. REG as in run_step. The inverse kernels (irfft.cu, mdct.cu)
// start each group of frames in the buffer the group before left free, so
// its overlap-add needs no barrier before the next group's first step.
template <bool REG, class Src>
__device__ __forceinline__ int fft_steps(float2 (*buf)[kPadElems],
                                         const StaticPlan& sp,
                                         const float2* cs,
                                         const StaticPlan& plan,
                                         const float2* __restrict__ tab,
                                         const Src& fr, int start) {
  const int M = plan.m;
  const Step& s0 = plan.step[0];
  int i = 1;
  if (s0.r1 > 7) {
    for (int e = threadIdx.x; e < plan.fpb * M; e += blockDim.x) {
      const int f = plan.by_m.div(e);
      const int m = e - f * M;
      float2 v[1];
      load_group<1, true>(nullptr, fr, f, 0, m, 0, v);
      buf[start][pad(e)] = v[0];
    }
    i = 0;
  } else {
    run_step<true, REG>(nullptr, fr, buf[start], tab, cs, M, s0);
  }
  __syncthreads();
  int cur = start;
  for (; i < sp.steps; ++i) {
    run_step<false, REG>(buf[cur], fr, buf[cur ^ 1], tab, cs, M, sp.step[i]);
    cur ^= 1;
    __syncthreads();
  }
  return cur;
}

// The M-point FFTs of the block's fpb frames (rfft.cu: each windowed and
// packed as z[m] = x[2m] + i x[2m+1]; mdct.cu: folded and pre-twiddled) by
// fft_steps from buf[0]; sp: a shared copy of the plan that thread 0
// writes here; cs: the shared cos/sin table of the primes up to kRegPrime,
// written here (prime_table). Returns the buffer that holds them, after a
// barrier. REG as in run_step; fr: the frames (Frames), or another source
// with Frames' load.
template <bool REG, class Src>
__device__ __forceinline__ int static_fft(float2 (*buf)[kPadElems],
                                          StaticPlan& sp, float2* cs,
                                          const StaticPlan& plan,
                                          const float2* __restrict__ tab,
                                          const Src& fr) {
  if (threadIdx.x == 0) sp = plan;
  prime_table<REG>(cs, plan, tab);
  return fft_steps<REG>(buf, sp, cs, plan, tab, fr, 0);
}

// The first steps the off-rule kernels build (any_fft): kQuadFirst only
// two radix-4 passes (a Bluestein length, any_plan); kOddFirst an odd
// length's (3 then 3, 3, 5 or 7). Fewer first steps, less code to compile
// for each source a kernel reads.
enum First { kQuadFirst, kOddFirst };

template <int FIRST, class Src>
__device__ __forceinline__ void run_first(const Src& fr, float2* dst,
                                          const float2* __restrict__ tab,
                                          int M, const Step& st) {
  if constexpr (FIRST == kQuadFirst) {
    fused_step<4, 4, true>(nullptr, fr, dst, tab, M, st);
  } else {
    switch (st.r1 * 8 + st.r2) {
      case 3 * 8 + 3: fused_step<3, 3, true>(nullptr, fr, dst, tab, M, st); break;
      case 3 * 8 + 1: fused_step<3, 1, true>(nullptr, fr, dst, tab, M, st); break;
      case 5 * 8 + 1: fused_step<5, 1, true>(nullptr, fr, dst, tab, M, st); break;
      default: fused_step<7, 1, true>(nullptr, fr, dst, tab, M, st);
    }
  }
}

// Bluestein's second FFT's first-step source: the first FFT's rows of L
// values (padded, in shared memory) times the table B, conjugated
// (kernels/rfft.py: bluestein_plain).
struct BlueMid {
  const float2* z;
  const float2* big;
  int L;

  template <int R>
  __device__ __forceinline__ void load(int f, int g, int G,
                                       float2 (&v)[R]) const {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = g + i * G;
      const float2 y = cmul(z[pad(f * L + m)], __ldg(big + m));
      v[i] = make_float2(y.x, -y.y);
    }
  }
};

// Value k of the row at base of the last FFT's buffer z (padded): the FFT
// itself, or under BLUE its conjugate times conj c[k] (k < M), the end of
// Bluestein's chirp z-transform, read where the stores (rfft.cu) and the
// overlap-add (irfft.cu) need it.
template <bool BLUE>
__device__ __forceinline__ float2 blue_value(const float2* z, int base,
                                             const float2* __restrict__ chirp,
                                             int k) {
  const float2 y = z[pad(base + k)];
  if constexpr (!BLUE) return y;
  return cmul(make_float2(y.x, -y.y), __ldg(chirp + k));
}

// The L-point FFTs of the block's rows off the static path (rfft.cu's
// rfft_any, irfft.cu's irfft_any) by the steps of `plan`, the first step
// reading fr (FIRST as in run_first; a plan whose first pass is a prime
// above 7 has fr's values framed into buf[start] first) and writing
// buf[start]; under BLUE then Bluestein's second forward FFT, whose first
// step reads the first's rows times B (big), conjugated (BlueMid). One loop
// runs the steps after the first for both FFTs, so a kernel holds one copy
// of their code (on an H100 the Bluestein stores ran 0.91-0.96 times as
// long as with two copies: PERF.md). sp: the plan's shared copy and cs the
// primes' cos/sin table (prime_table), both
// written before the call; REG as in run_step. Returns the buffer that
// holds the FFTs, after a barrier.
template <int FIRST, bool REG, bool BLUE, class Src>
__device__ __forceinline__ int any_fft(Buffers buf, const StaticPlan& sp,
                                       const float2* cs,
                                       const StaticPlan& plan,
                                       const float2* __restrict__ tab,
                                       const Src& fr,
                                       const float2* __restrict__ big,
                                       int start) {
  const int M = plan.m;
  const Step& s0 = plan.step[0];
  int cur = start;
#pragma unroll 1
  for (int k = 0; k < (BLUE ? 2 : 1); ++k) {
    int i = 1;
    if (k == 0 && !BLUE && s0.r1 > 7) {
      for (int e = threadIdx.x; e < plan.fpb * M; e += blockDim.x) {
        const int f = plan.by_m.div(e);
        const int m = e - f * M;
        float2 v[1];
        load_group<1, true>(nullptr, fr, f, 0, m, 0, v);
        buf[start][pad(e)] = v[0];
      }
      i = 0;
    } else if (k == 0) {
      run_first<FIRST>(fr, buf[start], tab, M, s0);
    } else {
      run_first<kQuadFirst>(BlueMid{buf[cur], big, M}, buf[cur ^ 1], tab, M,
                            s0);
      cur ^= 1;
    }
    __syncthreads();
    for (; i < sp.steps; ++i) {
      run_step<false, REG>(buf[cur], fr, buf[cur ^ 1], tab, cs, M,
                           sp.step[i]);
      cur ^= 1;
      __syncthreads();
    }
  }
  return cur;
}

// The output samples a block of the inverse kernels (irfft.cu's
// irfft_kernel and irfft_any, mdct.cu's imdct_ola_kernel) owns: a multiple m
// of the hop (m step <= kSpan), m + (N - 1) / step frames a block away from
// the signal's ends, in groups of fpb. Blocks run about a group's time a
// group, `slots` at once (SMs times the blocks an SM holds), so m
// minimises the waves of blocks times the groups a block (the larger m on a
// tie): on a long signal the fewest groups per output frame (WL 2048 / hop
// 1024: 7 hops, whose 8 frames fill 4 groups of 2; 8,192 samples took 9
// frames, 5 groups), on a short one more, shorter blocks.
inline int span_for(int n, int step, int fpb, long long out_len, int batch,
                    long long slots) {
  long long best_cost = -1;
  int best = 1;
  for (int m = 1; m * step <= kSpan; ++m) {
    const long long blocks = (out_len + m * step - 1) / (m * step) * batch;
    const long long cost = (blocks + slots - 1) / slots *
                           ceil_div(m + (n - 1) / step, fpb);
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = m;
    }
  }
  return best * step;
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
