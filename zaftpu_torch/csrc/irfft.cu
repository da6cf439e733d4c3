// Inverse real FFT + overlap-add in one launch, the frames never stored:
//   y[b, p] = sum_t s * irfft_N(H[b, t])[p - t*step]
// over the frames t in [0, T) with 0 <= p - t*step < N, summed t
// descending (c = r - t ascending for p = r*step + j, left-associated, from
// 0), s = scale / N rounded once to float32 on the host. H is the
// Hermitian-folded half spectrum (N/2 + 1 bins, N/2 rounded down); the
// imaginary parts of DC and Nyquist are not read, as an inverse real FFT
// ignores them. Any N from 16 to 4096, any hop in [1, N]: irfft_kernel
// (below) at an even N whose half is free of prime factors above 127
// (kernels/rfft.py: fits, 1,263 windows), irfft_any at every other N (an
// odd N, a prime above 127 by Bluestein).
//
// Replaces zaftpu/pallas/synth.py: _gemm_ola_impl as istft_ola reaches it
// (B4) and its _kernel_split4 (B4-s4) on every dial at those window
// lengths; synth.cu's GEMM kernels keep an explicit operator,
// ZAFTPU_FFT=matmul and a window below 16 (kernels/synth.py states the
// rule). The TPU kernels contract each frame with a dense (2 (N/2+1), N)
// inverse operator: 2 N (N + 2) FLOP per frame. The FFT does about 2.5 N
// log2 N at a smooth N and more at a large prime factor, which leaves this
// kernel bound by its bytes: the spectrum read once and the signal written
// once, 0.095 ms from the folded planes at the 600-s WL 2048 and WL 1102
// shapes on an H100 (3.35 TB/s), 0.158 ms from the full spectrum.
//
// irfft_kernel reads H through one of three loads, one kernel body:
//  - Planes (zt_irfft_ola): two float32 planes (batch, T, N/2 + 1).
//  - Complex<true> (zt_irfft_ola_full, istft's route at these windows):
//    the full complex64 spectrum (batch, T, N) in its own strides (a
//    bins-major spectrum or a column slice is read in place), folded in
//    the load, H[k] = (Z[k] + conj Z[(N - k) mod N]) / 2 in the fold's
//    order (mirror.cu's fold_kernel): the index-op fold's 423-MB read and
//    212-MB write at the 600-s WL 2048 shape, and its planes' read here,
//    are gone.
//  - Complex<false> (zt_irfft_ola_window): Griffin-Lim's complex64 half
//    spectrum (batch, T, N/2 + 1) as it holds it, no copy of its planes.
//
// Design: a 256-thread block owns `span` consecutive output samples of one
// batch row (grid x; the batch on grid y) in a shared-memory accumulator,
// so every hop from 1 to N works and each sample is written once,
// coalesced, with no atomics and nothing carried between blocks. span
// (zt::span_for) is the multiple of the hop up to kSpan = 8,192 whose block
// transforms the fewest groups per output frame: at WL 2048 / hop 1024,
// 7 hops, whose 8 frames fill 4 groups of 2 (8,192 samples took 9 frames,
// 5 groups). The block transforms the frames that reach its samples, fpb
// = 2048 / (N/2) at a time (a group), from the highest frame index down;
// the frames on both sides of a block's edge are transformed by both
// neighbours. For each group:
//  1. Inverse split step: Z[k] = (H[k] + conj H[M-k]) + i W_N^-k (H[k] -
//     conj H[M-k]), k = 0..M-1 (M = N/2), is twice the M-point DFT of
//     x[2j] + i x[2j+1], x = irfft_N(H) (numpy's normalisation), so the
//     unnormalised M-point inverse of Z is N (x[2j] + i x[2j+1]), and s =
//     scale / N turns it into scale * x. The inverse runs as conj ->
//     forward passes -> conj: the rows hold conj Z and x[2j] = Re, x[2j+1]
//     = -Im. The first step reads the spectrum from global memory into
//     registers. Where the first pass is a step of its own (the host
//     splits it off where that costs no step: WL 2048's five radix-4
//     passes take three steps either way) and the plan has no register
//     prime, it is first_step: a work item takes a group of the first
//     pass's butterflies and its mirror group, forms conj Z of both (each
//     pair H[k], H[M-k] read once), runs both butterflies and writes the
//     next buffer (on an H100, 1.26 times faster than one group an item
//     at WL 2048).
//     Otherwise zt::run_step's first step loads through Rows::load, each
//     conj Z from its two bins: first_step's code cost the register-prime
//     kernels their registers (on an H100 1.29 times slower at WL 1,102,
//     whose prime passes never run it). A plan whose first pass is a prime above 7
//     writes conj Z by pairs k, M - k first.
//  2. The rest of zt::static_fft's steps (stockham.cuh): pairs of radix-4
//     passes (and 4 then 2, 3 then 3) as one register step, the primes up
//     to 31 in registers (a kernel variant of their own, REG), larger ones
//     in tiles; per-pass twiddle tables after W_N
//     (kernels/rfft.kernel_tables), host division multipliers (Divmod),
//     padded buffers. The first step of each group writes the buffer the
//     group before did not leave its rows in, so the overlap-add of one
//     group needs no barrier before the next group's first step.
//  3. Overlap-add (add_rows): the samples the group's frames reach, each
//     thread one sample at a time: its frames (u = q / step by a Divmod,
//     then down by the hop) in descending order, s * Re or s * -Im of their
//     rows, into the accumulator.
// Since the groups run from the highest frame down, every sample gets its
// terms in c-ascending order. Every product and sum is an explicitly
// rounded intrinsic in the plain version's order (kernels/irfft.py), so the
// kernel equals it bit for bit, and the fused fold equals the fold kernel
// (or the index fold) followed by the planes load. Shared memory: the two
// padded FFT buffers (34.8 KB), the plan and the primes' cos/sin table,
// and the span's accumulator (28 KB at WL 2048 / hop 1024, at most 32 KB,
// dynamic): three blocks an SM, at most 80 registers a thread (four
// blocks at 64 registers spilled 700 bytes and ran up to 1.11 times
// slower on an H100; PERF.md).
//
// irfft_any (on the same steps and span design) runs each
// frame's transform as rfft.cu's rfft_any does, backwards: an odd N as one
// complex N-point FFT of the conjugated Hermitian extension a frame, a
// length with a prime above 127 by Bluestein (its product with B in the
// second FFT's first step, its last chirp product in the overlap-add's
// reads), in rows of the 2,048-, 4,096- or 8,192-value block
// (zt::any_plan) in dynamic shared memory before the accumulator: up to
// two 68-KB buffers and the 32-KB accumulator (N 3,093, P 6,400), one
// block an SM there. It takes the Planes and the Complex<true> loads, so
// istft's synthesis is one launch at every window from 16 to 4,096. Each
// frame is its own FFT (no two frames packed as one FFT's real and
// imaginary parts), so a silent frame gives exact zeros where no other
// frame reaches.
//
// The windowed store (kWindowed, zt_irfft_ola_window) is Griffin-Lim's
// synthesis, zaftpu/transforms/griffinlim.py:40-43: y[b, p] = (sum_t
// win[p - t*step] * s * irfft_N(S[b, t])[p - t*step]) / wsq[p], the same
// sum with each frame sample times the synthesis window before its add and
// the finished sum divided by the window-square envelope at the store. It
// reads the half spectrum S as it is: the Hermitian fold of S's conjugate
// mirror is S again (0.5 (a + a) = a), but for the imaginary parts of DC
// and Nyquist, which the kernel does not read. win and wsq come through
// the read-only cache.
#include "stockham.cuh"

namespace {

// conj Z[k] from a = H[k] and b = H[M-k] of one frame (at k = 0 their
// imaginary parts, DC's and Nyquist's, passed as 0) and w = W_N^k: Z[k] =
// (a + conj b) + i W_N^-k (a - conj b), W_N^-k = (w.x, -w.y).
__device__ __forceinline__ float2 conj_z_of(float ar, float ai, float br,
                                            float bi, float2 w) {
  const float sr = __fadd_rn(ar, br);
  const float si = __fsub_rn(ai, bi);
  const float dr = __fsub_rn(ar, br);
  const float di = __fadd_rn(ai, bi);
  const float zr =
      __fsub_rn(sr, __fsub_rn(__fmul_rn(w.x, di), __fmul_rn(w.y, dr)));
  const float zi =
      __fadd_rn(si, __fadd_rn(__fmul_rn(w.x, dr), __fmul_rn(w.y, di)));
  return make_float2(zr, -zi);
}

// The three loads of the static kernel: where frame u (from the block's
// first frame) keeps bin k of its folded half spectrum H.
//
// Planes: two contiguous float32 planes (batch, T, F), F = N/2 + 1.
struct Planes {
  const float* re;
  const float* im;
  int F;
  __device__ __forceinline__ Planes at(int b, long long t, int T) const {
    const long long row = (long long)b * T + t;
    return {re + row * F, im + row * F, F};
  }
  __device__ __forceinline__ float2 h(int u, int k) const {
    const int o = u * F + k;
    return make_float2(__ldg(re + o), __ldg(im + o));
  }
};

// Complex: complex64 values z[b sb + t st + k sk] (element strides, any
// layout: a bins-major spectrum and a column slice are read in place).
// FOLD: the full N-bin spectrum Z, read as its Hermitian fold H[k] = (Z[k]
// + conj Z[(N - k) mod N]) / 2 in the fold's order (mirror.cu: fold_kernel;
// core/fft.py: hermitian_fold_planes): a sum or difference, then the
// product by 0.5. Else the half spectrum H itself.
template <bool FOLD>
struct Complex {
  const float2* z;
  long long sb, st, sk;
  int n;
  __device__ __forceinline__ Complex at(int b, long long t, int) const {
    Complex c = *this;
    c.z = z + b * sb + t * st;
    return c;
  }
  __device__ __forceinline__ float2 h(int u, int k) const {
    const float2* r = z + u * st;
    const float2 a = __ldg(r + k * sk);
    if constexpr (!FOLD) {
      return a;
    } else {
      const float2 c = __ldg(r + (k == 0 ? 0 : n - k) * sk);
      return make_float2(__fmul_rn(__fadd_rn(a.x, c.x), 0.5f),
                         __fmul_rn(__fsub_rn(a.y, c.y), 0.5f));
    }
  }
};

// The rows of a group for zt::static_fft's steps: row f holds conj Z of
// frame top - f of the block (zeros past its first frame), from the load
// spec and the table tw of W_N. load is zt::run_step's first-step source
// (as Frames' in rfft.cu); pairs gives a group of the first pass and its
// mirror group together (first_step), each pair from the same two bins.
template <class Spec>
struct Rows {
  Spec spec;
  const float2* tw;
  int M, top;

  __device__ __forceinline__ float2 z(int u, int k) const {
    const float2 a = spec.h(u, k);
    const float2 b = spec.h(u, M - k);
    return conj_z_of(a.x, k == 0 ? 0.f : a.y, b.x, k == 0 ? 0.f : b.y,
                     __ldg(tw + k));
  }

  template <int R>
  __device__ __forceinline__ void load(int f, int g, int G,
                                       float2 (&v)[R]) const {
    const int u = top - f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      v[i] = u < 0 ? make_float2(0.f, 0.f) : z(u, g + i * G);
    }
  }

  // Group g of row f, va[i] = conj Z[g + i G], and its mirror group G - g,
  // vb[i] = conj Z[G - g + i G] = conj Z[M - (g + (R - 1 - i) G)], from
  // the same two bins a value; groups 0 and G/2 are their own mirrors (vb
  // unset).
  template <int R>
  __device__ __forceinline__ void pairs(int f, int g, int G, float2 (&va)[R],
                                        float2 (&vb)[R]) const {
    const int u = top - f;
    if (u < 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) va[i] = vb[i] = make_float2(0.f, 0.f);
      return;
    }
    if (g == 0 || 2 * g == G) {
#pragma unroll
      for (int i = 0; i < R; ++i) va[i] = z(u, g + i * G);
      return;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = g + i * G;
      const float2 a = spec.h(u, k);
      const float2 b = spec.h(u, M - k);
      va[i] = conj_z_of(a.x, a.y, b.x, b.y, __ldg(tw + k));
      vb[R - 1 - i] = conj_z_of(b.x, b.y, a.x, a.y, __ldg(tw + M - k));
    }
  }
};

// Writes the radix-R butterfly of v, group g of the row at base, as the
// first Stockham pass does (ns = 1: twiddles w, outputs at g R + s).
template <int R>
__device__ __forceinline__ void first_butterfly(float2 (&v)[R],
                                                const float2 (&w)[R],
                                                const float (&c)[R],
                                                const float (&sn)[R],
                                                float2* dst, int base, int g) {
  float2 x[R], y[R];
  x[0] = v[0];
#pragma unroll
  for (int u = 1; u < R; ++u) x[u] = zt::cmul(v[u], w[u]);
  zt::dft<R>(x, c, sn, y);
#pragma unroll
  for (int s = 0; s < R; ++s) dst[zt::pad(base + g * R + s)] = y[s];
}

// The first pass, radix R (a step of its own: zt::static_plan with
// single_first), from the spectrum, G = M / R groups a row: a work item
// takes group g of row f and its mirror group G - g (by_pair: G/2 + 1
// items a row), each input pair read once (Rows::pairs). R = 1 writes conj
// Z itself, for a plan whose first pass is a prime above 7 (G = M).
template <int R, class Src>
__device__ __forceinline__ void first_step(const Src& rows, float2* dst,
                                           const float2* __restrict__ tab,
                                           int M, int fpb, int G,
                                           const zt::Step& st,
                                           zt::Divmod by_pair) {
  const int H = G / 2 + 1;
  float c[R], sn[R];
  zt::odd_constants<R>(tab, st.cs1, c, sn);
  float2 w[R];
#pragma unroll
  for (int u = 1; u < R; ++u) w[u] = __ldg(tab + st.tw1 + u - 1);
  for (int it = threadIdx.x; it < fpb * H; it += blockDim.x) {
    const int f = by_pair.div(it);
    const int g = it - f * H;
    float2 va[R], vb[R];
    rows.template pairs<R>(f, g, G, va, vb);
    first_butterfly<R>(va, w, c, sn, dst, f * M, g);
    if (g != 0 && 2 * g != G) first_butterfly<R>(vb, w, c, sn, dst, f * M,
                                                 G - g);
  }
}

// The FFTs of a group's fpb rows by the plan's steps (sp, in shared
// memory), the first step writing buf[start] (the buffer the group before
// left free) from the spectrum: first_step's pairs of groups where the
// first pass is a step of its own (the host splits it off where that
// costs no step) in a kernel without register primes (REG: the code would
// cost their registers), else zt::run_step's first step through
// Rows::load; where the first pass is a prime above 7, conj Z into
// buf[start] by pairs k, M - k (by_pair: M/2 + 1 a row). Returns the
// buffer that holds the FFTs, after a barrier.
template <bool REG, class Src>
__device__ __forceinline__ int group_fft(float2 (*buf)[zt::kPadElems],
                                         const zt::StaticPlan& sp,
                                         const float2* cs,
                                         const float2* __restrict__ tab,
                                         const Src& rows, int start,
                                         zt::Divmod by_pair) {
  const int M = sp.m;
  const zt::Step& s0 = sp.step[0];
  float2* dst = buf[start];
  int i = 1;
  if (s0.r1 > 7) {
    first_step<1>(rows, dst, tab, M, sp.fpb, M, s0, by_pair);
    i = 0;
  } else if (!REG && s0.r2 == 1) {
    if constexpr (!REG) {
      switch (s0.r1) {
        case 4:
          first_step<4>(rows, dst, tab, M, sp.fpb, s0.span, s0, by_pair);
          break;
        case 2:
          first_step<2>(rows, dst, tab, M, sp.fpb, s0.span, s0, by_pair);
          break;
        case 3:
          first_step<3>(rows, dst, tab, M, sp.fpb, s0.span, s0, by_pair);
          break;
        case 5:
          first_step<5>(rows, dst, tab, M, sp.fpb, s0.span, s0, by_pair);
          break;
        default:
          first_step<7>(rows, dst, tab, M, sp.fpb, s0.span, s0, by_pair);
      }
    }
  } else {
    zt::run_step<true, REG>(nullptr, rows, dst, tab, cs, M, s0);
  }
  __syncthreads();
  int cur = start;
  for (; i < sp.steps; ++i) {
    zt::run_step<false, REG>(buf[cur], rows, buf[cur ^ 1], tab, cs, M,
                             sp.step[i]);
    cur ^= 1;
    __syncthreads();
  }
  return cur;
}

// Adds the group's frames u_end < u <= ug, frame u in row ug - u of z
// (padded, M values a row), into the accumulator at the samples they
// reach, q in [max(q0, (u_end + 1) step), min(q0 + len, ug step + N)), acc
// holding sample q at q - q0, frame index descending: s * x[j] (x[2j] =
// Re z[j], x[2j+1] = -Im z[j]), times win[j] in the windowed store.
template <bool kWindowed>
__device__ __forceinline__ void add_rows(float* acc, const float2* z, int M,
                                         int ug, int u_end, int q0, int len,
                                         int step, zt::Divmod by_step,
                                         float s,
                                         const float* __restrict__ win) {
  const int n = 2 * M;
  const int lo = max(q0, (u_end + 1) * step);
  const int hi = min(q0 + len, ug * step + n);
  for (int q = lo + threadIdx.x; q < hi; q += blockDim.x) {
    int u = by_step.div(q);
    if (u > ug) u = ug;
    float v = acc[q - q0];
    for (int j = q - u * step; u > u_end && j < n; --u, j += step) {
      const float2 c = z[zt::pad((ug - u) * M + (j >> 1))];
      const float x = __fmul_rn(j & 1 ? -c.y : c.x, s);
      v = __fadd_rn(v, kWindowed ? __fmul_rn(x, __ldg(win + j)) : x);
    }
    acc[q - q0] = v;
  }
}

// Blocks of irfft_kernel an SM holds: its launch bounds, and span_for's.
constexpr int kBlocksPerSm = 3;

// The inverse real FFT + overlap-add at a window static_plan takes: a
// block owns `span` output samples of one batch row (grid x; the batch on
// grid y) in a shared accumulator and transforms the frames that reach
// them fpb at a time, from the highest frame down (add_rows after each
// group, no barrier: the next group's first step writes the other
// buffer). spec: the load; tab: kernels/rfft.kernel_tables(N); REG as in
// zt::run_step.
template <class Spec, bool kWindowed, bool REG>
__global__ void __launch_bounds__(zt::kThreads, kBlocksPerSm)
irfft_kernel(Spec spec, const float2* __restrict__ tab,
             const float* __restrict__ win, const float* __restrict__ wsq,
             float* __restrict__ out, float s, int T, int step,
             long long out_len, int span, zt::Divmod by_step,
             zt::Divmod by_pair, zt::StaticPlan plan) {
  extern __shared__ float acc[];  // span floats
  __shared__ __align__(16) float2 buf[2][zt::kPadElems];
  __shared__ zt::StaticPlan sp;
  __shared__ float2 cs[zt::kMaxPrimes * zt::kRegPrime];
  const int M = plan.m;
  const int G = plan.fpb;
  const long long p0 = (long long)blockIdx.x * span;
  const int len = (int)min((long long)span, out_len - p0);
  const long long t_top = min((p0 + len - 1) / step, (long long)T - 1);
  const long long t_lo = zt::first_frame(p0, 2 * M, step);
  const int q0 = (int)(p0 - t_lo * step);
  Rows<Spec> rows{spec.at(blockIdx.y, t_lo, T), tab, M, 0};

  if (threadIdx.x == 0) sp = plan;
  zt::prime_table<REG>(cs, plan, tab);
  for (int e = threadIdx.x; e < len; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();

  int cur = 1;
  for (int ug = (int)(t_top - t_lo); ug >= 0; ug -= G) {
    rows.top = ug;
    cur = group_fft<REG>(buf, sp, cs, tab, rows, cur ^ 1, by_pair);
    add_rows<kWindowed>(acc, buf[cur], M, ug, max(ug - G, -1), q0, len, step,
                        by_step, s, win);
  }
  __syncthreads();

  float* ob = out + blockIdx.y * out_len + p0;
  for (int e = threadIdx.x; e < len; e += blockDim.x) {
    ob[e] = kWindowed ? __fdiv_rn(acc[e], __ldg(wsq + p0 + e)) : acc[e];
  }
}

template <class Spec, bool kWindowed>
int launch(const Spec& spec, const void* tw, const void* win, const void* wsq,
           void* out, float s, int batch, int T, int N, int step,
           void* stream) {
  zt::StaticPlan plan, single;
  if (!zt::static_plan(N, &plan) || step < 1 || step > N || batch > 65535 ||
      !zt::aligned8(tw)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  // The paired first step where its pass alone costs no step (group_fft).
  if (!plan.cs && zt::static_plan(N, &single, true) &&
      single.steps <= plan.steps) {
    plan = single;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  const long long out_len = (long long)(T - 1) * step + N;
  const int span = zt::span_for(N, step, plan.fpb, out_len, batch,
                            (long long)sms * kBlocksPerSm);
  // first_step's groups: M / r1, or the M values of a first prime pass.
  const zt::Step& s0 = plan.step[0];
  const int group = s0.r1 > 7 ? plan.m : s0.span;
  const int smem = span * (int)sizeof(float);
  auto kernel = plan.cs ? irfft_kernel<Spec, kWindowed, true>
                        : irfft_kernel<Spec, kWindowed, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((out_len + span - 1) / span), batch);
  kernel<<<grid, zt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      spec, static_cast<const float2*>(tw), static_cast<const float*>(win),
      static_cast<const float*>(wsq), static_cast<float*>(out), s, T, step,
      out_len, span, zt::make_divmod(step), zt::make_divmod(group / 2 + 1),
      plan);
  return (int)cudaGetLastError();
}

// The rows of a group of irfft_any as zt::any_fft's first-step source
// (Rows' role in irfft_kernel): row f holds frame top - f of the block
// (zeros past its first frame) as its FFT's input, from the load spec: ODD
// the conjugated Hermitian extension of H (m = 0: Re H[0]; m <= (N-1)/2:
// conj H[m]; above: H[N - m]), else conj Z over M = N/2 points (conj_z_of,
// the inverse split step, tw the table of W_N); BLUE times conj c[m] for m
// < M, zeros from M to P, which it does not load.
template <class Spec, bool ODD, bool BLUE>
struct AnyRows {
  Spec spec;
  const float2* tw;
  const float2* chirp;
  int n, M, top;

  __device__ __forceinline__ float2 value(int u, int m) const {
    float2 v;
    if constexpr (ODD) {
      if (m == 0) {
        v = make_float2(spec.h(u, 0).x, 0.f);
      } else if (2 * m < n) {
        const float2 h = spec.h(u, m);
        v = make_float2(h.x, -h.y);
      } else {
        v = spec.h(u, n - m);
      }
    } else {
      const float2 a = spec.h(u, m);
      const float2 b = spec.h(u, M - m);
      v = conj_z_of(a.x, m == 0 ? 0.f : a.y, b.x, m == 0 ? 0.f : b.y,
                    __ldg(tw + m));
    }
    if constexpr (BLUE) v = zt::cmul(v, __ldg(chirp + m));
    return v;
  }

  template <int R>
  __device__ __forceinline__ void load(int f, int g, int G,
                                       float2 (&v)[R]) const {
    const int u = top - f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = g + i * G;
      v[i] = u < 0 || (BLUE && m >= M) ? make_float2(0.f, 0.f) : value(u, m);
    }
  }
};

// irfft_any's overlap-add: add_rows with rows of L values and each frame
// sample from zt::blue_value (Bluestein's last chirp product where BLUE):
// s * Re at position j (ODD), else s * Re at j/2 for an even j and s * -Im
// for an odd one.
template <bool ODD, bool BLUE>
__device__ __forceinline__ void add_any(float* acc, const float2* z, int L,
                                        int ug, int u_end, int q0, int len,
                                        int n, int step, zt::Divmod by_step,
                                        float s,
                                        const float2* __restrict__ chirp) {
  const int lo = max(q0, (u_end + 1) * step);
  const int hi = min(q0 + len, ug * step + n);
  for (int q = lo + threadIdx.x; q < hi; q += blockDim.x) {
    int u = by_step.div(q);
    if (u > ug) u = ug;
    float v = acc[q - q0];
    for (int j = q - u * step; u > u_end && j < n; --u, j += step) {
      const float2 c =
          zt::blue_value<BLUE>(z, (ug - u) * L, chirp, ODD ? j : j >> 1);
      v = __fadd_rn(v, __fmul_rn(ODD || !(j & 1) ? c.x : -c.y, s));
    }
    acc[q - q0] = v;
  }
}

// irfft_kernel at a window fft_fits refuses (zt::any_plan), each frame's
// transform as rfft.cu's rfft_any runs it, backwards: a.rows rows of a.L
// values a group in two padded buffers of dynamic shared memory, the span's
// accumulator after them. ODD runs the N-point FFT of the conjugated
// Hermitian extension and reads x[j] = Re at position j; otherwise conj Z
// over M = N/2 points and x[2j] = Re, x[2j+1] = -Im at position j, as
// irfft_kernel. BLUE runs the M-point FFT (M = N when odd) by Bluestein on
// rows of L = P values: the first step reads the chirped rows (AnyRows),
// the second FFT's first step the first's times B, conjugated (BlueMid),
// and the overlap-add each value conjugated and times conj c (blue_value).
// The rest is irfft_kernel's design: a block owns `span` samples (a
// multiple of the hop chosen by waves of blocks, span_for), transforms the
// frames that reach them a group at a time from the highest frame down, and
// adds each group's samples c ascending with no barrier before the next
// group's first step. Each frame is its own FFT, so a frame's samples round
// with no other frame's. spec: the load (Planes, or the full spectrum with
// the fold, Complex<true>); tab: kernels/rfft.kernel_tables(N); REG as in
// rfft_any.
template <class Spec, bool ODD, bool BLUE, bool REG>
__global__ void __launch_bounds__(zt::kThreads, kBlocksPerSm)
irfft_any(Spec spec, const float2* __restrict__ tab, float* __restrict__ out,
          float s, int T, int n, int step, long long out_len, int span,
          zt::Divmod by_step, zt::AnyPlan a) {
  extern __shared__ __align__(16) float2 smem[];
  __shared__ zt::StaticPlan sp;
  __shared__ float2 cs[zt::kMaxPrimes * zt::kRegPrime];
  const zt::Buffers buf{smem, a.stride};
  float* acc = reinterpret_cast<float*>(smem + 2 * a.stride);  // span
  const int M = a.M;
  const int L = a.L;
  const int G = a.rows;
  const float2* twp = BLUE ? tab + n : tab;  // W_L and the passes' tables
  const float2* chirp = tab + n + L;         // BLUE only
  const long long p0 = (long long)blockIdx.x * span;
  const int len = (int)min((long long)span, out_len - p0);
  const long long t_top = min((p0 + len - 1) / step, (long long)T - 1);
  const long long t_lo = zt::first_frame(p0, n, step);
  const int q0 = (int)(p0 - t_lo * step);
  AnyRows<Spec, ODD, BLUE> rows{spec.at(blockIdx.y, t_lo, T), tab, chirp, n,
                                M, 0};

  if (threadIdx.x == 0) sp = a.sp;
  zt::prime_table<REG>(cs, a.sp, twp);
  for (int e = threadIdx.x; e < len; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();

  constexpr int kFirst = BLUE ? zt::kQuadFirst : zt::kOddFirst;
  int cur = 1;
  for (int ug = (int)(t_top - t_lo); ug >= 0; ug -= G) {
    rows.top = ug;
    cur = zt::any_fft<kFirst, REG, BLUE>(buf, sp, cs, a.sp, twp, rows,
                                         chirp + M, cur ^ 1);
    add_any<ODD, BLUE>(acc, buf[cur], L, ug, max(ug - G, -1), q0, len, n,
                       step, by_step, s, chirp);
  }
  __syncthreads();

  float* ob = out + blockIdx.y * out_len + p0;
  for (int e = threadIdx.x; e < len; e += blockDim.x) ob[e] = acc[e];
}

// Blocks of irfft_any an SM holds: kBlocksPerSm, or as many as the SM's
// 228 KB of shared memory takes of its two buffers, the largest
// accumulator (kSpan floats) and 3 KB of static shared memory and reserve
// (kernels/irfft.py: geometry): 3 in the 2,048-value block, 2 or 3 in the
// 4,096-value one, 1 in the 8,192-value one. (On an H100, blocks of up to
// twice kSpan ran 1.06-1.35 times as long at ANY_WINDOWS' shapes: PERF.md.)
inline int any_blocks_per_sm(const zt::AnyPlan& a) {
  const int bytes = 2 * a.stride * (int)sizeof(float2) +
                    zt::kSpan * (int)sizeof(float) + 3 * 1024;
  const int fit = 228 * 1024 / bytes;
  return fit < kBlocksPerSm ? fit : kBlocksPerSm;
}

template <class Spec, bool ODD, bool BLUE, bool REG>
int launch_any(const Spec& spec, const float2* tab, float* out, float s,
               int batch, int T, int n, int step, const zt::AnyPlan& a,
               cudaStream_t st) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  const long long out_len = (long long)(T - 1) * step + n;
  const int span = zt::span_for(n, step, a.rows, out_len, batch,
                            (long long)sms * any_blocks_per_sm(a));
  const int smem = 2 * a.stride * (int)sizeof(float2) +
                   span * (int)sizeof(float);
  auto kernel = irfft_any<Spec, ODD, BLUE, REG>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((out_len + span - 1) / span), batch);
  kernel<<<grid, zt::kThreads, smem, st>>>(spec, tab, out, s, T, n, step,
                                           out_len, span,
                                           zt::make_divmod(step), a);
  return (int)cudaGetLastError();
}

// irfft_any's launch at window N and Bluestein length P, after the checks
// zt_irfft_ola makes: odd with Bluestein, odd (with a register prime or
// not), or even with Bluestein.
template <class Spec>
int launch_off_rule(const Spec& spec, const void* tw, void* out, float s,
                    int batch, int T, int N, int step, int P,
                    void* stream) {
  zt::AnyPlan a;
  if (!zt::any_plan(N, P, &a) || step < 1 || step > N || batch > 65535 ||
      !zt::aligned8(tw)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  const float2* t = static_cast<const float2*>(tw);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.blue) {
    return a.odd ? launch_any<Spec, true, true, false>(spec, t, y, s, batch,
                                                       T, N, step, a, st)
                 : launch_any<Spec, false, true, false>(spec, t, y, s, batch,
                                                        T, N, step, a, st);
  }
  return a.sp.cs ? launch_any<Spec, true, false, true>(spec, t, y, s, batch,
                                                       T, N, step, a, st)
                 : launch_any<Spec, true, false, false>(spec, t, y, s, batch,
                                                        T, N, step, a, st);
}

}  // namespace

// h_re, h_im: (batch, T, N/2 + 1) float32 (N/2 rounded down); tw:
// kernels/rfft.kernel_tables(N), 8-byte aligned; out: (batch, (T - 1) *
// step + N) float32; s the factor (scale / N); P the Bluestein length
// (kernels/rfft.layout(N).p, 0 where the passes take the FFT's own
// length). All contiguous. Any N in [16, 4096]: irfft_kernel where fft_fits
// (P = 0), else irfft_any; step in [1, N] and batch at most 65535. Anything
// else, or a wrong P, returns cudaErrorInvalidValue before a launch. T = 0
// returns after the checks and writes nothing: the wrapper returns the N -
// step zeros itself.
ZT_EXPORT int zt_irfft_ola(const void* h_re, const void* h_im, const void* tw,
                           void* out, float s, int batch, int T, int N,
                           int step, int P, void* stream) {
  const Planes spec{static_cast<const float*>(h_re),
                    static_cast<const float*>(h_im), N / 2 + 1};
  zt::Plan plan;
  if (P == 0 && zt::fft_fits(N, &plan)) {
    return launch<Planes, false>(spec, tw, nullptr, nullptr, out, s, batch,
                                 T, N, step, stream);
  }
  return launch_off_rule(spec, tw, out, s, batch, T, N, step, P, stream);
}

// The fused fold: z the full complex64 spectrum (batch, T, N), element
// (b, t, k) at z + b * sb + t * st + k * sk (strides in complex elements,
// any layout; 8-byte aligned), read as its Hermitian fold; the rest as
// zt_irfft_ola, at any N in [16, 4096] with its Bluestein length P.
// Bit-equal to the fold (zt_fold_half) followed by zt_irfft_ola.
ZT_EXPORT int zt_irfft_ola_full(const void* z, const void* tw, void* out,
                                float s, int batch, int T, int N, int step,
                                int P, long long sb, long long st,
                                long long sk, void* stream) {
  if (!zt::aligned8(z)) return (int)cudaErrorInvalidValue;
  const Complex<true> spec{static_cast<const float2*>(z), sb, st, sk, N};
  zt::Plan plan;
  if (P == 0 && zt::fft_fits(N, &plan)) {
    return launch<Complex<true>, false>(spec, tw, nullptr, nullptr, out, s,
                                        batch, T, N, step, stream);
  }
  return launch_off_rule(spec, tw, out, s, batch, T, N, step, P, stream);
}

// The windowed store: spec the half spectrum (batch, T, N/2 + 1)
// complex64, contiguous; win (N,) the synthesis window and wsq ((T - 1) *
// step + N,) the envelope it divides by, float32; the rest as
// zt_irfft_ola at a window fft_fits takes (s = 1 / N for Griffin-Lim's
// inverse).
ZT_EXPORT int zt_irfft_ola_window(const void* spec, const void* tw,
                                  const void* win, const void* wsq, void* out,
                                  float s, int batch, int T, int N, int step,
                                  void* stream) {
  const long long f = N / 2 + 1;
  if (!zt::aligned8(spec)) return (int)cudaErrorInvalidValue;
  return launch<Complex<false>, true>(
      Complex<false>{static_cast<const float2*>(spec), T * f, f, 1, N}, tw,
      win, wsq, out, s, batch, T, N, step, stream);
}
