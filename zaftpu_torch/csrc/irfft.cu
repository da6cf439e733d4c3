// Inverse real FFT + overlap-add in one launch, the frames never stored:
//   y[b, p] = sum_t s * irfft_N(H[b, t])[p - t*step]
// over the frames t in [0, T) with 0 <= p - t*step < N, summed t
// descending (c = r - t ascending for p = r*step + j, left-associated, from
// 0), s = scale / N rounded once to float32 on the host. H is the
// Hermitian-folded half spectrum as two float32 planes (batch, T, N/2 + 1),
// N/2 rounded down; the imaginary parts of DC and Nyquist are not read, as
// an inverse real FFT ignores them. Any N from 16 to 4096, any hop in
// [1, N]: irfft_ola_kernel (below) at an even N whose half is free of prime
// factors above 127 (kernels/rfft.py: fits), irfft_any at every other N
// (an odd N, a prime above 127 by Bluestein).
//
// Replaces zaftpu/pallas/synth.py: _gemm_ola_impl as istft_ola reaches it
// (B4) and its _kernel_split4 (B4-s4) on every dial at those window
// lengths; synth.cu's GEMM kernels keep an explicit operator,
// ZAFTPU_FFT=matmul and a window below 16 (kernels/synth.py states the
// rule). The TPU kernels contract each frame with a dense (2 (N/2+1), N)
// inverse operator: 2 N (N + 2) FLOP per frame. The FFT does about 2.5 N
// log2 N at a smooth N and more at a large prime factor, which leaves this
// kernel bound by its bytes: both planes read once and the signal written
// once, 0.095 ms at the 600-s WL 2048 and WL 1102 shapes on an H100 (3.35
// TB/s).
//
// Design: a 256-thread block owns kSpan = 8,192 consecutive output samples
// of one batch row (grid x; the batch on grid y) in a shared-memory
// accumulator, so every hop from 1 to N works and each sample is written
// once, coalesced, with no atomics and nothing carried between blocks. The
// block transforms the frames that touch its samples, ⌊kElems / M⌋ (M =
// N/2) at a time, from the highest frame index down; the frames on both
// sides of a block's edge are transformed by both neighbours (at most 1 +
// (N - step) / kSpan transforms per output frame, plus the last partial
// group). For each group:
//  1. Inverse split step: Z[k] = (H[k] + conj H[M-k]) + i W_N^-k (H[k] -
//     conj H[M-k]), k = 0..M-1, is twice the M-point DFT of x[2j] + i
//     x[2j+1], x = irfft_N(H) (numpy's normalisation), so the unnormalised
//     M-point inverse of Z is N (x[2j] + i x[2j+1]), and s = scale / N
//     turns it into scale * x. The inverse runs as conj -> forward passes
//     -> conj: the block stores conj Z and reads x[2j] = Re, x[2j+1] = -Im.
//  2. The forward Stockham passes of stockham.cuh over the group's rows.
//  3. Overlap-add: each thread adds, into the accumulator entries it owns
//     (samples tid, tid + 256, ...), s * Re and s * -Im of the rows (the
//     even and odd samples of each frame), frame index descending.
// Since the groups run from the highest frame down, every sample gets its
// terms in c-ascending order. Every product and sum is an explicitly
// rounded intrinsic in the plain version's order (kernels/irfft.py), so the
// kernel equals it bit for bit. Shared memory: 64 KB (the two 16-KB FFT
// buffers, the 32-KB accumulator, dynamic), three blocks per SM.
//
// irfft_any keeps that span design and runs each frame's transform as
// rfft.cu's rfft_any does, backwards: an odd N as one complex N-point FFT
// of the conjugated Hermitian extension a frame, a length with a prime
// above 127 by Bluestein, in rows of the 2,048-, 4,096- or 8,192-value
// block (zt::any_plan) in dynamic shared memory before the accumulator: up
// to two 50-KB buffers and the 32-KB accumulator (N 3,093, P 6,400), one
// block an SM there. Each frame is its own FFT (no two frames packed as one
// FFT's real and imaginary parts), so a silent frame gives exact zeros
// where no other frame reaches.
//
// The windowed store (kWindowed, zt_irfft_ola_window) is Griffin-Lim's
// synthesis, zaftpu/transforms/griffinlim.py:40-43: y[b, p] = (sum_t
// win[p - t*step] * s * irfft_N(S[b, t])[p - t*step]) / wsq[p], the same
// sum with each frame sample times the synthesis window before its add and
// the finished sum divided by the window-square envelope at the store. It
// reads the half spectrum S as it is: the Hermitian fold of S's conjugate
// mirror is S again (0.5 (a + a) = a), but for the imaginary parts of DC
// and Nyquist, which the kernel does not read. win and wsq come through
// the read-only cache, so the shared memory and the blocks per SM stay.
#include "stockham.cuh"

namespace {

// conj Z[k] of one frame's folded planes a (re), b (im) (k = 0..M-1, the
// imaginary parts of DC and Nyquist read as 0): Z[k] = (H[k] + conj H[M-k])
// + i W_N^-k (H[k] - conj H[M-k]), tw the table of W_N.
__device__ __forceinline__ float2 conj_z(const float* a, const float* b,
                                         const float2* __restrict__ tw, int k,
                                         int M) {
  const float ar = a[k];
  const float br = a[M - k];
  const float ai = k == 0 ? 0.f : b[k];
  const float bi = k == 0 ? 0.f : b[M - k];
  const float2 w = __ldg(tw + k);  // W_N^k; W_N^-k = (w.x, -w.y)
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

// The kSpan output samples of block (blockIdx.x, blockIdx.y) and the
// frames that reach them: samples [p0, p0 + span), block-relative sample q
// = p - t_lo * step of relative frame u = t - t_lo (q < kSpan + N, u * step
// <= q), q0 the block's first sample, u_top its last frame, `first` the
// planes' row of frame t_lo.
struct Span {
  long long p0, first;
  int span, q0, u_top;
};

__device__ __forceinline__ Span block_span(long long out_len, int T, int n,
                                           int step) {
  Span b;
  b.p0 = (long long)blockIdx.x * zt::kSpan;
  const long long rest = out_len - b.p0;
  b.span = rest < zt::kSpan ? (int)rest : zt::kSpan;
  const long long last = (b.p0 + b.span - 1) / step;
  const long long t_top = last < T - 1 ? last : T - 1;
  const long long t_lo = zt::first_frame(b.p0, n, step);
  b.q0 = (int)(b.p0 - t_lo * step);
  b.u_top = (int)(t_top - t_lo);
  b.first = (long long)blockIdx.y * T + t_lo;
  return b;
}

// Adds the group's frames u_end < u <= ug, frame u in row ug - u of z (L
// values apart), into the accumulator entries this thread owns, frame
// index descending: s * x[j] (ODD: Re z[j]; else Re z[j/2] at an even j,
// -Im at an odd one), times win[j] in the windowed store; then a barrier.
template <bool ODD, bool kWindowed>
__device__ __forceinline__ void add_group(float* acc, const float2* z, int L,
                                          int ug, int u_end, const Span& b,
                                          int n, int step, float s,
                                          const float* __restrict__ win) {
  for (int e = threadIdx.x; e < b.span; e += blockDim.x) {
    const int q = b.q0 + e;
    int u = q / step;
    if (u > ug) u = ug;
    float v = acc[e];
    for (int j = q - u * step; u > u_end && j < n; --u, j += step) {
      const float2 c = z[(ug - u) * L + (ODD ? j : j >> 1)];
      const float x = __fmul_rn(ODD || !(j & 1) ? c.x : -c.y, s);
      v = __fadd_rn(v, kWindowed ? __fmul_rn(x, __ldg(win + j)) : x);
    }
    acc[e] = v;
  }
  __syncthreads();
}

template <bool kWindowed>
__global__ void __launch_bounds__(zt::kThreads)
irfft_ola_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                 const float2* __restrict__ tw, const float* __restrict__ win,
                 const float* __restrict__ wsq, float* __restrict__ out,
                 float s, int T, int n, int step, long long out_len,
                 zt::Plan plan) {
  extern __shared__ float acc[];  // kSpan floats
  __shared__ __align__(16) float2 buf[2][zt::kElems];
  const int M = n / 2;
  const int F = M + 1;
  const int G = zt::kElems / M;  // frames per group
  const Span b = block_span(out_len, T, n, step);
  const float* hrb = hr + b.first * F;
  const float* hib = hi + b.first * F;

  for (int e = threadIdx.x; e < b.span; e += blockDim.x) acc[e] = 0.f;

  for (int ug = b.u_top; ug >= 0; ug -= G) {
    const int cnt = ug + 1 < G ? ug + 1 : G;  // rows u = ug, ug - 1, ...
    for (int e = threadIdx.x; e < cnt * M; e += blockDim.x) {
      const int f = e / M;
      const int k = e - f * M;
      buf[0][e] = conj_z(hrb + (long long)(ug - f) * F,
                         hib + (long long)(ug - f) * F, tw, k, M);
    }
    __syncthreads();
    int cur = 0;
    zt::fft_rows(buf, cur, tw, M, cnt, n, plan);
    add_group<false, kWindowed>(acc, buf[cur], M, ug, ug - cnt, b, n, step,
                                s, win);
  }

  float* ob = out + blockIdx.y * out_len + b.p0;
  for (int e = threadIdx.x; e < b.span; e += blockDim.x) {
    ob[e] = kWindowed ? __fdiv_rn(acc[e], __ldg(wsq + b.p0 + e)) : acc[e];
  }
}

// irfft_ola_kernel at a window fft_fits refuses (zt::any_plan), with each
// frame's transform as rfft.cu's rfft_any runs it, backwards: `rows` rows
// of L values in two buffers of dynamic shared memory, the accumulator
// after them. ODD loads row position m of the conjugated Hermitian
// extension (m = 0: Re H[0]; m <= (N-1)/2: conj H[m]; above: H[N - m]),
// runs the N-point FFT and reads x[j] = Re at position j; otherwise conj Z
// (conj_z) over M = N/2 points and x[2j] = Re, x[2j+1] = -Im at position
// j, as irfft_ola_kernel. BLUE runs the M-point FFT (M = N when odd) by
// Bluestein on rows of L = P values, as rfft_any does. Each frame is its
// own FFT, so a frame's samples round with no other frame's. tab is
// kernels/rfft.store_tables(N).
template <bool ODD, bool BLUE>
__global__ void __launch_bounds__(zt::kThreads)
irfft_any(const float* __restrict__ hr, const float* __restrict__ hi,
          const float2* __restrict__ tab, float* __restrict__ out, float s,
          int T, int n, int step, long long out_len, int P, int rows,
          zt::Plan plan) {
  extern __shared__ __align__(16) float2 smem[];
  const int M = ODD ? n : n / 2;
  const int L = BLUE ? P : M;  // values a row
  const int F = n / 2 + 1;     // bins a frame's planes hold
  const zt::Buffers buf{smem, rows * L};
  float* acc = reinterpret_cast<float*>(smem + 2 * rows * L);  // kSpan
  const float2* twp = BLUE ? tab + n : tab;  // the passes' table, W_L
  const float2* chirp = tab + n + P;
  const float2* big = chirp + M;
  const Span b = block_span(out_len, T, n, step);
  const float* hrb = hr + b.first * F;
  const float* hib = hi + b.first * F;

  for (int e = threadIdx.x; e < b.span; e += blockDim.x) acc[e] = 0.f;

  for (int ug = b.u_top; ug >= 0; ug -= rows) {
    const int cnt = ug + 1 < rows ? ug + 1 : rows;  // rows u = ug, ug - 1, ...
    for (int e = threadIdx.x; e < cnt * L; e += blockDim.x) {
      const int f = e / L;
      const int m = e - f * L;
      float2 v = make_float2(0.f, 0.f);
      if (m < M) {
        const float* re = hrb + (long long)(ug - f) * F;
        const float* im = hib + (long long)(ug - f) * F;
        if constexpr (ODD) {
          if (m == 0) {
            v.x = re[0];
          } else if (m < F) {
            v = make_float2(re[m], -im[m]);
          } else {
            v = make_float2(re[n - m], im[n - m]);
          }
        } else {
          v = conj_z(re, im, tab, m, M);
        }
        if constexpr (BLUE) v = zt::cmul(v, __ldg(chirp + m));
      }
      buf[0][e] = v;
    }
    __syncthreads();
    int cur = 0;
    zt::fft_rows(buf, cur, twp, L, cnt, L, plan);
    if constexpr (BLUE) {
      zt::bluestein_tail(buf, cur, twp, chirp, big, L, M, cnt, plan);
    }
    add_group<ODD, false>(acc, buf[cur], L, ug, ug - cnt, b, n, step, s,
                          nullptr);
  }

  float* ob = out + blockIdx.y * out_len + b.p0;
  for (int e = threadIdx.x; e < b.span; e += blockDim.x) ob[e] = acc[e];
}

template <bool ODD, bool BLUE>
int launch_any(const float* hr, const float* hi, const float2* tab,
               float* out, float s, int batch, int T, int n, int step,
               const zt::AnyPlan& a, int P, cudaStream_t st) {
  auto kernel = irfft_any<ODD, BLUE>;
  const int smem = 2 * a.rows * a.L * (int)sizeof(float2) +
                   zt::kSpan * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long out_len = (long long)(T - 1) * step + n;
  const dim3 grid((unsigned int)((out_len + zt::kSpan - 1) / zt::kSpan),
                  batch);
  kernel<<<grid, zt::kThreads, smem, st>>>(hr, hi, tab, out, s, T, n, step,
                                           out_len, P, a.rows, a.plan);
  return (int)cudaGetLastError();
}

template <bool kWindowed>
int launch(const void* h_re, const void* h_im, const void* tw,
           const void* win, const void* wsq, void* out, float s, int batch,
           int T, int N, int step, void* stream) {
  zt::Plan plan;
  if (!zt::fft_fits(N, &plan) || step < 1 || step > N || batch > 65535 ||
      !zt::aligned8(tw)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  const int smem = zt::kSpan * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      irfft_ola_kernel<kWindowed>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long out_len = (long long)(T - 1) * step + N;
  const long long blocks = (out_len + zt::kSpan - 1) / zt::kSpan;
  const dim3 grid((unsigned int)blocks, batch);
  irfft_ola_kernel<kWindowed><<<grid, zt::kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h_re), static_cast<const float*>(h_im),
      static_cast<const float2*>(tw), static_cast<const float*>(win),
      static_cast<const float*>(wsq), static_cast<float*>(out), s, T, N, step,
      out_len, plan);
  return (int)cudaGetLastError();
}

}  // namespace

// h_re, h_im: (batch, T, N/2 + 1) float32 (N/2 rounded down); tw:
// kernels/rfft.store_tables(N), 8-byte aligned (where fft_fits takes N,
// the (N, 2) float32 table W_N^j = (cos, sin)(-2 pi j / N)); out: (batch,
// (T - 1) * step + N) float32; s the factor (scale / N); P the Bluestein
// length (kernels/rfft.layout(N).p, 0 where the passes take the FFT's own
// length). All contiguous. Any N in [16, 4096]: irfft_ola_kernel where
// fft_fits (P = 0), else irfft_any; step in [1, N] and batch at most
// 65535. Anything else, or a wrong P, returns cudaErrorInvalidValue before
// a launch. T = 0 returns after the checks and writes nothing: the wrapper
// returns the N - step zeros itself.
ZT_EXPORT int zt_irfft_ola(const void* h_re, const void* h_im, const void* tw,
                           void* out, float s, int batch, int T, int N,
                           int step, int P, void* stream) {
  zt::Plan plan;
  if (P == 0 && zt::fft_fits(N, &plan)) {
    return launch<false>(h_re, h_im, tw, nullptr, nullptr, out, s, batch, T,
                         N, step, stream);
  }
  zt::AnyPlan a;
  if (!zt::any_plan(N, P, &a) || step < 1 || step > N || batch > 65535 ||
      !zt::aligned8(tw)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  const float* hr = static_cast<const float*>(h_re);
  const float* hi = static_cast<const float*>(h_im);
  const float2* t = static_cast<const float2*>(tw);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.odd && a.blue) {
    return launch_any<true, true>(hr, hi, t, y, s, batch, T, N, step, a, P,
                                  st);
  }
  if (a.odd) {
    return launch_any<true, false>(hr, hi, t, y, s, batch, T, N, step, a, P,
                                   st);
  }
  return launch_any<false, true>(hr, hi, t, y, s, batch, T, N, step, a, P,
                                 st);
}

// The windowed store: s_re, s_im the half spectrum's planes (batch, T, N/2 +
// 1) float32; win (N,) the synthesis window and wsq ((T - 1) * step + N,)
// the envelope it divides by, float32; the rest as zt_irfft_ola (s =
// 1 / N for Griffin-Lim's inverse).
ZT_EXPORT int zt_irfft_ola_window(const void* s_re, const void* s_im,
                                  const void* tw, const void* win,
                                  const void* wsq, void* out, float s,
                                  int batch, int T, int N, int step,
                                  void* stream) {
  return launch<true>(s_re, s_im, tw, win, wsq, out, s, batch, T, N, step,
                      stream);
}
