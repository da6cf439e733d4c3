// Inverse real FFT + overlap-add in one launch, the frames never stored:
//   y[b, p] = sum_t s * irfft_N(H[b, t])[p - t*step]
// over the frames t in [0, T) with 0 <= p - t*step < N, summed t
// descending (c = r - t ascending for p = r*step + j, left-associated, from
// 0), s = scale / N rounded once to float32 on the host. H is the
// Hermitian-folded half spectrum as two float32 planes (batch, T, N/2 + 1);
// the imaginary parts of DC and Nyquist are not read, as an inverse real
// FFT ignores them. N even, from 16 to 4096, with N/2 free of prime factors
// above 127 (kernels/rfft.py: fits), any hop in [1, N].
//
// Replaces zaftpu/pallas/synth.py: _gemm_ola_impl as istft_ola reaches it
// (B4) and its _kernel_split4 (B4-s4) on both dials at those window
// lengths; synth.cu's GEMM kernels keep every other length, an explicit
// operator and ZAFTPU_FFT=matmul (kernels/synth.py states the rule). The TPU
// kernels contract each frame with a dense (2 (N/2+1), N) inverse operator:
// 2 N (N + 2) FLOP per frame. The FFT does about 2.5 N log2 N at a smooth
// N and more at a large prime factor, which leaves this kernel bound by its
// bytes: both planes read once and the signal written once, 0.095 ms at the
// 600-s WL 2048 and WL 1102 shapes on an H100 (3.35 TB/s).
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
  const long long p0 = (long long)blockIdx.x * zt::kSpan;
  const long long rest = out_len - p0;
  const int span = rest < zt::kSpan ? (int)rest : zt::kSpan;
  const long long last = (p0 + span - 1) / step;
  const long long t_top = last < T - 1 ? last : T - 1;
  const long long t_lo = zt::first_frame(p0, n, step);
  // Block-relative positions and frames: sample q = p - t_lo * step of
  // relative frame u = t - t_lo (q < kSpan + N, u * step <= q).
  const int q0 = (int)(p0 - t_lo * step);
  const int u_top = (int)(t_top - t_lo);
  const long long rows = (long long)blockIdx.y * T + t_lo;
  const float* hrb = hr + rows * F;
  const float* hib = hi + rows * F;

  for (int e = threadIdx.x; e < span; e += blockDim.x) acc[e] = 0.f;

  for (int ug = u_top; ug >= 0; ug -= G) {
    const int cnt = ug + 1 < G ? ug + 1 : G;  // rows u = ug, ug - 1, ...
    for (int e = threadIdx.x; e < cnt * M; e += blockDim.x) {
      const int f = e / M;
      const int k = e - f * M;
      const float* a = hrb + (long long)(ug - f) * F;
      const float* b = hib + (long long)(ug - f) * F;
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
      buf[0][e] = make_float2(zr, -zi);  // conj Z
    }
    __syncthreads();
    int cur = 0;
    zt::fft_rows(buf, cur, tw, M, cnt, n, plan);

    const int u_end = ug - cnt;  // the group's rows are u_end < u <= ug
    const float2* z = buf[cur];
    for (int e = threadIdx.x; e < span; e += blockDim.x) {
      const int q = q0 + e;
      int u = q / step;
      if (u > ug) u = ug;
      float v = acc[e];
      for (int j = q - u * step; u > u_end && j < n; --u, j += step) {
        const float2 c = z[(ug - u) * M + (j >> 1)];
        const float x = __fmul_rn((j & 1) ? -c.y : c.x, s);
        v = __fadd_rn(v, kWindowed ? __fmul_rn(x, __ldg(win + j)) : x);
      }
      acc[e] = v;
    }
    __syncthreads();
  }

  float* ob = out + blockIdx.y * out_len + p0;
  for (int e = threadIdx.x; e < span; e += blockDim.x) {
    ob[e] = kWindowed ? __fdiv_rn(acc[e], __ldg(wsq + p0 + e)) : acc[e];
  }
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

// h_re, h_im: (batch, T, N/2 + 1) float32; tw: (N, 2) float32, W_N^j =
// (cos, sin)(-2 pi j / N), 8-byte aligned; out: (batch, (T - 1) * step +
// N) float32; s the factor (scale / N). All contiguous. N even in [16,
// 4096] with no prime factor above 127 in N/2, step in [1, N] and batch at
// most 65535; anything else returns cudaErrorInvalidValue before a launch.
// T = 0 returns after the checks and writes nothing: the wrapper returns
// the N - step zeros itself.
ZT_EXPORT int zt_irfft_ola(const void* h_re, const void* h_im, const void* tw,
                           void* out, float s, int batch, int T, int N,
                           int step, void* stream) {
  return launch<false>(h_re, h_im, tw, nullptr, nullptr, out, s, batch, T, N,
                       step, stream);
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
