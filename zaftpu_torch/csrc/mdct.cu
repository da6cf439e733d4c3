// MDCT analysis and IMDCT synthesis + overlap-add by a quarter-length
// complex FFT, the frames never stored. With N the window length, F = N/2,
// Q = N/4 and n0 = (F + 1)/2:
//   mdct:  X[b, t, k] = sum_{n<N} w[n] x[b, t F + n]
//                    cos(2 pi/N (n + n0)(k + 1/2))
//   imdct: y[b, p] = sum_t s w[p - t F] sum_{k<F} X[b, t, k]
//                    cos(2 pi/N (p - t F + n0)(k + 1/2)),  s = 2/F,
// over the frames t with 0 <= p - t F < N (two per sample), the
// (batch, T F + F) signal before the reference's trim. N a multiple of 4
// from 32 to 4096 with no prime factor above 127 in Q (kernels/mdct.py:
// fits): 724 lengths.
//
// Replaces zaftpu/pallas/fused.py: _frames_matmul_impl as frames_op reaches
// it with the MDCT operator (B2) and its _kernel_split4 (B2-s4), and
// zaftpu/pallas/synth.py: _gemm_ola_impl as imdct_ola reaches it (B7) and
// its _kernel_split4 (B7-s4), on both dials at those window lengths;
// fused.cu and synth.cu keep every other length, an explicit operator and
// ZAFTPU_FFT=matmul (kernels/mdct.py states the rule). The TPU kernels
// contract each frame with a dense (N, F) operator: 2 N F FLOP a frame. The
// fast MDCT does a Q-point FFT (about 5 Q log2 Q FLOP at a smooth Q) plus
// the fold, the twiddles and the window, which leaves both kernels bound by
// their bytes: the signal read once and the coefficients written once (or
// the reverse), 0.063 ms at the 600-s WL 2048 shape on an H100 (3.35 TB/s).
//
// The DCT-IV of F values v by a Q-point FFT: z[j] = (v[2j] + i v[F-1-2j])
// pre[j], Z = FFT_Q(z), Y[k] = Z[k] post[k], v's DCT-IV d[2k] = Re Y[k],
// d[F-1-2k] = -Im Y[k], with pre[j] = exp(-i pi j / F) and post[k] =
// exp(-i pi (k + 1/4) / F) in one host table (tw: pre then post, float64
// math rounded once to float32). The MDCT is the DCT-IV of the fold v[j] =
// -(u[3Q-1-j] + u[3Q+j]), v[Q+j] = u[j] - u[2Q-1-j] (j < Q) of the windowed
// frame u; the IMDCT frame is the DCT-IV d of the coefficients unfolded by
// the TDAC symmetries, y[j] = d[Q+j] (j < Q), -d[3Q-1-j] (Q <= j < 3Q),
// -d[j-3Q] (j >= 3Q), times the window scaled by 2/F (one float32 table).
// The FFT runs on stockham.cuh's passes with the real-FFT kernels' plan and
// twiddle table of length F (ftw). Every product and sum is an explicitly
// rounded intrinsic in the plain versions' order (kernels/mdct.py), so the
// kernels equal them bit for bit.
//
// Design. Forward: as rfft.cu, a 256-thread block transforms ⌊kElems / Q⌋
// consecutive frames of one batch row (four at WL 2048), reading each
// frame's samples straight from the padded signal, windowed and folded as
// read (four samples a packed value), then the passes, then the
// post-twiddle and a store of X[2k] and X[F-1-2k] by the thread of bin
// pair k. Inverse: as irfft.cu, a block owns kSpan = 8,192 output samples
// of one row in a shared-memory accumulator and transforms every frame
// that reaches them, ⌊kElems / Q⌋ at a time from the highest frame down
// (1.125 transforms per output frame at WL 2048); after the passes each
// thread post-twiddles its own values in place, then adds each sample's
// two terms, the higher frame's first, as imdct_ola's overlap-add sums
// them: no carry between blocks, no atomics. Shared memory: the two 16-KB
// FFT buffers (forward), plus the 32-KB accumulator (inverse, dynamic).
#include "stockham.cuh"

namespace {

// An N in [32, 4096], a multiple of 4, whose quarter Q has no prime factor
// above kMaxPrime, with the plan of its Q-point FFT.
bool mdct_fits(int n, zt::Plan* plan) {
  return n % 4 == 0 && n <= 2 * zt::kElems && zt::fft_fits(n / 2, plan);
}

// u[i] = x[i] w[i], the windowed sample.
__device__ __forceinline__ float windowed(const float* x, const float* w,
                                          int i) {
  return __fmul_rn(x[i], __ldg(w + i));
}

// v[m] of the fold of the windowed frame at x, m < F.
__device__ __forceinline__ float folded(const float* x, const float* w,
                                        int m, int q) {
  if (m < q) {
    return -__fadd_rn(windowed(x, w, 3 * q - 1 - m),
                      windowed(x, w, 3 * q + m));
  }
  const int j = m - q;
  return __fsub_rn(windowed(x, w, j), windowed(x, w, 2 * q - 1 - j));
}

__global__ void __launch_bounds__(zt::kThreads)
mdct_kernel(const float* __restrict__ sig, const float* __restrict__ win,
            const float2* __restrict__ tw, const float2* __restrict__ ftw,
            float* __restrict__ out, long long sig_len, int T, int n,
            zt::Plan plan) {
  __shared__ __align__(16) float2 buf[2][zt::kElems];
  const int Q = n / 4;
  const int F = n / 2;
  const int fpb = zt::kElems / Q;  // frames per block
  const long long t0 = (long long)blockIdx.x * fpb;
  const float* sb = sig + blockIdx.y * sig_len;

  for (int e = threadIdx.x; e < fpb * Q; e += blockDim.x) {
    const int f = e / Q;
    const int j = e - f * Q;
    const long long t = t0 + f;
    float2 z = make_float2(0.f, 0.f);
    if (t < T) {
      const float* x = sb + t * F;
      z = zt::cmul(make_float2(folded(x, win, 2 * j, Q),
                               folded(x, win, F - 1 - 2 * j, Q)),
                   __ldg(tw + j));
    }
    buf[0][e] = z;
  }
  __syncthreads();

  int cur = 0;
  zt::fft_rows(buf, cur, ftw, Q, fpb, F, plan);

  for (int e = threadIdx.x; e < fpb * Q; e += blockDim.x) {
    const int f = e / Q;
    const int k = e - f * Q;
    const long long t = t0 + f;
    if (t >= T) continue;
    const float2 y = zt::cmul(buf[cur][e], __ldg(tw + Q + k));
    float* o = out + ((long long)blockIdx.y * T + t) * F;
    o[2 * k] = y.x;
    o[F - 1 - 2 * k] = -y.y;
  }
}

// Sample j of the unfolded frame, from the post-twiddled values zf of its
// FFT: zf[k] = (d[2k], d[F-1-2k]).
__device__ __forceinline__ float unfolded(const float2* zf, int j, int q,
                                          int f) {
  const int m = j < q ? q + j : j < 3 * q ? 3 * q - 1 - j : j - 3 * q;
  const float d = (m & 1) ? zf[(f - 1 - m) >> 1].y : zf[m >> 1].x;
  return j < q ? d : -d;
}

__global__ void __launch_bounds__(zt::kThreads)
imdct_ola_kernel(const float* __restrict__ coeffs,
                 const float* __restrict__ win, const float2* __restrict__ tw,
                 const float2* __restrict__ ftw, float* __restrict__ out,
                 int T, int n, long long out_len, zt::Plan plan) {
  extern __shared__ float acc[];  // kSpan floats
  __shared__ __align__(16) float2 buf[2][zt::kElems];
  const int Q = n / 4;
  const int F = n / 2;
  const int G = zt::kElems / Q;  // frames per group
  const long long p0 = (long long)blockIdx.x * zt::kSpan;
  const long long rest = out_len - p0;
  const int span = rest < zt::kSpan ? (int)rest : zt::kSpan;
  const long long last = (p0 + span - 1) / F;
  const long long t_top = last < T - 1 ? last : T - 1;
  const long long t_lo = zt::first_frame(p0, n, F);
  // Block-relative positions and frames: sample q = p - t_lo * F of
  // relative frame u = t - t_lo (q < kSpan + N, u * F <= q).
  const int q0 = (int)(p0 - t_lo * F);
  const int u_top = (int)(t_top - t_lo);
  const float* cb = coeffs + ((long long)blockIdx.y * T + t_lo) * F;

  for (int e = threadIdx.x; e < span; e += blockDim.x) acc[e] = 0.f;

  for (int ug = u_top; ug >= 0; ug -= G) {
    const int cnt = ug + 1 < G ? ug + 1 : G;  // rows u = ug, ug - 1, ...
    for (int e = threadIdx.x; e < cnt * Q; e += blockDim.x) {
      const int f = e / Q;
      const int j = e - f * Q;
      const float* c = cb + (long long)(ug - f) * F;
      buf[0][e] =
          zt::cmul(make_float2(c[2 * j], c[F - 1 - 2 * j]), __ldg(tw + j));
    }
    __syncthreads();
    int cur = 0;
    zt::fft_rows(buf, cur, ftw, Q, cnt, F, plan);

    // Post-twiddle in place: (Re, -Im) of Z[k] post[k] = (d[2k], d[F-1-2k]).
    float2* z = buf[cur];
    for (int e = threadIdx.x; e < cnt * Q; e += blockDim.x) {
      const float2 y = zt::cmul(z[e], __ldg(tw + Q + e % Q));
      z[e] = make_float2(y.x, -y.y);
    }
    __syncthreads();

    const int u_end = ug - cnt;  // the group's rows are u_end < u <= ug
    for (int e = threadIdx.x; e < span; e += blockDim.x) {
      const int q = q0 + e;
      int u = q / F;
      if (u > ug) u = ug;
      float v = acc[e];
      for (int j = q - u * F; u > u_end && j < n; --u, j += F) {
        v = __fadd_rn(v, __fmul_rn(unfolded(z + (ug - u) * Q, j, Q, F),
                                   __ldg(win + j)));
      }
      acc[e] = v;
    }
    __syncthreads();
  }

  float* ob = out + blockIdx.y * out_len + p0;
  for (int e = threadIdx.x; e < span; e += blockDim.x) ob[e] = acc[e];
}

}  // namespace

// sig: (batch, sig_len) with sig_len >= (T + 1) N/2; win: (N,); tw: (2, N/4,
// 2) float32, the pre- and post-twiddles as (cos, sin); ftw: (N/2, 2)
// float32, W_{N/2}^j = (cos, sin)(-4 pi j / N); out: (batch, T, N/2)
// float32. All contiguous, tw and ftw 8-byte aligned. N as in mdct_fits,
// batch at most 65535; anything else returns cudaErrorInvalidValue before a
// launch.
ZT_EXPORT int zt_mdct_fft(const void* sig, const void* win, const void* tw,
                          const void* ftw, void* out, int batch,
                          long long sig_len, int T, int N, void* stream) {
  zt::Plan plan;
  if (!mdct_fits(N, &plan) || batch > 65535 || !zt::aligned8(tw) ||
      !zt::aligned8(ftw)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  const int fpb = zt::kElems / (N / 4);
  const dim3 grid(zt::ceil_div(T, fpb), batch);
  mdct_kernel<<<grid, zt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<const float2*>(ftw),
      static_cast<float*>(out), sig_len, T, N, plan);
  return (int)cudaGetLastError();
}

// coeffs: (batch, T, N/2) float32; win: (N,) float32, the window times 2/F;
// tw, ftw as for zt_mdct_fft; out: (batch, (T + 1) N/2) float32. All
// contiguous. N as in mdct_fits and batch at most 65535; anything else
// returns cudaErrorInvalidValue before a launch. T = 0 returns after the
// checks and writes nothing: the wrapper returns the N/2 zeros itself.
ZT_EXPORT int zt_imdct_ola_fft(const void* coeffs, const void* win,
                               const void* tw, const void* ftw, void* out,
                               int batch, int T, int N, void* stream) {
  zt::Plan plan;
  if (!mdct_fits(N, &plan) || batch > 65535 || !zt::aligned8(tw) ||
      !zt::aligned8(ftw)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  const int smem = zt::kSpan * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      imdct_ola_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long out_len = (long long)(T + 1) * (N / 2);
  const long long blocks = (out_len + zt::kSpan - 1) / zt::kSpan;
  const dim3 grid((unsigned int)blocks, batch);
  imdct_ola_kernel<<<grid, zt::kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<const float2*>(ftw),
      static_cast<float*>(out), T, N, out_len, plan);
  return (int)cudaGetLastError();
}
