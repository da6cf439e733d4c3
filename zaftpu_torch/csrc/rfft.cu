// Framing + window + real FFT, the frames never stored:
//   out[b, t, k] = sum_w sig[b, t*step + w] * win[w] * exp(-2 pi i k w / N)
// for k = 0..N/2, N = WL a power of two from 16 to 4096, with two stores of
// the same values: rfft_half writes the interleaved complex (batch, T, F)
// half spectrum, rfft_planes the two float32 planes (2, batch, T, F), F =
// N/2 + 1. Both run one kernel body, so they are bit-equal.
//
// Replaces zaftpu/pallas/fused.py: _frames_matmul_impl as frames_rfft
// reaches it (B1) and _frames_matmul2_impl (B12) on the exact dial at those
// window lengths; the GEMM kernels of fused.cu keep every other length and
// an explicit operator (kernels/fused.py states the rule). The TPU kernels
// contract each frame with a dense (N, F) cos/sin operator on the matrix
// unit: 4 N F FLOP per frame. Here the same sums come from an FFT, about
// 2.5 N log2 N FLOP, which leaves the kernel bound by its bytes: each
// signal sample read once (4 bytes per hop) and 8 F bytes written per
// frame, 0.095 ms at the 600-s WL 2048 shape on an H100 (3.35 TB/s).
//
// Design: a block of 256 threads transforms kElems = 2048 complex values at
// once, the N/2-point complex FFTs of kElems / (N/2) consecutive frames of
// one batch row (two frames at WL 2048, one at 4096). Frame groups ride
// grid x and the batch grid y, so an hour-long signal fits one launch.
//  1. Framing: each thread reads sample pairs (2m, 2m + 1) of a frame (one
//     8-byte load where the hop and the pointers allow), multiplies them by
//     the window and stores z[m] = x[2m] + i x[2m+1] in shared memory:
//     the real FFT of N as a complex FFT of N/2.
//  2. Stockham autosort passes between two shared-memory buffers (16 KB
//     each), one barrier per pass: radix 4 while it fits, then one radix-2
//     pass when log2(N/2) is odd. Pass p with sub-transform length ns reads
//     v[s] = in[j + s * N/(2R)], multiplies v[s] (s > 0) by the twiddle
//     W_N^(s k N/(ns R)), k = j mod ns, runs the R-point DFT and writes
//     y[s] to out[(j - k) R + k + s ns]. After the last pass the buffer
//     holds Z = FFT_{N/2}(z) in natural order.
//  3. Split: X[k] = E + W_N^k O with E = (Z[k] + conj Z[N/2-k]) / 2,
//     O = (Z[k] - conj Z[N/2-k]) / 2i, for k = 0..N/2; a warp writes
//     consecutive bins of one frame, so both stores are coalesced.
// The twiddles W_N^j, j < N, are one host table (float64 math rounded once
// to float32, kernels/rfft.py), read through the read-only cache. Every
// product and sum is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn),
// so nothing is contracted into an FMA and the kernel does the plain
// version's float32 operations in the plain version's order. No atomics;
// ragged T is masked at the loads (zeros) and the stores.
#include "common.cuh"

namespace {

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

// One radix-R Stockham pass over every frame of the block: sub-transforms
// of length 2^log_ns grow to R times that.
template <int R>
__device__ __forceinline__ void stage(const float2* __restrict__ src,
                                      float2* __restrict__ dst,
                                      const float2* __restrict__ tw,
                                      int log_m, int log_ns, int log_n) {
  constexpr int LOG_R = R == 4 ? 2 : 1;
  const int log_q = log_m - LOG_R;       // butterflies per frame: N/2 / R
  const int q = 1 << log_q;
  const int ns = 1 << log_ns;
  const int log_tw = log_n - log_ns - LOG_R;  // N / (ns R)
  for (int b = threadIdx.x; b < kElems / R; b += blockDim.x) {
    const int f = b >> log_q;
    const int j = b & (q - 1);
    const int k = j & (ns - 1);
    const float2* in = src + (f << log_m) + j;
    float2 v[R];
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = in[s * q];
#pragma unroll
    for (int s = 1; s < R; ++s) {
      v[s] = cmul(v[s], __ldg(tw + ((s * k) << log_tw)));
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
    } else {
      y[0] = cadd(v[0], v[1]);
      y[1] = csub(v[0], v[1]);
    }
    float2* out = dst + (f << log_m) + (j - k) * R + k;
#pragma unroll
    for (int s = 0; s < R; ++s) out[s * ns] = y[s];
  }
}

// VEC: 8-byte signal and window loads. PLANES: the (2, batch, T, F) store.
template <bool VEC, bool PLANES>
__global__ void __launch_bounds__(zt::kThreads)
rfft_kernel(const float* __restrict__ sig, const float* __restrict__ win,
            const float2* __restrict__ tw, float* __restrict__ out,
            long long sig_len, int T, int log_n, int step) {
  __shared__ __align__(16) float2 buf[2][kElems];
  const int log_m = log_n - 1;
  const int M = 1 << log_m;
  const int fpb = kElems >> log_m;  // frames per block
  const long long t0 = (long long)blockIdx.x * fpb;
  const float* sb = sig + blockIdx.y * sig_len;

  for (int e = threadIdx.x; e < kElems; e += blockDim.x) {
    const int m = e & (M - 1);
    const long long t = t0 + (e >> log_m);
    float2 v = make_float2(0.f, 0.f);
    if (t < T) {
      const float* p = sb + t * step + 2 * m;
      float2 x, w;
      if constexpr (VEC) {
        x = *reinterpret_cast<const float2*>(p);
        w = *reinterpret_cast<const float2*>(win + 2 * m);
      } else {
        x = make_float2(p[0], p[1]);
        w = make_float2(win[2 * m], win[2 * m + 1]);
      }
      v = make_float2(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y));
    }
    buf[0][e] = v;
  }
  __syncthreads();

  int cur = 0;
  int log_ns = 0;
  for (; log_ns + 2 <= log_m; log_ns += 2) {
    stage<4>(buf[cur], buf[cur ^ 1], tw, log_m, log_ns, log_n);
    cur ^= 1;
    __syncthreads();
  }
  if (log_ns < log_m) {
    stage<2>(buf[cur], buf[cur ^ 1], tw, log_m, log_ns, log_n);
    cur ^= 1;
    __syncthreads();
  }

  const int F = M + 1;
  const long long plane = (long long)gridDim.y * T * F;
  for (int e = threadIdx.x; e < fpb * F; e += blockDim.x) {
    const int f = e / F;
    const int k = e - f * F;
    const long long t = t0 + f;
    if (t >= T) continue;
    const float2* z = buf[cur] + (f << log_m);
    const float2 a = z[k & (M - 1)];
    const float2 b = z[(M - k) & (M - 1)];
    const float2 w = __ldg(tw + k);
    const float er = __fmul_rn(__fadd_rn(a.x, b.x), 0.5f);
    const float ei = __fmul_rn(__fsub_rn(a.y, b.y), 0.5f);
    const float od = __fmul_rn(__fadd_rn(a.y, b.y), 0.5f);
    const float oi = __fmul_rn(__fsub_rn(b.x, a.x), 0.5f);
    const float xr =
        __fadd_rn(er, __fsub_rn(__fmul_rn(w.x, od), __fmul_rn(w.y, oi)));
    const float xi =
        __fadd_rn(ei, __fadd_rn(__fmul_rn(w.x, oi), __fmul_rn(w.y, od)));
    const long long idx = ((long long)blockIdx.y * T + t) * F + k;
    if constexpr (PLANES) {
      out[idx] = xr;
      out[plane + idx] = xi;
    } else {
      reinterpret_cast<float2*>(out)[idx] = make_float2(xr, xi);
    }
  }
}

inline bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
}

template <bool PLANES>
int launch(const void* sig, const void* win, const void* tw, void* out,
           int batch, long long sig_len, int T, int WL, int step,
           void* stream) {
  int log_n = 0;
  while ((1 << log_n) < WL) ++log_n;
  if (WL < 16 || WL > 2 * kElems || (1 << log_n) != WL || step < 1 ||
      step > WL || batch > 65535 || !aligned8(tw)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fpb = kElems / (WL / 2);
  const dim3 grid(zt::ceil_div(T, fpb), batch);
  const float* s = static_cast<const float*>(sig);
  const float* w = static_cast<const float*>(win);
  const float2* t = static_cast<const float2*>(tw);
  float* y = static_cast<float*>(out);
  if (step % 2 == 0 && sig_len % 2 == 0 && aligned8(sig) && aligned8(win)) {
    rfft_kernel<true, PLANES><<<grid, zt::kThreads, 0, st>>>(
        s, w, t, y, sig_len, T, log_n, step);
  } else {
    rfft_kernel<false, PLANES><<<grid, zt::kThreads, 0, st>>>(
        s, w, t, y, sig_len, T, log_n, step);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sig: (batch, sig_len) with sig_len >= (T - 1) * step + WL; win: (WL,);
// tw: (WL, 2) float32, W_WL^j = (cos, sin)(-2 pi j / WL), 8-byte aligned;
// out: (batch, T, WL/2 + 1) complex64 as float pairs. WL a power of two in
// [16, 4096], step in [1, WL]. All contiguous.
ZT_EXPORT int zt_rfft_half(const void* sig, const void* win, const void* tw,
                           void* out, int batch, long long sig_len, int T,
                           int WL, int step, void* stream) {
  return launch<false>(sig, win, tw, out, batch, sig_len, T, WL, step,
                       stream);
}

// As zt_rfft_half, out two float32 planes (2, batch, T, WL/2 + 1): the real
// parts, then the imaginary parts.
ZT_EXPORT int zt_rfft_planes(const void* sig, const void* win, const void* tw,
                             void* out, int batch, long long sig_len, int T,
                             int WL, int step, void* stream) {
  return launch<true>(sig, win, tw, out, batch, sig_len, T, WL, step, stream);
}
