// Framing + window + real FFT, the frames never stored:
//   X[b, t, k] = sum_w sig[b, t*step + w] * win[w] * exp(-2 pi i k w / N)
// for k = 0..N/2, N = WL even, from 16 to 4096, with N/2 free of prime
// factors above 127 (1,263 lengths: every power of two, and 400, 1102,
// 1764, 2822, 3000 ...), with five stores of the same values: rfft_half
// writes the interleaved complex (batch, T, F) half spectrum, rfft_planes
// the two float32 planes (2, batch, T, F), F = N/2 + 1, rfft_full the
// complex (batch, T, N) full spectrum, out[N - k] = conj out[k] for k =
// 1..N/2 - 1 (the reference's zaf.py:139 convention), rfft_spec the
// magnitudes (batch, T, N/2) of bins 1..N/2 (DC dropped, Nyquist kept,
// zaf.py:370), and rfft_mel those magnitudes (or their squares, the power)
// times a mel filterbank, (batch, T, n_mels). All five run one kernel body,
// so every bin is bit-equal across them (the conjugate's negation is
// exact).
//
// Replaces zaftpu/pallas/fused.py: _frames_matmul_impl as frames_rfft
// reaches it (B1), its _kernel_split4 (B1-s4), _frames_matmul2_impl (B12),
// its _kernel2_split4 (B12-s4), _frames_matmul_full_impl (B3, the mirror in
// its epilogue) and its _kernel_full_split4 (B3-s4) on both dials at those
// window lengths. The magnitude store replaces zaftpu/pallas/melfused.py:
// _spec_rows_impl (:200, B8) and the mel store its _mel_rows_impl (:263,
// B9) and that kernel's _kernel_split4 (:142, B9-s4) there too. All five
// stores also take every other window from 16 to 4096 (rfft_any, below), on
// every dial: the GEMM kernels of fused.cu and melfused.cu and their twins
// keep only an explicit operator, ZAFTPU_FFT=matmul and a window below 16
// (kernels/fused.py and kernels/melfused.route state the rules).
// The TPU kernels contract each frame with a dense (N, F) cos/sin
// operator on the matrix unit: 4 N F FLOP per frame. Here the same sums
// come from an FFT, about 2.5 N log2 N FLOP at a smooth N and more at a
// large prime factor (a radix-p pass does O(p) operations a point), which
// leaves the kernel bound by its bytes: each signal sample read once (4
// bytes per hop) and 8 F bytes (8 N for the full store) written per frame,
// 0.095 ms (0.158 ms) at the 600-s WL 2048 and WL 1102 shapes on an H100
// (3.35 TB/s). The magnitude store writes 4 N/2 bytes a frame (half the
// half store's writes, and no complex spectrum for a later |.| to read
// back): bound 0.0632 ms at WL 2048. The mel store writes 4 n_mels bytes a
// frame, so it reads the signal and little else: bound 0.0328 ms at WL
// 2048 with 40 mels, 0.0258 ms at Whisper's front end (16 kHz, WL 400, hop
// 160, 80 mels), both by bytes. B8 and B9 contract with the dense operator in FP32 without tensor
// cores (3.2 ms), and B9 then multiplies by a dense (N/2, n_mels)
// filterbank that is 95% zeros at MelConfig(); the mel store adds only the
// filterbank's nonzeros (2 operations each).
//
// Design: a block of 256 threads transforms up to kElems = 2048 complex
// values at once, the M-point complex FFTs (M = N/2) of fpb = kElems / M
// (rounded down) consecutive frames of one batch row: two frames at WL 2048
// and 1764, three at 1102, one at 3000 and 4096, ten at 400. Frame groups
// ride grid x and the batch grid y, so an hour-long signal fits one launch.
//  1. Framing: each thread reads sample pairs (2m, 2m + 1) of a frame (one
//     8-byte load where the hop and the pointers allow), multiplies them by
//     the window and stores z[m] = x[2m] + i x[2m+1] in shared memory:
//     the real FFT of N as a complex FFT of M.
//  2. The Stockham passes of stockham.cuh, in the plan the host gives
//     (kernels/rfft.radices), between two shared-memory buffers (16 KB
//     each): the buffer then holds Z = FFT_M(z) in natural order.
//  3. Split: X[k] = E + W_N^k O with E = (Z[k] + conj Z[(M-k) mod M]) / 2,
//     O = (Z[k] - conj Z[(M-k) mod M]) / 2i, for k = 0..M (Z[M] read as
//     Z[0]); a warp writes consecutive bins of one frame, so every store is
//     coalesced: the full store's mirrored writes land on consecutive
//     descending addresses, in the same loop iteration as the forward ones.
//  4. Magnitude store: for k = 1..N/2, sqrt(re^2 + im^2) (__fmul_rn,
//     __fadd_rn, __fsqrt_rn), consecutive threads on consecutive bins.
//     Mel store: the same values (the power skips the root) go into the
//     shared buffer the last pass did not write (N/2 floats a frame, at
//     most 2,048 of its 4,096), then after a barrier each thread takes
//     (frame, mel) outputs in turn, any n_mels, and walks that mel's row of
//     a CSR table (row pointer, column c for bin c + 1, float32 weight, read
//     through the read-only cache: a dense foreign filterbank may hold N/2
//     n_mels nonzeros, more than shared memory), adding weight * value to a
//     zero sum in the table's (ascending-column) order. One output a thread
//     leaves threads idle at a few mels (80 outputs for 256 threads at WL
//     2048 and 40 mels) and rows of 4 to 163 terms unbalanced at
//     MelConfig(); a later change may split the rows.
//
// Off that rule the five stores run rfft_any:
// an odd N transforms each frame alone as a complex N-point FFT with zero
// imaginary parts (the passes take N: the odd radices and primes up to
// 127). That is twice a real FFT's work, but a frame's bins round with no
// other frame's: two frames packed as one FFT's real and imaginary parts
// put about 1e-7 of the loud one's magnitude into a silent partner, which
// a log-mel or MFCC turns into a different value than the GEMM's exact
// zero (PERF.md).
// An FFT length M (N/2, or N when odd) with a prime factor above 127 runs
// by Bluestein's chirp z-transform: M-point DFT = conj c[k] (a * c)[k],
// a[m] = z[m] conj c[m], c[j] = exp(i pi j^2 / M), the convolution
// circular over P >= 2M - 1 values the passes take
// (kernels/rfft.bluestein_length: 2,304 for M 1,031, 4,096 for 2,039) as a
// forward FFT, a product with the host table B = FFT_P(c wrapped) / P and
// a conjugated forward FFT. A block holds as many rows as fit in the
// smallest of 2,048, 4,096 and 8,192 values that holds one (an odd N above
// 2,048, or P, takes the larger ones) and allocates two buffers of just
// those rows in dynamic shared memory (up to 128 KB; cudaFuncSetAttribute
// above 48 KB): at WL 2,062 (P 2,304) and 2,205 the stores took 0.76-0.87
// of the time of buffers of the whole 4,096 values on an H100
// (scripts/torch_ab.py --label any, PERF.md), and 512 threads a block took
// 1.08-1.35 times as long as 256 at WL 2,062 and 4,078. Counted as the
// M-point DFT it computes (5 M log2 M operations), the 600-s WL 2,062
// magnitude store (hop 512) is bound by its bytes, 0.095 ms
// (chip_smoke.bound); Bluestein's own work, two P-point FFTs and three
// pointwise products, would take 0.224 ms at the FP32 peak, and B8 GEMM's
// FP32 bound is 6.56 ms.
#include "stockham.cuh"

namespace {

// The output layouts of one body: (batch, T, F) complex, (2, batch, T, F)
// float32 planes, (batch, T, N) complex with the conjugate mirror,
// (batch, T, N/2) magnitudes of bins 1..N/2, (batch, T, n_mels) mel rows.
enum class Store { kHalf, kPlanes, kFull, kSpec, kMel };

// The mel store's filterbank over bins 1..N/2, in CSR form: row m holds
// entries [rowptr[m], rowptr[m + 1]), each a column c (bin c + 1) and a
// weight, columns ascending. power: the squared magnitude, unrooted.
struct Mel {
  const int* rowptr;
  const int* cols;
  const float* weights;
  int n_mels;
  int power;
};

// Bin k of the split step from Z = FFT_M(z) of one frame (k = 0..M, Z[M]
// read as Z[0]): X[k] = E + W_N^k O.
__device__ __forceinline__ float2 split_bin(const float2* z,
                                            const float2* __restrict__ tw,
                                            int k, int M) {
  const float2 a = z[k == M ? 0 : k];
  const float2 b = z[k == 0 ? 0 : M - k];
  const float2 w = __ldg(tw + k);
  const float er = __fmul_rn(__fadd_rn(a.x, b.x), 0.5f);
  const float ei = __fmul_rn(__fsub_rn(a.y, b.y), 0.5f);
  const float od = __fmul_rn(__fadd_rn(a.y, b.y), 0.5f);
  const float oi = __fmul_rn(__fsub_rn(b.x, a.x), 0.5f);
  return make_float2(
      __fadd_rn(er, __fsub_rn(__fmul_rn(w.x, od), __fmul_rn(w.y, oi))),
      __fadd_rn(ei, __fadd_rn(__fmul_rn(w.x, oi), __fmul_rn(w.y, od))));
}

// VEC: 8-byte signal and window loads.
template <bool VEC, Store S>
__global__ void __launch_bounds__(zt::kThreads)
rfft_kernel(const float* __restrict__ sig, const float* __restrict__ win,
            const float2* __restrict__ tw, float* __restrict__ out,
            long long sig_len, int T, int n, int step, zt::Plan plan,
            Mel mel) {
  __shared__ __align__(16) float2 buf[2][zt::kElems];
  const int M = n / 2;
  const int fpb = zt::kElems / M;  // frames per block
  const long long t0 = (long long)blockIdx.x * fpb;
  const float* sb = sig + blockIdx.y * sig_len;

  for (int e = threadIdx.x; e < fpb * M; e += blockDim.x) {
    const int f = e / M;
    const int m = e - f * M;
    const long long t = t0 + f;
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
  zt::fft_rows(buf, cur, tw, M, fpb, n, plan);

  if constexpr (S == Store::kSpec || S == Store::kMel) {
    // Bins 1..M: the magnitudes straight out, or into the free buffer.
    float* vals = reinterpret_cast<float*>(buf[cur ^ 1]);
    for (int e = threadIdx.x; e < fpb * M; e += blockDim.x) {
      const int f = e / M;
      const int k = e - f * M + 1;
      const long long t = t0 + f;
      if (t >= T) continue;
      const float2 x = split_bin(buf[cur] + f * M, tw, k, M);
      const float p = __fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y));
      if constexpr (S == Store::kSpec) {
        out[((long long)blockIdx.y * T + t) * M + k - 1] = __fsqrt_rn(p);
      } else {
        vals[e] = mel.power ? p : __fsqrt_rn(p);
      }
    }
    if constexpr (S == Store::kMel) {
      __syncthreads();
      for (int o = threadIdx.x; o < fpb * mel.n_mels; o += blockDim.x) {
        const int f = o / mel.n_mels;
        const int m = o - f * mel.n_mels;
        const long long t = t0 + f;
        if (t >= T) continue;
        const float* v = vals + f * M;
        const int end = __ldg(mel.rowptr + m + 1);
        float acc = 0.f;
        for (int j = __ldg(mel.rowptr + m); j < end; ++j) {
          acc = __fadd_rn(acc, __fmul_rn(__ldg(mel.weights + j),
                                         v[__ldg(mel.cols + j)]));
        }
        out[((long long)blockIdx.y * T + t) * mel.n_mels + m] = acc;
      }
    }
  } else {
    const int F = M + 1;
    for (int e = threadIdx.x; e < fpb * F; e += blockDim.x) {
      const int f = e / F;
      const int k = e - f * F;
      const long long t = t0 + f;
      if (t >= T) continue;
      const float2 x = split_bin(buf[cur] + f * M, tw, k, M);
      const long long row = (long long)blockIdx.y * T + t;
      if constexpr (S == Store::kPlanes) {
        out[row * F + k] = x.x;
        out[((long long)gridDim.y * T + row) * F + k] = x.y;
      } else if constexpr (S == Store::kHalf) {
        reinterpret_cast<float2*>(out)[row * F + k] = x;
      } else {
        float2* o = reinterpret_cast<float2*>(out) + row * n;
        o[k] = x;
        if (k != 0 && k != M) o[n - k] = make_float2(x.x, -x.y);
      }
    }
  }
}

// The five stores at a window the static path refuses, on `rows` rows of L
// values in dynamic shared memory (two buffers of rows * L values), row r
// frame t0 + r: ODD holds z[m] = x[m]
// w[m] (m < N, zero imaginary parts) and runs the N-point complex FFT,
// whose bins 0..(N-1)/2 are the frame's (no Nyquist bin), each frame
// alone (no two frames share an FFT, so a frame's bins round with no
// other frame's); otherwise the frame's even/odd
// packing, M = N/2 points, and split_bin. BLUE runs that M-point FFT (M =
// N or N/2) by Bluestein's chirp z-transform on rows of L = P values: z[m]
// times conj c[m], zeros to P, the forward passes (table W_P), times B[k],
// conjugated, the forward passes, conjugated, times conj c[k]. tab holds
// W_N (N values), then under BLUE W_P (P), conj c (M) and B (P)
// (kernels/rfft.store_tables). Then the stores of rfft_kernel: bins 0..F
// (half, planes, full with its mirror) or 1..F (magnitude, mel), F = N/2
// rounded down.
template <bool ODD, bool BLUE, Store S>
__global__ void __launch_bounds__(zt::kThreads)
rfft_any(const float* __restrict__ sig, const float* __restrict__ win,
         const float2* __restrict__ tab, float* __restrict__ out,
         long long sig_len, int T, int n, int step, int P, int rows,
         zt::Plan plan, Mel mel) {
  extern __shared__ __align__(16) float2 smem[];
  const int M = ODD ? n : n / 2;
  const int L = BLUE ? P : M;     // values a row
  const zt::Buffers buf{smem, rows * L};
  const int F = n / 2;            // bins 1..F a frame
  const long long t0 = (long long)blockIdx.x * rows;
  const float* sb = sig + blockIdx.y * sig_len;
  const float2* twp = BLUE ? tab + n : tab;  // the passes' table, W_L
  const float2* chirp = tab + n + P;
  const float2* big = chirp + M;

  for (int e = threadIdx.x; e < rows * L; e += blockDim.x) {
    const int r = e / L;
    const int m = e - r * L;
    float2 v = make_float2(0.f, 0.f);
    const long long t = t0 + r;
    if (m < M && t < T) {
      const float* p = sb + t * step;
      if constexpr (ODD) {
        v.x = __fmul_rn(p[m], win[m]);
      } else {
        v = make_float2(__fmul_rn(p[2 * m], win[2 * m]),
                        __fmul_rn(p[2 * m + 1], win[2 * m + 1]));
      }
      if constexpr (BLUE) v = zt::cmul(v, __ldg(chirp + m));
    }
    buf[0][e] = v;
  }
  __syncthreads();

  int cur = 0;
  zt::fft_rows(buf, cur, twp, L, rows, L, plan);
  if constexpr (BLUE) {
    zt::bluestein_tail(buf, cur, twp, chirp, big, L, M, rows, plan);
  }

  if constexpr (S == Store::kHalf || S == Store::kPlanes ||
                S == Store::kFull) {
    // Bins 0..F (H = F + 1 a frame, DC included; an odd N has no Nyquist
    // bin), rfft_kernel's layouts, consecutive threads on consecutive bins
    // of a frame; the full store also writes bin N - k as the conjugate of
    // bin k for k = 1..(N-1)/2 (the mirror, not the FFT's own upper bins,
    // which an odd N's FFT holds but which round otherwise).
    const int H = F + 1;
    for (int e = threadIdx.x; e < rows * H; e += blockDim.x) {
      const int f = e / H;
      const int k = e - f * H;
      const long long t = t0 + f;
      if (t >= T) continue;
      const float2 x = ODD ? buf[cur][f * L + k]
                           : split_bin(buf[cur] + f * L, tab, k, M);
      const long long row = (long long)blockIdx.y * T + t;
      if constexpr (S == Store::kPlanes) {
        out[row * H + k] = x.x;
        out[((long long)gridDim.y * T + row) * H + k] = x.y;
      } else if constexpr (S == Store::kHalf) {
        reinterpret_cast<float2*>(out)[row * H + k] = x;
      } else {
        float2* o = reinterpret_cast<float2*>(out) + row * n;
        o[k] = x;
        if (k != 0 && 2 * k != n) o[n - k] = make_float2(x.x, -x.y);
      }
    }
  } else {
    // Bins 1..F: the magnitudes straight out, or into the free buffer.
    float* vals = reinterpret_cast<float*>(buf[cur ^ 1]);
    for (int e = threadIdx.x; e < rows * F; e += blockDim.x) {
      const int f = e / F;
      const int k = e - f * F + 1;
      const long long t = t0 + f;
      if (t >= T) continue;
      const float2 x = ODD ? buf[cur][f * L + k]
                           : split_bin(buf[cur] + f * L, tab, k, M);
      const float p = __fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y));
      if constexpr (S == Store::kSpec) {
        out[((long long)blockIdx.y * T + t) * F + k - 1] = __fsqrt_rn(p);
      } else {
        vals[e] = mel.power ? p : __fsqrt_rn(p);
      }
    }
    if constexpr (S == Store::kMel) {
      __syncthreads();
      for (int o = threadIdx.x; o < rows * mel.n_mels; o += blockDim.x) {
        const int f = o / mel.n_mels;
        const int m = o - f * mel.n_mels;
        const long long t = t0 + f;
        if (t >= T) continue;
        const float* v = vals + f * F;
        const int end = __ldg(mel.rowptr + m + 1);
        float acc = 0.f;
        for (int j = __ldg(mel.rowptr + m); j < end; ++j) {
          acc = __fadd_rn(acc, __fmul_rn(__ldg(mel.weights + j),
                                         v[__ldg(mel.cols + j)]));
        }
        out[((long long)blockIdx.y * T + t) * mel.n_mels + m] = acc;
      }
    }
  }
}

template <bool ODD, bool BLUE, Store S>
int launch_any(const float* s, const float* w, const float2* t, float* y,
               int batch, long long sig_len, int T, int n, int step,
               const zt::AnyPlan& a, int P, cudaStream_t st, Mel mel) {
  auto kernel = rfft_any<ODD, BLUE, S>;
  const int bytes = 2 * a.rows * a.L * (int)sizeof(float2);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(zt::ceil_div(T, a.rows), batch);
  kernel<<<grid, zt::kThreads, bytes, st>>>(s, w, t, y, sig_len, T, n, step, P,
                                       a.rows, a.plan, mel);
  return (int)cudaGetLastError();
}

// The checks of every store's arguments but the window's.
template <Store S>
bool args_ok(int WL, int step, int batch, const void* tw, const Mel& mel) {
  return step >= 1 && step <= WL && batch <= 65535 && zt::aligned8(tw) &&
         (S != Store::kMel ||
          (mel.n_mels >= 1 && mel.rowptr && mel.cols && mel.weights));
}

template <Store S>
int launch(const void* sig, const void* win, const void* tw, void* out,
           int batch, long long sig_len, int T, int WL, int step,
           void* stream, Mel mel = Mel{}) {
  zt::Plan plan;
  if (!zt::fft_fits(WL, &plan) || !args_ok<S>(WL, step, batch, tw, mel)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fpb = zt::kElems / (WL / 2);
  const dim3 grid(zt::ceil_div(T, fpb), batch);
  const float* s = static_cast<const float*>(sig);
  const float* w = static_cast<const float*>(win);
  const float2* t = static_cast<const float2*>(tw);
  float* y = static_cast<float*>(out);
  if (step % 2 == 0 && sig_len % 2 == 0 && zt::aligned8(sig) &&
      zt::aligned8(win)) {
    rfft_kernel<true, S><<<grid, zt::kThreads, 0, st>>>(
        s, w, t, y, sig_len, T, WL, step, plan, mel);
  } else {
    rfft_kernel<false, S><<<grid, zt::kThreads, 0, st>>>(
        s, w, t, y, sig_len, T, WL, step, plan, mel);
  }
  return (int)cudaGetLastError();
}

// The half, planes, magnitude or mel store at any window from 16 to 4096:
// rfft_kernel where fft_fits (P = 0), else rfft_any in the block its row
// needs.
template <Store S>
int launch_store(const void* sig, const void* win, const void* tw, void* out,
                 int batch, long long sig_len, int T, int WL, int step, int P,
                 void* stream, Mel mel = Mel{}) {
  zt::Plan plan;
  if (P == 0 && zt::fft_fits(WL, &plan)) {
    return launch<S>(sig, win, tw, out, batch, sig_len, T, WL, step, stream,
                     mel);
  }
  zt::AnyPlan a;
  if (!zt::any_plan(WL, P, &a) || !args_ok<S>(WL, step, batch, tw, mel)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(sig);
  const float* w = static_cast<const float*>(win);
  const float2* t = static_cast<const float2*>(tw);
  float* y = static_cast<float*>(out);
  if (a.odd && a.blue) {
    return launch_any<true, true, S>(s, w, t, y, batch, sig_len, T, WL, step,
                                     a, P, st, mel);
  }
  if (a.odd) {
    return launch_any<true, false, S>(s, w, t, y, batch, sig_len, T, WL,
                                      step, a, P, st, mel);
  }
  return launch_any<false, true, S>(s, w, t, y, batch, sig_len, T, WL, step,
                                    a, P, st, mel);
}

}  // namespace

// sig: (batch, sig_len) with sig_len >= (T - 1) * step + WL; win: (WL,);
// tw: kernels/rfft.store_tables(WL), 8-byte aligned (at a WL whose half
// rfft.fits takes, that is the (WL, 2) float32 table W_WL^j = (cos,
// sin)(-2 pi j / WL)); P: its Bluestein length (kernels/rfft.layout(WL).p;
// 0 where the passes take the FFT's own length); out: (batch, T, WL/2 + 1)
// complex64 as float pairs, bins 0..WL/2 (WL/2 rounded down: an odd WL has
// no Nyquist bin). Any WL in [16, 4096] and step in [1, WL]: rfft_kernel
// where the WL fits (P = 0), else rfft_any; any other WL or a wrong P
// returns cudaErrorInvalidValue before a launch. All contiguous.
ZT_EXPORT int zt_rfft_half(const void* sig, const void* win, const void* tw,
                           void* out, int batch, long long sig_len, int T,
                           int WL, int step, int P, void* stream) {
  return launch_store<Store::kHalf>(sig, win, tw, out, batch, sig_len, T, WL,
                                    step, P, stream);
}

// As zt_rfft_half, out two float32 planes (2, batch, T, WL/2 + 1): the real
// parts, then the imaginary parts.
ZT_EXPORT int zt_rfft_planes(const void* sig, const void* win, const void* tw,
                             void* out, int batch, long long sig_len, int T,
                             int WL, int step, int P, void* stream) {
  return launch_store<Store::kPlanes>(sig, win, tw, out, batch, sig_len, T,
                                      WL, step, P, stream);
}

// As zt_rfft_half, out the full spectrum (batch, T, WL) complex64 as float
// pairs: bins 0..WL/2 (rounded down) as zt_rfft_half writes them, and bin
// WL - k the conjugate of bin k for k = 1..(WL-1)/2.
ZT_EXPORT int zt_rfft_full(const void* sig, const void* win, const void* tw,
                           void* out, int batch, long long sig_len, int T,
                           int WL, int step, int P, void* stream) {
  return launch_store<Store::kFull>(sig, win, tw, out, batch, sig_len, T, WL,
                                    step, P, stream);
}

// As zt_rfft_half, out the magnitudes (batch, T, WL/2) float32 of bins
// 1..WL/2: out[b, t, k - 1] = sqrt(re^2 + im^2) of bin k of the windowed
// frame's DFT, of zt_rfft_half's bins.
ZT_EXPORT int zt_rfft_spec(const void* sig, const void* win, const void* tw,
                           void* out, int batch, long long sig_len, int T,
                           int WL, int step, int P, void* stream) {
  return launch_store<Store::kSpec>(sig, win, tw, out, batch, sig_len, T, WL,
                                    step, P, stream);
}

// As zt_rfft_spec (power != 0: the squares, unrooted), each frame's values
// v[c] (bin c + 1) times a filterbank of n_mels >= 1 rows in CSR form:
// out (batch, T, n_mels) float32, out[b, t, m] = the sum over j in
// [rowptr[m], rowptr[m + 1]) of weights[j] * v[cols[j]], from zero in j
// order; rowptr (n_mels + 1,) and cols (nnz,) int32 with cols in
// [0, WL/2), weights (nnz,) float32.
ZT_EXPORT int zt_rfft_mel(const void* sig, const void* win, const void* tw,
                          const void* rowptr, const void* cols,
                          const void* weights, void* out, int batch,
                          long long sig_len, int T, int WL, int step, int P,
                          int n_mels, int power, void* stream) {
  return launch_store<Store::kMel>(
      sig, win, tw, out, batch, sig_len, T, WL, step, P, stream,
      Mel{static_cast<const int*>(rowptr), static_cast<const int*>(cols),
          static_cast<const float*>(weights), n_mels, power});
}
