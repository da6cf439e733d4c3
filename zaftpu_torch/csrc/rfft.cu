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
//  1. Framing: z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1] (one 8-byte load of
//     signal and window where the hop and the pointers allow): the real FFT
//     of N as a complex FFT of M. The first step of the passes reads these
//     values itself; a plan that starts with a prime above 7 stores them in
//     shared memory first.
//  2. The passes (stockham.cuh: static_fft, in the plan the host builds
//     from kernels/rfft.radices): pairs of radix-4 passes (and 4 then 2, 3
//     then 3) as one register step of 16 (8, 9) values a thread, other
//     radices up to 7 one pass a step, primes up to 31 in registers (each
//     work item one butterfly's real or imaginary halves) and above 31 in
//     tiles of four outputs; between two padded shared-memory buffers of
//     17 KB: three round trips at WL 2048, where the framing and five
//     radix-4 passes took six. Every index from a host-computed Divmod,
//     every twiddle from a
//     per-pass table (kernels/rfft.kernel_tables) read by neighbouring
//     threads at neighbouring entries. The buffer then holds Z = FFT_M(z)
//     in natural order.
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
// 2,048, or P, takes the larger ones) in two padded buffers of just those
// rows in dynamic shared memory (up to 136 KB; cudaFuncSetAttribute above
// 48 KB). The transforms run on stockham.cuh's steps (zt::any_fft, as
// rfft_kernel's do): the first step reads the frame from the
// signal into registers (the odd frame, or the packing, times conj c under
// Bluestein, and no load for Bluestein's zeros), Bluestein's product with B
// and its conjugation ride the second FFT's first step (zt::BlueMid), and
// its last conjugation and chirp product ride the stores' reads
// (zt::blue_value): where the first design took a framing sweep, one
// barrier a pass and three more sweeps, P 2,304 (WL 2,062) takes three
// register steps an FFT and nothing else (PERF.md). Counted as the
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

// The split step's bin from a = Z[k] and b = Z[(M-k) mod M] of one frame
// and w = W_N^k: X[k] = E + W_N^k O.
__device__ __forceinline__ float2 split_pair(float2 a, float2 b, float2 w) {
  const float er = __fmul_rn(__fadd_rn(a.x, b.x), 0.5f);
  const float ei = __fmul_rn(__fsub_rn(a.y, b.y), 0.5f);
  const float od = __fmul_rn(__fadd_rn(a.y, b.y), 0.5f);
  const float oi = __fmul_rn(__fsub_rn(b.x, a.x), 0.5f);
  return make_float2(
      __fadd_rn(er, __fsub_rn(__fmul_rn(w.x, od), __fmul_rn(w.y, oi))),
      __fadd_rn(ei, __fadd_rn(__fmul_rn(w.x, oi), __fmul_rn(w.y, od))));
}

// Bin k of the split step (k = 0..M, Z[M] read as Z[0]) of the frame at row
// base (base = f M) of a padded buffer: X[k] = E + W_N^k O.
__device__ __forceinline__ float2 split_at(const float2* z, int base,
                                           const float2* __restrict__ tw,
                                           int k, int M) {
  return split_pair(z[zt::pad(base + (k == M ? 0 : k))],
                    z[zt::pad(base + (k == 0 ? 0 : M - k))], __ldg(tw + k));
}

// tab: W_N, then the passes' tables (kernels/rfft.kernel_tables); vec:
// 8-byte signal and window loads; REG: the plan has a prime pass up to
// zt::kRegPrime (a kernel of its own, so the other plans keep their
// registers).
template <Store S, bool REG>
__global__ void __launch_bounds__(zt::kThreads, 4)
rfft_kernel(const float* __restrict__ sig, const float* __restrict__ win,
            const float2* __restrict__ tab, float* __restrict__ out,
            long long sig_len, int T, int step, int vec, zt::StaticPlan plan,
            Mel mel) {
  __shared__ __align__(16) float2 buf[2][zt::kPadElems];
  __shared__ zt::StaticPlan sp;
  __shared__ float2 cs[zt::kMaxPrimes * zt::kRegPrime];
  const int M = plan.m;
  const int fpb = plan.fpb;  // frames per block
  const long long t0 = (long long)blockIdx.x * fpb;
  const zt::Frames fr{sig + blockIdx.y * sig_len, win, t0, T, step, vec};
  const int cur = zt::static_fft<REG>(buf, sp, cs, plan, tab, fr);
  const float2* z = buf[cur];

  if constexpr (S == Store::kSpec || S == Store::kMel) {
    // Bins 1..M: the magnitudes straight out, or into the free buffer.
    float* vals = reinterpret_cast<float*>(buf[cur ^ 1]);
    for (int e = threadIdx.x; e < fpb * M; e += blockDim.x) {
      const int f = plan.by_m.div(e);
      const int k = e - f * M + 1;
      const long long t = t0 + f;
      if (t >= T) continue;
      const float2 x = split_at(z, f * M, tab, k, M);
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
    const int n = 2 * M;
    for (int e = threadIdx.x; e < fpb * F; e += blockDim.x) {
      const int f = plan.by_f.div(e);
      const int k = e - f * F;
      const long long t = t0 + f;
      if (t >= T) continue;
      const float2 x = split_at(z, f * M, tab, k, M);
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

// The frames of a block of rfft_any, rows f = frame t0 + f (zeros from T
// on), as zt::any_fft's first-step source: ODD the windowed frame z[m] =
// x[m] w[m] (zero imaginary parts, m < N), else its even/odd packing z[m] =
// x[2m] w[2m] + i x[2m+1] w[2m+1]; BLUE times the chirp conj c[m] for m < M
// and zeros from M to P, which it does not load.
template <bool ODD, bool BLUE>
struct AnyFrames {
  const float* sig;
  const float* win;
  const float2* chirp;
  long long t0;
  int T, step, M;

  template <int R>
  __device__ __forceinline__ void load(int f, int g, int G,
                                       float2 (&v)[R]) const {
    const long long t = t0 + f;
    const float* p = sig + t * step;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = g + i * G;
      float2 x = make_float2(0.f, 0.f);
      if (t < T && (!BLUE || m < M)) {
        if constexpr (ODD) {
          x.x = __fmul_rn(__ldg(p + m), __ldg(win + m));
        } else {
          x = make_float2(__fmul_rn(__ldg(p + 2 * m), __ldg(win + 2 * m)),
                          __fmul_rn(__ldg(p + 2 * m + 1),
                                    __ldg(win + 2 * m + 1)));
        }
        if constexpr (BLUE) x = zt::cmul(x, __ldg(chirp + m));
      }
      v[i] = x;
    }
  }
};

// Bin k (k <= F) of the frame at row base: ODD straight from its N-point
// FFT, else split_pair of its M-point FFT's values k and M - k (mod M).
template <bool ODD, bool BLUE>
__device__ __forceinline__ float2 any_bin(const float2* z, int base,
                                          const float2* __restrict__ tw,
                                          const float2* __restrict__ chirp,
                                          int k, int M) {
  if constexpr (ODD) {
    return zt::blue_value<BLUE>(z, base, chirp, k);
  } else {
    return split_pair(zt::blue_value<BLUE>(z, base, chirp, k == M ? 0 : k),
                      zt::blue_value<BLUE>(z, base, chirp, k == 0 ? 0 : M - k),
                      __ldg(tw + k));
  }
}

// The five stores at a window the static path refuses (zt::any_plan), on
// a.rows frames of a.L values a block in dynamic shared memory (two padded
// buffers of a.stride values), by zt::any_fft's steps: ODD transforms
// each frame alone as one complex N-point FFT with zero imaginary parts,
// whose bins 0..(N-1)/2 are the frame's (no Nyquist bin), else the frame's
// even/odd packing over M = N/2 points and split_pair. BLUE runs that
// M-point FFT (M = N or N/2) by Bluestein's chirp z-transform on rows of L
// = P values: the first step reads the chirped frame (AnyFrames), the
// forward steps (table W_P), then a second forward FFT whose first step
// reads those rows times B, conjugated (BlueMid), and the stores read each
// value conjugated and times conj c[k] (any_value), so no sweep of its own
// remains. tab holds W_N (N values), under BLUE then W_P (P), conj c (M)
// and B (P), then the per-pass tables of W_L (kernels/rfft.kernel_tables).
// The store is a runtime choice (one kernel serves all five, uniform across
// the block): bins 0..F (half, planes, full with its mirror) or 1..F
// (magnitude, mel), F = N/2 rounded down, as rfft_kernel writes them. REG:
// the plan has a prime pass up to zt::kRegPrime (only odd N, never a
// Bluestein length).
template <bool ODD, bool BLUE, bool REG>
__global__ void __launch_bounds__(zt::kThreads, 4)
rfft_any(const float* __restrict__ sig, const float* __restrict__ win,
         const float2* __restrict__ tab, float* __restrict__ out,
         long long sig_len, int T, int n, int step, zt::AnyPlan a, Store S,
         Mel mel) {
  extern __shared__ __align__(16) float2 smem[];
  __shared__ zt::StaticPlan sp;
  __shared__ float2 cs[zt::kMaxPrimes * zt::kRegPrime];
  const int M = a.M;
  const int L = a.L;
  const int rows = a.rows;
  const zt::Buffers buf{smem, a.stride};
  const long long t0 = (long long)blockIdx.x * rows;
  const float2* twp = BLUE ? tab + n : tab;  // W_L and the passes' tables
  const float2* chirp = tab + n + L;         // BLUE only
  const AnyFrames<ODD, BLUE> fr{sig + blockIdx.y * sig_len, win, chirp, t0,
                                T, step, M};
  constexpr int kFirst = BLUE ? zt::kQuadFirst : zt::kOddFirst;
  if (threadIdx.x == 0) sp = a.sp;
  zt::prime_table<REG>(cs, a.sp, twp);
  const int cur = zt::any_fft<kFirst, REG, BLUE>(buf, sp, cs, a.sp, twp, fr,
                                                 chirp + M, 0);
  const float2* z = buf[cur];
  const int F = n / 2;  // bins 1..F a frame

  if (S == Store::kHalf || S == Store::kPlanes || S == Store::kFull) {
    // Bins 0..F (H = F + 1 a frame, DC included; an odd N has no Nyquist
    // bin), rfft_kernel's layouts, consecutive threads on consecutive bins
    // of a frame; the full store also writes bin N - k as the conjugate of
    // bin k for k = 1..(N-1)/2 (the mirror, not the FFT's own upper bins,
    // which an odd N's FFT holds but which round otherwise).
    const int H = F + 1;
    for (int e = threadIdx.x; e < rows * H; e += blockDim.x) {
      const int f = a.by_h.div(e);
      const int k = e - f * H;
      const long long t = t0 + f;
      if (t >= T) continue;
      const float2 x = any_bin<ODD, BLUE>(z, f * L, tab, chirp, k, M);
      const long long row = (long long)blockIdx.y * T + t;
      if (S == Store::kPlanes) {
        out[row * H + k] = x.x;
        out[((long long)gridDim.y * T + row) * H + k] = x.y;
      } else if (S == Store::kHalf) {
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
      const int f = a.by_f.div(e);
      const int k = e - f * F + 1;
      const long long t = t0 + f;
      if (t >= T) continue;
      const float2 x = any_bin<ODD, BLUE>(z, f * L, tab, chirp, k, M);
      const float p = __fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y));
      if (S == Store::kSpec) {
        out[((long long)blockIdx.y * T + t) * F + k - 1] = __fsqrt_rn(p);
      } else {
        vals[e] = mel.power ? p : __fsqrt_rn(p);
      }
    }
    if (S == Store::kMel) {
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

template <bool ODD, bool BLUE, bool REG>
int launch_any(const float* s, const float* w, const float2* t, float* y,
               int batch, long long sig_len, int T, int n, int step,
               const zt::AnyPlan& a, cudaStream_t st, Store store, Mel mel) {
  auto kernel = rfft_any<ODD, BLUE, REG>;
  const int bytes = 2 * a.stride * (int)sizeof(float2);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(zt::ceil_div(T, a.rows), batch);
  kernel<<<grid, zt::kThreads, bytes, st>>>(s, w, t, y, sig_len, T, n, step,
                                            a, store, mel);
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
  zt::StaticPlan plan;
  if (!zt::static_plan(WL, &plan) || !args_ok<S>(WL, step, batch, tw, mel)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  const int vec = step % 2 == 0 && sig_len % 2 == 0 && zt::aligned8(sig) &&
                  zt::aligned8(win);
  const dim3 grid(zt::ceil_div(T, plan.fpb), batch);
  auto kernel = plan.cs ? rfft_kernel<S, true> : rfft_kernel<S, false>;
  kernel<<<grid, zt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<float*>(out), sig_len, T,
      step, vec, plan, mel);
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
  if (a.blue) {
    return a.odd ? launch_any<true, true, false>(s, w, t, y, batch, sig_len,
                                                 T, WL, step, a, st, S, mel)
                 : launch_any<false, true, false>(s, w, t, y, batch, sig_len,
                                                  T, WL, step, a, st, S, mel);
  }
  return a.sp.cs ? launch_any<true, false, true>(s, w, t, y, batch, sig_len,
                                                 T, WL, step, a, st, S, mel)
                 : launch_any<true, false, false>(s, w, t, y, batch, sig_len,
                                                  T, WL, step, a, st, S, mel);
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
