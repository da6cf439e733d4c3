// Magnitude CQT in its spectral form, the reference's |K . FFT(frame)|
// (zaf.py:627-633):
//   out[b, t, i] = | sum_j K[i, c_j] X_{b,t}[c_j] |
// with X_{b,t} the real FFT of the unwindowed frame sig[b, t*step ..
// t*step + L), L a power of two from 16 to 32,768, and K the thresholded
// spectral kernel (conjugated and scaled by 1/L) as a host table
// (kernels/cqtfft.kernel_table): a row pointer, each nonzero's
// half-spectrum bin with a conjugate flag (a column c > L/2 reads conj
// X[L - c]), its value as complex64, rows' nonzeros in ascending column
// order.
//
// Replaces zaftpu/pallas/cqtslab.py: magnitudes_in_trace (_kernel, B10)
// and its _kernel_split4 (B10-s4) on both schemes at those L. The TPU
// kernels contract each frame with the dense time-domain operator FFT(K
// rows)^T: 4 L F FLOP a frame (283 GFLOP per 600-s segment at
// CqtConfig(): T 15,000, L 32,768, F 144), and B10 writes 16 chunk
// partials (276 MB) that a second pass sums (cqtslab.cu). Here each frame
// is transformed once and only the kernel's nonzeros are read: the
// 16,384-point complex FFT of the real frame (974,848 operations in
// chip_smoke._fft_ops' count), the split step at the 2,634 bins the
// kernel reads (16 each) and the banded product (8 a nonzero, 9,450
// nonzeros), about 1.09 M operations a frame, 16.4 GFLOP a segment: bound
// by FP32 operations, 0.245 ms at the H100's 67 TFLOP/s (the signal read
// once, 106 MB, and the magnitudes written once, 8.6 MB, take 0.034 ms at
// 3.35 TB/s).
//
// Design: a block of 1,024 threads holds fpb = 16,384 / M frames' M =
// L/2-point complex FFTs in one float2 buffer (136 KB of dynamic shared
// memory with its padding): one frame at L 32,768, 8 at L 4,096. A
// 16,384-point FFT fits a block's 227 KB only as one buffer, not as
// Stockham's two (stockham.cuh transforms 2,048 values between two 16-KB
// buffers), so each pass runs in place: a thread loads all its values,
// runs its butterflies in registers and stores them after a barrier. One
// block an SM, each looping over frame groups, and no partial goes through
// device memory: the frame's FFT, the product and the magnitude all stay
// in the block.
//  1. Framing, as rfft.cu: sample pairs (2m, 2m + 1) of each frame read
//     straight from the signal (one 8-byte load where the hop and the
//     pointer allow) as z[m] = x[2m] + i x[2m+1]; no window. From L 512
//     on, the first two passes read them into registers themselves.
//  2. The M-point complex FFT in place, in the plan of rfft.radices(M)
//     (radix 4, then one radix-2 pass when log2 M is odd) with
//     stockham.cuh's butterflies: two radix-4 passes at a time as one
//     radix-16 group a thread (the first pass's outputs are the second's
//     inputs in the same thread), so L 32,768's seven passes take four
//     trips through shared memory and the framing none. The twiddles come
//     from shared memory: the table (kernels/cqtfft._twiddles) has exact
//     quarter-turn symmetry, so the passes' W_L^2i for 2i < L/4 (32 KB)
//     serve every pass by exact swaps and negations, loaded once a block.
//     The buffer is padded (a value every 16) and so is the twiddle
//     table, so a warp's accesses at a power-of-two stride spread over the
//     banks.
//  3. The split step only at the bins the kernel reads: X[k] = E + W_L^k
//     O, E = (Z[k] + conj Z[(M-k) mod M]) / 2, O = (Z[k] - conj Z[(M-k)
//     mod M]) / 2i, as rfft.cu's store (W_L^k from the kernel's table, one
//     a nonzero); nothing else of the spectrum is formed.
//  4. The products K X (conj X where flagged), every thread computing
//     some, into a 48-KB buffer; then one thread a (frame, row) adds its
//     row's products in the table's order from 0 (their loads unrolled by
//     16: the adds form one chain a row) and writes sqrt(re^2 + im^2)
//     frames-major (batch, T, F), as B10 writes it.
// Every product and sum is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsqrt_rn), so nothing is contracted into an FMA and the
// kernel does its plain version's float32 operations
// (kernels/cqtfft.cqt_magnitudes_fft_plain) in their order: bit-equal.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): about 11 times its
// bound at CqtConfig(), with one frame a block and its table read from L2
// for every frame. Left for later: a second frame in flight (the table's
// reads and the passes do not overlap), the table's bytes (20 a nonzero:
// 189 KB a frame at CqtConfig()), pruning the last pass to the outputs
// the split step reads (5,345 of 16,384 at CqtConfig()), and the fused
// pass's spills at 64 registers.
#include "stockham.cuh"

namespace {

constexpr int kThreadsFft = 1024;   // threads a block
constexpr int kBlockElems = 16384;  // complex values a block's FFTs hold
constexpr int kPerThread = kBlockElems / kThreadsFft;  // values a pass
constexpr int kGroups = kPerThread / 16;  // radix-16 groups a thread
// The buffer holds value i at pad(i) = i + i / 16: a radix-16 group's 16
// consecutive outputs then start 17 values (34 banks) apart, so its
// stores do not conflict.
constexpr int kPadded = kBlockElems + kBlockElems / 16;
// W_L^2i, 2i < L/4 (L/8 values), value x at tpad(x) = x + x/16 + x/256,
// so that a warp's reads at a power-of-two stride spread over the banks.
constexpr int kTwiddles = kBlockElems / 4 + kBlockElems / 64 + 16;
constexpr int kChunk = 6144;  // products a pass
constexpr int kMinLength = 16;
constexpr int kMaxLength = 2 * kBlockElems;
// The FFT buffer (136 KB), the twiddles (34 KB), the products (48 KB).
constexpr size_t kSmemBytes =
    (kPadded + kTwiddles + kChunk) * sizeof(float2);

// L a power of two from 16 to 32,768 (kernels/cqtfft.fits).
bool cqt_fft_fits(int n) {
  return n >= kMinLength && n <= kMaxLength && (n & (n - 1)) == 0;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }
__device__ __forceinline__ int tpad(int x) { return x + (x >> 4) + (x >> 8); }

// W_L^idx for an even idx < 3L/4 from the block's W_L^2i, 2i < L/4 =
// 2^lq: the table's later quarters are the first one turned by -i, exactly
// (kernels/cqtfft._twiddles).
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tws,
                                          int idx, int lq) {
  const float2 w = tws[tpad((idx & ((1 << lq) - 1)) >> 1)];
  const int q = idx >> lq;
  return q == 0 ? w : q == 1 ? make_float2(w.y, -w.x)
                             : make_float2(-w.x, -w.y);
}

// Two radix-4 Stockham passes in place, sub-transforms of length ns =
// 2^log2ns growing to 16 ns, as radix-16 groups (fpb M / 16 = 1,024 a
// block, kGroups a thread): the first pass's butterflies j0 + u M/16 (u <
// 4) share k = j0 mod ns, and their outputs s are the inputs u of the
// second pass's butterflies j'_s = (j0 / ns) 4 ns + s ns + k, so a group's
// 16 values stay in registers between the passes. Each butterfly does
// stockham.cuh's twiddle products and dft<4> in the plain version's order.
// For M >= 256 and log2ns a multiple of 4 (ns = 1, 16, 256, 4096), as the
// kernel calls it: the group's loads are M/16 apart, a multiple of 16, and
// its stores ns apart from a multiple of 16 (ns = 1) or a multiple of 16
// apart, so pad(x + d) = pad(x) + pad(d) and one address a group serves.
//
// With SIG the pass is the first (ns = 1) and reads its 16 values a group
// straight from the signal (sb, frames t0.. at hop step, zeros past frame
// T), which does the framing as well: z[m] = x[2m] + i x[2m+1]. VEC:
// 8-byte loads. Not inlined: inlined, it spilled more and ran slower.
template <bool SIG, bool VEC>
__device__ __noinline__ void fused_pass(float2* __restrict__ z,
                                        const float2* __restrict__ tws,
                                        int log2m, int log2ns, int lq,
                                        const float* __restrict__ sb,
                                        long long t0, int T, int step) {
  float c[4], sn[4];  // the odd radices' constants: unused here
  const int log2g = log2m - 4;  // groups per row: M / 16
  const int ns = 1 << log2ns;
  const int stride = 1 << (lq - log2ns);  // L / (4 ns)
  const int stride2 = stride >> 2;        // L / (16 ns)
  const int lstep = 17 << (log2g - 4);  // pad(M / 16)
  const int sstep = log2ns ? 17 << (log2ns - 4) : 1;  // pad(ns)
  float2 a[kGroups][4][4];  // a[r][u][s]: input s of first-pass butterfly u
#pragma unroll
  for (int r = 0; r < kGroups; ++r) {
    const int grp = threadIdx.x + r * kThreadsFft;
    const int j0 = grp & ((1 << log2g) - 1);
    const int k = j0 & (ns - 1);
    if constexpr (SIG) {
      const long long t = t0 + (grp >> log2g);
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        float2 v = make_float2(0.f, 0.f);
        if (t < T) {
          const float* p = sb + t * step + 2 * (j0 + (m << log2g));
          if constexpr (VEC) {
            v = *reinterpret_cast<const float2*>(p);
          } else {
            v = make_float2(p[0], p[1]);
          }
        }
        a[r][m & 3][m >> 2] = v;
      }
    } else {
      const float2* in = z + pad(((grp >> log2g) << log2m) + j0);
#pragma unroll
      for (int m = 0; m < 16; ++m) a[r][m & 3][m >> 2] = in[m * lstep];
    }
    const float2 w1 = twiddle(tws, k * stride, lq);
    const float2 w2 = twiddle(tws, 2 * k * stride, lq);
    const float2 w3 = twiddle(tws, 3 * k * stride, lq);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float2 v[4] = {a[r][u][0], zt::cmul(a[r][u][1], w1),
                     zt::cmul(a[r][u][2], w2), zt::cmul(a[r][u][3], w3)};
      zt::dft<4>(v, c, sn, a[r][u]);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int kp = (s << log2ns) + k;  // j'_s mod 4 ns
      float2 v[4] = {
          a[r][0][s], zt::cmul(a[r][1][s], twiddle(tws, kp * stride2, lq)),
          zt::cmul(a[r][2][s], twiddle(tws, 2 * kp * stride2, lq)),
          zt::cmul(a[r][3][s], twiddle(tws, 3 * kp * stride2, lq))};
      float2 y[4];
      zt::dft<4>(v, c, sn, y);
#pragma unroll
      for (int t = 0; t < 4; ++t) a[r][t][s] = y[t];  // a[r][s''][s]
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kGroups; ++r) {
    const int grp = threadIdx.x + r * kThreadsFft;
    const int j0 = grp & ((1 << log2g) - 1);
    float2* out = z + pad(((grp >> log2g) << log2m) +
                          ((j0 >> log2ns) << (log2ns + 4)) + (j0 & (ns - 1)));
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int t = 0; t < 4; ++t) out[(s + 4 * t) * sstep] = a[r][t][s];
    }
  }
  __syncthreads();
}

// One radix-R Stockham pass in place over the block's buffer (fpb rows of
// M = 2^log2m points; sub-transforms of length ns = 2^log2ns grow to R
// ns): every butterfly of the thread is loaded and computed before the
// barrier, and stored after it, since a pass's outputs land on other
// threads' inputs.
template <int R>
__device__ __forceinline__ void inplace_pass(float2* __restrict__ z,
                                             const float2* __restrict__ tws,
                                             int log2m, int log2ns, int lq) {
  constexpr int LR = R == 4 ? 2 : 1;
  constexpr int NB = kPerThread / R;  // butterflies a thread
  const int log2q = log2m - LR;      // butterflies per row: q = M / R
  const int q = 1 << log2q;
  const int ns = 1 << log2ns;
  const int stride = 1 << (lq + 2 - LR - log2ns);  // L / (ns R)
  // pad(x + d) = pad(x) + 17 d / 16 for d a multiple of 16: one address a
  // butterfly where q and ns are (L >= 128 and ns >= 16), pad() else.
  const int qs = q >= 16 ? 17 * (q >> 4) : 0;
  const int nss = ns >= 16 ? 17 * (ns >> 4) : 0;
  float c[R], sn[R];  // the odd radices' constants: unused here
  float2 y[NB][R];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int b = threadIdx.x + i * kThreadsFft;
    const int j = b & (q - 1);
    const int k = j & (ns - 1);
    const int in = ((b >> log2q) << log2m) + j;
    const int inp = pad(in);
    float2 v[R];
    v[0] = z[inp];
#pragma unroll
    for (int s = 1; s < R; ++s) {
      v[s] = zt::cmul(z[qs ? inp + s * qs : pad(in + s * q)],
                      twiddle(tws, s * k * stride, lq));
    }
    zt::dft<R>(v, c, sn, y[i]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int b = threadIdx.x + i * kThreadsFft;
    const int j = b & (q - 1);
    const int k = j & (ns - 1);
    const int out = ((b >> log2q) << log2m) + (j - k) * R + k;
    const int outp = pad(out);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      z[nss ? outp + s * nss : pad(out + s * ns)] = y[i][s];
    }
  }
  __syncthreads();
}

// One nonzero's product K X[k] of a frame's FFT Z (M points from the
// unpadded offset base): the split step at bin k = c >> 1, X[k] = E + w O
// with w = W_L^k, E = (Z[k] + conj Z[(M-k) mod M]) / 2, O = (Z[k] - conj
// Z[(M-k) mod M]) / 2i, conjugated where c & 1, times the kernel's value
// kv.
__device__ __forceinline__ float2 product(const float2* __restrict__ z,
                                          int base, int c, float2 kv,
                                          float2 w, int M) {
  const int k = c >> 1;
  const float2 a = z[pad(base + (k & (M - 1)))];        // Z[M] as Z[0]
  const float2 b = z[pad(base + ((M - k) & (M - 1)))];  // Z[(M-k) mod M]
  const float er = __fmul_rn(__fadd_rn(a.x, b.x), 0.5f);
  const float ei = __fmul_rn(__fsub_rn(a.y, b.y), 0.5f);
  const float od = __fmul_rn(__fadd_rn(a.y, b.y), 0.5f);
  const float oi = __fmul_rn(__fsub_rn(b.x, a.x), 0.5f);
  const float xr =
      __fadd_rn(er, __fsub_rn(__fmul_rn(w.x, od), __fmul_rn(w.y, oi)));
  float xi = __fadd_rn(ei, __fadd_rn(__fmul_rn(w.x, oi), __fmul_rn(w.y, od)));
  if (c & 1) xi = -xi;
  return make_float2(__fsub_rn(__fmul_rn(kv.x, xr), __fmul_rn(kv.y, xi)),
                     __fadd_rn(__fmul_rn(kv.x, xi), __fmul_rn(kv.y, xr)));
}

// VEC: 8-byte signal loads. Grid: x = blocks a batch row, each looping
// over frame groups g = blockIdx.x, blockIdx.x + gridDim.x, ...; y = batch
// row.
template <bool VEC>
__global__ void __launch_bounds__(kThreadsFft, 1)
cqt_fft_kernel(const float* __restrict__ sig, const float2* __restrict__ tw,
               const int* __restrict__ rowptr, const int* __restrict__ code,
               const float2* __restrict__ vals,
               const float2* __restrict__ wk, float* __restrict__ out,
               long long sig_len, int T, int n, int step, int F, int log2m,
               long long groups) {
  extern __shared__ __align__(16) float2 smem[];
  float2* z = smem;
  float2* tws = smem + kPadded;
  float2* prod = tws + kTwiddles;
  const int M = 1 << log2m;
  const int lq = log2m - 1;  // L/4 = 2^lq
  const int fpb = kBlockElems >> log2m;  // frames per group
  const float* sb = sig + blockIdx.y * sig_len;
  const int items = fpb * F;
  const int nnz = __ldg(rowptr + F);
  // The passes' twiddles, once a block.
  for (int i = threadIdx.x; i < (n >> 3); i += kThreadsFft) {
    tws[tpad(i)] = __ldg(tw + 2 * i);
  }
  __syncthreads();

  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long t0 = g * fpb;
    int log2ns = 0;
    if (log2m >= 8) {  // the first two passes read the frames themselves
      fused_pass<true, VEC>(z, tws, log2m, 0, lq, sb, t0, T, step);
      log2ns = 4;
    } else {
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int e = threadIdx.x + u * kThreadsFft;
        const long long t = t0 + (e >> log2m);
        float2 v = make_float2(0.f, 0.f);
        if (t < T) {
          const float* p = sb + t * step + 2 * (e & (M - 1));
          if constexpr (VEC) {
            v = *reinterpret_cast<const float2*>(p);
          } else {
            v = make_float2(p[0], p[1]);
          }
        }
        z[pad(e)] = v;
      }
      __syncthreads();
    }
    for (; log2m >= 8 && log2ns + 4 <= log2m; log2ns += 4) {
      fused_pass<false, VEC>(z, tws, log2m, log2ns, lq, sb, t0, T, step);
    }
    for (; log2ns + 2 <= log2m; log2ns += 2) {
      inplace_pass<4>(z, tws, log2m, log2ns, lq);
    }
    if (log2ns < log2m) inplace_pass<2>(z, tws, log2m, log2ns, lq);

    // The products in parallel, the sums in order. Items (frame, row) go
    // kThreadsFft at a time, one a thread; their products, a contiguous
    // range of e = f nnz + j, go through the product buffer kChunk at a
    // time, each computed by one thread; then each item's thread adds its
    // own, in order.
    for (int r0 = 0; r0 < items; r0 += kThreadsFft) {
      const int last = min(items, r0 + kThreadsFft) - 1;
      const int e_lo = r0 / F * nnz + __ldg(rowptr + r0 % F);
      const int e_hi = last / F * nnz + __ldg(rowptr + last % F + 1);
      const int item = r0 + threadIdx.x;
      int lo = 0;
      int hi = 0;
      if (item < items) {
        const int f = item / F;
        const int i = item - f * F;
        lo = f * nnz + __ldg(rowptr + i);
        hi = f * nnz + __ldg(rowptr + i + 1);
      }
      float re = 0.f;
      float im = 0.f;
      for (int c0 = e_lo; c0 < e_hi; c0 += kChunk) {
        const int c1 = min(e_hi, c0 + kChunk);
        for (int e = c0 + threadIdx.x; e < c1; e += kThreadsFft) {
          const int f = e / nnz;
          const int j = e - f * nnz;
          prod[e - c0] = product(z, f << log2m, __ldg(code + j),
                                 __ldg(vals + j), __ldg(wk + j), M);
        }
        __syncthreads();
        const int b = min(hi, c1);
#pragma unroll 16
        for (int e = max(lo, c0); e < b; ++e) {
          const float2 p = prod[e - c0];
          re = __fadd_rn(re, p.x);
          im = __fadd_rn(im, p.y);
        }
        __syncthreads();
      }
      if (item < items && t0 + item / F < T) {
        out[((long long)blockIdx.y * T + t0 + item / F) * F + item % F] =
            __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
      }
    }
    __syncthreads();  // the next group's framing overwrites the buffer
  }
}

template <bool VEC>
int launch(const float* sig, const float2* tw, const int* rowptr,
           const int* code, const float2* vals, const float2* wk, float* out,
           int batch,
           long long sig_len, int T, int n, int step, int F,
           cudaStream_t st) {
  int log2m = 0;
  while ((2 << log2m) < n) ++log2m;
  const long long groups = zt::ceil_div(T, kBlockElems >> log2m);
  // One block an SM: the blocks of a batch row loop over its groups.
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return (int)err;
  const long long per_row = sms / batch > 1 ? sms / batch : 1;
  const dim3 grid((unsigned)(groups < per_row ? groups : per_row), batch);
  // Above 48 KB a block's shared memory is dynamic and opted into.
  err = cudaFuncSetAttribute(cqt_fft_kernel<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cqt_fft_kernel<VEC><<<grid, kThreadsFft, kSmemBytes, st>>>(
      sig, tw, rowptr, code, vals, wk, out, sig_len, T, n, step, F, log2m,
      groups);
  return (int)cudaGetLastError();
}

}  // namespace

// sig: (batch, sig_len) float32, sig_len >= (T - 1) * step + L; tw: (L, 2)
// float32, W_L^j = (cos, sin)(-2 pi j / L) with exact quarter-turn symmetry
// (kernels/cqtfft._twiddles), 8-byte aligned; rowptr: (F + 1)
// int32; code: (nnz) int32, 2 * bin + conj with bin in [0, L/2]; vals:
// (nnz) complex64 as float pairs; wk: (nnz) complex64, tw[bin] of each
// nonzero; vals and wk 8-byte aligned; out: (batch, T, F) float32. L a
// power of two from 16 to 32,768, step >= 1, F >= 1; any other L returns
// cudaErrorInvalidValue before a launch. All contiguous.
ZT_EXPORT int zt_cqt_magnitudes_fft(const void* sig, const void* tw,
                                    const void* rowptr, const void* code,
                                    const void* vals, const void* wk,
                                    void* out, int batch, long long sig_len,
                                    int T, int L, int step, int F,
                                    void* stream) {
  if (!cqt_fft_fits(L) || step < 1 || F < 1 || batch > 65535 ||
      !zt::aligned8(tw) || !zt::aligned8(vals) || !zt::aligned8(wk)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  const float* s = static_cast<const float*>(sig);
  const float2* t = static_cast<const float2*>(tw);
  const int* r = static_cast<const int*>(rowptr);
  const int* c = static_cast<const int*>(code);
  const float2* v = static_cast<const float2*>(vals);
  const float2* w = static_cast<const float2*>(wk);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (step % 2 == 0 && sig_len % 2 == 0 && zt::aligned8(sig)) {
    return launch<true>(s, t, r, c, v, w, o, batch, sig_len, T, L, step, F,
                        st);
  }
  return launch<false>(s, t, r, c, v, w, o, batch, sig_len, T, L, step, F,
                       st);
}
