// Magnitude CQT of a padded signal against the time-domain CQT operator:
//   out[b, t, f] = | sum_{w < L} sig[b, t*step + w] * (M_re + i M_im)[w, f] |
// with M = FFT(kernel rows)^T, (L, F) (transforms/cqt.py folds the frame
// FFT into the operator), stored as ops (2, L, FP), FP a multiple of 64.
//
// Replaces zaftpu/pallas/cqtslab.py: magnitudes_in_trace (_kernel). The
// Pallas kernel holds a block of 512 frames' signal rows (rows, step128) in
// VMEM and sums the hop-wide slab products seg[k:k+B] @ op[k], k
// ascending; the slabs are only how it reads overlapped frames out of whole
// signal rows. Here the frames come from the signal directly, as in the
// STFT kernels: B10 is frames_gemm.cuh's tile<VEC, 2> with WL = L and no
// window, so any hop and frame count is taken (hop 1764 does not divide
// L = 32768; the tile masks w >= L and T).
//
// Bound: FP32 arithmetic, 2 x 2 x L FLOP per frame and column (377 GFLOP
// per 600-s segment at CqtConfig(): T 15,000, L 32,768, FP 192). Design:
// the contraction is split into chunks of CH = 2048 samples. One block
// owns 64 frames x 64 columns of one chunk, its re/im sums go to a
// partial (P, batch, T, F) buffer, and a second pass adds the P = L/CH
// partials in ascending order and takes sqrt(re^2 + im^2). This does two
// things. Accuracy: a slice of 16 FMAs, then a running sum over a chunk's
// 128 slices (the STFT's depth), then one over the chunks. A running sum
// over all 2,048 slices of L read 2.3e-6 of max against float64 in a CPU
// simulation of the order, the chunked one 4.7e-7. Parallelism: 16 x as
// many blocks (11,280 at 600 s, against 264 resident two to an SM), where
// whole-L blocks would leave 705 long ones. For L <= CH the one pass stores
// the magnitudes itself. Every result is the same from run to run: no
// atomics.
#include "frames_gemm.cuh"

namespace {

using namespace zt::frames;

constexpr int CH = 2048;  // contraction samples per block

// Grid: x = chunk * (FP / BN) + column tile, y = frame tile, z = batch.
template <bool VEC>
__global__ void __launch_bounds__(zt::kThreads)
cqt_chunk_kernel(const float* __restrict__ sig, const float* __restrict__ ops,
                 float* __restrict__ out, long long sig_len, int T, int L,
                 int step, int F, int FP, int P) {
  const int tiles = FP / BN;
  const int p = blockIdx.x / tiles;
  const int f0 = (blockIdx.x % tiles) * BN;
  const int t0 = blockIdx.y * BM;
  const int tx = threadIdx.x % (BN / 4);
  const int ty = threadIdx.x / (BN / 4);
  const int w0 = p * CH;
  const int width = min(CH, L - w0);

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  tile<VEC, 2, false>(sig + blockIdx.z * sig_len + w0, nullptr,
                      ops + (long long)w0 * FP, (long long)L * FP, T, width,
                      step, FP, t0, f0, acc);

  const long long plane = (long long)gridDim.z * T * F;  // one chunk's
  const long long base = (long long)blockIdx.z * T * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty * TM + i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f >= F) continue;
      const float re = acc[i][j];
      const float im = acc[i][4 + j];
      const long long e = base + (long long)t * F + f;
      if (P == 1) {
        out[e] = sqrtf(re * re + im * im);
      } else {
        reinterpret_cast<float2*>(out)[p * plane + e] = make_float2(re, im);
      }
    }
  }
}

// out[i] = |part[0][i] + part[1][i] + ... + part[P-1][i]|, in that order.
__global__ void __launch_bounds__(zt::kThreads)
cqt_sum_kernel(const float2* __restrict__ part, float* __restrict__ out,
               long long n, int P) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float2 s = part[i];
    for (int p = 1; p < P; ++p) {
      const float2 v = part[p * n + i];
      s.x += v.x;
      s.y += v.y;
    }
    out[i] = sqrtf(s.x * s.x + s.y * s.y);
  }
}

}  // namespace

// Chunks of the contraction for an operator of L rows: part must hold
// zt_cqt_chunks(L) x batch x T x F complex64 values when that is above 1.
ZT_EXPORT int zt_cqt_chunks(int L) { return zt::ceil_div(L, CH); }

// sig: (batch, sig_len) float32, sig_len >= (T - 1) * step + L; ops:
// (2, L, FP) float32, M_re then M_im, FP a multiple of 64 with zero columns
// from F on, 16-byte aligned; part: (P, batch, T, F) complex64 scratch
// (unused for P = 1); out: (batch, T, F) float32. All contiguous.
ZT_EXPORT int zt_cqt_magnitudes(const void* sig, const void* ops, void* part,
                                void* out, int batch, long long sig_len,
                                int T, int L, int step, int F, int FP,
                                void* stream) {
  if (FP % BN != 0 || FP < F || F < 1 || L < 1 || step < 1 ||
      !zt::aligned16(ops)) {
    return (int)cudaErrorInvalidValue;
  }
  const int P = zt::ceil_div(L, CH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(P * (FP / BN), zt::ceil_div(T, BM), batch);
  const float* s = static_cast<const float*>(sig);
  const float* o = static_cast<const float*>(ops);
  float* dst = static_cast<float*>(P > 1 ? part : out);
  if (vec_ok(sig, nullptr, sig_len, L, step)) {
    cqt_chunk_kernel<true><<<grid, zt::kThreads, 0, st>>>(
        s, o, dst, sig_len, T, L, step, F, FP, P);
  } else {
    cqt_chunk_kernel<false><<<grid, zt::kThreads, 0, st>>>(
        s, o, dst, sig_len, T, L, step, F, FP, P);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return (int)err;
  const long long n = (long long)batch * T * F;
  cqt_sum_kernel<<<zt::grid_1d(n, zt::kThreads), zt::kThreads, 0, st>>>(
      static_cast<const float2*>(part), static_cast<float*>(out), n, P);
  return (int)cudaGetLastError();
}
