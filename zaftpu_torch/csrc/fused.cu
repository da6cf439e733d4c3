// Framing + window + operator GEMM, the frames never stored:
//   out[b, t, c, f] = sum_w sig[b, t*step + w] * win[w] * ops[c, w, f]
// for NC = 2 (frames_rfft: the cos and sin rDFT operators, written as an
// interleaved complex (batch, T, F) half spectrum; frames_rfft_full: the
// same sums written as the full (batch, T, WL) spectrum, each bin f in
// 1..WL-F also stored conjugated at WL - f) and NC = 1 (frames_op: one real
// operator such as the folded MDCT matrix, a real (batch, T, F) result).
//
// Replaces zaftpu/pallas/fused.py: _frames_matmul_impl as reached from
// frames_rfft (C = 2) and frames_op (C = 1), and _frames_matmul_full_impl
// (frames_rfft_full, its mirror epilogue). The Pallas kernels form a
// 128-frame block of windowed frames in VMEM and run one pallas_call per
// operator component against the whole VMEM-resident (WL, F_pad) operator;
// the full twin reverses lanes in its epilogue, which Mosaic cannot lower.
// One launch here computes every component from the same frame tile, and
// the mirror is a second store address: the full spectrum is bit-equal to
// frames_rfft followed by the mirror, since both store the same sums.
//
// Bound: FP32 arithmetic, NC x 2 x WL x F FLOP per frame (8.4 MFLOP at
// WL 2048 for the rDFT, half that for the MDCT) against 4 bytes of new
// signal per hop; the full store writes 8 x WL bytes per frame, twice the
// half spectrum's. The main loop and its design are in frames_gemm.cuh;
// this file adds the stores: ragged F is masked there.
#include "frames_gemm.cuh"

namespace {

using namespace zt::frames;

enum Store { kReal, kHalf, kFull };

template <bool VEC, Store S>
__global__ void __launch_bounds__(zt::kThreads)
frames_kernel(const float* __restrict__ sig, const float* __restrict__ win,
              const float* __restrict__ ops, float* __restrict__ out,
              long long sig_len, int T, int WL, int step, int F, int FP) {
  constexpr int NC = S == kReal ? 1 : 2;
  const int tx = threadIdx.x % (BN / 4);
  const int ty = threadIdx.x / (BN / 4);
  const int f0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * BM;

  // acc[i][c*4 + j]: component c, column f0 + tx*4 + j of frame ty*TM + i.
  float acc[TM][4 * NC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.f;
  }
  tile<VEC, NC>(sig + blockIdx.z * sig_len, win, ops, (long long)WL * FP, T,
                WL, step, FP, t0, f0, acc);

  // Output row length in floats: F reals, F complex bins or WL of them.
  const int row = S == kReal ? F : (S == kHalf ? 2 * F : 2 * WL);
  float* ob = out + blockIdx.z * (long long)T * row;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty * TM + i;
    if (t >= T) continue;
    float* orow = ob + (long long)t * row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f >= F) continue;
      if constexpr (S == kReal) {
        orow[f] = acc[i][j];
      } else {
        const float re = acc[i][j];
        const float im = acc[i][4 + j];
        *reinterpret_cast<float2*>(orow + 2 * f) = make_float2(re, im);
        if (S == kFull && f >= 1 && f <= WL - F) {
          *reinterpret_cast<float2*>(orow + 2 * (WL - f)) =
              make_float2(re, -im);
        }
      }
    }
  }
}

template <Store S>
int launch(const void* sig, const void* win, const void* ops, void* out,
           int batch, long long sig_len, int T, int WL, int step, int F,
           int FP, void* stream) {
  if (FP % BN != 0 || FP < F || !zt::aligned16(ops)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(FP / BN, zt::ceil_div(T, BM), batch);
  const float* s = static_cast<const float*>(sig);
  const float* w = static_cast<const float*>(win);
  const float* o = static_cast<const float*>(ops);
  float* y = static_cast<float*>(out);
  if (vec_ok(sig, win, sig_len, WL, step)) {
    frames_kernel<true, S><<<grid, zt::kThreads, 0, st>>>(
        s, w, o, y, sig_len, T, WL, step, F, FP);
  } else {
    frames_kernel<false, S><<<grid, zt::kThreads, 0, st>>>(
        s, w, o, y, sig_len, T, WL, step, F, FP);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sig: (batch, sig_len) with sig_len >= (T - 1) * step + WL; win: (WL,);
// ops: (2, WL, FP), cos then sin, FP a multiple of 64 with zero columns
// from F on, 16-byte aligned; out: (batch, T, F) complex64 as float pairs.
// All contiguous.
ZT_EXPORT int zt_frames_rfft(const void* sig, const void* win,
                             const void* ops, void* out, int batch,
                             long long sig_len, int T, int WL, int step,
                             int F, int FP, void* stream) {
  return launch<kHalf>(sig, win, ops, out, batch, sig_len, T, WL, step, F,
                       FP, stream);
}

// As zt_frames_rfft with one real operator: ops (1, WL, FP), out
// (batch, T, F) float32.
ZT_EXPORT int zt_frames_op(const void* sig, const void* win, const void* ops,
                           void* out, int batch, long long sig_len, int T,
                           int WL, int step, int F, int FP, void* stream) {
  return launch<kReal>(sig, win, ops, out, batch, sig_len, T, WL, step, F,
                       FP, stream);
}

// As zt_frames_rfft with F = WL/2 + 1, out the full (batch, T, WL)
// complex64 spectrum: bins 0..F-1 as computed, bin k >= F the conjugate of
// bin WL - k.
ZT_EXPORT int zt_frames_rfft_full(const void* sig, const void* win,
                                  const void* ops, void* out, int batch,
                                  long long sig_len, int T, int WL, int step,
                                  int F, int FP, void* stream) {
  if (F != WL / 2 + 1) return (int)cudaErrorInvalidValue;
  return launch<kFull>(sig, win, ops, out, batch, sig_len, T, WL, step, F,
                       FP, stream);
}
