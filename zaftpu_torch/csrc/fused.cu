// Framing + window + operator GEMM, the frames never stored:
//   out[b, t, c, f] = sum_w sig[b, t*step + w] * win[w] * ops[c, w, f]
// for NC = 2 (frames_rfft: the cos and sin rDFT operators, written as an
// interleaved complex (batch, T, F) half spectrum) and NC = 1 (frames_op:
// one real operator such as the folded MDCT matrix, a real (batch, T, F)
// result).
//
// Replaces zaftpu/pallas/fused.py: _frames_matmul_impl as reached from
// frames_rfft (C = 2) and frames_op (C = 1). The Pallas kernel forms a
// 128-frame block of windowed frames in VMEM and runs one pallas_call per
// operator component against the whole VMEM-resident (WL, F_pad) operator.
// One launch here computes every component from the same frame tile.
//
// Bound: FP32 arithmetic, NC x 2 x WL x F FLOP per frame (8.4 MFLOP at
// WL 2048 for the rDFT, half that for the MDCT) against 4 bytes of new
// signal per hop. The main loop and its design are in frames_gemm.cuh;
// this file adds the stores: ragged F is masked there.
#include "frames_gemm.cuh"

namespace {

using namespace zt::frames;

template <bool VEC, int NC>
__global__ void __launch_bounds__(zt::kThreads)
frames_kernel(const float* __restrict__ sig, const float* __restrict__ win,
              const float* __restrict__ ops, float* __restrict__ out,
              long long sig_len, int T, int WL, int step, int F, int FP) {
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
  tile<VEC, NC>(sig + blockIdx.z * sig_len, win, ops, T, WL, step, FP, t0,
                f0, acc);

  float* ob = out + blockIdx.z * (long long)T * F * NC;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty * TM + i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f >= F) continue;
      if constexpr (NC == 2) {
        *reinterpret_cast<float2*>(ob + ((long long)t * F + f) * 2) =
            make_float2(acc[i][j], acc[i][4 + j]);
      } else {
        ob[(long long)t * F + f] = acc[i][j];
      }
    }
  }
}

template <int NC>
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
    frames_kernel<true, NC><<<grid, zt::kThreads, 0, st>>>(
        s, w, o, y, sig_len, T, WL, step, F, FP);
  } else {
    frames_kernel<false, NC><<<grid, zt::kThreads, 0, st>>>(
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
  return launch<2>(sig, win, ops, out, batch, sig_len, T, WL, step, F, FP,
                   stream);
}

// As zt_frames_rfft with one real operator: ops (1, WL, FP), out
// (batch, T, F) float32.
ZT_EXPORT int zt_frames_op(const void* sig, const void* win, const void* ops,
                           void* out, int batch, long long sig_len, int T,
                           int WL, int step, int F, int FP, void* stream) {
  return launch<1>(sig, win, ops, out, batch, sig_len, T, WL, step, F, FP,
                   stream);
}
