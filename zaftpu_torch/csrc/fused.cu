// Framing + window + operator GEMM, the frames never stored:
//   out[b, t, c, f] = sum_w sig[b, t*step + w] * win[w] * ops[c, w, f]
// for NC = 2 (frames_rfft: the cos and sin rDFT operators, written as an
// interleaved complex (batch, T, F) half spectrum; frames_rfft_full: the
// same sums written as the full (batch, T, WL) spectrum, each bin f in
// 1..WL-F also stored conjugated at WL - f; frames_planes: the same sums as
// two float32 planes (2, batch, T, F)) and NC = 1 (frames_op: one real
// operator such as the folded MDCT matrix, a real (batch, T, F) result).
// Each has an exact entry point (frames_gemm.cuh's FP32 tile) and a
// *_split4 one (frames_gemm_split4.cuh's tensor-core tile, the operator
// presplit into bf16 hi and lo, at 4, 3 or 1 bf16 passes); the stores are
// shared.
//
// Replaces zaftpu/pallas/fused.py: _frames_matmul_impl as reached from
// frames_rfft (C = 2) and frames_op (C = 1), _frames_matmul_full_impl
// (frames_rfft_full, its mirror epilogue) and _frames_matmul2_impl
// (frames_matmul2, one call writing both component planes), with their
// _kernel_split4 bodies. The Pallas kernels form a 128-frame block of
// windowed frames in VMEM and run one pallas_call per operator component
// against the whole VMEM-resident (WL, F_pad) operator (the two-output one
// holds both components); the full twin reverses lanes in its epilogue,
// which Mosaic cannot lower. One launch here computes every component from
// the same frame tile, and the mirror and the planes are other store
// addresses: the full spectrum and the planes are bit-equal to frames_rfft
// (followed by the mirror), since all store the same sums.
//
// Bound: NC x 2 x WL x F FLOP per frame (8.4 MFLOP at WL 2048 for the
// rDFT, half that for the MDCT) against 4 bytes of new signal per hop, in
// FP32 (exact) or four bf16 passes (split4); the full store writes 8 x WL
// bytes per frame, twice the half spectrum's. The main loops and their
// design are in frames_gemm.cuh and frames_gemm_split4.cuh; this file adds
// the stores: ragged F is masked there.
#include "frames_gemm_split4.cuh"

namespace {

using namespace zt::frames;

enum Store { kReal, kHalf, kFull, kPlanes };

// P > 0: the split4 tile at P bf16 passes, ops the presplit (2, NC, WL, FP)
// bf16 stack; P = 0: the exact tile, ops (NC, WL, FP) float32.
template <bool VEC, Store S, int P>
__global__ void __launch_bounds__(zt::kThreads)
frames_kernel(const float* __restrict__ sig, const float* __restrict__ win,
              const void* __restrict__ ops, float* __restrict__ out,
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
  if constexpr (P > 0) {
    tile_split4<VEC, NC, true, P>(sig + blockIdx.z * sig_len, win,
                                  static_cast<const __nv_bfloat16*>(ops),
                                  (long long)WL * FP, T, WL, step, FP, t0, f0,
                                  acc);
  } else {
    tile<VEC, NC>(sig + blockIdx.z * sig_len, win,
                  static_cast<const float*>(ops), (long long)WL * FP, T, WL,
                  step, FP, t0, f0, acc);
  }

  // Output row length in floats: F reals (per plane), F complex bins or WL
  // of them.
  const int row = S == kReal || S == kPlanes ? F
                  : (S == kHalf ? 2 * F : 2 * WL);
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
      } else if constexpr (S == kPlanes) {
        // The imaginary plane follows the batch's real planes.
        orow[f] = acc[i][j];
        orow[(long long)gridDim.z * T * F + f] = acc[i][4 + j];
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

template <Store S, int P = 0>
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
  float* y = static_cast<float*>(out);
  if (vec_ok(sig, win, sig_len, WL, step)) {
    frames_kernel<true, S, P><<<grid, zt::kThreads, 0, st>>>(
        s, w, ops, y, sig_len, T, WL, step, F, FP);
  } else {
    frames_kernel<false, S, P><<<grid, zt::kThreads, 0, st>>>(
        s, w, ops, y, sig_len, T, WL, step, F, FP);
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

// As zt_frames_rfft with F = WL/2 + 1 or any F, out two float32 planes
// (2, batch, T, F): the real parts, then the imaginary parts.
ZT_EXPORT int zt_frames_planes(const void* sig, const void* win,
                               const void* ops, void* out, int batch,
                               long long sig_len, int T, int WL, int step,
                               int F, int FP, void* stream) {
  return launch<kPlanes>(sig, win, ops, out, batch, sig_len, T, WL, step, F,
                         FP, stream);
}

// The split4 twins of the four entry points above: the same arguments and
// outputs, ops the presplit (2, NC, WL, FP) bf16 stack (hi, then lo; NC = 2
// for the rDFT, 1 for frames_op), 16-byte aligned; passes: 4, 3 or 1
// (split4.cuh).
ZT_EXPORT int zt_frames_rfft_split4(const void* sig, const void* win,
                                    const void* ops, void* out, int batch,
                                    long long sig_len, int T, int WL,
                                    int step, int F, int FP, int passes,
                                    void* stream) {
  return zt::s4::with_passes(passes, [&](auto p) {
    return launch<kHalf, decltype(p)::value>(sig, win, ops, out, batch,
                                             sig_len, T, WL, step, F, FP,
                                             stream);
  });
}

ZT_EXPORT int zt_frames_op_split4(const void* sig, const void* win,
                                  const void* ops, void* out, int batch,
                                  long long sig_len, int T, int WL, int step,
                                  int F, int FP, int passes, void* stream) {
  return zt::s4::with_passes(passes, [&](auto p) {
    return launch<kReal, decltype(p)::value>(sig, win, ops, out, batch,
                                             sig_len, T, WL, step, F, FP,
                                             stream);
  });
}

ZT_EXPORT int zt_frames_rfft_full_split4(const void* sig, const void* win,
                                         const void* ops, void* out,
                                         int batch, long long sig_len, int T,
                                         int WL, int step, int F, int FP,
                                         int passes, void* stream) {
  if (F != WL / 2 + 1) return (int)cudaErrorInvalidValue;
  return zt::s4::with_passes(passes, [&](auto p) {
    return launch<kFull, decltype(p)::value>(sig, win, ops, out, batch,
                                             sig_len, T, WL, step, F, FP,
                                             stream);
  });
}

ZT_EXPORT int zt_frames_planes_split4(const void* sig, const void* win,
                                      const void* ops, void* out, int batch,
                                      long long sig_len, int T, int WL,
                                      int step, int F, int FP, int passes,
                                      void* stream) {
  return zt::s4::with_passes(passes, [&](auto p) {
    return launch<kPlanes, decltype(p)::value>(sig, win, ops, out, batch,
                                               sig_len, T, WL, step, F, FP,
                                               stream);
  });
}
