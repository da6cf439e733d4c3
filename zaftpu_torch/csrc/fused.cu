// Framing + window + real-DFT GEMM, both components in one launch:
//   re[b, t, f] = sum_w sig[b, t*step + w] * win[w] * cos_op[w, f]
//   im[b, t, f] = sum_w sig[b, t*step + w] * win[w] * sin_op[w, f]
// written as an interleaved complex (batch, T, F) half spectrum.
//
// Replaces zaftpu/pallas/fused.py: _frames_matmul_impl as reached from
// frames_rfft (C = 2). The Pallas kernel forms a 128-frame block of
// windowed frames in VMEM and runs one pallas_call per operator component
// against the whole VMEM-resident (WL, F_pad) operator. One launch here
// computes both components from the same frame tile.
//
// Bound: FP32 arithmetic. 2 components x 2 x WL x F FLOP per frame
// (8.4 MFLOP at WL 2048) against 4 bytes of new signal per hop, far above
// the card's FLOP:byte balance, and exactness forbids the TF32 tensor
// cores. Design: a register-tiled SIMT GEMM. Each 256-thread block owns
// 64 frames x 64 bins of each component and walks WL in slices of 16.
// Per slice it builds the windowed frame tile in shared memory directly
// from the signal (16-byte loads where the hop and pointers allow), so
// frames never reach device memory, and stages the cos and sin operator
// tiles beside it; each thread then accumulates a 4 x 4 tile of both
// components with FP32 FMAs from the same A values (zt::slice_fma, which
// also sums the contraction in two levels for accuracy). At 64 frames a
// block its 32 + 32 accumulators keep a thread under 128 registers, so two
// blocks share an SM; 128-frame blocks needed ~210 registers and measured
// 7% slower on the H100 (PERF.md). The next slice's
// loads are in flight while the current one is computed, from pointers
// fixed once per block, and shared memory is double-buffered, so one
// barrier per slice suffices. The operator is padded to whole 64-bin
// tiles with zero columns, so its loads need no masks; the operators
// (2 x 8.9 MB at WL 2048) stay in L2 across blocks. Ragged T and F are
// masked at the frame loads and the store.
#include "common.cuh"

namespace {

constexpr int BM = 64;        // frames per block
constexpr int BN = 64;        // bins per component per block
constexpr int BK = 16;        // window samples per shared-memory slice
constexpr int TM = BM / 16;   // frames per thread
constexpr int AV = BM / 64;   // 16-byte frame loads per thread
constexpr int APAD = 4;       // keeps the transposed A stores off one bank

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// VEC: the signal rows and the window are read as 16-byte vectors, which
// needs step, WL and the batch stride divisible by 4 and aligned pointers.
template <bool VEC>
__global__ void __launch_bounds__(zt::kThreads)
frames_rfft_kernel(const float* __restrict__ sig,
                   const float* __restrict__ win,
                   const float* __restrict__ ops, float* __restrict__ out,
                   long long sig_len, int T, int WL, int step, int F,
                   int FP) {
  __shared__ __align__(16) float As[2][BK][BM + APAD];
  __shared__ __align__(16) float Bs[2][BK][2 * BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);  // 16 column groups of 4 bins
  const int ty = tid / (BN / 4);  // 16 row groups of TM frames
  const int f0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * BM;
  const float* sb = sig + blockIdx.z * sig_len;

  // Frame-tile loads. VEC: AV float4 per thread, frames ar + 64j, samples
  // ak..ak+3 of the slice. Scalar: TM floats, frames sr + 16i, sample sk
  // of the slice.
  const int ar = tid / 4;
  const int ak = (tid % 4) * 4;
  const int sr = tid / BK;
  const int sk = tid % BK;
  const float* ap = sb + (long long)(t0 + (VEC ? ar : sr)) * step +
                    (VEC ? ak : sk);
  bool av[AV];
#pragma unroll
  for (int j = 0; j < AV; ++j) av[j] = t0 + ar + 64 * j < T;
  // Operator-tile loads: row bk of the slice, bins bc..bc+3 of cos and sin.
  const int bk = tid / (BN / 4);
  const int bc = (tid % (BN / 4)) * 4;
  const float* bp = ops + (long long)bk * FP + f0 + bc;
  const long long sin_off = (long long)WL * FP;

  float4 ra[AV];
  float rs[TM];
  float4 rb[2];
  auto load = [&](int k0) {
    if constexpr (VEC) {
      const int w = k0 + ak;
      const float4 wv = w < WL ? *reinterpret_cast<const float4*>(win + w)
                               : zt::zero4();
#pragma unroll
      for (int j = 0; j < AV; ++j) {
        ra[j] = (w < WL && av[j])
                    ? mul4(*reinterpret_cast<const float4*>(
                               ap + 64LL * j * step + k0), wv)
                    : zt::zero4();
      }
    } else {
      const int w = k0 + sk;
      const float wv = w < WL ? win[w] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        rs[i] = (w < WL && t0 + sr + 16 * i < T)
                    ? ap[16LL * i * step + k0] * wv
                    : 0.f;
      }
    }
    if (k0 + bk < WL) {
      const float* row = bp + (long long)k0 * FP;
      rb[0] = *reinterpret_cast<const float4*>(row);
      rb[1] = *reinterpret_cast<const float4*>(row + sin_off);
    } else {
      rb[0] = rb[1] = zt::zero4();
    }
  };
  auto store = [&](int s) {
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < AV; ++j) {
        const int m = ar + 64 * j;
        As[s][ak][m] = ra[j].x;
        As[s][ak + 1][m] = ra[j].y;
        As[s][ak + 2][m] = ra[j].z;
        As[s][ak + 3][m] = ra[j].w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) As[s][sk][sr + 16 * i] = rs[i];
    }
    *reinterpret_cast<float4*>(&Bs[s][bk][bc]) = rb[0];
    *reinterpret_cast<float4*>(&Bs[s][bk][BN + bc]) = rb[1];
  };

  // acc[i][0..3]: cos bins, acc[i][4..7]: sin bins of frame ty*TM + i.
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int slices = zt::ceil_div(WL, BK);
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) load((s + 1) * BK);
    zt::slice_fma<BK, TM, 2, BN, BM + APAD, 2 * BN>(As[cur], Bs[cur], ty, tx,
                                                    acc);
    if (s + 1 < slices) store(cur ^ 1);
    __syncthreads();
  }

  float* ob = out + blockIdx.z * (long long)T * F * 2;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty * TM + i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f >= F) continue;
      *reinterpret_cast<float2*>(ob + ((long long)t * F + f) * 2) =
          make_float2(acc[i][j], acc[i][4 + j]);
    }
  }
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
  if (FP % BN != 0 || FP < F || !zt::aligned16(ops)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(FP / BN, zt::ceil_div(T, BM), batch);
  const bool vec = step % 4 == 0 && WL % 4 == 0 && sig_len % 4 == 0 &&
                   zt::aligned16(sig) && zt::aligned16(win);
  const float* s = static_cast<const float*>(sig);
  const float* w = static_cast<const float*>(win);
  const float* o = static_cast<const float*>(ops);
  float* y = static_cast<float*>(out);
  if (vec) {
    frames_rfft_kernel<true><<<grid, zt::kThreads, 0, st>>>(
        s, w, o, y, sig_len, T, WL, step, F, FP);
  } else {
    frames_rfft_kernel<false><<<grid, zt::kThreads, 0, st>>>(
        s, w, o, y, sig_len, T, WL, step, F, FP);
  }
  return (int)cudaGetLastError();
}
