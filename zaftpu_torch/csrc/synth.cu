// Inverse GEMM + overlap-add in one launch:
//   frames[t, n] = sum_q h[t, q] * op[q, n]
//   y[r*step + j] = sum_c frames[r - c, c*step + j]      (c ascending)
// Two callers:
// - istft_ola: h = [h_re | 0 | h_im | 0], the Hermitian-folded planes
//   packed into (T, 2*KP) rows, and op = [cos; 0; -sin; 0], (2*KP, N),
//   carrying the pair weights, 1/N and the COLA 1/gain;
// - imdct_ola: h = the MDCT coefficients (T, F), zero-padded to Q = F
//   rounded up to 16 where F is not a multiple of 16, and op the
//   window-folded inverse MDCT matrix (Q, 2F) with zero rows past F; so
//   N = 2F, step = F, K = 2 (the TDAC overlap-add).
//
// Replaces zaftpu/pallas/synth.py: _gemm_ola_impl as reached from
// istft_ola (C = 2, here the two planes side by side in one contraction)
// and imdct_ola (C = 1). The Pallas kernel walks frame blocks on a
// sequential grid and carries the last K-1 frame rows of each block to the
// next in VMEM. CUDA blocks run in no order, so nothing is carried here.
//
// Bound: FP32 arithmetic, 2 x Q x N FLOP per frame, the same as one full
// inverse GEMM. Design: each 256-thread block owns 64 output rows
// (hops) x 64 columns of one hop. Output row r needs exactly column chunk c
// of frame row r - c, so for c = 0..K-1 the block computes the GEMM piece
// frames[r0 - c .. r0 - c + 64, c*step + cols] in its own register tile
// (a SIMT GEMM over the Q contraction, staged through double-buffered
// shared memory in slices of 16 with the next slice's 16-byte loads in
// flight, zt::slice_fma) and adds each finished piece into the running
// sum. Every frame element is computed once, no halo is redone, no atomics
// are needed, the frame matrix never reaches device memory, and the sum
// keeps zaftpu's c-ascending order. Frame rows outside [0, T) are masked
// to zero at load, which is the zero contribution of the padded chunk
// views in the plain version. The zero padding of the rows to Q keeps
// every load 16-byte aligned and unmasked along the contraction. A thread
// holds 4 x 4 outputs, its piece and its slice partial in about 80
// registers, so several blocks share an SM; 128-row blocks measured 5%
// slower on the H100 (PERF.md).
#include "common.cuh"

namespace {

constexpr int BM = 64;       // output rows (hops) per block
constexpr int BN = 64;       // columns of one hop per block
constexpr int BK = 16;       // contraction slice
constexpr int TM = BM / 16;  // output rows per thread
constexpr int AV = BM / 64;  // 16-byte spectrum loads per thread
constexpr int APAD = 4;

// VEC_B: operator columns read as 16-byte vectors (step and N divisible
// by 4), else one float at a time.
template <bool VEC_B>
__global__ void __launch_bounds__(zt::kThreads)
gemm_ola_kernel(const float* __restrict__ h, const float* __restrict__ ops,
                 float* __restrict__ out, int T, int Q, int N, int step,
                 int K, long long out_len) {
  __shared__ __align__(16) float As[2][BK][BM + APAD];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);
  const int j0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const float* hb = h + blockIdx.z * (long long)T * Q;

  // Spectrum-tile loads: AV float4 per thread, tile rows ar + 64j,
  // contraction entries ak..ak+3 of the slice.
  const int ar = tid / 4;
  const int ak = (tid % 4) * 4;
  // Operator-tile loads: slice row bk, hop columns j0 + bc .. + 3.
  const int bk = tid / (BN / 4);
  const int bc = (tid % (BN / 4)) * 4;
  const float* bp = ops + (long long)bk * N + j0 + bc;

  float4 ra[AV];
  float4 rb;
  auto load = [&](int c, int q0) {
#pragma unroll
    for (int j = 0; j < AV; ++j) {
      const int t = r0 - c + ar + 64 * j;
      ra[j] = (t >= 0 && t < T) ? *reinterpret_cast<const float4*>(
                                      hb + (long long)t * Q + q0 + ak)
                                : zt::zero4();
    }
    const float* row = bp + (long long)q0 * N + (long long)c * step;
    const int col = j0 + bc;
    if constexpr (VEC_B) {
      rb = (col < step && c * step + col < N)
               ? *reinterpret_cast<const float4*>(row)
               : zt::zero4();
    } else {
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        v[jj] = (col + jj < step && c * step + col + jj < N) ? row[jj] : 0.f;
      }
      rb = make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int j = 0; j < AV; ++j) {
      const int m = ar + 64 * j;
      As[s][ak][m] = ra[j].x;
      As[s][ak + 1][m] = ra[j].y;
      As[s][ak + 2][m] = ra[j].z;
      As[s][ak + 3][m] = ra[j].w;
    }
    *reinterpret_cast<float4*>(&Bs[s][bk][bc]) = rb;
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int slices = Q / BK;
  for (int c = 0; c < K; ++c) {
    float piece[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) piece[i][j] = 0.f;
    }
    load(c, 0);
    store(0);
    __syncthreads();
    for (int s = 0; s < slices; ++s) {
      const int cur = s & 1;
      if (s + 1 < slices) load(c, (s + 1) * BK);
      zt::slice_fma<BK, TM, 1, BN, BM + APAD, BN>(As[cur], Bs[cur], ty, tx,
                                                  piece);
      if (s + 1 < slices) store(cur ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + piece[i][j];
    }
  }

  float* ob = out + blockIdx.z * out_len;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = r0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx * 4 + j;
      const long long n = r * step + col;
      if (col < step && n < out_len) ob[n] = acc[i][j];
    }
  }
}

}  // namespace

// h: (batch, T, Q), Q a multiple of 16; ops: (Q, N); out:
// (batch, (T - 1) * step + N). float32, contiguous, 16-byte aligned.
ZT_EXPORT int zt_gemm_ola(const void* h, const void* ops, void* out,
                          int batch, int T, int Q, int N, int step,
                          void* stream) {
  if (Q % BK != 0 || !zt::aligned16(h) || !zt::aligned16(ops)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = zt::ceil_div(N, step);
  const long long out_len = (long long)(T - 1) * step + N;
  const int rows = T - 1 + K;  // hop rows covering out_len
  const dim3 grid(zt::ceil_div(step, BN), zt::ceil_div(rows, BM), batch);
  const float* hp = static_cast<const float*>(h);
  const float* o = static_cast<const float*>(ops);
  float* y = static_cast<float*>(out);
  if (step % 4 == 0 && N % 4 == 0) {
    gemm_ola_kernel<true><<<grid, zt::kThreads, 0, st>>>(
        hp, o, y, T, Q, N, step, K, out_len);
  } else {
    gemm_ola_kernel<false><<<grid, zt::kThreads, 0, st>>>(
        hp, o, y, T, Q, N, step, K, out_len);
  }
  return (int)cudaGetLastError();
}
