// The magnitude front ends: framing + window + rDFT GEMM over bins 1..WL/2
// (DC dropped, Nyquist kept, the reference's zaf.py:370 slice), then
//   spec_rows: out[b, t, f] = sqrt(re^2 + im^2)                  (T, WL/2)
//   mel_rows:  out[b, t, m] = sum_f mag[t, f] * fbt[f, m]      (T, n_mels)
// with mag the magnitude, or for MFCC the power re^2 + im^2. The operator
// ops (2, WL, FP) holds the cos and sin columns of bins 1..WL/2 in its
// columns 0..WL/2-1, zero columns after, so output column f is bin f + 1
// and at WL 2048 the 1,024 bins are exactly 16 tiles of 64: the DC column
// is never computed.
//
// Replaces zaftpu/pallas/melfused.py: _spec_rows_impl (spec_rows) and
// _mel_rows_impl (mel_rows). The Pallas kernels hold a block's whole
// (block, F_pad) spectrum in VMEM, so one grid step forms the magnitudes
// and runs the filterbank dot on them.
//
// Bound: FP32 arithmetic, the rDFT's 2 x 2 x WL FLOP per frame and bin
// (frames_gemm.cuh has the main loop and its design); the filterbank adds
// n_mels / (2 WL), 1% at 40 mels. spec_rows is the B1 grid with a
// magnitude store. mel_rows has the catch that a (T, n_mels) output row
// sums over all bins, while the B1 grid spreads the bins over blocks.
// Design: the B1 grid, one 64-frame x 64-bin tile per block; the block
// writes its 64 x 64 magnitudes to shared memory, stages the tile's
// filterbank rows beside them, 256 mels at a time (kMelChunk, so any mel
// count fits), and writes their product (a 64-long sum per element) as
// partial p = blockIdx.x of (P, batch, T, n_mels); a second pass sums the
// P partials in ascending order. No atomics: every result is the same from
// run to run. A block that walks
// all bins itself leaves 404 blocks at the 600-s shape, 1.5 waves of two
// blocks on 132 SMs: 9.7 ms against 7.3 ms for one tile per block, with
// runs of 2, 4 and 8 tiles in between (H100 80GB HBM3, 700 W; PERF.md).
//
// mel_rows_split4 replaces _mel_rows_impl's _kernel_split4 (the split4
// dial with ZAFTPU_MELFUSE=1): the same grid, epilogue and second pass
// around frames_gemm_split4.cuh's tensor-core tile, ops the presplit
// (2, 2, WL, FP) bf16 stack. The filterbank product stays FP32, as zaftpu
// keeps it at HIGHEST. Bound: four bf16 passes of the rDFT, 0.88 ms per
// 600-s segment at WL 2048. The split4 tile's 33,792 bytes of static
// shared memory come on top of the epilogue's dynamic mel_smem_bytes
// (82,176 bytes at 256 mels or more).
#include "frames_gemm_split4.cuh"

namespace {

using namespace zt::frames;

template <bool VEC>
__global__ void __launch_bounds__(zt::kThreads)
spec_rows_kernel(const float* __restrict__ sig,
                 const float* __restrict__ win,
                 const float* __restrict__ ops, float* __restrict__ out,
                 long long sig_len, int T, int WL, int step, int F, int FP) {
  const int tx = threadIdx.x % (BN / 4);
  const int ty = threadIdx.x / (BN / 4);
  const int f0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * BM;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  tile<VEC, 2>(sig + blockIdx.z * sig_len, win, ops, (long long)WL * FP, T,
               WL, step, FP, t0, f0, acc);

  float* ob = out + blockIdx.z * (long long)T * F;
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
      ob[(long long)t * F + f] = sqrtf(re * re + im * im);
    }
  }
}

// Mels the epilogue stages at a time: a wider filterbank is walked in
// chunks of this many columns, so any mel count runs.
constexpr int kMelChunk = 256;

// Dynamic shared memory: the tile's (BN, MC) filterbank chunk and its
// (BM, BN + 1) magnitudes, MC = min(M, kMelChunk).
inline size_t mel_smem_bytes(int M) {
  const int mc = M < kMelChunk ? M : kMelChunk;
  return sizeof(float) * ((size_t)BN * mc + BM * (BN + 1));
}

// At most 128 registers, so two blocks share an SM. Left free, the
// compiler took more and one block per SM measured 17-20% slower for the
// exact kernel, and 1.44-1.48 times slower for the split4 one (134-136
// registers; H100 80GB HBM3, 700 W; scripts/torch_ab.py, PERF.md).
// S4: the split4 tile, ops the presplit (2, 2, WL, FP) bf16 stack; else the
// exact tile, ops (2, WL, FP) float32.
template <bool VEC, bool POWER, bool S4>
__global__ void __launch_bounds__(zt::kThreads, 2)
mel_rows_kernel(const float* __restrict__ sig, const float* __restrict__ win,
                const void* __restrict__ ops, const float* __restrict__ fbt,
                float* __restrict__ part, long long sig_len, int T, int WL,
                int step, int F, int FP, int M) {
  const int MC = M < kMelChunk ? M : kMelChunk;
  extern __shared__ __align__(16) float dyn[];
  float* fs = dyn;             // [BN][MC]
  float* ms = fs + BN * MC;    // [BM][BN + 1]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);
  const int f0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * BM;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  if constexpr (S4) {
    tile_split4<VEC, 2>(sig + blockIdx.z * sig_len, win,
                        static_cast<const __nv_bfloat16*>(ops),
                        (long long)WL * FP, T, WL, step, FP, t0, f0, acc);
  } else {
    tile<VEC, 2>(sig + blockIdx.z * sig_len, win,
                 static_cast<const float*>(ops), (long long)WL * FP, T, WL,
                 step, FP, t0, f0, acc);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float re = acc[i][j];
      const float im = acc[i][4 + j];
      const float p2 = re * re + im * im;
      ms[(ty * TM + i) * (BN + 1) + tx * 4 + j] = POWER ? p2 : sqrtf(p2);
    }
  }
  float* pb = part + ((long long)blockIdx.x * gridDim.z + blockIdx.z) *
                         (long long)T * M;
  // Mels c0..c0+mc of fbt rows f0..f0+BN; rows past F read as 0. Each
  // output is the same 64-long sum whatever the chunking.
  for (int c0 = 0; c0 < M; c0 += MC) {
    const int mc = M - c0 < MC ? M - c0 : MC;
    for (int e = tid; e < BN * mc; e += zt::kThreads) {
      const int f = f0 + e / mc;
      fs[e] = f < F ? fbt[(long long)f * M + c0 + e % mc] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < BM * mc; e += zt::kThreads) {
      const int t = t0 + e / mc;
      if (t >= T) continue;
      const float* mr = ms + (e / mc) * (BN + 1);
      const float* fc = fs + e % mc;
      float s = mr[0] * fc[0];
#pragma unroll 8
      for (int k = 1; k < BN; ++k) s = fmaf(mr[k], fc[k * mc], s);
      pb[(long long)t * M + c0 + e % mc] = s;
    }
    __syncthreads();  // before the next chunk overwrites fs
  }
}

// out[i] = part[0][i] + part[1][i] + ... + part[P-1][i], in that order.
__global__ void __launch_bounds__(zt::kThreads)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                    long long n, int P) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int p = 1; p < P; ++p) s += part[p * n + i];
    out[i] = s;
  }
}

template <bool VEC, bool POWER, bool S4>
cudaError_t launch_mel(dim3 grid, size_t smem, cudaStream_t st,
                       const float* s, const float* w, const void* o,
                       const float* fb, float* part, long long sig_len, int T,
                       int WL, int step, int F, int FP, int M) {
  auto kernel = mel_rows_kernel<VEC, POWER, S4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    // Clear the error so the next launch does not read it.
    cudaGetLastError();
    return err;
  }
  kernel<<<grid, zt::kThreads, smem, st>>>(s, w, o, fb, part, sig_len, T, WL,
                                           step, F, FP, M);
  return cudaGetLastError();
}

template <bool S4>
int mel_rows(const void* sig, const void* win, const void* ops,
             const void* fbt, void* part, void* out, int batch,
             long long sig_len, int T, int WL, int step, int F, int FP, int M,
             int power, void* stream) {
  if (FP % BN != 0 || FP < F || M < 1 || !zt::aligned16(ops)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = FP / BN;
  const dim3 grid(P, zt::ceil_div(T, BM), batch);
  const size_t smem = mel_smem_bytes(M);
  const float* s = static_cast<const float*>(sig);
  const float* w = static_cast<const float*>(win);
  const float* fb = static_cast<const float*>(fbt);
  float* y = static_cast<float*>(out);
  float* dst = P > 1 ? static_cast<float*>(part) : y;
  const bool vec = vec_ok(sig, win, sig_len, WL, step);
  cudaError_t err;
  if (vec && power) {
    err = launch_mel<true, true, S4>(grid, smem, st, s, w, ops, fb, dst,
                                     sig_len, T, WL, step, F, FP, M);
  } else if (vec) {
    err = launch_mel<true, false, S4>(grid, smem, st, s, w, ops, fb, dst,
                                      sig_len, T, WL, step, F, FP, M);
  } else if (power) {
    err = launch_mel<false, true, S4>(grid, smem, st, s, w, ops, fb, dst,
                                      sig_len, T, WL, step, F, FP, M);
  } else {
    err = launch_mel<false, false, S4>(grid, smem, st, s, w, ops, fb, dst,
                                       sig_len, T, WL, step, F, FP, M);
  }
  if (err != cudaSuccess || P == 1) return (int)err;
  const long long n = (long long)batch * T * M;
  sum_partials_kernel<<<zt::grid_1d(n, zt::kThreads), zt::kThreads, 0, st>>>(
      dst, y, n, P);
  return (int)cudaGetLastError();
}

}  // namespace

// sig: (batch, sig_len) with sig_len >= (T - 1) * step + WL; win: (WL,);
// ops: (2, WL, FP), FP a multiple of 64, 16-byte aligned; out: (batch, T, F)
// float32 with F = WL / 2. All contiguous.
ZT_EXPORT int zt_spec_rows(const void* sig, const void* win, const void* ops,
                           void* out, int batch, long long sig_len, int T,
                           int WL, int step, int F, int FP, void* stream) {
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
    spec_rows_kernel<true><<<grid, zt::kThreads, 0, st>>>(
        s, w, o, y, sig_len, T, WL, step, F, FP);
  } else {
    spec_rows_kernel<false><<<grid, zt::kThreads, 0, st>>>(
        s, w, o, y, sig_len, T, WL, step, F, FP);
  }
  return (int)cudaGetLastError();
}

// As zt_spec_rows, then the filterbank: fbt (F, M) float32, out
// (batch, T, M). For P = FP / 64 > 1 bin tiles, part is (P, batch, T, M)
// scratch that a second pass sums into out; for P = 1 the tiles write out
// directly and part is unused.
ZT_EXPORT int zt_mel_rows(const void* sig, const void* win, const void* ops,
                          const void* fbt, void* part, void* out, int batch,
                          long long sig_len, int T, int WL, int step, int F,
                          int FP, int M, int power, void* stream) {
  return mel_rows<false>(sig, win, ops, fbt, part, out, batch, sig_len, T,
                         WL, step, F, FP, M, power, stream);
}

// The split4 twin: the same arguments, ops the presplit (2, 2, WL, FP) bf16
// stack (hi then lo, each cos then sin), 16-byte aligned.
ZT_EXPORT int zt_mel_rows_split4(const void* sig, const void* win,
                                 const void* ops, const void* fbt, void* part,
                                 void* out, int batch, long long sig_len,
                                 int T, int WL, int step, int F, int FP,
                                 int M, int power, void* stream) {
  return mel_rows<true>(sig, win, ops, fbt, part, out, batch, sig_len, T, WL,
                        step, F, FP, M, power, stream);
}
