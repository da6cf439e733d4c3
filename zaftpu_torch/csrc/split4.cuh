// The split4 scheme on Hopper's tensor cores, shared by the analysis tile
// (frames_gemm_split4.cuh) and the synthesis kernel (synth.cu):
//   a . b = ((al.bl + al.bh) + ah.bl) + ah.bh
// with x = xh + xl + eps, xh = x rounded to bf16 (nearest even), xl = the
// exact float32 difference rounded to bf16, |eps| ~ 2^-17 |x|. Each pass is
// mma.sync m16n8k16 (bf16 x bf16 products, float32 sums), which is what
// zaftpu's TPU matrix unit does in its four passes
// (zaftpu/core/policy.py: _split4_matmul).
//
// Pass count P (a template parameter of slice and of the tiles built on
// it; the twins' entries take it at run time, with_passes): P = 4 keeps all
// four terms; P = 3 drops al.bl, (al.bh + ah.bl) + ah.bh, which is XLA's
// Precision.HIGH on zaftpu's TPU (ZAFTPU_PRECISION=high); P = 1 keeps ah.bh
// alone, one bf16 pass (ZAFTPU_PRECISION=default, and the bf16 compute
// dtype against the operator's hi half). The lo halves are neither loaded
// from shared memory nor multiplied at P = 1.
//
// Sums: the small terms chain into one set of accumulators, cr; the
// large term ah.bh goes into hh, one fresh mma partial per 16-deep slice
// added into the running sum, the port's two-level sum (one running sum
// over a 2048-long contraction cost about 9 dB of round trip on the H100,
// PERF.md); the result is cr + hh.
//
// Block tile: 64 rows x 64 columns of each of NC components over 256
// threads. Warp w owns rows (w / 4) * 32 .. + 32 (two 16-row m-tiles) and
// columns (w % 4) * 16 .. + 16 (two 8-column n-tiles). Shared memory holds
// one 16-deep slice: A as [half][row][k] (k contiguous, ldmatrix), B as
// [half][component][k][column] (columns contiguous, ldmatrix .trans). The
// rows are padded (48 and 144 bytes) so the eight row addresses of each
// ldmatrix fall on distinct banks.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace zt {
namespace s4 {

constexpr int BM = 64;        // rows per block
constexpr int BN = 64;        // columns per component per block
constexpr int BK = 16;        // contraction per slice (one mma deep)
constexpr int LDA = BK + 8;   // bf16 per A row in shared memory
constexpr int LDB = BN + 8;   // bf16 per B row in shared memory

using bf16 = __nv_bfloat16;

template <int NC>
using Frag = float[NC][2][2][4];  // [component][m-tile][n-tile][mma reg]

template <int NC>
__device__ __forceinline__ void zero(Frag<NC>& f) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) f[c][m][n][r] = 0.f;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d = a * b + c on one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1,
                                    const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// Four consecutive float32 values split into their bf16 hi and lo halves,
// each packed as four bf16 in one 8-byte word (element 0 at the low end).
__device__ __forceinline__ void split4v(float4 v, uint2& hi, uint2& lo) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
  const __nv_bfloat162 l01 = __floats2bfloat162_rn(
      v.x - __low2float(h01), v.y - __high2float(h01));
  const __nv_bfloat162 l23 = __floats2bfloat162_rn(
      v.z - __low2float(h23), v.w - __high2float(h23));
  hi = make_uint2(as_u32(h01), as_u32(h23));
  lo = make_uint2(as_u32(l01), as_u32(l23));
}

// The hi halves alone (the P = 1 staging).
__device__ __forceinline__ uint2 hi4v(float4 v) {
  return make_uint2(as_u32(__floats2bfloat162_rn(v.x, v.y)),
                    as_u32(__floats2bfloat162_rn(v.z, v.w)));
}

__device__ __forceinline__ void split1(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Calls f(std::integral_constant<int, P>()) for the pass count P = passes
// (4, 3 or 1) and returns its result; any other count is
// cudaErrorInvalidValue.
template <class F>
int with_passes(int passes, F&& f) {
  switch (passes) {
    case 4: return f(std::integral_constant<int, 4>());
    case 3: return f(std::integral_constant<int, 3>());
    case 1: return f(std::integral_constant<int, 1>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// One 16-deep slice of the block tile: A[half][row][k] and
// B[half][component][k][column] in shared memory, accumulated into this
// thread's fragments of hh (ah.bh, two-level) and cr (the P - 1 small
// terms, chained smallest first).
template <int NC, int P = 4>
__device__ __forceinline__ void slice(const bf16 (&A)[2][BM][LDA],
                                      const bf16 (&B)[2][NC][BK][LDB],
                                      Frag<NC>& hh, Frag<NC>& cr) {
  static_assert(P == 1 || P == 3 || P == 4, "1, 3 or 4 bf16 passes");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  // ldmatrix row addresses: lanes 8j..8j+7 give the rows of matrix j.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;
  unsigned ah[2][4], al[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    ldsm_x4(ah[m], &A[0][wm * 32 + m * 16 + arow][acol]);
    if constexpr (P > 1) ldsm_x4(al[m], &A[1][wm * 32 + m * 16 + arow][acol]);
  }
  const float zeros[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    // Regs 0, 1: b0, b1 of n-tile 0; regs 2, 3: those of n-tile 1.
    unsigned bh[4], bl[4];
    ldsm_x4_trans(bh, &B[0][c][arow][wn * 16 + acol]);
    if constexpr (P > 1) ldsm_x4_trans(bl, &B[1][c][arow][wn * 16 + acol]);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float (&x)[4] = cr[c][m][n];
        if constexpr (P == 4) mma(x, al[m], bl[2 * n], bl[2 * n + 1], x);
        if constexpr (P >= 3) {
          mma(x, al[m], bh[2 * n], bh[2 * n + 1], x);
          mma(x, ah[m], bl[2 * n], bl[2 * n + 1], x);
        }
        float p[4];
        mma(p, ah[m], bh[2 * n], bh[2 * n + 1], zeros);
#pragma unroll
        for (int r = 0; r < 4; ++r) hh[c][m][n][r] += p[r];
      }
    }
  }
}

// Where this thread's fragment register r of (m-tile m, n-tile n) sits in
// the block tile: row and column (component offset not included).
__device__ __forceinline__ int frag_row(int m, int r) {
  const int lane = threadIdx.x & 31;
  return (threadIdx.x >> 7) * 32 + m * 16 + (lane >> 2) + (r >> 1) * 8;
}

__device__ __forceinline__ int frag_col(int n, int r) {
  const int lane = threadIdx.x & 31;
  return ((threadIdx.x >> 5) & 3) * 16 + n * 8 + (lane & 3) * 2 + (r & 1);
}

}  // namespace s4
}  // namespace zt
