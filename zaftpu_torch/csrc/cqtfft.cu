// Magnitude CQT in its spectral form, the reference's |K . FFT(frame)|
// (zaf.py:627-633):
//   out[b, t, i] = | sum_j K[i, c_j] X_{b,t}[c_j] |
// with X_{b,t} the real FFT of the unwindowed frame sig[b, t*step ..
// t*step + L), L a power of two from 16 to 131,072, and K the thresholded
// spectral kernel (conjugated and scaled by 1/L) as a host table
// (kernels/cqtfft.device_table): a row pointer, each row's nonzeros in
// ascending column order as complex64 values with one code each (its
// half-spectrum bin, a conjugate flag for a column c > L/2, which reads
// conj X[L - c], and on a cluster the blocks that hold X[bin]), and the
// split list: the bins the table reads, grouped as step 3 takes them.
//
// Replaces zaftpu/pallas/cqtslab.py: magnitudes_in_trace (_kernel, B10)
// and its _kernel_split4 (B10-s4) on both schemes at those L. The TPU
// kernels contract each frame with the dense time-domain operator FFT(K
// rows)^T: 4 L F FLOP a frame (283 GFLOP per 600-s segment at
// CqtConfig(): T 15,000, L 32,768, F 144). Here each frame is transformed
// once and only the kernel's nonzeros are read: the 16,384-point complex
// FFT of the real frame (974,848 operations in chip_smoke._fft_ops'
// count), the split step at the 2,634 bins the kernel reads (16 each) and
// the banded product (8 a nonzero, 9,450 nonzeros), about 1.09 M
// operations a frame, 16.4 GFLOP a segment: bound by FP32 operations,
// 0.245 ms at the H100's 67 TFLOP/s, which counts an FMA as two; the
// kernel issues every product and sum on its own (__fmul_rn, __fadd_rn),
// so at one operation an issue slot it would take 0.49 ms (the signal
// read once, 106 MB, and the magnitudes written once, 8.6 MB, take 0.034
// ms at 3.35 TB/s). Measured (PERF.md, scripts/torch_cqt_variants.py
// --phases) the FFT takes two thirds of the time and the row sums most of
// the rest.
//
// Design: a block of 1,024 threads holds fpb = 16,384 / M frames' M-point
// complex FFTs in one float2 buffer (136 KB of dynamic shared memory with
// its padding): one frame at L 32,768, 8 at L 4,096. A 16,384-point FFT
// fits a block's 227 KB only as one buffer, not as Stockham's two, so each
// pass runs in place: a thread loads all its values, runs its butterflies
// in registers and stores them after a barrier. One block an SM, each
// looping over frame groups; no partial goes through device memory.
//  1. Framing, as rfft.cu: sample pairs (2m, 2m + 1) of each frame read
//     straight from the signal (one 8-byte load where the hop and the
//     pointer allow) as z[m] = x[2m] + i x[2m+1]; no window. From L 512
//     on, the first two passes read them into registers themselves.
//  2. The M-point complex FFT in place, in the plan of rfft.radices(M)
//     (radix 4, then one radix-2 pass when log2 M is odd) with
//     stockham.cuh's butterflies: two radix-4 passes at a time as one
//     radix-16 group a thread, so L 32,768's seven passes take four trips
//     through shared memory and the framing none. The twiddles come from
//     shared memory: the table (kernels/cqtfft._twiddles) has exact
//     quarter-turn symmetry, so the passes' W_L^2i for 2i < L/4 (32 KB)
//     serve every pass by exact swaps and negations (selects, no branch),
//     loaded once a block. The buffer is padded (a value every 16) and so
//     is the twiddle table, so a warp's accesses at a power-of-two stride
//     spread over the banks.
//  3. The split step once a bin the table reads, in place: X[k] = E + W_L^k
//     O, E = (Z[k] + conj Z[(M-k) mod M]) / 2, O = (Z[k] - conj Z[(M-k) mod
//     M]) / 2i (kernels/rfft.split_planes). A thread takes one entry of
//     the split list, reads the values its bins need, and writes each X
//     where a Z was: the entries' positions are disjoint, so no barrier
//     stands between the reads and the writes and X needs no buffer of its
//     own (X[M], Nyquist, goes to a side slot a frame). An entry is a
//     pair of bins k and M - k (split_pairs). W_L^k comes from the device
//     table through the read-only cache.
//  4. The row sums: the products K X (conj X where flagged) go through a
//     40-KB buffer 5,120 at a time, each computed by one thread; then one
//     thread a (frame, row) adds its row's products from 0 in the table's
//     order (eight products loaded at once, as four float4, ahead of the
//     adds, which form one chain a row) and
//     writes sqrt(re^2 + im^2) frames-major (batch, T, F), as B10 writes
//     it.
//
// L 65,536 (M 32,768 points, 272 KB with the padding) runs on a cluster of
// two blocks on neighbouring SMs that read each other's shared memory
// (distributed shared memory). The plan of rfft.radices(32,768) is seven
// radix-4 passes and one radix-2 pass. A Stockham pass at sub-transform
// length ns combines the sub-transforms c + s M / (R ns) (c < M / (R ns)):
// up to the seventh pass none crosses the even and odd values of z, so
// the first seven passes are two independent 16,384-point FFTs, of z[2i]
// and z[2i+1], in the same butterflies, twiddles and order. Block r runs
// the one-block design's FFT on z[2i + r] (its first pass reads those
// samples from the signal), with the W_{L/2} table of the L 32,768 case
// (W_65536^4i = W_32768^2i bit for bit: kernels/cqtfft.cluster_fft_plain
// checks the split on the CPU). After a cluster barrier the last pass
// (Z[j] = Y0[j] + W_L^2j Y1[j], Z[j + M/2] = Y0[j] - W_L^2j Y1[j]) runs
// only where the split step reads, fused with it: positions j and M/2 - j
// of both blocks hold every value bins j, M/2 - j, M/2 + j and M - j read,
// so a thread takes such a quad, reads the four Y (two of them in the
// other block), and writes each X where a Y was: bin k in block k >= M/2
// at position k mod M/2, and also in the other block when that block's
// bin there (k +- M/2) is not read and its rows read bin k (a copy bit of
// the entry; kernels/cqtfft.x_slots). The blocks then take half of the
// rows each (split by nonzeros); a kernel cqtkernel builds finds all its X
// in each block's own shared memory, and a foreign kernel's nonzero reads
// its X where its code says it lies.
// The frame ends on a cluster barrier. There is no fallback: a cluster
// launch the card refuses returns its error.
//
// L 131,072 (M 65,536 = 4^8 points) runs on a cluster of four blocks, by
// the same argument: up to the eighth pass the sub-transforms a pass
// combines lie a multiple of 4 apart, so the first seven radix-4 passes
// are four independent 16,384-point FFTs, of z[4i + r], block r's, on the
// L 32,768 table again (W_131072^8i = W_32768^2i). The eighth, radix-4
// pass (Z[j + sH] = butterfly s of Y0[j], W_L^2j Y1[j], W_L^4j Y2[j],
// W_L^6j Y3[j], H = M/4) is fused with the split step (split_cross<4>): a
// thread takes positions j and H - j of the four blocks (eight Y, six of
// them in other blocks), which give every value bins j + sH and (s+1)H - j
// read, and writes each X at its block's position, the lowest bin read at
// a position also into every block whose own bin there is not read and
// whose rows read it. Every bin cqtkernel reads lies below H, so again
// each block holds every X it reads; the blocks take a quarter of the rows
// each, split by nonzeros. Distributed shared memory is slow beside a
// block's own, so only the blocks whose rows read an X get a copy (copy
// bits in the split list): 9,181 remote writes a frame at C0 (44.1 kHz
// from 16.35 Hz) instead of 31,932, 3% of the kernel's time on the H100
// (scripts/torch_cqt_variants.py). The cross step's six remote reads an
// entry stay: 8,147 entries a frame at C0.
//
// Every product and sum is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsqrt_rn), so nothing is contracted into an FMA and the
// kernel does its plain version's float32 operations
// (kernels/cqtfft.cqt_magnitudes_fft_plain) in their order: bit-equal.
#include <cooperative_groups.h>

#include "stockham.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreadsFft = 1024;   // threads a block
constexpr int kBlockElems = 16384;  // complex values a block's FFTs hold
constexpr int kPerThread = kBlockElems / kThreadsFft;  // values a pass
constexpr int kGroups = kPerThread / 16;  // radix-16 groups a thread
// The buffer holds value i at pad(i) = i + i / 16: a radix-16 group's 16
// consecutive outputs then start 17 values (34 banks) apart, so its
// stores do not conflict.
constexpr int kPadded = kBlockElems + kBlockElems / 16;
// X[M] of each frame after the buffer: fpb slots, 2,048 at L 16.
constexpr int kSideSlots = kBlockElems / 8;
// W_L^2i, 2i < L/4 (L/8 values), value x at tpad(x) = x + x/16 + x/256,
// so that a warp's reads at a power-of-two stride spread over the banks.
constexpr int kTwiddles = kBlockElems / 4 + kBlockElems / 64 + 16;
constexpr int kChunk = 5120;  // products a pass of step 4
constexpr int kSumBatch = 8;  // products a row's chain loads at once
constexpr int kMinLength = 16;
constexpr int kOneBlockLength = 2 * kBlockElems;  // 32,768
constexpr int kMaxLength = 4 * kOneBlockLength;   // 131,072: four blocks
// A nonzero's code: bin << kCodeShift | holders << 1 | conj, 4 holder bits.
constexpr int kCodeShift = 5;
// The FFT buffer (136 KB), the side slots (16 KB), the twiddles (34 KB),
// the products (40 KB).
constexpr size_t kSmemBytes =
    (kPadded + kSideSlots + kTwiddles + kChunk) * sizeof(float2);
static_assert((kPadded + kSideSlots + kTwiddles) % 2 == 0,
              "the product buffer starts 16-byte aligned");

// L a power of two from 16 to 131,072 (kernels/cqtfft.fits).
bool cqt_fft_fits(int n) {
  return n >= kMinLength && n <= kMaxLength && (n & (n - 1)) == 0;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }
__device__ __forceinline__ int tpad(int x) { return x + (x >> 4) + (x >> 8); }

// W_L^idx for an even idx < 3L/4 from the block's W_L^2i, 2i < L/4 =
// 2^lq: the table's later quarters are the first one turned by -i, exactly
// (kernels/cqtfft._twiddles): quarter q = 1 is (w.y, -w.x), q = 2 (-w.x,
// -w.y). The turn is selects and sign flips, with no branch: the lanes of
// a warp read twiddles in different quarters.
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tws,
                                          int idx, int lq) {
  const float2 w = tws[tpad((idx & ((1 << lq) - 1)) >> 1)];
  const int q = idx >> lq;
  const unsigned sx = q == 2 ? 0x80000000u : 0u;
  const unsigned sy = q != 0 ? 0x80000000u : 0u;
  return make_float2(__uint_as_float(__float_as_uint(q & 1 ? w.y : w.x) ^ sx),
                     __uint_as_float(__float_as_uint(q & 1 ? w.x : w.y) ^ sy));
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
// T), which does the framing as well: value m of the row is z[(m << zs) +
// zr] of the frame, z[m] = x[2m] + i x[2m+1] (zs 1: a cluster block's
// half, zr its rank). VEC: 8-byte loads. Not inlined: inlined, it spilled
// more and ran slower.
template <bool SIG, bool VEC>
__device__ __noinline__ void fused_pass(float2* __restrict__ z,
                                        const float2* __restrict__ tws,
                                        int log2m, int log2ns, int lq,
                                        const float* __restrict__ sb,
                                        long long t0, int T, int step,
                                        int zs, int zr) {
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
          const float* p =
              sb + t * step + 2 * (((j0 + (m << log2g)) << zs) + zr);
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

// The M-point FFT of the block's fpb frames t0.. (a cluster block: its
// half of one frame, zs = 1, zr its rank), in place in z: the framing and
// the passes of steps 1 and 2. vec: 8-byte signal loads.
__device__ __forceinline__ void frame_fft(float2* __restrict__ z,
                                          const float2* __restrict__ tws,
                                          int log2m, const float* sb,
                                          long long t0, int T, int step,
                                          bool vec, int zs, int zr) {
  const int M = 1 << log2m;
  const int lq = log2m - 1;  // L/4 = 2^lq of the block's FFT
  int log2ns = 0;
  if (log2m >= 8) {  // the first two passes read the frames themselves
    if (vec) {
      fused_pass<true, true>(z, tws, log2m, 0, lq, sb, t0, T, step, zs, zr);
    } else {
      fused_pass<true, false>(z, tws, log2m, 0, lq, sb, t0, T, step, zs,
                              zr);
    }
    log2ns = 4;
  } else {  // one block a frame group only: zs = 0, zr = 0
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int e = threadIdx.x + u * kThreadsFft;
      const long long t = t0 + (e >> log2m);
      float2 v = make_float2(0.f, 0.f);
      if (t < T) {
        const float* p = sb + t * step + 2 * (e & (M - 1));
        v = vec ? *reinterpret_cast<const float2*>(p)
                : make_float2(p[0], p[1]);
      }
      z[pad(e)] = v;
    }
    __syncthreads();
  }
  for (; log2m >= 8 && log2ns + 4 <= log2m; log2ns += 4) {
    fused_pass<false, false>(z, tws, log2m, log2ns, lq, sb, t0, T, step, 0,
                             0);
  }
  for (; log2ns + 2 <= log2m; log2ns += 2) {
    inplace_pass<4>(z, tws, log2m, log2ns, lq);
  }
  if (log2ns < log2m) inplace_pass<2>(z, tws, log2m, log2ns, lq);
}

// The split step at bin k from a = Z[k mod M] and b = Z[(M-k) mod M]:
// X[k] = E + w O, w = W_L^k (kernels/rfft.split_planes' operations).
__device__ __forceinline__ float2 split_bin(float2 a, float2 b, float2 w) {
  const float er = __fmul_rn(__fadd_rn(a.x, b.x), 0.5f);
  const float ei = __fmul_rn(__fsub_rn(a.y, b.y), 0.5f);
  const float od = __fmul_rn(__fadd_rn(a.y, b.y), 0.5f);
  const float oi = __fmul_rn(__fsub_rn(b.x, a.x), 0.5f);
  return make_float2(
      __fadd_rn(er, __fsub_rn(__fmul_rn(w.x, od), __fmul_rn(w.y, oi))),
      __fadd_rn(ei, __fadd_rn(__fmul_rn(w.x, oi), __fmul_rn(w.y, od))));
}

// Step 3 on one block's fpb frames of M = 2^log2m points: each entry of
// the split list is p << 2 | 1 (X[p] read) | 2 (X[M - p] read; X[M] for p
// = 0), p <= M/2. X[k] goes where Z[k] was, X[M] to frame f's side slot.
__device__ __forceinline__ void split_pairs(float2* __restrict__ z,
                                            const float2* __restrict__ tw,
                                            const int* __restrict__ splits,
                                            int nsplit, int fpb, int log2m) {
  const int M = 1 << log2m;
  for (int it = threadIdx.x; it < fpb * nsplit; it += kThreadsFft) {
    const int f = it / nsplit;
    const int e = __ldg(splits + it - f * nsplit);
    const int p = e >> 2;
    const int base = f << log2m;
    const int pa = pad(base + p);
    const int pb = pad(base + ((M - p) & (M - 1)));
    const float2 a = z[pa];
    const float2 b = z[pb];
    if (e & 1) z[pa] = split_bin(a, b, __ldg(tw + p));
    if (e & 2) {
      z[p ? pb : kPadded + f] = split_bin(b, a, __ldg(tw + M - p));
    }
  }
}

// Position pos of block r's buffer, this block (rank) holding z: z + pos
// itself, or its image in block r's shared memory.
__device__ __forceinline__ float2* block_at(float2* z, int pos, int r,
                                            int rank) {
  return r == rank ? z + pos : cg::this_cluster().map_shared_rank(z + pos, r);
}

// The last pass at position pos of the cluster's C blocks (block r: the
// H-point FFT Y_r of z[C i + r]): Z[pos + sH] = butterfly s of Y_0[pos]
// and W_L^(2 r j) Y_r[pos] (j = pos's index), stockham.cuh's radix-C
// butterfly in the plain version's order.
template <int C>
__device__ __forceinline__ void last_pass(float2* z, int rank,
                                          const float2* __restrict__ tw,
                                          int pos, int j, float2 (&y)[C]) {
  float c[C], sn[C];  // the odd radices' constants: unused here
  float2 v[C];
  v[0] = *block_at(z, pos, 0, rank);
#pragma unroll
  for (int r = 1; r < C; ++r) {
    v[r] = zt::cmul(*block_at(z, pos, r, rank), __ldg(tw + 2 * r * j));
  }
  zt::dft<C>(v, c, sn, y);
}

// Step 3 on a cluster of C = 2 or 4 blocks (this one: rank, buffer z; H =
// 2^log2h). Entry j << 4C | copies << 2C | flags (flag bit s: bin j + sH;
// C + s: bin (s+1)H - j, M for s = C - 1 and j = 0; j <= H/2): the last
// pass at positions P = j and Q = (H - j) mod H, then the split step at
// the bins flagged, each X written where its Y was (bin k in block k / H),
// the lowest X at a position also into each block that copy bit r (P) or
// C + r (Q) names, X[M] into every block's side slot. Block r takes the
// r-th of C contiguous parts of the list, so a warp's entries, and its
// accesses in every block, are neighbours (alternate entries ran 8% slower
// at CQT_WIDE). X is stored as it is made: only the lowest stays live.
template <int C>
__device__ __forceinline__ void split_cross(float2* z, int rank,
                                            const float2* __restrict__ tw,
                                            const int* __restrict__ splits,
                                            int nsplit, int log2h) {
  constexpr int kAll = (1 << C) - 1;
  const int H = 1 << log2h;
  const int share = (nsplit + C - 1) / C;
  for (int it = rank * share + threadIdx.x;
       it < min(nsplit, (rank + 1) * share); it += kThreadsFft) {
    const int e = __ldg(splits + it);
    const int j = e >> (4 * C);
    const int q = j ? H - j : 0;
    const int pp = pad(j);
    const int pq = pad(q);
    float2 zp[C], zq[C];
    last_pass<C>(z, rank, tw, pp, j, zp);
    if (q != j) {
      last_pass<C>(z, rank, tw, pq, q, zq);
    } else {
#pragma unroll
      for (int s = 0; s < C; ++s) zq[s] = zp[s];
    }
    // Bin k reads a = Z[k mod M] and b = Z[(M - k) mod M].
    const int lo = e & kAll;  // bins j + sH
    float2 low;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      if (lo >> s & 1) {
        const float2 x =
            split_bin(zp[s], j ? zq[C - 1 - s] : zp[(C - s) & (C - 1)],
                      __ldg(tw + j + s * H));
        *block_at(z, pp, s, rank) = x;
        if (!(lo & ((1 << s) - 1))) low = x;
      }
    }
    const int cp = e >> (2 * C) & kAll;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (cp >> r & 1) *block_at(z, pp, r, rank) = low;
    }
    const int hi = e >> C & kAll;  // bins (s+1)H - j
    if (!j) {
      if (hi) {  // X[M]
        const float2 x = split_bin(zp[0], zp[0], __ldg(tw + C * H));
#pragma unroll
        for (int r = 0; r < C; ++r) *block_at(z, kPadded, r, rank) = x;
      }
      continue;
    }
#pragma unroll
    for (int s = 0; s < C; ++s) {
      if (hi >> s & 1) {
        const float2 x =
            split_bin(zq[s], zp[C - 1 - s], __ldg(tw + (s + 1) * H - j));
        *block_at(z, pq, s, rank) = x;
        if (!(hi & ((1 << s) - 1))) low = x;
      }
    }
    const int cq = e >> (3 * C) & kAll;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (cq >> r & 1) *block_at(z, pq, r, rank) = low;
    }
  }
}

// One nonzero's product K X[k] (conj X[k] where flagged), v its value,
// from its code c = bin << kCodeShift | holders << 1 | conj
// (kernels/cqtfft.kernel_codes).
__device__ __forceinline__ float2 product(float2 v, float2 x, int c) {
  const float xi = c & 1 ? -x.y : x.y;
  return make_float2(__fsub_rn(__fmul_rn(v.x, x.x), __fmul_rn(v.y, xi)),
                     __fadd_rn(__fmul_rn(v.x, xi), __fmul_rn(v.y, x.x)));
}

// Step 4 for `items` row items, item u = row i of frame f: its nonzeros
// are the range range(u) of the flat index e = f nnz + j (j the table's
// nonzero). The products of kThreadsFft items at a time go through the
// product buffer kChunk at a time, each computed by one thread (xat(f,
// c): X of frame f at the bin of code c); then each item's thread adds
// its own from 0 in the table's order (kSumBatch loaded at once: the adds
// form one chain a row) and store(u, magnitude) writes it.
template <class Range, class XAt, class Store>
__device__ __forceinline__ void row_sums(float2* __restrict__ prod,
                                         int items, int nnz,
                                         const int* __restrict__ index,
                                         const float2* __restrict__ vals,
                                         Range range, XAt xat, Store store) {
  for (int r0 = 0; r0 < items; r0 += kThreadsFft) {
    const int last = min(items, r0 + kThreadsFft) - 1;
    const int e_lo = range(r0).x;
    const int e_hi = range(last).y;
    const int item = r0 + threadIdx.x;
    const int2 own = item < items ? range(item) : make_int2(0, 0);
    float re = 0.f;
    float im = 0.f;
    for (int c0 = e_lo; c0 < e_hi; c0 += kChunk) {
      const int c1 = min(e_hi, c0 + kChunk);
      for (int e = c0 + threadIdx.x; e < c1; e += kThreadsFft) {
        const int f = e / nnz;
        const int c = __ldg(index + e - f * nnz);
        prod[e - c0] = product(__ldg(vals + e - f * nnz), xat(f, c), c);
      }
      __syncthreads();
      // The chain: products two at a time as float4 (the buffer starts
      // 16-byte aligned, so an even offset is), kSumBatch a batch so that
      // the loads go ahead of the adds.
      auto add = [&](float2 p) {
        re = __fadd_rn(re, p.x);
        im = __fadd_rn(im, p.y);
      };
      const int b = min(own.y, c1);
      int e = max(own.x, c0);
      if (e < b && ((e - c0) & 1)) add(prod[e++ - c0]);
      for (; e + kSumBatch <= b; e += kSumBatch) {
        const float4* p4 = reinterpret_cast<const float4*>(prod + (e - c0));
        float4 q[kSumBatch / 2];
#pragma unroll
        for (int k = 0; k < kSumBatch / 2; ++k) q[k] = p4[k];
#pragma unroll
        for (int k = 0; k < kSumBatch / 2; ++k) {
          add(make_float2(q[k].x, q[k].y));
          add(make_float2(q[k].z, q[k].w));
        }
      }
      for (; e < b; ++e) add(prod[e - c0]);
      __syncthreads();
    }
    if (item < items) {
      store(item, __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im))));
    }
  }
}

// Step 4 on one block's fpb frames t0.. (rows F, nonzeros nnz): items u =
// f F + i, frames past T included and not stored.
__device__ __forceinline__ void sums_frames(
    const float2* __restrict__ z, float2* __restrict__ prod,
    const int* __restrict__ rowptr, const int* __restrict__ index,
    const float2* __restrict__ vals, float* __restrict__ ob, int F, int nnz,
    int fpb, int log2m, long long t0, int T) {
  const int M = 1 << log2m;
  row_sums(
      prod, fpb * F, nnz, index, vals,
      [&](int u) {
        const int f = u / F;
        const int i = u - f * F;
        return make_int2(f * nnz + __ldg(rowptr + i),
                         f * nnz + __ldg(rowptr + i + 1));
      },
      [&](int f, int c) {
        const int k = c >> kCodeShift;
        return z[k < M ? pad((f << log2m) + k) : kPadded + f];
      },
      [&](int u, float mag) {
        if (t0 * F + u < (long long)T * F) ob[t0 * F + u] = mag;
      });
}

// Step 4 on a cluster of C blocks at frame t0: this block (rank, buffer
// z) takes rows [r0, r1); X[k] from z where its code says the block holds
// it, else from the block k >= H = 2^log2h holds it in.
template <int C>
__device__ __forceinline__ void sums_cluster(
    float2* z, float2* __restrict__ prod, const int* __restrict__ rowptr,
    const int* __restrict__ index, const float2* __restrict__ vals,
    float* __restrict__ ob, int F, int nnz, int r0, int r1, int log2h,
    int rank, long long t0) {
  const int H = 1 << log2h;
  row_sums(
      prod, r1 - r0, nnz, index, vals,
      [&](int u) {
        return make_int2(__ldg(rowptr + r0 + u), __ldg(rowptr + r0 + u + 1));
      },
      [&](int, int c) {
        const int k = c >> kCodeShift;
        const int pos = k < C * H ? pad(k & (H - 1)) : kPadded;
        return (c >> (1 + rank)) & 1 ? z[pos]
                                     : *block_at(z, pos, k >> log2h, rank);
      },
      [&](int u, float mag) { ob[t0 * F + r0 + u] = mag; });
}

// Grid: x = blocks (C = 2, 4: clusters of C) a batch row, each looping
// over frame groups g = blockIdx.x / C, + gridDim.x / C, ...; y = batch
// row. log2m: the block's FFT, L / (2C) points. rs1, rs2, rs3: on a
// cluster the first rows of blocks 1, 2, 3 (block C - 1 ends at F). vec:
// 8-byte signal loads.
template <int C>
__global__ void __launch_bounds__(kThreadsFft, 1)
cqt_fft_kernel(const float* __restrict__ sig, const float2* __restrict__ tw,
               const int* __restrict__ rowptr, const int* __restrict__ index,
               const float2* __restrict__ vals,
               const int* __restrict__ splits, float* __restrict__ out,
               long long sig_len, int T, int n, int step, int F, int nsplit,
               int rs1, int rs2, int rs3, int log2m, long long groups,
               bool vec) {
  extern __shared__ __align__(16) float2 smem[];
  float2* z = smem;
  float2* tws = smem + kPadded + kSideSlots;
  float2* prod = tws + kTwiddles;
  const int M = 1 << log2m;
  const int fpb = kBlockElems >> log2m;  // frames per group
  const int nnz = __ldg(rowptr + F);
  const float* sb = sig + blockIdx.y * sig_len;
  float* ob = out + (long long)blockIdx.y * T * F;
  // The passes' twiddles, once a block: W_L^2Ci = W_{L/C}^2i.
  for (int i = threadIdx.x; i < (n >> 3) / C; i += kThreadsFft) {
    tws[tpad(i)] = __ldg(tw + 2 * C * i);
  }
  __syncthreads();

  // A cluster block's rank and rows [r0, r1).
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int r0 = rank == 0 ? 0 : rank == 1 ? rs1 : rank == 2 ? rs2 : rs3;
  const int r1 = rank == C - 1 ? F : rank == 0 ? rs1 : rank == 1 ? rs2 : rs3;
  for (long long g = blockIdx.x / C; g < groups; g += gridDim.x / C) {
    const long long t0 = g * fpb;
    if constexpr (C == 1) {
      frame_fft(z, tws, log2m, sb, t0, T, step, vec, 0, 0);
      split_pairs(z, tw, splits, nsplit, fpb, log2m);
      __syncthreads();
      sums_frames(z, prod, rowptr, index, vals, ob, F, nnz, fpb, log2m, t0,
                  T);
      // Step 4 ends on a barrier: the next group may overwrite z.
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      frame_fft(z, tws, log2m, sb, t0, T, step, vec, C == 4 ? 2 : 1, rank);
      cluster.sync();  // every block's residue class transformed
      split_cross<C>(z, rank, tw, splits, nsplit, log2m);
      cluster.sync();  // every X in place
      sums_cluster<C>(z, prod, rowptr, index, vals, ob, F, nnz, r0, r1,
                      log2m, rank, t0);
      cluster.sync();  // the other blocks' reads done before the next frame
    }
  }
}

template <int C>
int launch(const float* sig, const float2* tw, const int* rowptr,
           const int* index, const float2* vals, const int* splits,
           float* out, int batch, long long sig_len, int T, int n, int step,
           int F, int nsplit, int rs1, int rs2, int rs3, bool vec,
           cudaStream_t st) {
  int log2m = 0;  // the block's FFT: L / (2 C) points
  while ((2 * C << log2m) < n) ++log2m;
  const long long groups = zt::ceil_div(T, kBlockElems >> log2m);
  void (*kernel)(const float*, const float2*, const int*, const int*,
                 const float2*, const int*, float*, long long, int, int, int,
                 int, int, int, int, int, int, long long, bool) =
      cqt_fft_kernel<C>;
  // Above 48 KB a block's shared memory is dynamic and opted into.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if constexpr (C == 1) {
    // One block an SM: the blocks of a batch row loop over its groups.
    int device = 0;
    int sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err != cudaSuccess) return (int)err;
    const long long per_row = sms / batch > 1 ? sms / batch : 1;
    const dim3 grid((unsigned)(groups < per_row ? groups : per_row), batch);
    kernel<<<grid, kThreadsFft, kSmemBytes, st>>>(
        sig, tw, rowptr, index, vals, splits, out, sig_len, T, n, step, F,
        nsplit, rs1, rs2, rs3, log2m, groups, vec);
  } else {
    // Clusters of C blocks: as many as the card schedules at once.
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(kThreadsFft, 1, 1);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    const long long per_row = clusters / batch > 1 ? clusters / batch : 1;
    cfg.gridDim =
        dim3((unsigned)(C * (groups < per_row ? groups : per_row)), batch, 1);
    err = cudaLaunchKernelEx(&cfg, kernel, sig, tw, rowptr, index, vals,
                             splits, out, sig_len, T, n, step, F, nsplit,
                             rs1, rs2, rs3, log2m, groups, vec);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sig: (batch, sig_len) float32, sig_len >= (T - 1) * step + L; tw: (L, 2)
// float32, W_L^j = (cos, sin)(-2 pi j / L) with exact quarter-turn symmetry
// (kernels/cqtfft._twiddles), 8-byte aligned; rowptr: (F + 1) int32; index:
// (nnz) int32, bin << 5 | holders << 1 | conj with bin in [0, L/2] and
// above L 32,768 holders bit r set when the cluster's block r holds X[bin]
// (kernels/cqtfft.kernel_codes); vals: (nnz) complex64 as float pairs,
// 8-byte aligned; splits: (nsplit) int32, the split list (kernels/cqtfft
// .split_list); rs1 <= rs2 <= rs3 in [0, F]: above L 32,768 the first rows
// of the cluster's blocks 1, 2 and 3 (at L 65,536 only rs1 is read; block
// C - 1 ends at F); out: (batch, T, F) float32. L a power of two from 16
// to 131,072, step >= 1, F >= 1; any other L returns cudaErrorInvalidValue
// before a launch. All contiguous.
ZT_EXPORT int zt_cqt_magnitudes_fft(const void* sig, const void* tw,
                                    const void* rowptr, const void* index,
                                    const void* vals, const void* splits,
                                    void* out, int batch, long long sig_len,
                                    int T, int L, int step, int F,
                                    int nsplit, int rs1, int rs2, int rs3,
                                    void* stream) {
  if (!cqt_fft_fits(L) || step < 1 || F < 1 || batch > 65535 ||
      nsplit < 0 || rs1 < 0 || rs1 > rs2 || rs2 > rs3 || rs3 > F ||
      !zt::aligned8(tw) || !zt::aligned8(vals)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  const float* s = static_cast<const float*>(sig);
  const float2* t = static_cast<const float2*>(tw);
  const int* r = static_cast<const int*>(rowptr);
  const int* c = static_cast<const int*>(index);
  const float2* v = static_cast<const float2*>(vals);
  const int* sp = static_cast<const int*>(splits);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = step % 2 == 0 && sig_len % 2 == 0 && zt::aligned8(sig);
  if (L > 2 * kOneBlockLength) {
    return launch<4>(s, t, r, c, v, sp, o, batch, sig_len, T, L, step, F,
                     nsplit, rs1, rs2, rs3, vec, st);
  }
  if (L > kOneBlockLength) {
    return launch<2>(s, t, r, c, v, sp, o, batch, sig_len, T, L, step, F,
                     nsplit, rs1, rs2, rs3, vec, st);
  }
  return launch<1>(s, t, r, c, v, sp, o, batch, sig_len, T, L, step, F,
                   nsplit, rs1, rs2, rs3, vec, st);
}
