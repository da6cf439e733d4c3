// MDCT analysis and IMDCT synthesis + overlap-add by a quarter-length
// complex FFT, the frames never stored. With N the window length, F = N/2,
// Q = N/4 and n0 = (F + 1)/2:
//   mdct:  X[b, t, k] = sum_{n<N} w[n] x[b, t F + n]
//                    cos(2 pi/N (n + n0)(k + 1/2))
//   imdct: y[b, p] = sum_t s w[p - t F] sum_{k<F} X[b, t, k]
//                    cos(2 pi/N (p - t F + n0)(k + 1/2)),  s = 2/F,
// over the frames t with 0 <= p - t F < N (two per sample), the
// (batch, T F + F) signal before the reference's trim. N a multiple of 4
// from 32 to 4096 with no prime factor above 127 in Q (kernels/mdct.py:
// fits): 724 lengths.
//
// Replaces zaftpu/pallas/fused.py: _frames_matmul_impl as frames_op reaches
// it with the MDCT operator (B2) and its _kernel_split4 (B2-s4), and
// zaftpu/pallas/synth.py: _gemm_ola_impl as imdct_ola reaches it (B7) and
// its _kernel_split4 (B7-s4), on both dials at those window lengths;
// fused.cu and synth.cu keep every other length, an explicit operator and
// ZAFTPU_FFT=matmul (kernels/mdct.py states the rule). The TPU kernels
// contract each frame with a dense (N, F) operator: 2 N F FLOP a frame. The
// fast MDCT does a Q-point FFT (about 5 Q log2 Q FLOP at a smooth Q) plus
// the fold, the twiddles and the window, which leaves both kernels bound by
// their bytes: the signal read once and the coefficients written once (or
// the reverse), 0.063 ms at the 600-s WL 2048 shape on an H100 (3.35 TB/s).
//
// The DCT-IV of F values v by a Q-point FFT: z[j] = (v[2j] + i v[F-1-2j])
// pre[j], Z = FFT_Q(z), Y[k] = Z[k] post[k], v's DCT-IV d[2k] = Re Y[k],
// d[F-1-2k] = -Im Y[k], with pre[j] = exp(-i pi j / F) and post[k] =
// exp(-i pi (k + 1/4) / F) in one host table (tw: pre then post, float64
// math rounded once to float32). The MDCT is the DCT-IV of the fold v[j] =
// -(u[3Q-1-j] + u[3Q+j]), v[Q+j] = u[j] - u[2Q-1-j] (j < Q) of the windowed
// frame u; the IMDCT frame is the DCT-IV d of the coefficients unfolded by
// the TDAC symmetries, y[j] = d[Q+j] (j < Q), -d[3Q-1-j] (Q <= j < 3Q),
// -d[j-3Q] (j >= 3Q), times the window scaled by 2/F (one float32 table).
// The Q-point FFT is the static real FFT's at window N/2 (zt::static_plan(N
// / 2): its plan, fpb = 2048 / Q rows a block, and the table
// kernels/rfft.kernel_tables(N / 2), W_{N/2} then the passes' tables). Every
// product and sum is an explicitly rounded intrinsic in the plain versions'
// order (kernels/mdct.py), so the kernels equal them bit for bit.
//
// Design, on stockham.cuh's register steps (zt::fft_steps), as rfft.cu and
// irfft.cu run them:
//  - Forward (mdct_kernel): a 256-thread block transforms fpb consecutive
//    frames of one batch row (four at WL 2048). The first step reads each
//    packed value straight from the signal into registers (Folded: four
//    windowed samples, the fold and the pre-twiddle), so no sweep writes
//    the folded frames to shared memory first; a plan whose first pass is
//    a prime above 7 stores them first. Where it costs no step the first
//    pass is a step of its own (zt_mdct_fft), so the reads spread over
//    every thread. After the steps a thread takes
//    bins k and Q-1-k of a frame and writes X[2k] = Re Y[k] and X[2k+1] =
//    -Im Y[Q-1-k] as one 8-byte store, only the halves of the post-twiddle
//    products it stores: a warp writes 256 contiguous bytes.
//  - Inverse (imdct_ola_kernel): as irfft.cu's irfft_kernel, a block owns
//    `span` output samples of one row (zt::span_for: a multiple of the hop
//    F chosen by waves of blocks, 7 hops at WL 2048, whose 8 frames fill 2
//    groups of 4) in a shared-memory accumulator and transforms the frames
//    that reach them fpb at a time, from the highest frame down, the first
//    step reading the coefficient pairs (c[2j], c[F-1-2j]) times pre[j]
//    into registers (Coeffs), each group's first step writing the buffer
//    the group before left free. After the steps one in-place sweep turns
//    each row into its DCT-IV in natural order (unfold_rows: the
//    post-twiddle once a value), and the overlap-add (add_frames) takes
//    each output sample's two terms, the higher frame's first, as one value
//    of d each with its sign and window, frame and position from a Divmod
//    quotient (no runtime division). Each output sample is written once,
//    coalesced, with no atomics and nothing carried between blocks. On an
//    H100 the sweep ran 0.93 times as long as the post-twiddle applied in
//    the overlap-add's reads (four times a value), and the two explicit
//    terms 0.91 times as long as a loop down the frames (PERF.md).
// Shared memory: the two padded FFT buffers (34.8 KB), the plan and the
// primes' cos/sin table, plus the inverse's accumulator (28 KB at WL 2048,
// at most 32 KB, dynamic). REG: the plan has a prime pass from 11 to
// zt::kRegPrime (WL 1,100: Q 275 = 5^2 11), a kernel of its own so the
// other plans keep their registers.
#include "stockham.cuh"

namespace {

// The plan of the Q-point FFT at an N in [32, 4096], a multiple of 4 whose
// quarter Q has no prime factor above kMaxPrime, or false.
bool mdct_plan(int n, zt::StaticPlan* plan) {
  return n % 4 == 0 && n <= 2 * zt::kElems && zt::static_plan(n / 2, plan);
}

// The forward's first-step source (zt::Frames' role in rfft.cu): row f is
// frame t0 + f of the batch row at sig (zeros from T on), its values z[j] =
// (v[2j] + i v[F-1-2j]) pre[j], v the fold of the windowed frame u, read as
// v[2j] = -(u[3Q-1-2j] + u[3Q+2j]) and v[F-1-2j] = u[Q-1-2j] - u[Q+2j] for
// 2j < Q, else v[2j] = u[2j-Q] - u[3Q-1-2j] and v[F-1-2j] = -(u[Q+2j] +
// u[5Q-1-2j]): four samples a value, two of them at the same offsets in
// both halves.
struct Folded {
  const float* sig;
  const float* win;
  const float2* pre;
  long long t0;
  int T, Q;

  __device__ __forceinline__ float u(const float* x, int i) const {
    return __fmul_rn(__ldg(x + i), __ldg(win + i));
  }

  template <int R>
  __device__ __forceinline__ void load(int f, int g, int G,
                                       float2 (&v)[R]) const {
    const long long t = t0 + f;
    if (t >= T) {
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = make_float2(0.f, 0.f);
      return;
    }
    const float* x = sig + t * (2 * Q);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = g + i * G;
      const bool lo = 2 * j < Q;
      const float c = u(x, 3 * Q - 1 - 2 * j);
      const float d = u(x, lo ? 3 * Q + 2 * j : 2 * j - Q);
      const float e = u(x, Q + 2 * j);
      const float h = u(x, lo ? Q - 1 - 2 * j : 5 * Q - 1 - 2 * j);
      const float re = lo ? -__fadd_rn(c, d) : __fsub_rn(d, c);
      const float im = lo ? __fsub_rn(h, e) : -__fadd_rn(e, h);
      v[i] = zt::cmul(make_float2(re, im), __ldg(pre + j));
    }
  }
};

// tw: the pre-twiddles, then the post-twiddles (Q each); tab: W_{N/2}, then
// the passes' tables (kernels/rfft.kernel_tables(N / 2)); plan: the Q-point
// FFT's (mdct_plan).
template <bool REG>
__global__ void __launch_bounds__(zt::kThreads, 4)
mdct_kernel(const float* __restrict__ sig, const float* __restrict__ win,
            const float2* __restrict__ tw, const float2* __restrict__ tab,
            float* __restrict__ out, long long sig_len, int T,
            zt::StaticPlan plan) {
  __shared__ __align__(16) float2 buf[2][zt::kPadElems];
  __shared__ zt::StaticPlan sp;
  __shared__ float2 cs[zt::kMaxPrimes * zt::kRegPrime];
  const int Q = plan.m;
  const int fpb = plan.fpb;  // frames per block
  const long long t0 = (long long)blockIdx.x * fpb;
  const Folded fr{sig + blockIdx.y * sig_len, win, tw, t0, T, Q};
  const float2* z = buf[zt::static_fft<REG>(buf, sp, cs, plan, tab, fr)];

  // X[2k] = Re Y[k] and X[2k+1] = X[F-1-2k'] = -Im Y[k'], k' = Q-1-k,
  // Y = Z post: a float2 store a thread.
  const float2* post = tw + Q;
  for (int e = threadIdx.x; e < fpb * Q; e += blockDim.x) {
    const int f = plan.by_m.div(e);
    const int k = e - f * Q;
    const long long t = t0 + f;
    if (t >= T) continue;
    const float2 a = z[zt::pad(f * Q + k)];
    const float2 b = z[zt::pad(f * Q + Q - 1 - k)];
    const float2 wa = __ldg(post + k);
    const float2 wb = __ldg(post + Q - 1 - k);
    const float re = __fsub_rn(__fmul_rn(a.x, wa.x), __fmul_rn(a.y, wa.y));
    const float im = __fadd_rn(__fmul_rn(b.x, wb.y), __fmul_rn(b.y, wb.x));
    reinterpret_cast<float2*>(out)[((long long)blockIdx.y * T + t) * Q + k] =
        make_float2(re, -im);
  }
}

// The inverse's first-step source (irfft.cu's Rows' role): row f holds
// frame top - f from the block's first frame, whose coefficients start at
// c (row stride F), zeros past the first frame: z[j] = (c[2j] + i
// c[F-1-2j]) pre[j].
struct Coeffs {
  const float* c;
  const float2* pre;
  int F, top;

  template <int R>
  __device__ __forceinline__ void load(int f, int g, int G,
                                       float2 (&v)[R]) const {
    const int u = top - f;
    if (u < 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = make_float2(0.f, 0.f);
      return;
    }
    const float* r = c + (long long)u * F;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = g + i * G;
      v[i] = zt::cmul(make_float2(__ldg(r + 2 * j), __ldg(r + F - 1 - 2 * j)),
                      __ldg(pre + j));
    }
  }
};

// In place, each of the group's first `rows` rows of z (padded, Q values
// a row: Z = FFT_Q) becomes the DCT-IV d of its frame's coefficients in
// natural order, value k holding (d[2k], d[2k+1]): d[2k] = Re Y[k] and
// d[F-1-2k] = -Im Y[k], Y = Z post. A work item takes values k and Q-1-k
// of a row, which hold each other's odd halves (d[2k+1] = -Im Y[Q-1-k]);
// the middle value of an odd Q is its own partner. by_h divides by (Q +
// 1) / 2.
__device__ __forceinline__ void unfold_rows(float2* z,
                                            const float2* __restrict__ post,
                                            int Q, int rows,
                                            zt::Divmod by_h) {
  const int H = (Q + 1) / 2;
  for (int e = threadIdx.x; e < rows * H; e += blockDim.x) {
    const int f = by_h.div(e);
    const int k = e - f * H;
    const int k2 = Q - 1 - k;
    const float2 a = zt::cmul(z[zt::pad(f * Q + k)], __ldg(post + k));
    const float2 b = zt::cmul(z[zt::pad(f * Q + k2)], __ldg(post + k2));
    z[zt::pad(f * Q + k)] = make_float2(a.x, -b.y);
    z[zt::pad(f * Q + k2)] = make_float2(b.x, -a.y);
  }
}

// d[m] of the frame in the row at base of z, after unfold_rows.
__device__ __forceinline__ float d_at(const float2* z, int base, int m) {
  return reinterpret_cast<const float*>(z)[2 * zt::pad(base + (m >> 1)) +
                                           (m & 1)];
}

// Adds the group's frames u_end < u <= ug, frame u in row ug - u of z
// (after unfold_rows), into the accumulator at the samples they reach, q
// in [max(q0, (u_end + 1) F), min(q0 + len, ug F + N)), acc holding sample
// q at q - q0. At hop F = N/2 sample q = r F + j (j < F) takes frame r's
// sample j, then frame r - 1's sample F + j (the higher frame first), each
// d[m] of the unfold times its sign and win (the window times 2/F): frame
// sample j < Q is d[Q + j], Q <= j < 3Q is -d[3Q-1-j], j >= 3Q is
// -d[j - 3Q].
__device__ __forceinline__ void add_frames(float* acc, const float2* z,
                                           const float* __restrict__ win,
                                           int Q, int ug, int u_end, int q0,
                                           int len, zt::Divmod by_f) {
  const int F = 2 * Q;
  const int lo = max(q0, (u_end + 1) * F);
  const int hi = min(q0 + len, (ug + 2) * F);
  for (int q = lo + threadIdx.x; q < hi; q += blockDim.x) {
    const int r = by_f.div(q);
    const int j = q - r * F;
    const bool first = j < Q;
    float v = acc[q - q0];
    if (r <= ug) {
      const float d = d_at(z, (ug - r) * Q, first ? Q + j : 3 * Q - 1 - j);
      v = __fadd_rn(v, __fmul_rn(first ? d : -d, __ldg(win + j)));
    }
    if (r - 1 > u_end) {
      const float d = d_at(z, (ug - r + 1) * Q, first ? Q - 1 - j : j - Q);
      v = __fadd_rn(v, __fmul_rn(-d, __ldg(win + F + j)));
    }
    acc[q - q0] = v;
  }
}

// Blocks of imdct_ola_kernel an SM holds: its launch bounds, and
// span_for's.
constexpr int kBlocksPerSm = 3;

// A block owns `span` output samples of one batch row (grid x; the batch on
// grid y) and transforms the frames that reach them fpb at a time, from the
// highest frame down (add_frames after each group, no barrier: the next
// group's first step writes the other buffer). win: the window times 2/F;
// tw and tab as for mdct_kernel; by_f and by_h divide by F and (Q + 1) / 2.
template <bool REG>
__global__ void __launch_bounds__(zt::kThreads, kBlocksPerSm)
imdct_ola_kernel(const float* __restrict__ coeffs,
                 const float* __restrict__ win, const float2* __restrict__ tw,
                 const float2* __restrict__ tab, float* __restrict__ out,
                 int T, long long out_len, int span, zt::Divmod by_f,
                 zt::Divmod by_h, zt::StaticPlan plan) {
  extern __shared__ float acc[];  // span floats
  __shared__ __align__(16) float2 buf[2][zt::kPadElems];
  __shared__ zt::StaticPlan sp;
  __shared__ float2 cs[zt::kMaxPrimes * zt::kRegPrime];
  const int Q = plan.m;
  const int F = 2 * Q;
  const int G = plan.fpb;  // frames per group
  const long long p0 = (long long)blockIdx.x * span;
  const int len = (int)min((long long)span, out_len - p0);
  const long long t_top = min((p0 + len - 1) / F, (long long)T - 1);
  const long long t_lo = zt::first_frame(p0, 2 * F, F);
  // Block-relative positions and frames: sample q = p - t_lo F of relative
  // frame u = t - t_lo.
  const int q0 = (int)(p0 - t_lo * F);
  Coeffs rows{coeffs + ((long long)blockIdx.y * T + t_lo) * F, tw, F, 0};

  if (threadIdx.x == 0) sp = plan;
  zt::prime_table<REG>(cs, plan, tab);
  for (int e = threadIdx.x; e < len; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();

  int cur = 1;
  for (int ug = (int)(t_top - t_lo); ug >= 0; ug -= G) {
    rows.top = ug;
    cur = zt::fft_steps<REG>(buf, sp, cs, plan, tab, rows, cur ^ 1);
    unfold_rows(buf[cur], tw + Q, Q, min(G, ug + 1), by_h);
    __syncthreads();
    add_frames(acc, buf[cur], win, Q, ug, max(ug - G, -1), q0, len, by_f);
  }
  __syncthreads();

  float* ob = out + blockIdx.y * out_len + p0;
  for (int e = threadIdx.x; e < len; e += blockDim.x) ob[e] = acc[e];
}

}  // namespace

// sig: (batch, sig_len) with sig_len >= (T + 1) N/2; win: (N,); tw: (2, N/4,
// 2) float32, the pre- and post-twiddles as (cos, sin); tab:
// kernels/rfft.kernel_tables(N/2), W_{N/2}^j = (cos, sin)(-4 pi j / N), j <
// N/2, then the Q-point FFT's per-pass tables; out: (batch, T, N/2)
// float32. All contiguous, tw, tab and out 8-byte aligned. N as in
// mdct_plan, batch at most 65535; anything else returns
// cudaErrorInvalidValue before a launch.
ZT_EXPORT int zt_mdct_fft(const void* sig, const void* win, const void* tw,
                          const void* tab, void* out, int batch,
                          long long sig_len, int T, int N, void* stream) {
  zt::StaticPlan plan;
  if (!mdct_plan(N, &plan) || batch > 65535 || !zt::aligned8(tw) ||
      !zt::aligned8(tab) || !zt::aligned8(out)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  // The first pass a step of its own where that costs no step (WL 2048:
  // (4), (4, 4), (4, 2) for (4, 4), (4, 4), (4, 2)), so the first step,
  // which reads the signal, has a group for every thread of the block, not
  // one for every second (on an H100 0.84 times as long at WL 2048; the
  // inverse's first step gained nothing from it: PERF.md).
  zt::StaticPlan single;
  if (zt::static_plan(N / 2, &single, true) && single.steps <= plan.steps) {
    plan = single;
  }
  const dim3 grid(zt::ceil_div(T, plan.fpb), batch);
  auto kernel = plan.cs ? mdct_kernel<true> : mdct_kernel<false>;
  kernel<<<grid, zt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sig), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<const float2*>(tab),
      static_cast<float*>(out), sig_len, T, plan);
  return (int)cudaGetLastError();
}

// coeffs: (batch, T, N/2) float32; win: (N,) float32, the window times 2/F;
// tw, tab as for zt_mdct_fft; out: (batch, (T + 1) N/2) float32. All
// contiguous. N as in mdct_plan and batch at most 65535; anything else
// returns cudaErrorInvalidValue before a launch. T = 0 returns after the
// checks and writes nothing: the wrapper returns the N/2 zeros itself.
ZT_EXPORT int zt_imdct_ola_fft(const void* coeffs, const void* win,
                               const void* tw, const void* tab, void* out,
                               int batch, int T, int N, void* stream) {
  zt::StaticPlan plan;
  if (!mdct_plan(N, &plan) || batch > 65535 || !zt::aligned8(tw) ||
      !zt::aligned8(tab)) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || batch <= 0) return (int)cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  const int F = N / 2;
  const long long out_len = (long long)(T + 1) * F;
  const int span = zt::span_for(N, F, plan.fpb, out_len, batch,
                                (long long)sms * kBlocksPerSm);
  const int smem = span * (int)sizeof(float);
  auto kernel = plan.cs ? imdct_ola_kernel<true> : imdct_ola_kernel<false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((out_len + span - 1) / span), batch);
  kernel<<<grid, zt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<const float2*>(tab),
      static_cast<float*>(out), T, out_len, span, zt::make_divmod(F),
      zt::make_divmod((N / 4 + 1) / 2), plan);
  return (int)cudaGetLastError();
}
