// The conjugate mirror and the Hermitian fold, as index kernels:
//   mirror (B11a): full[r, k] = half[r, k] for k < H, conj(half[r, n - k])
//                  for H <= k < n, with H = n/2 + 1 half-spectrum bins;
//   fold (B11b):   h[r, k] = (z[r, k] + conj(z[r, (n - k) mod n])) / 2 for
//                  k = 0..n/2, written as re and im planes.
//
// Replace zaftpu/pallas/mirror.py: mirror_full_planes (_mirror_kernel) and
// fold_half_planes (_fold_kernel). On the TPU the lane reversal of a VMEM
// tile needed a rev or an anti-identity GEMM; here it is index arithmetic,
// so any n and any row count are taken. The arithmetic is the plain
// version's (a negation; one add and one multiply by 0.5 per component,
// which nvcc cannot contract into an FMA), so both kernels are bit-equal
// to core/fft.py's index ops.
//
// Bound: device memory. At the 600-s STFT shape (T 25,841, n 2048) the
// mirror reads 212 MB and writes 423 MB, the fold the reverse. Design: one
// thread per output element along the row, rows on grid y with a stride
// loop, so no division per element; consecutive threads read and write
// consecutive bins (the mirrored half reads them in reverse, from the same
// lines). The fold takes the strided frames-major view that synthesis_ola
// hands it, so a bins-major spectrum is read in place, uncoalesced.
#include "common.cuh"

namespace {

constexpr int kRowsPerGrid = 65535;  // CUDA's limit on grid y

__global__ void __launch_bounds__(zt::kThreads)
mirror_kernel(const float2* __restrict__ half, float2* __restrict__ full,
              long long rows, int H, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const bool direct = k < H;
  const int src = direct ? k : n - k;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    float2 v = half[r * H + src];
    if (!direct) v.y = -v.y;
    full[r * n + k] = v;
  }
}

// z: rows of n complex64 values at z + b * sb + t * st + k * sk (in
// complex elements) for row r = b * T + t; hr, hi: (rows, n/2 + 1).
__global__ void __launch_bounds__(zt::kThreads)
fold_kernel(const float2* __restrict__ z, float* __restrict__ hr,
            float* __restrict__ hi, long long rows, int T, int n,
            long long sb, long long st, long long sk) {
  const int H = n / 2 + 1;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= H) return;
  const int m = k == 0 ? 0 : n - k;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long b = r / T;
    const float2* zr = z + b * sb + (r - b * T) * st;
    const float2 a = zr[k * sk];
    const float2 c = zr[m * sk];
    hr[r * H + k] = 0.5f * (a.x + c.x);
    hi[r * H + k] = 0.5f * (a.y - c.y);
  }
}

dim3 grid_for(long long rows, int cols) {
  return dim3(zt::ceil_div(cols, zt::kThreads),
              (unsigned)(rows < kRowsPerGrid ? (rows > 0 ? rows : 1)
                                             : kRowsPerGrid));
}

}  // namespace

// half: (rows, n/2 + 1) complex64, full: (rows, n) complex64; contiguous.
ZT_EXPORT int zt_mirror_full(const void* half, void* full, long long rows,
                             int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int H = n / 2 + 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mirror_kernel<<<grid_for(rows, n), zt::kThreads, 0, st>>>(
      static_cast<const float2*>(half), static_cast<float2*>(full), rows, H,
      n);
  return (int)cudaGetLastError();
}

// z: (batch, T, n) complex64 with element strides (sb, st, sk); hr, hi:
// (batch * T, n/2 + 1) float32, contiguous.
ZT_EXPORT int zt_fold_half(const void* z, void* hr, void* hi, long long rows,
                           int T, int n, long long sb, long long st,
                           long long sk, void* stream) {
  if (n < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fold_kernel<<<grid_for(rows, n / 2 + 1), zt::kThreads, 0, s>>>(
      static_cast<const float2*>(z), static_cast<float*>(hr),
      static_cast<float*>(hi), rows, T, n, sb, st, sk);
  return (int)cudaGetLastError();
}
