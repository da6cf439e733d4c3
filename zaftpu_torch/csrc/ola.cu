// Overlap-add: y[b, r*step + j] = sum_c frames[b, r - c, c*step + j].
//
// Replaces zaftpu/pallas/ola.py: overlap_add (its Pallas kernel DMAs the K
// chunk rows of a 256-row output block into VMEM, zeroes the out-of-range
// ones, and writes each output row once).
//
// Bound: device-memory bytes, one read of the (T, WL) frames and one write
// of the signal. Design: one thread per output sample (or per 16-byte
// vector of samples, the vector lying inside one hop row), gathering its
// <= K = ceil(WL/step) contributions straight from the frames, so each
// output sample is written exactly once and no atomics are needed. Rows
// outside [0, T) and columns past WL read as zero. The contributions are
// summed c ascending, left-associated, as zaftpu/core/frame.py's
// overlap_add sums its padded chunk views, so for step | WL the result is
// bit-identical to the plain PyTorch version.
#include "common.cuh"

namespace {

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  float4 o;
  o.x = a.x + b.x;
  o.y = a.y + b.y;
  o.z = a.z + b.z;
  o.w = a.w + b.w;
  return o;
}

__global__ void __launch_bounds__(zt::kThreads)
overlap_add_vec4(const float* __restrict__ frames, float* __restrict__ out,
                 int T, int WL, int step, int K, long long out_len,
                 long long total) {
  const long long len4 = out_len >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long b = i / len4;
    const long long n = (i - b * len4) << 2;
    const long long r = n / step;
    const int j = (int)(n - r * step);
    const float* fb = frames + b * T * (long long)WL;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < K; ++c) {
      const long long t = r - c;
      const int q = c * step + j;
      if (t < 0 || t >= T || q >= WL) continue;
      acc = add4(acc, *reinterpret_cast<const float4*>(fb + t * WL + q));
    }
    *reinterpret_cast<float4*>(out + b * out_len + n) = acc;
  }
}

__global__ void __launch_bounds__(zt::kThreads)
overlap_add_scalar(const float* __restrict__ frames, float* __restrict__ out,
                   int T, int WL, int step, int K, long long out_len,
                   long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long b = i / out_len;
    const long long n = i - b * out_len;
    const long long r = n / step;
    const int j = (int)(n - r * step);
    const float* fb = frames + b * T * (long long)WL;
    float acc = 0.f;
    for (int c = 0; c < K; ++c) {
      const long long t = r - c;
      const int q = c * step + j;
      if (t < 0 || t >= T || q >= WL) continue;
      acc = acc + fb[t * WL + q];
    }
    out[i] = acc;
  }
}

}  // namespace

// frames: (batch, T, WL); out: (batch, (T - 1) * step + WL). float32,
// contiguous.
ZT_EXPORT int zt_overlap_add(const void* frames, void* out, int batch, int T,
                             int WL, int step, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = zt::ceil_div(WL, step);
  const long long out_len = (long long)(T - 1) * step + WL;
  const bool vec = WL % 4 == 0 && step % 4 == 0 && zt::aligned16(frames) &&
                   zt::aligned16(out);
  if (vec) {
    const long long total = (long long)batch * (out_len / 4);
    overlap_add_vec4<<<zt::grid_1d(total, zt::kThreads), zt::kThreads, 0,
                       st>>>(static_cast<const float*>(frames),
                             static_cast<float*>(out), T, WL, step, K,
                             out_len, total);
  } else {
    const long long total = (long long)batch * out_len;
    overlap_add_scalar<<<zt::grid_1d(total, zt::kThreads), zt::kThreads, 0,
                         st>>>(static_cast<const float*>(frames),
                               static_cast<float*>(out), T, WL, step, K,
                               out_len, total);
  }
  return (int)cudaGetLastError();
}
