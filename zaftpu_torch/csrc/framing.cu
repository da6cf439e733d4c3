// Frame + window: out[b, t, w] = sig[b, t*step + w] * win[w].
//
// Replaces zaftpu/pallas/framing.py: frame_window (its Pallas kernel DMAs
// the overlapping signal rows of a 256-frame block into VMEM and writes the
// K windowed sub-blocks). Any step <= WL is taken here, not only step | WL.
//
// Bound: device-memory bytes. Each frame sample is one multiply, and the
// output is WL/step times the signal's size, so the write of the frame
// matrix is the cost. Design: one thread per 16-byte vector of w, adjacent
// threads on adjacent addresses, so loads and stores are coalesced 16-byte
// transactions; the overlapping signal reads are served from L2. A scalar
// twin takes pointers or strides that are not 16-byte aligned. The product
// is a single f32 multiply, so the result is bit-identical to the plain
// PyTorch version.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(zt::kThreads)
frame_window_vec4(const float* __restrict__ sig, const float* __restrict__ win,
                  float* __restrict__ out, long long sig_len, int T, int WL,
                  int step, long long total) {
  const int wl4 = WL >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / wl4;  // b * T + t
    const int w = (int)(i - row * wl4) << 2;
    const long long b = row / T;
    const long long t = row - b * T;
    const float4 s = *reinterpret_cast<const float4*>(
        sig + b * sig_len + t * step + w);
    const float4 v = *reinterpret_cast<const float4*>(win + w);
    float4 o;
    o.x = s.x * v.x;
    o.y = s.y * v.y;
    o.z = s.z * v.z;
    o.w = s.w * v.w;
    *reinterpret_cast<float4*>(out + row * WL + w) = o;
  }
}

__global__ void __launch_bounds__(zt::kThreads)
frame_window_scalar(const float* __restrict__ sig,
                    const float* __restrict__ win, float* __restrict__ out,
                    long long sig_len, int T, int WL, int step,
                    long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / WL;
    const int w = (int)(i - row * WL);
    const long long b = row / T;
    const long long t = row - b * T;
    out[i] = sig[b * sig_len + t * step + w] * win[w];
  }
}

}  // namespace

// sig: (batch, sig_len) with sig_len >= (T - 1) * step + WL; win: (WL,);
// out: (batch, T, WL). All float32, contiguous.
ZT_EXPORT int zt_frame_window(const void* sig, const void* win, void* out,
                              int batch, long long sig_len, int T, int WL,
                              int step, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = WL % 4 == 0 && step % 4 == 0 && sig_len % 4 == 0 &&
                   zt::aligned16(sig) && zt::aligned16(win) &&
                   zt::aligned16(out);
  const long long rows = (long long)batch * T;
  if (vec) {
    const long long total = rows * (WL / 4);
    frame_window_vec4<<<zt::grid_1d(total, zt::kThreads), zt::kThreads, 0,
                        st>>>(static_cast<const float*>(sig),
                              static_cast<const float*>(win),
                              static_cast<float*>(out), sig_len, T, WL, step,
                              total);
  } else {
    const long long total = rows * WL;
    frame_window_scalar<<<zt::grid_1d(total, zt::kThreads), zt::kThreads, 0,
                          st>>>(static_cast<const float*>(sig),
                                static_cast<const float*>(win),
                                static_cast<float*>(out), sig_len, T, WL,
                                step, total);
  }
  return (int)cudaGetLastError();
}
