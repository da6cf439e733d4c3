// Error text for the codes the launch entry points return.
#include "common.cuh"

ZT_EXPORT const char* zt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
