// Error text for the codes the kernel entry points return.
#include "common.cuh"

PT_EXPORT const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
