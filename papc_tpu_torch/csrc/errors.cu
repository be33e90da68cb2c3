// Error text for the codes the kernel entry points return.
#include "common.cuh"

PAPC_EXPORT const char* papc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
