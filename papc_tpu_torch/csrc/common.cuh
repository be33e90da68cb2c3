// Shared helpers of the papc_tpu_torch kernel library.
//
// Every exported entry point has C linkage, launches on the stream it
// is given, allocates nothing, and returns the cudaError_t of its
// launch (0 on success); the Python wrapper raises on anything else.
#pragma once

#include <cuda_runtime.h>

#define PAPC_EXPORT extern "C" __attribute__((visibility("default")))

// Opt a kernel into more than 48 KB of dynamic shared memory, launch
// it, and report the launch's error (a refused launch never runs, and
// a later synchronize would not report it).
template <typename Kernel, typename... Args>
inline cudaError_t papc_launch(Kernel kernel, dim3 grid, dim3 block,
                               size_t smem, cudaStream_t stream,
                               Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}
