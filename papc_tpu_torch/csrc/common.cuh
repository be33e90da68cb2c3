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

// papc_launch for a grid of thread-block clusters of `cluster` blocks
// along x (cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension;
// `non_portable` allows more than 8). A cluster of 1 is a plain launch.
template <typename... KArgs, typename... Args>
inline cudaError_t papc_launch_cluster(void (*kernel)(KArgs...), dim3 grid,
                                       dim3 block, size_t smem, int cluster,
                                       bool non_portable, cudaStream_t stream,
                                       Args... args) {
  if (cluster == 1)
    return papc_launch(kernel, grid, block, smem, stream, args...);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (non_portable) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<KArgs>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
