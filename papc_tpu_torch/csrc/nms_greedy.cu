// Greedy NMS sweep over a precomputed IoU matrix, one thread block per
// frame:
//   keep = valid; for i in 0..K-1: if keep[i]: keep[j] = 0 for every
//   j > i with iou[i, j] > threshold.
//
// Replaces: papc_tpu/ops/pallas/nms.py::greedy_suppress_pallas
// (_greedy_kernel), which holds the padded [K, K] overlap matrix in
// VMEM and so serves K <= 1408 only.
//
// What bounds it on the H100: the chain of K dependent iterations. The
// bytes are one read of the matrix (4 MB a frame at K = 1000, 1.2 us at
// 3.35 TB/s) and the operations one compare a pair; each iteration
// ends at a block barrier, and a kept row's read waits on the memory
// latency of its first bytes.
//
// Design: the keep flags (one byte a box) live in shared memory; the
// matrix stays in device memory and L2, so K is limited only by the
// flags (227 KB). Iteration i starts at a barrier, reads keep[i]
// (uniform across the block) and, when it is set, thread t reads row i
// at columns i+1+t, i+1+t+blockDim, ... (coalesced) and clears the
// flags it exceeds. Writes in iteration i touch only j > i, and
// keep[i+1] is read after the next barrier, so one barrier an
// iteration suffices. A suppressed box never suppresses, as in the
// JAX sweep.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
    nms_greedy_kernel(const float* __restrict__ iou,
                      const bool* __restrict__ valid, int k, float thr,
                      bool* __restrict__ keep_out) {
  extern __shared__ unsigned char keep[];
  const int b = blockIdx.x;
  const float* m = iou + static_cast<size_t>(b) * k * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    keep[j] = valid[static_cast<size_t>(b) * k + j] ? 1 : 0;
  for (int i = 0; i < k; ++i) {
    __syncthreads();
    if (!keep[i]) continue;  // uniform: every thread reads the same flag
    const float* row = m + static_cast<size_t>(i) * k;
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x)
      if (keep[j] && row[j] > thr) keep[j] = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    keep_out[static_cast<size_t>(b) * k + j] = keep[j] != 0;
}

}  // namespace

// iou [B, K, K] f32, valid [B, K] bool -> keep [B, K] bool.
PAPC_EXPORT int papc_nms_greedy(const float* iou, const bool* valid, int b,
                                int k, float thr, bool* keep, void* stream) {
  if (b <= 0 || k <= 0) return cudaErrorInvalidValue;
  const int threads = k >= 1024 ? 1024 : ((k + 31) / 32) * 32;
  return papc_launch(nms_greedy_kernel, dim3(b), dim3(threads),
                     static_cast<size_t>(k), static_cast<cudaStream_t>(stream),
                     iou, valid, k, thr, keep);
}
