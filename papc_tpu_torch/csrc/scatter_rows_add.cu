// Row scatter-add, the backward of the flat row gather (index_points):
//   out[b, idx[b, r], c] += g[b, r, c]      for 0 <= idx[b, r] < n_rows
// An index outside [0, n_rows) contributes nothing (out zero-filled first).
//
// Replaces: papc_tpu/ops/pallas/scatter.py::scatter_rows_add_pallas
// (_scatter_kernel). On the TPU the sum is a product of a transposed
// one-hot with the gradient tile on the MXU, and the index tile is padded
// with -1, which matches no row: that is where "out of range contributes
// nothing" comes from, and this kernel keeps it. (The grouping gather's
// backward, group_scatter_add.cu, clamps instead, as its forward does.)
//
// What bounds it on the H100: bytes and atomic throughput. It reads the
// gradient once (MSG classification's SA2 branches: 32 x 128 x (32 + 64 +
// 128) rows of 323 f32, 1.19 GB a step) and adds into [B, n_rows, C] f32
// (32 x 512 x 323 x 4 B = 21 MB, which stays in L2).
//
// Design: one thread per gradient element, grid-stride, neighbouring
// threads on neighbouring channels (coalesced reads), f32 atomicAdd into
// the output. Ball-query padding repeats a group's first index up to K-1
// times, so those rows take many adds each; they spread over channels and
// over the rows of other groups. The adds land in an order that changes
// from run to run, so the result matches the plain index_add_ to f32
// rounding of the sums (the TPU kernel too sums in another order than
// XLA's scatter).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void scatter_rows_add_kernel(const T* __restrict__ g,
                                        const int* __restrict__ idx, int r,
                                        int c, int n_rows, long long total,
                                        float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += stride) {
    const long long row = e / c;  // flat (b, r)
    const int j = idx[row];
    if (j < 0 || j >= n_rows) continue;
    const int ch = static_cast<int>(e - row * c);
    const long long b = row / r;
    atomicAdd(&out[(b * n_rows + j) * c + ch], as_f32(g[e]));
  }
}

}  // namespace

// g [B, R, C] f32 (g_bf16 = 0) or bf16 (g_bf16 = 1), idx [B, R] i32, out
// [B, n_rows, C] f32 zero-filled by the caller -> out += the scatter of g.
PAPC_EXPORT int papc_scatter_rows_add(const void* g, int g_bf16,
                                      const int* idx, int b, int r, int c,
                                      int n_rows, float* out, void* stream) {
  if (b <= 0 || r <= 0 || c <= 0 || n_rows <= 0) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * r * c;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  const auto s = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    return papc_launch(scatter_rows_add_kernel<__nv_bfloat16>,
                       dim3(static_cast<int>(blocks)), dim3(threads), 0, s,
                       static_cast<const __nv_bfloat16*>(g), idx, r, c, n_rows,
                       total, out);
  return papc_launch(scatter_rows_add_kernel<float>,
                     dim3(static_cast<int>(blocks)), dim3(threads), 0, s,
                     static_cast<const float*>(g), idx, r, c, n_rows, total,
                     out);
}
