// Backward of the grouping gather, in row layout:
//   out[b, clip(idx[b, s, k]), c] += g[b, s, k, c]     (out zero-filled first)
//
// Replaces: papc_tpu/ops/pallas/gather_t.py::scatter_cols_add_pallas
// (_scatter_t_kernel), the VJP of gather_cols. On the TPU the scatter is a
// product of the gradient with a one-hot on the MXU, in a channel-major
// [B, C, M] layout; the port groups in row layout [B, S, K, 3 + D], so this
// is the same function on that layout. Indices are clamped to [0, N), as
// the forward gather clamps them.
//
// What bounds it on the H100: bytes and atomic throughput. It reads the
// gradient once (SA2: 32 x 128 x 64 x 131 x 4 B = 137 MB) and adds into
// [B, N, C] f32 (SA2: 8.6 MB, which stays in L2).
//
// Design: one thread per gradient element, neighbouring threads on
// neighbouring channels (coalesced reads), f32 atomicAdd into the output.
// Atomics add in an order that changes from run to run, so the result
// matches the plain index_add_ to f32 rounding of the sums, not bitwise
// (the TPU kernel too sums in another order than XLA's scatter).
#include "common.cuh"

namespace {

__global__ void group_scatter_add_kernel(const float* __restrict__ g,
                                         const int* __restrict__ idx, int n,
                                         int s, int k, int c,
                                         long long total,
                                         float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += stride) {
    const long long row = e / c;  // flat (b, s, k)
    const int ch = static_cast<int>(e - row * c);
    const long long b = row / (static_cast<long long>(s) * k);
    int j = idx[row];
    j = j < 0 ? 0 : (j >= n ? n - 1 : j);
    atomicAdd(&out[(b * n + j) * c + ch], g[e]);
  }
}

}  // namespace

// g [B, S, K, C] f32, idx [B, S, K] i32, out [B, N, C] f32 zero-filled by
// the caller -> out += the scatter of g.
PAPC_EXPORT int papc_group_scatter_add(const float* g, const int* idx, int b,
                                       int n, int s, int k, int c, float* out,
                                       void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || k <= 0 || c <= 0)
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * s * k * c;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  return papc_launch(group_scatter_add_kernel, dim3(static_cast<int>(blocks)),
                     dim3(threads), 0, static_cast<cudaStream_t>(stream), g,
                     idx, n, s, k, c, total, out);
}
