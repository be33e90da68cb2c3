// Backward of the grouping gather, in row layout:
//   out[b, j, c] = sum of g[b, s, k, c] over the entries (s, k) with
//                  clip(idx[b, s, k]) == j            (0 where none has j)
//
// Replaces: papc_tpu/ops/pallas/gather_t.py::scatter_cols_add_pallas
// (_scatter_t_kernel), the VJP of gather_cols. On the TPU the scatter is a
// product of the gradient with a one-hot on the MXU, in a channel-major
// [B, C, M] layout; the port groups in row layout [B, S, K, 3 + D], so this
// is the same function on that layout. Indices are clamped to [0, N), as
// the forward gather clamps them.
//
// What bounds it on the H100: bytes. It reads the gradient once (SA2: 32 x
// 128 x 64 x 131 x 4 B = 137 MB, half of it in bf16) and idx (1 MB), and
// writes [B, N, C] once (SA2: 8.6 MB, or 4.3 MB in bf16).
//
// Design: the owners of an output row compute it, in two launches behind
// the one entry point, on the bodies in scatter_sorted.cuh (the plan is
// ops/kernels/gather.py::scatter_add_plan): a stable counting sort of
// each cloud's entries by their clamped point (inverse_index_kernel), then
// a sum that splits each block's rows' lists evenly over its workers and
// writes every row once (scatter_sum_kernel). No atomics on the output
// and no memset: two calls give the same bits.
//
// bf16 (the bf16 training step; the TPU kernel's bf16 branch multiplies a
// bf16 g into an f32 accumulator, papc_tpu/ops/pallas/gather_t.py:100-101,
// and the VJP casts the sum to the source's dtype): g is read as bf16 raw
// bits and widened exactly at the add, each point's sum is taken in f32 in
// the same fixed order, and the row is rounded once to bf16. The inverse
// index does not depend on the dtype.
#include "scatter_sorted.cuh"

namespace {

__global__ void __launch_bounds__(1024)
    inverse_index_kernel(const int* __restrict__ idx, int n, int entries,
                         int* __restrict__ offsets, int* __restrict__ order) {
  sorted::inverse_index<false>(idx, n, entries, offsets, order);
}

// g and out in one type T (f32 or bf16), the sums in f32.
template <int L, int CH, typename T>
__global__ void __launch_bounds__(sorted::kSumThreads)
    scatter_sum_kernel(const T* __restrict__ g,
                       const int* __restrict__ offsets,
                       const int* __restrict__ order, int n, int entries,
                       int c, T* __restrict__ out) {
  sorted::scatter_sum<L, CH, T, T>(g, offsets, order, n, entries, c, out);
}

template <typename T>
struct Sum {
  template <int L, int CH>
  struct At {
    static cudaError_t launch(dim3 grid, cudaStream_t stream, const T* g,
                              const int* offsets, const int* order, int n,
                              int entries, int c, T* out) {
      return papc_launch(scatter_sum_kernel<L, CH, T>, grid,
                         dim3(sorted::kSumThreads), 0, stream, g, offsets,
                         order, n, entries, c, out);
    }
  };
};

}  // namespace

// g [B, S, K, C] and out [B, N, C] both f32 (bf16 = 0) or both bf16 (bf16
// = 1), idx [B, S, K] i32; every row of out written. Scratch: offsets [B,
// N + 1] and order [B, S * K] i32, both written here (the inverse index).
// warps: the index kernel's warps a cloud (shared memory (warps * N + N +
// 32) * 4 bytes); lanes (4, 8, 16 or 32; 32 with chans > 1) and chans
// (1-8): the sum kernel's lanes a row and channels a lane.
PAPC_EXPORT int papc_group_scatter_add(const void* g, int bf16,
                                       const int* idx, int b, int n, int s,
                                       int k, int c, int warps, int lanes,
                                       int chans, int* offsets, int* order,
                                       void* out, void* stream) {
  if (s <= 0 || k <= 0) return cudaErrorInvalidValue;
  const long long entries = static_cast<long long>(s) * k;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return sorted::launch<Sum<__nv_bfloat16>::At>(
        inverse_index_kernel, static_cast<const __nv_bfloat16*>(g), idx, b, n,
        entries, c, warps, lanes, chans, offsets, order,
        static_cast<__nv_bfloat16*>(out), st);
  return sorted::launch<Sum<float>::At>(
      inverse_index_kernel, static_cast<const float*>(g), idx, b, n, entries,
      c, warps, lanes, chans, offsets, order, static_cast<float*>(out), st);
}
