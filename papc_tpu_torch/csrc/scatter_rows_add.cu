// Row scatter-add, the backward of the flat row gather (index_points):
//   out[b, j, c] = sum of g[b, r, c] over the rows r with idx[b, r] == j
//                  (0 where none has j); an index outside [0, n_rows)
//                  contributes nothing.
//
// Replaces: papc_tpu/ops/pallas/scatter.py::scatter_rows_add_pallas
// (_scatter_kernel). On the TPU the sum is a product of a transposed
// one-hot with the gradient tile on the MXU, and the index tile is padded
// with -1, which matches no row: that is where "out of range contributes
// nothing" comes from, and this kernel keeps it. (The grouping gather's
// backward, group_scatter_add.cu, clamps instead, as its forward does.)
//
// What bounds it on the H100: bytes. It reads the gradient once (MSG
// classification's SA2 branches: 32 x 128 x (32 + 64 + 128) rows of 323
// f32, 1.19 GB a step) and idx, and writes [B, n_rows, C] f32 once (32 x
// 512 x 323 x 4 B = 21 MB a call).
//
// Design: the owners of an output row compute it, in two launches behind
// the one entry point, on the bodies in scatter_sorted.cuh (the plan is
// ops/kernels/scatter_sorted.py::sorted_plan): a stable counting sort
// of each cloud's rows by their index, an index outside [0, n_rows) in no
// list (row_index_kernel), then a sum that splits each block's rows'
// lists evenly over its workers and writes every output row once, g read
// as f32 or bf16 and added in f32 (row_sum_kernel). Ball query's padding
// repeats a group's first index up to K - 1 times, so a few rows take
// lists many times the mean (MSG SA2 at K = 128: over 1000 entries); the
// even split keeps them off one worker. No atomics on the output and no
// memset: two calls give the same bits, and a row inside one worker's
// part adds in list order, a sequential index_add_'s.
#include "scatter_sorted.cuh"

namespace {

__global__ void __launch_bounds__(1024)
    row_index_kernel(const int* __restrict__ idx, int n, int entries,
                     int* __restrict__ offsets, int* __restrict__ order) {
  sorted::inverse_index<true>(idx, n, entries, offsets, order);
}

template <int L, int CH, typename T>
__global__ void __launch_bounds__(sorted::kSumThreads)
    row_sum_kernel(const T* __restrict__ g, const int* __restrict__ offsets,
                   const int* __restrict__ order, int n, int entries, int c,
                   float* __restrict__ out) {
  sorted::scatter_sum<L, CH, T, float>(g, offsets, order, n, entries, c,
                                       out);
}

template <typename T>
struct RowSum {
  template <int L, int CH>
  struct At {
    static cudaError_t launch(dim3 grid, cudaStream_t stream, const T* g,
                              const int* offsets, const int* order, int n,
                              int entries, int c, float* out) {
      return papc_launch(row_sum_kernel<L, CH, T>, grid,
                         dim3(sorted::kSumThreads), 0, stream, g, offsets,
                         order, n, entries, c, out);
    }
  };
};

}  // namespace

// g [B, R, C] f32 (g_bf16 = 0) or bf16 (g_bf16 = 1), idx [B, R] i32 ->
// out [B, n_rows, C] f32, every row written. Scratch: offsets [B, n_rows +
// 1] and order [B, R] i32, both written here (the inverse index; order
// past offsets[b, n_rows] is left as it was). warps: the index kernel's
// warps a cloud (shared memory (warps * n_rows + n_rows + 32) * 4 bytes);
// lanes (4, 8, 16 or 32; 32 with chans > 1) and chans (1-8): the sum
// kernel's lanes a row and channels a lane.
PAPC_EXPORT int papc_scatter_rows_add(const void* g, int g_bf16,
                                      const int* idx, int b, int r, int c,
                                      int n_rows, int warps, int lanes,
                                      int chans, int* offsets, int* order,
                                      float* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    return sorted::launch<RowSum<__nv_bfloat16>::At>(
        row_index_kernel, static_cast<const __nv_bfloat16*>(g), idx, b,
        n_rows, r, c, warps, lanes, chans, offsets, order, out, s);
  return sorted::launch<RowSum<float>::At>(
      row_index_kernel, static_cast<const float*>(g), idx, b, n_rows, r, c,
      warps, lanes, chans, offsets, order, out, s);
}
