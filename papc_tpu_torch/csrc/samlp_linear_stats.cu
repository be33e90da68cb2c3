// One training-forward layer pass of a set-abstraction MLP:
//   h = x                                  (first layer: the raw block input)
//   h = max(x * scale + shift, 0)          (later layers: the previous BN + ReLU)
//   a = bf16(h) . bf16(W) + b    -> stored as bf16
//   sums = (sum of a, sum of a^2) per column, over every row, from the f32 a
//
// Replaces: papc_tpu/ops/pallas/samlp.py::linear_stats (_linear_stats_kernel),
// one pass per layer of fused_mlp's stream-mode training forward. Numeric
// contract kept from it: bf16 operands, f32 accumulation, f32 bias and
// affine, statistics of the f32 pre-activation before its bf16 rounding.
//
// What bounds it on the H100: the product (SSG at B = 32, per layer:
// SA1 524288 x 3/64/64 -> 64/64/128, SA2 262144 x 131/128/128 -> 128/128/256,
// SA3 4096 x 259/256/512 -> 256/512/1024) and writing a, 2 bytes a value.
//
// Design: the block loads a tile of 128 input rows into shared memory as
// bf16, applying the previous layer's affine and ReLU on the way (with
// __fmul_rn / __fadd_rn, so the value equals the plain version's), zero in
// the channel padding (C0 = 3, 131, 259 pad to 16) and past the last row.
// Tensor-core products as in samlp_eval.cu; the epilogue adds the bias,
// stores bf16 a and adds a and a^2 into the block's column sums. Blocks
// walk the tiles b, b + gridDim.x, ...; each writes its sums to
// partials[block], and a second kernel adds the blocks in order. The
// weights come packed once per step (bf16, padded to 16).
#include "samlp_train.cuh"

namespace {

using samlp_train::affine;
using samlp_train::bf2f;

__global__ void __launch_bounds__(samlp_train::kWarps * 32)
    linear_stats_kernel(const __nv_bfloat16* __restrict__ x, int m, int cin,
                        const float* __restrict__ vec,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, int cout, int cin_p,
                        int cout_p, int tm, int ld_x,
                        __nv_bfloat16* __restrict__ a_out,
                        float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* scratch =
      reinterpret_cast<float*>(tile + static_cast<size_t>(tm) * ld_x);
  float* colsum = scratch + samlp_train::kWarps * 256;
  const int row_blocks = tm / samlp_train::kUnitRows;
  for (int e = threadIdx.x; e < row_blocks * 2 * cout_p; e += blockDim.x)
    colsum[e] = 0.f;

  const int tiles = (m + tm - 1) / tm;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * tm;
    __syncthreads();  // the previous tile's products are done with `tile`
    for (int e = threadIdx.x; e < tm * cin_p; e += blockDim.x) {
      const int r = e / cin_p, c = e - r * cin_p;
      const int row = row0 + r;
      float v = 0.f;
      if (row < m && c < cin) {
        v = bf2f(x[static_cast<size_t>(row) * cin + c]);
        if (vec != nullptr) {
          v = affine(v, vec[c], vec[cin + c]);
          v = v > 0.f ? v : 0.f;
        }
      }
      tile[r * ld_x + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    samlp_train::rows_times_matrix<false>(
        tile, ld_x, cin_p, w, cout_p, cout_p, row_blocks, scratch, colsum,
        [&](int rl, int col, float acc) {
          const int row = row0 + rl;
          if (row >= m || col >= cout) return make_float2(0.f, 0.f);
          const float a = __fadd_rn(acc, bias[col]);
          a_out[static_cast<size_t>(row) * cout + col] =
              __float2bfloat16_rn(a);
          return make_float2(a, __fmul_rn(a, a));
        });
  }
  __syncthreads();
  samlp_train::write_block_sums(colsum, row_blocks, cout_p, partials);
}

}  // namespace

// x [M, Cin] bf16; vec: null (first layer) or f32 rows (scale, shift, ...)
// of width Cin, of which rows 0 and 1 are read; w bf16 [cin_p, cout_p]
// (padded to multiples of 16, zero-filled); bias f32 [Cout]. tm: rows per
// tile (a multiple of 64); ld_x: shared-memory row stride (bf16 elements);
// blocks: the grid, which fixes the order of the sums.
// -> a [M, Cout] bf16, partials [blocks, 2, cout_p] (scratch),
//    sums [2, Cout] f32.
PAPC_EXPORT int papc_samlp_linear_stats(const void* x, int m, int cin,
                                        const float* vec, const void* w,
                                        const float* bias, int cout,
                                        int cin_p, int cout_p, int tm,
                                        int ld_x, int blocks, void* a,
                                        float* partials, float* sums,
                                        void* stream) {
  if (m <= 0 || cin <= 0 || cout <= 0 || cin_p % 16 != 0 ||
      cout_p % 16 != 0 || cin_p < cin || cout_p < cout || tm <= 0 ||
      tm % samlp_train::kUnitRows != 0 || ld_x < cin_p || ld_x % 8 != 0 ||
      blocks <= 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(tm) * ld_x * 2 +
                      samlp_train::kWarps * 256 * sizeof(float) +
                      static_cast<size_t>(tm / samlp_train::kUnitRows) * 2 *
                          cout_p * sizeof(float);
  cudaError_t err = papc_launch(
      linear_stats_kernel, dim3(blocks), dim3(samlp_train::kWarps * 32), smem,
      s, static_cast<const __nv_bfloat16*>(x), m, cin, vec,
      static_cast<const __nv_bfloat16*>(w), bias, cout, cin_p, cout_p, tm,
      ld_x, static_cast<__nv_bfloat16*>(a), partials);
  if (err != cudaSuccess) return err;
  return samlp_train::reduce_partials(partials, blocks, 2, cout, 2, cout_p,
                                      sums, s);
}
