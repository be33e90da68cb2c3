// Shared pieces of the training-mode set-abstraction kernels
// (samlp_linear_stats.cu, samlp_finalize_seed.cu, samlp_bwd_layer.cu).
//
// rows_times_matrix: a tile of 64 * row_blocks rows (bf16, in shared or
// device memory) times a bf16 matrix held in device memory, on tensor
// cores (nvcuda::wmma m16n16k16, f32 accumulators), as in samlp_eval.cu:
// each warp takes units of 64 rows x 16 columns and loads every weight
// fragment once for four row fragments. The epilogue is called once per
// element with (row in tile, column, f32 product) and returns two values
// to add to that column's sums, which are kept per 64-row unit in shared
// memory. A unit always belongs to the same warp (unit u -> warp u % 8),
// so every column sum is formed in a fixed order, and repeated runs give
// the same bits.
//
// reduce_partials: out[r, c] = sum over i < n of part[i, r, c], one thread
// per output, in order of i: the fixed-order second stage of every
// cross-block sum.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace samlp_train {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kRowFrags = 4;  // 16-row fragments per warp unit
constexpr int kUnitRows = 16 * kRowFrags;

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a * scale + shift without contraction into an FMA: the plain version
// runs the two ops separately, and an ulp moves the o > 0 gate.
__device__ __forceinline__ float affine(float a, float scale, float shift) {
  return __fadd_rn(__fmul_rn(a, scale), shift);
}

// B is row-major [kdim, ldb] (kTransB false) or, for kTransB, the
// transpose of a row-major [ncols, ldb] matrix. colsum: [row_blocks][2]
// [ncols] f32 in shared memory, or null when the epilogue sums nothing.
template <bool kTransB, typename Epilogue>
__device__ void rows_times_matrix(const __nv_bfloat16* a, int lda, int kdim,
                                  const __nv_bfloat16* b, int ldb, int ncols,
                                  int row_blocks, float* scratch,
                                  float* colsum, Epilogue epi) {
  using BLayout = typename std::conditional<kTransB, wmma::col_major,
                                            wmma::row_major>::type;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col_tiles = ncols / 16;
  const int units = col_tiles * row_blocks;
  float* my = scratch + warp * 256;
  for (int u = warp; u < units; u += kWarps) {
    const int ct = u % col_tiles;
    const int rb = u / col_tiles;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowFrags];
#pragma unroll
    for (int f = 0; f < kRowFrags; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int kk = 0; kk < kdim; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
      const __nv_bfloat16* bp =
          kTransB ? b + static_cast<size_t>(ct) * 16 * ldb + kk
                  : b + static_cast<size_t>(kk) * ldb + ct * 16;
      wmma::load_matrix_sync(bf, bp, ldb);
#pragma unroll
      for (int f = 0; f < kRowFrags; ++f) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af;
        wmma::load_matrix_sync(
            af, a + static_cast<size_t>(rb * kUnitRows + f * 16) * lda + kk,
            lda);
        wmma::mma_sync(acc[f], af, bf, acc[f]);
      }
    }
    // lane l always sees column l % 16 of the fragment (rows l / 16 + 2i)
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int f = 0; f < kRowFrags; ++f) {
      wmma::store_matrix_sync(my, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const float2 t = epi(rb * kUnitRows + f * 16 + (e >> 4),
                             ct * 16 + (e & 15), my[e]);
        s1 += t.x;
        s2 += t.y;
      }
      __syncwarp();
    }
    if (colsum != nullptr) {
      s1 += __shfl_down_sync(0xffffffffu, s1, 16);
      s2 += __shfl_down_sync(0xffffffffu, s2, 16);
      if (lane < 16) {
        colsum[(rb * 2) * ncols + ct * 16 + lane] += s1;
        colsum[(rb * 2 + 1) * ncols + ct * 16 + lane] += s2;
      }
    }
  }
}

// The block's column sums over its row units, in order, into
// part[block][2][ncols].
__device__ inline void write_block_sums(const float* colsum, int row_blocks,
                                        int ncols, float* part) {
  for (int e = threadIdx.x; e < 2 * ncols; e += blockDim.x) {
    float s = 0.f;
    for (int rb = 0; rb < row_blocks; ++rb) s += colsum[rb * 2 * ncols + e];
    part[static_cast<size_t>(blockIdx.x) * 2 * ncols + e] = s;
  }
}

// out[r * cols + c] = sum_{i < n} part[(i * part_rows + r) * ld + c].
// static: every source that includes this header keeps its own copy.
static __global__ void reduce_partials_kernel(const float* __restrict__ part,
                                              int n, int rows, int cols,
                                              int part_rows, int ld,
                                              float* __restrict__ out) {
  const int total = rows * cols;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int r = e / cols, c = e - r * cols;
    float s = 0.f;
    for (int i = 0; i < n; ++i)
      s += part[(static_cast<size_t>(i) * part_rows + r) * ld + c];
    out[e] = s;
  }
}

static inline cudaError_t reduce_partials(const float* part, int n,
                                          int rows, int cols, int part_rows,
                                          int ld, float* out,
                                          cudaStream_t stream) {
  const int threads = 256;
  int blocks = (rows * cols + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  return papc_launch(reduce_partials_kernel, dim3(blocks), dim3(threads), 0,
                     stream, part, n, rows, cols, part_rows, ld, out);
}

}  // namespace samlp_train
