// Shared pieces of the training-mode set-abstraction kernels
// (samlp_linear_stats.cu, samlp_finalize_seed.cu, samlp_bwd_layer.cu,
// samlp_rc_fwd.cu, samlp_rc_bwd.cu, and the wmma recompute passes through
// samlp_recompute.cuh).
//
// rows_times_matrix (the product of #15 and #16, through
// samlp_recompute.cuh): a tile of 16 * RF * row_blocks rows (bf16, in
// shared or device memory) times a bf16 matrix
// held in device memory, on tensor cores (nvcuda::wmma m16n16k16, f32
// accumulators): each warp takes units of 16 * RF rows x 16 columns (RF =
// 4 unless the tile is smaller) and loads every weight fragment once for
// RF row fragments. The epilogue is called once per element with (row in
// tile, column, f32 product) and returns two values, which are added to
// that column's two sums, kept per unit row in shared memory. A unit always belongs to the same warp (unit u -> warp u % 8),
// so every column sum is formed in a fixed order, and repeated runs give
// the same bits.
//
// split_reduce (samlp_linear_stats.cu, samlp_finalize_seed.cu,
// samlp_bwd_layer.cu, samlp_rc_fwd.cu, samlp_rc_bwd.cu): out[r, c] = the
// sum over i < n of part[i, r, c], `lanes` lanes a column, each summing
// every lanes-th part in order, then the lanes' sums in order; up to
// kMaxJobs sums a launch: the fixed-order second stage of a cross-block
// sum.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

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

// max(x * scale + shift, 0) rounded to bf16, as the plain version's h.
__device__ __forceinline__ __nv_bfloat16 relu_affine(__nv_bfloat16 x,
                                                     float scale,
                                                     float shift) {
  const float v = affine(bf2f(x), scale, shift);
  return __float2bfloat16_rn(v > 0.f ? v : 0.f);
}

// B is row-major [kdim, ldb]. colsum: [row_blocks][2][ncols] f32 in
// shared memory, or null when the epilogue sums nothing.
template <int RF = kRowFrags, typename Epilogue>
__device__ void rows_times_matrix(const __nv_bfloat16* a, int lda, int kdim,
                                  const __nv_bfloat16* b, int ldb, int ncols,
                                  int row_blocks, float* scratch,
                                  float* colsum, Epilogue epi) {
  constexpr int kRows = 16 * RF;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col_tiles = ncols / 16;
  const int units = col_tiles * row_blocks;
  float* my = scratch + warp * 256;
  for (int u = warp; u < units; u += kWarps) {
    const int ct = u % col_tiles;
    const int rb = u / col_tiles;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RF];
#pragma unroll
    for (int f = 0; f < RF; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int kk = 0; kk < kdim; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf;
      wmma::load_matrix_sync(bf, b + static_cast<size_t>(kk) * ldb + ct * 16,
                             ldb);
#pragma unroll
      for (int f = 0; f < RF; ++f) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af;
        wmma::load_matrix_sync(
            af, a + static_cast<size_t>(rb * kRows + f * 16) * lda + kk, lda);
        wmma::mma_sync(acc[f], af, bf, acc[f]);
      }
    }
    // lane l always sees column l % 16 of the fragment (rows l / 16 + 2i)
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int f = 0; f < RF; ++f) {
      wmma::store_matrix_sync(my, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const float2 t = epi(rb * kRows + f * 16 + (e >> 4),
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

// One sum over splits: out[r * cols + c] = the sum over i < n of
// part[(i * part_rows + r) * ld + c], for r < rows and c < cols.
struct SplitSum {
  const float* part;
  int n, part_rows, ld, rows, cols;
  float* out;
};

// Up to kMaxJobs sums over splits in one launch: block b takes job q
// (first[q] <= b < first[q + 1]), row (b - first[q]) / column blocks of
// 32 columns.
constexpr int kMaxJobs = 8;
struct SplitJobs {
  SplitSum j[kMaxJobs];
  int first[kMaxJobs + 1];
  int n;
};

// Each sum in a fixed order: lane row y of a block (of blockDim.y <= 32)
// sums splits y, y + blockDim.y, ... of its 32 columns in order, then row
// 0 adds the blockDim.y sums in order. A lane issues eight loads before
// adding them; with the launch bounds the compiler keeps them in flight
// (looked up from the list without both, about two were, which took twice
// the time of a two-job kernel indexed by blockIdx.z).
static __global__ void __launch_bounds__(1024, 1)
    split_reduce_kernel(SplitJobs js) {
  __shared__ float sums[32][33];
  int q = 0;
  while (q + 1 < js.n && js.first[q + 1] <= static_cast<int>(blockIdx.x)) ++q;
  const SplitSum j = js.j[q];
  const int col_blocks = (j.cols + 31) / 32;
  const int b = blockIdx.x - js.first[q];
  const int r = b / col_blocks;
  const int x = threadIdx.x, y = threadIdx.y, lanes = blockDim.y;
  const int c = (b - r * col_blocks) * 32 + x;
  float s = 0.f;
  if (c < j.cols) {
    const float* p = j.part + static_cast<size_t>(r) * j.ld + c;
    const size_t step = static_cast<size_t>(j.part_rows) * j.ld;
    int i = y;
    for (; i + 7 * lanes < j.n; i += 8 * lanes) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = p[static_cast<size_t>(i + u * lanes) * step];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; i < j.n; i += lanes) s += p[static_cast<size_t>(i) * step];
  }
  sums[y][x] = s;
  __syncthreads();
  if (y != 0 || c >= j.cols) return;
  s = sums[0][x];
  for (int k = 1; k < lanes; ++k) s += sums[k][x];
  j.out[static_cast<size_t>(r) * j.cols + c] = s;
}

// The n (1 .. kMaxJobs) jobs' sums in one launch, `lanes` (8 or 32) lanes
// a column; a job of no rows is skipped.
static inline cudaError_t split_reduce(const SplitSum* jobs, int n, int lanes,
                                       cudaStream_t s) {
  if (n < 1 || n > kMaxJobs) return cudaErrorInvalidValue;
  SplitJobs js{};
  for (int q = 0; q < n; ++q) {
    if (jobs[q].rows <= 0) continue;
    js.j[js.n] = jobs[q];
    js.first[js.n + 1] =
        js.first[js.n] + jobs[q].rows * ((jobs[q].cols + 31) / 32);
    ++js.n;
  }
  if (js.n == 0) return cudaSuccess;
  return papc_launch(split_reduce_kernel, dim3(js.first[js.n]),
                     dim3(32, lanes), 0, s, js);
}

// The two jobs' sums (j1.rows 0: one job) in one launch.
static inline cudaError_t split_reduce(const SplitSum& j0, const SplitSum& j1,
                                       int lanes, cudaStream_t s) {
  const SplitSum jobs[2] = {j0, j1};
  return split_reduce(jobs, 2, lanes, s);
}

}  // namespace samlp_train
