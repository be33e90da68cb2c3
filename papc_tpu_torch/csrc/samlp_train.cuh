// Shared pieces of the training-mode set-abstraction kernels
// (samlp_linear_stats.cu, samlp_finalize_seed.cu, samlp_bwd_layer.cu and
// the recompute passes through samlp_rc_fwd.cuh and samlp_rc_bwd.cuh): the
// affine and ReLU the plain versions run op for op, and the cross-split
// reduce.
//
// split_reduce (samlp_linear_stats.cu, samlp_finalize_seed.cu,
// samlp_bwd_layer.cu, samlp_rc_fwd.cu, samlp_rc_bwd.cu): out[r, c] = the
// sum over i < n of part[i, r, c], `lanes` lanes a column, each summing
// every lanes-th part in order, then the lanes' sums in order; up to
// kMaxJobs sums a launch: the fixed-order second stage of a cross-block
// sum.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace samlp_train {

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
