// Ball query: for each query, the first nsample point indices within the
// radius, one warp per query.
//
// Replaces: papc_tpu/ops/pallas/ball_query.py::query_ball_point_pallas
// (_ball_query_kernel), which streams the cloud through VMEM in tiles and
// appends in-radius indices by min-extraction, with an early exit once
// every row is full.
//
// What bounds it on the H100: reading the cloud. A query scans points in
// index order until it holds nsample hits, so a dense ball stops early
// and a sparse one reads all N points (12 B each, from L1/L2: one cloud
// is 12 KB at N = 1024 and is shared by the S queries of its batch row).
//
// Design: the 32 lanes of a warp test 32 consecutive points at once.
// __ballot_sync gives the warp the hit mask, and each hit's slot is the
// running count plus the hits of lower lanes (__popc), so the indices
// land in ascending order with no sort and no shared memory. The warp
// stops at nsample hits. Epilogue as the TPU kernel's: empty slots take
// the row's first hit; a row with no hit is all N-1.
//
// Rounding: distances are the direct ((dx*dx + dy*dy) + dz*dz) with each
// operation rounded on its own (no FMA contraction) and the test is the
// inclusive d <= r^2, so membership equals the plain PyTorch version's
// bit for bit.
#include "common.cuh"

namespace {

__global__ void ball_query_kernel(const float* __restrict__ xyz,
                                  const float* __restrict__ q, int n,
                                  int s, int nsample, float r2,
                                  int n_queries, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int qid = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qid >= n_queries) return;  // uniform across the warp
  const int b = qid / s;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const float qx = q[3 * qid], qy = q[3 * qid + 1], qz = q[3 * qid + 2];
  int* o = out + static_cast<size_t>(qid) * nsample;

  int cnt = 0;
  int first = n;
  for (int base = 0; base < n && cnt < nsample; base += 32) {
    const int j = base + lane;
    bool in = false;
    if (j < n) {
      const float dx = __fsub_rn(qx, p[3 * j]);
      const float dy = __fsub_rn(qy, p[3 * j + 1]);
      const float dz = __fsub_rn(qz, p[3 * j + 2]);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
          __fmul_rn(dz, dz));
      in = d <= r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    if (mask) {
      if (cnt == 0) first = base + __ffs(mask) - 1;
      const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
      if (in && pos < nsample) o[pos] = j;
      cnt += __popc(mask);
    }
  }
  const int fill = first < n ? first : n - 1;
  for (int slot = min(cnt, nsample) + lane; slot < nsample; slot += 32)
    o[slot] = fill;
}

}  // namespace

// xyz [B, N, 3], new_xyz [B, S, 3] f32 contiguous -> out [B, S, nsample] i32.
PAPC_EXPORT int papc_ball_query(const float* xyz, const float* new_xyz,
                                int b, int n, int s, int nsample,
                                float r2, int* out, void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || nsample <= 0)
    return cudaErrorInvalidValue;
  constexpr int kWarpsPerBlock = 8;
  const int n_queries = b * s;
  const int blocks = (n_queries + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return papc_launch(ball_query_kernel, dim3(blocks),
                     dim3(kWarpsPerBlock * 32), 0,
                     static_cast<cudaStream_t>(stream), xyz, new_xyz, n, s,
                     nsample, r2, n_queries, out);
}
