// Ball query: for each query, the first nsample point indices within the
// radius, in ascending order.
//
// Replaces: papc_tpu/ops/pallas/ball_query.py::query_ball_point_pallas
// (_ball_query_kernel), which keeps the cloud resident in VMEM, streams it
// in tiles, appends in-radius indices by min-extraction and leaves the
// tile loop once every row of its block is full.
//
// What bounds it on the H100: instruction issue, not bytes. A query scans
// points in index order until it holds nsample hits, so a dense ball
// stops early and a sparse one tests all N points: 9 f32 operations, a
// ballot and a few integer ones a point and query, against 12 bytes a
// point that the queries of one cloud share (12 KB at N = 1024). How
// long a query scans depends on where it lies: on a Gaussian cloud of
// 16384 points at r = 0.4, K = 32, a query near the centre fills within
// a few thousand points and one in the tail never fills.
//
// Design (the plan is ops/kernels/ball_query.py::ball_query_plan): a
// block of `warps` warps takes warps x Q consecutive queries of ONE cloud
// and stages that cloud in shared memory as it lies in memory (x, y, z of
// a point in turn), with coalesced 16-byte cp.async copies where the
// cloud starts on 16 bytes (4-byte ones where it does not), padded to a
// multiple of 128 points with points at +inf, which no ball holds. Lane l
// reads point j at floats 3j .. 3j + 2: a stride of 3 words puts the 32
// lanes in 32 banks, so no transpose into planes is needed. The whole
// cloud when it fits (N = 16384 takes 192 KB); otherwise tiles of `tile`
// points, double-buffered: the next tile's copy runs while the warps scan
// this one, and the block leaves the tile loop once every query of the
// block is full (__syncthreads_and, the TPU kernel's early exit). A warp
// scans for its Q queries at once, 128 points a visit: each lane loads
// its 4 points once for all Q queries, and the 4 x Q distances and
// ballots are independent of each other, so the latency of one query's
// chain hides behind the others. __ballot_sync gives a query the hit mask
// of 32 points, and each hit's slot in the row is the running count plus
// the hits of lower lanes (__popc): indices land in ascending order with
// no sort. A warp stops once all its queries hold nsample hits. The plan
// takes 32 warps and the largest Q of 4, 2, 1 that still gives 128
// blocks: Q = 4 at SSG SA1, 1 at SA2, 2 at B=4 x 16384 points (measured
// against every other warps x Q; PERF.md §6).
//
// A hit goes straight to its slot of the query's output row, so a
// ballot's hits land as one run of consecutive ints; then the empty slots
// take the row's first hit (a row with no hit is all N - 1, as the TPU
// kernel's epilogue), written by the warp as one coalesced run. (Rows
// built in shared memory and copied out whole measured 1-4 % slower at
// every shape of PERF.md §6.)
//
// Rounding: distances are the direct ((dx*dx + dy*dy) + dz*dz) with each
// operation rounded on its own (no FMA contraction) and the test is the
// inclusive d <= r^2, so membership equals the plain PyTorch version's
// bit for bit.
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "samlp_mma.cuh"

namespace {

constexpr int kSmemLimit = 232448;

using samlp_mma::cp_async16;
using samlp_mma::cp_async4;
using samlp_mma::cp_async_commit;
using samlp_mma::cp_async_wait;

constexpr int kU = 4;           // 32-point chunks a warp tests a visit
constexpr int kStep = 32 * kU;  // points a visit

__host__ __device__ inline int pad_step(int points) {
  return (points + kStep - 1) / kStep * kStep;
}

// Copy points [base, base + len) of the cloud into dst (one cp.async
// group a thread) and set the points up to the next multiple of kStep to
// +inf (plain stores: no copy touches them).
__device__ __forceinline__ void stage_points(float* dst,
                                             const float* __restrict__ cloud,
                                             int base, int len) {
  const float* src = cloud + 3ll * base;
  const int floats = 3 * len;
  const int chunks =
      (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? floats / 4 : 0;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * chunks + threadIdx.x; i < floats; i += blockDim.x)
    cp_async4(dst + i, src + i, true);
  cp_async_commit();
  for (int i = floats + threadIdx.x; i < 3 * pad_step(len); i += blockDim.x)
    dst[i] = INFINITY;
}

// One visit: the kStep points at p (lane l of chunk u: p[96u + 3l ..]),
// point indices j0 onwards, tested against each of the warp's Q queries
// still short of nsample. The chunks' loads and distances are
// independent; a query's hits go to its row at cnt onwards (while below
// nsample) in point order, and cnt counts them all. Returns whether every
// query is full.
template <int Q>
__device__ __forceinline__ bool visit(const float* p, int j0,
                                      const float (&qx)[Q],
                                      const float (&qy)[Q],
                                      const float (&qz)[Q], float r2,
                                      int nsample, int* const (&row)[Q],
                                      int (&cnt)[Q]) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  float px[kU], py[kU], pz[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    px[u] = p[96 * u + 3 * lane];
    py[u] = p[96 * u + 3 * lane + 1];
    pz[u] = p[96 * u + 3 * lane + 2];
  }
  bool full = true;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (cnt[i] < nsample) {  // uniform across the warp
      unsigned mask[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float dx = __fsub_rn(qx[i], px[u]);
        const float dy = __fsub_rn(qy[i], py[u]);
        const float dz = __fsub_rn(qz[i], pz[u]);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        mask[u] = __ballot_sync(0xffffffffu, d <= r2);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (mask[u]) {  // uniform across the warp
          if ((mask[u] >> lane) & 1u) {
            const int pos = cnt[i] + __popc(mask[u] & below);
            if (pos < nsample) row[i][pos] = j0 + 32 * u + lane;
          }
          cnt[i] += __popc(mask[u]);
        }
      }
    }
    full = full && cnt[i] >= nsample;
  }
  return full;
}

// The row's empty slots take its first hit (N - 1 where it has none).
// The whole warp calls it.
__device__ __forceinline__ void finish_row(int* row, int cnt, int nsample,
                                           int n) {
  const int have = min(cnt, nsample);
  __syncwarp();  // the hits of every lane written
  const int fill = have ? row[0] : n - 1;
  for (int slot = have + (threadIdx.x & 31); slot < nsample; slot += 32)
    row[slot] = fill;
}

// A block's warps x Q queries of one cloud against the cloud staged
// whole (tile >= n) or in double-buffered tiles; each warp holds its Q
// queries (a query past S is full from the start) through every tile.
template <int Q>
__global__ void __launch_bounds__(1024)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ q, int n, int s,
                      int nsample, float r2, int tile,
                      int* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5, w = threadIdx.x >> 5;
  const int per_cloud = (s + warps * Q - 1) / (warps * Q);
  const int b = blockIdx.x / per_cloud;
  const int q0 = ((blockIdx.x - b * per_cloud) * warps + w) * Q;
  const int tiles = (n + tile - 1) / tile;
  float* const buf0 = smem;
  float* const buf1 = smem + 3 * pad_step(tile);
  const float* cloud = xyz + 3ll * b * n;

  float qx[Q], qy[Q], qz[Q];
  int cnt[Q];
  int* row[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const bool live = q0 + i < s;
    const long long id = static_cast<long long>(b) * s + (live ? q0 + i : 0);
    qx[i] = q[3 * id];
    qy[i] = q[3 * id + 1];
    qz[i] = q[3 * id + 2];
    cnt[i] = live ? 0 : nsample;
    row[i] = out + id * nsample;
  }

  stage_points(buf0, cloud, 0, min(tile, n));
  if (tiles > 1) stage_points(buf1, cloud, tile, min(tile, n - tile));
  bool full = true;
#pragma unroll
  for (int i = 0; i < Q; ++i) full = full && cnt[i] >= nsample;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const float* p = t & 1 ? buf1 : buf0;
    const int base = t * tile, len = pad_step(min(tile, n - base));
    for (int c = 0; c < len && !full; c += kStep)
      full = visit<Q>(p + 3 * c, base + c, qx, qy, qz, r2, nsample, row,
                      cnt);
    if (t + 1 == tiles) break;
    // every warp is done with this buffer; leave once every query of the
    // block is full
    if (__syncthreads_and(full)) break;
    if (t + 2 < tiles)
      stage_points(t & 1 ? buf1 : buf0, cloud, (t + 2) * tile,
                   min(tile, n - (t + 2) * tile));
  }
  cp_async_wait<0>();  // a tile still in flight when the block left early

#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (q0 + i >= s) break;  // uniform across the warp
    finish_row(row[i], cnt[i], nsample, n);
  }
}

template <int Q>
cudaError_t launch(const float* xyz, const float* new_xyz, int b, int n,
                   int s, int nsample, float r2, int warps, int tile,
                   int* out, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(b) * ((s + warps * Q - 1) / (warps * Q));
  const size_t smem = 12ull * (tile < n ? 2 : 1) * pad_step(tile);
  if (blocks > INT32_MAX || smem > kSmemLimit) return cudaErrorInvalidValue;
  return papc_launch(ball_query_kernel<Q>, dim3(static_cast<int>(blocks)),
                     dim3(32 * warps), smem, stream, xyz, new_xyz, n, s,
                     nsample, r2, tile, out);
}

}  // namespace

// xyz [B, N, 3], new_xyz [B, S, 3] f32 contiguous -> out [B, S, nsample]
// i32. A block of `warps` warps (1-32) takes warps x Q (queries: 1, 2 or
// 4) consecutive queries of one cloud. tile: the points staged at once,
// N or more for the whole cloud (taken as N), else a multiple of 128,
// double-buffered.
PAPC_EXPORT int papc_ball_query(const float* xyz, const float* new_xyz,
                                int b, int n, int s, int nsample, float r2,
                                int warps, int queries, int tile, int* out,
                                void* stream) {
  if (b <= 0 || n <= 0 || s <= 0 || nsample <= 0 || nsample > n ||
      warps < 1 || warps > 32 || tile < 1 || (tile < n && tile % kStep))
    return cudaErrorInvalidValue;
  tile = min(tile, n);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (queries) {
    case 1:
      return launch<1>(xyz, new_xyz, b, n, s, nsample, r2, warps, tile, out,
                       st);
    case 2:
      return launch<2>(xyz, new_xyz, b, n, s, nsample, r2, warps, tile, out,
                       st);
    case 4:
      return launch<4>(xyz, new_xyz, b, n, s, nsample, r2, warps, tile, out,
                       st);
    default:
      return cudaErrorInvalidValue;
  }
}
