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
// 128 x 64 x 131 x 4 B = 137 MB) and idx (1 MB), and writes [B, N, C] once
// (SA2: 8.6 MB).
//
// Design: the owners of an output row compute it, in two launches behind
// the one entry point (the plan is ops/kernels/gather.py::scatter_add_plan).
//  1. inverse_index_kernel, a block of `warps` warps a cloud: the stable
//     counting sort of the cloud's S x K entries by their clamped point.
//     Warp w takes the w-th contiguous chunk of entries (8 loads a lane in
//     flight) and counts them by point into its own row of shared memory
//     (warps x N ints, shared-memory atomics: a count does not depend on
//     their order). A column pass turns each point's counts into per-warp
//     starts, and an exclusive scan of the totals gives offsets[b, 0..N].
//     Then each warp walks its chunk again, 32 entries at a time in order,
//     and writes entry e at offsets[j] + its warp's start for j + the
//     lanes below it with the same j (one ballot a bit of j, then __popc):
//     each point's list in order[b] holds its entries in ascending flat
//     order, whatever the schedule. The counts set the largest N (the plan
//     raises above it).
//  2. scatter_sum_kernel: a block takes 128 / L consecutive rows (b, j) of
//     one cloud, whose lists are one contiguous range of order[b], and
//     splits that range evenly over its 256 / L workers of L lanes (4 to
//     32): ball query's padding gives a few points lists many times the
//     mean, which one worker alone would walk for the whole launch. A
//     worker walks its part in order, each lane adding `chans` channels
//     (lane + L * i) of each entry's g row into f32 registers with
//     __fadd_rn, eight entries' loads in flight and the next eight indices
//     loading behind them. A row that
//     lies inside one worker's part is written whole by it; a row split
//     over workers leaves each part's sum in shared memory, and the merge
//     adds the parts in worker order and writes the row, or zeros where no
//     entry takes it: every row is written once and nothing is zero-filled
//     beforehand. Channels beyond L x chans take further walks.
// No atomics on the output: the sum order is fixed by the index and the
// shapes, so two calls give the same bits. A row inside one worker's part
// adds in list order, which is a sequential index_add_'s (the plain
// version on the CPU); against the card's index_add_ (atomics, in no fixed
// order) the sums agree to their f32 rounding.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kSumThreads = 256;
constexpr int kUnroll = 8;  // entries whose loads are in flight together
constexpr int kBatch = 8;  // entries a lane of the index loads at once
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ int clip(int j, int n) {
  return min(max(j, 0), n - 1);
}

// The lanes of the warp that are live and hold the same point j: one
// ballot a bit of j (the whole warp calls it).
__device__ __forceinline__ unsigned same_point(int j, bool live, int bits) {
  unsigned peers = __ballot_sync(0xffffffffu, live);
  for (int bit = 0; bit < bits; ++bit) {
    const unsigned set = __ballot_sync(0xffffffffu, (j >> bit) & 1);
    peers &= (j >> bit) & 1 ? set : ~set;
  }
  return peers;
}

// The clamped points of entries e, e + 32, ... (kBatch of them, below hi),
// their loads in flight together.
__device__ __forceinline__ void load_points(const int* __restrict__ cloud,
                                            int n, int e, int hi,
                                            int (&j)[kBatch]) {
#pragma unroll
  for (int t = 0; t < kBatch; ++t)
    j[t] = e + 32 * t < hi ? clip(cloud[e + 32 * t], n) : 0;
}

__global__ void __launch_bounds__(1024)
    inverse_index_kernel(const int* __restrict__ idx, int n, int entries,
                         int* __restrict__ offsets, int* __restrict__ order) {
  extern __shared__ int smem[];
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int* counts = smem;                // [warps][n], then each warp's starts
  int* starts = counts + warps * n;  // [n]: the cloud's offsets
  int* sums = starts + n;            // [32]: the scan's warp totals
  int* mine = counts + w * n;
  const int* cloud = idx + static_cast<long long>(blockIdx.x) * entries;
  const int chunk = (entries + warps - 1) / warps;
  const int lo = min(w * chunk, entries), hi = min(lo + chunk, entries);
  const unsigned below = (1u << lane) - 1;
  const int bits = 32 - __clz(max(n - 1, 1));  // bits of a point index

  for (int i = threadIdx.x; i < warps * n; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  for (int base = lo; base < hi; base += 32 * kBatch) {  // count the chunk
    int j[kBatch];
    load_points(cloud, n, base + lane, hi, j);
#pragma unroll
    for (int t = 0; t < kBatch; ++t)
      if (base + 32 * t + lane < hi) atomicAdd(&mine[j[t]], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {  // per-warp starts
    int run = 0;
    for (int v = 0; v < warps; ++v) {
      const int c = counts[v * n + j];
      counts[v * n + j] = run;
      run += c;
    }
    starts[j] = run;
  }
  __syncthreads();
  // exclusive scan of the totals: each thread a contiguous range of points
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int a = min(static_cast<int>(threadIdx.x) * per, n);
  const int z = min(a + per, n);
  int own = 0;
  for (int i = a; i < z; ++i) own += starts[i];
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    int t = lane < warps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    sums[lane] = t;
  }
  __syncthreads();
  int run = incl - own + (w ? sums[w - 1] : 0);
  for (int i = a; i < z; ++i) {
    const int c = starts[i];
    starts[i] = run;
    run += c;
  }
  __syncthreads();
  int* cloud_offsets = offsets + static_cast<long long>(blockIdx.x) * (n + 1);
  for (int i = threadIdx.x; i <= n; i += blockDim.x)
    cloud_offsets[i] = i < n ? starts[i] : entries;
  int* cloud_order = order + static_cast<long long>(blockIdx.x) * entries;
  for (int base = lo; base < hi; base += 32 * kBatch) {  // place it in order
    int j[kBatch];
    load_points(cloud, n, base + lane, hi, j);
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int e = base + 32 * t + lane;
      const unsigned peers = same_point(j[t], e < hi, bits);
      if (e < hi)
        cloud_order[starts[j[t]] + mine[j[t]] + __popc(peers & below)] = e;
      __syncwarp();
      if (e < hi && (peers & below) == 0) mine[j[t]] += __popc(peers);
      __syncwarp();
    }
  }
}

// Where a row's partial sum goes when a worker has walked its part of it:
// a row inside the worker's entry range [a, z) is written out; a row that
// began before a leaves its partial in head, one that runs past z in tail.
template <int L, int CH>
__device__ __forceinline__ void flush(const float (&acc)[CH], int lo, int hi,
                                      int a, int z, int sub, int ch, int c,
                                      float* row, float* head, float* tail) {
  if (lo == hi) return;  // no entry: the merge writes its zeros
  float* dst = lo >= a && hi <= z ? row : lo < a ? head : tail;
  const int base = dst == row ? ch : sub;
#pragma unroll
  for (int i = 0; i < CH; ++i)
    if (ch + L * i < c) dst[base + L * i] = acc[i];
}

template <int L, int CH>
__global__ void __launch_bounds__(kSumThreads)
    scatter_sum_kernel(const float* __restrict__ g,
                       const int* __restrict__ offsets,
                       const int* __restrict__ order, int n, int entries,
                       int c, float* __restrict__ out) {
  constexpr int kWorkers = kSumThreads / L;
  constexpr int kRows = kWorkers / 2;  // rows a block
  constexpr int kSpan = L * CH;        // channels a walk
  __shared__ int offs[kRows + 1];
  __shared__ float head[kWorkers][kSpan], tail[kWorkers][kSpan];
  const int b = blockIdx.y, j0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - j0);
  const int w = threadIdx.x / L, sub = threadIdx.x % L;
  if (threadIdx.x <= rows)
    offs[threadIdx.x] =
        offsets[static_cast<long long>(b) * (n + 1) + j0 + threadIdx.x];
  __syncthreads();
  // the block's rows own one contiguous range of the sorted entries; each
  // worker (L lanes) takes an equal part of it, in order
  const int begin = offs[0], total = offs[rows] - begin;
  const int per = (total + kWorkers - 1) / kWorkers;
  const int a = begin + min(w * per, total);
  const int z = begin + min((w + 1) * per, total);
  int r0 = 0;  // the row of entry a
  while (r0 + 1 < rows && offs[r0 + 1] <= a) ++r0;
  const int* list = order + static_cast<long long>(b) * entries;
  const float* cloud = g + static_cast<long long>(b) * entries * c;
  float* rows_out = out + (static_cast<long long>(b) * n + j0) * c;

  for (int c0 = 0; c0 < c; c0 += kSpan) {
    const int ch = c0 + sub;
    float acc[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) acc[i] = 0.0f;
    int r = r0, row_end = offs[r0 + 1];
    int e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) e[u] = a + u < z ? list[a + u] : 0;
    for (int p = a; p < z; p += kUnroll) {
      float v[kUnroll][CH];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* src = cloud + static_cast<long long>(e[u]) * c + ch;
#pragma unroll
        for (int i = 0; i < CH; ++i)
          v[u][i] = p + u < z && ch + L * i < c ? src[L * i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)  // the next entries, in flight
        e[u] = p + kUnroll + u < z ? list[p + kUnroll + u] : 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u < z) {
          while (p + u >= row_end) {  // row r ends here
            flush<L, CH>(acc, offs[r], row_end, a, z, sub, ch, c,
                         rows_out + static_cast<long long>(r) * c, head[w],
                         tail[w]);
#pragma unroll
            for (int i = 0; i < CH; ++i) acc[i] = 0.0f;
            row_end = offs[++r + 1];
          }
#pragma unroll
          for (int i = 0; i < CH; ++i) acc[i] = __fadd_rn(acc[i], v[u][i]);
        }
      }
    }
    if (a < z)
      flush<L, CH>(acc, offs[r], row_end, a, z, sub, ch, c,
                   rows_out + static_cast<long long>(r) * c, head[w], tail[w]);
    __syncthreads();
    // the merge: worker w writes block row w where no one worker held all
    // of it, adding the partials in worker order (zeros for no entry)
    if (w < rows) {
      const int lo = offs[w], hi = offs[w + 1];
      const int first = lo == hi ? 0 : (lo - begin) / per;
      const int last = lo == hi ? -1 : (hi - 1 - begin) / per;
      if (first != last) {
        float s[CH];
#pragma unroll
        for (int i = 0; i < CH; ++i)
          s[i] = last < 0 ? 0.0f : tail[first][sub + L * i];
        for (int q = first + 1; q <= last; ++q) {
#pragma unroll
          for (int i = 0; i < CH; ++i)
            s[i] = __fadd_rn(s[i], head[q][sub + L * i]);
        }
        float* dst = rows_out + static_cast<long long>(w) * c;
#pragma unroll
        for (int i = 0; i < CH; ++i)
          if (ch + L * i < c) dst[ch + L * i] = s[i];
      }
    }
    __syncthreads();
  }
}

template <int L, int CH>
cudaError_t launch_sum(const float* g, const int* offsets, const int* order,
                       int b, int n, int entries, int c, float* out,
                       cudaStream_t stream) {
  constexpr int rows_a_block = kSumThreads / L / 2;
  const dim3 grid((n + rows_a_block - 1) / rows_a_block, b);
  return papc_launch(scatter_sum_kernel<L, CH>, grid, dim3(kSumThreads), 0,
                     stream, g, offsets, order, n, entries, c, out);
}

template <int CH = 1>
cudaError_t launch_sum_32(int chans, const float* g, const int* offsets,
                          const int* order, int b, int n, int entries, int c,
                          float* out, cudaStream_t stream) {
  if (chans == CH)
    return launch_sum<32, CH>(g, offsets, order, b, n, entries, c, out,
                              stream);
  if constexpr (CH < 8)
    return launch_sum_32<CH + 1>(chans, g, offsets, order, b, n, entries, c,
                                 out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// g [B, S, K, C] f32, idx [B, S, K] i32 -> out [B, N, C] f32, every row
// written. Scratch: offsets [B, N + 1] and order [B, S * K] i32, both
// written here (the inverse index). warps: the index kernel's warps a
// cloud (shared memory (warps * N + N + 32) * 4 bytes); lanes (4, 8, 16 or
// 32; 32 with chans > 1) and chans (1-8): the sum kernel's lanes a row and
// channels a lane.
PAPC_EXPORT int papc_group_scatter_add(const float* g, const int* idx, int b,
                                       int n, int s, int k, int c, int warps,
                                       int lanes, int chans, int* offsets,
                                       int* order, float* out, void* stream) {
  const long long entries = static_cast<long long>(s) * k;
  if (b <= 0 || n <= 0 || s <= 0 || k <= 0 || c <= 0 || warps < 1 ||
      warps > 32 || chans < 1 || chans > 8 || (lanes < 32 && chans != 1) ||
      entries > INT_MAX || b > 65535 ||
      static_cast<long long>(b) * n > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(warps) * n + n + 32) * sizeof(int);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = papc_launch(inverse_index_kernel, dim3(b),
                                dim3(32 * warps), smem, st, idx, n,
                                static_cast<int>(entries), offsets, order);
  if (err != cudaSuccess) return err;
  const int e = static_cast<int>(entries);
  switch (lanes) {
    case 4:
      return launch_sum<4, 1>(g, offsets, order, b, n, e, c, out, st);
    case 8:
      return launch_sum<8, 1>(g, offsets, order, b, n, e, c, out, st);
    case 16:
      return launch_sum<16, 1>(g, offsets, order, b, n, e, c, out, st);
    case 32:
      return launch_sum_32(chans, g, offsets, order, b, n, e, c, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}
