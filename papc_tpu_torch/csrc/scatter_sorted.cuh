// The owner-computes scatter-add of the port's two scatter backwards:
//   out[b, j, c] = sum of g[b, e, c] over the entries e of cloud b whose
//                  point is j                        (0 where none is j)
// in two launches, planned by ops/kernels/scatter_sorted.py::sorted_plan.
// The grouping gather's backward (group_scatter_add.cu, #4) clamps an
// entry's index into [0, n) as its forward does; the row gather's
// (scatter_rows_add.cu, #5) drops an index outside [0, n), as the TPU
// kernel's -1 padding matches no row. Each file defines its own two
// __global__ kernels on these bodies, so the profiler tells them apart.
//
//  1. inverse_index, a block of `warps` warps a cloud: the stable
//     counting sort of the cloud's entries by their point. Warp w takes
//     the w-th contiguous chunk of entries (8 loads a lane in flight) and
//     counts the ones it takes by point into its own row of shared memory
//     (warps x n ints, shared-memory atomics: a count does not depend on
//     their order). A column pass turns each point's counts into per-warp
//     starts, and an exclusive scan of the totals gives offsets[b, 0..n];
//     offsets[b, n] is the count of entries taken (all of them under
//     clamp). Then each warp walks its chunk again, 32 entries at a time
//     in order, and writes entry e at offsets[j] + its warp's start for j
//     + the lanes below it with the same j (one ballot a bit of j, then
//     __popc): each point's list in order[b] holds its entries in
//     ascending order, whatever the schedule. A dropped entry is in no
//     list, and order[b] past offsets[b, n] is left as it was. The counts
//     set the largest n (the plan raises above it).
//  2. scatter_sum: a block takes 128 / L consecutive rows (b, j) of one
//     cloud, whose lists are one contiguous range of order[b], and splits
//     that range evenly over its 256 / L workers of L lanes (4 to 32):
//     ball query's padding gives a few points lists many times the mean,
//     which one worker alone would walk for the whole launch. A worker
//     walks its part in order, each lane adding `chans` channels (lane +
//     L * i) of each entry's g row (f32, or bf16 widened exactly) into
//     f32 registers with __fadd_rn, eight entries' loads in flight and
//     the next eight indices loading behind them. A row that lies inside
//     one worker's part is written whole by it; a row split over workers
//     leaves each part's sum in shared memory, and the merge adds the
//     parts in worker order and writes the row, or zeros where no entry
//     takes it: every row is written once and nothing is zero-filled
//     beforehand. Channels beyond L x chans take further walks. The row
//     is written as f32, or rounded once from its f32 sum to bf16 where
//     the caller's output is bf16 (the grouping gather's backward of a
//     bf16 source).
// No atomics on the output: the sum order is fixed by the index and the
// shapes, so two calls give the same bits. A row inside one worker's part
// adds in list order, which is a sequential index_add_'s (the plain
// version on the CPU); against the card's index_add_ (atomics, in no fixed
// order) the sums agree to their f32 rounding.
#pragma once

#include <climits>

#include <cuda_bf16.h>

#include "common.cuh"

namespace sorted {

constexpr int kSumThreads = 256;
constexpr int kUnroll = 8;  // entries whose loads are in flight together
constexpr int kBatch = 8;   // entries a lane of the index loads at once
constexpr int kSmemLimit = 232448;

// One element of g as its raw bits, widened to f32 (exactly) only where
// it is added: widening a bf16 as it lands made the compiler reuse one
// register for every load and so wait for each in turn.
__device__ __forceinline__ unsigned load_bits(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ unsigned load_bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}
template <typename T>
__device__ __forceinline__ float widen(unsigned bits) {
  return __uint_as_float(sizeof(T) == 2 ? bits << 16 : bits);
}

// A finished f32 sum stored in the output's type: as it is, or rounded
// once to bf16.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// The points of entries e, e + 32, ... (kBatch of them, below hi), their
// loads in flight together, and whether each is taken: below hi, and
// under kDrop inside [0, n) (without kDrop clamped into it).
template <bool kDrop>
__device__ __forceinline__ void load_points(const int* __restrict__ cloud,
                                            int n, int e, int hi,
                                            int (&j)[kBatch],
                                            bool (&taken)[kBatch]) {
#pragma unroll
  for (int t = 0; t < kBatch; ++t) {
    const int v = e + 32 * t < hi ? cloud[e + 32 * t] : 0;
    taken[t] = e + 32 * t < hi && (!kDrop || (v >= 0 && v < n));
    j[t] = kDrop ? v : min(max(v, 0), n - 1);
  }
}

// Launch: a block of 32 * warps threads a cloud, dynamic shared memory
// (warps * n + n + 32) * 4 bytes.
template <bool kDrop>
__device__ __forceinline__ void inverse_index(const int* __restrict__ idx,
                                              int n, int entries,
                                              int* __restrict__ offsets,
                                              int* __restrict__ order) {
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
    bool taken[kBatch];
    load_points<kDrop>(cloud, n, base + lane, hi, j, taken);
#pragma unroll
    for (int t = 0; t < kBatch; ++t)
      if (taken[t]) atomicAdd(&mine[j[t]], 1);
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
  if (w == 0) {  // sums[31] ends as the count of every entry taken
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
    cloud_offsets[i] = i < n ? starts[i] : sums[31];
  int* cloud_order = order + static_cast<long long>(blockIdx.x) * entries;
  for (int base = lo; base < hi; base += 32 * kBatch) {  // place it in order
    int j[kBatch];
    bool taken[kBatch];
    load_points<kDrop>(cloud, n, base + lane, hi, j, taken);
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int e = base + 32 * t + lane;
      const unsigned peers = same_point(j[t], taken[t], bits);
      if (taken[t])
        cloud_order[starts[j[t]] + mine[j[t]] + __popc(peers & below)] = e;
      __syncwarp();
      if (taken[t] && (peers & below) == 0) mine[j[t]] += __popc(peers);
      __syncwarp();
    }
  }
}

// Where a row's partial sum goes when a worker has walked its part of it:
// a row inside the worker's entry range [a, z) is written out; a row that
// began before a leaves its partial in head, one that runs past z in tail.
template <int L, int CH, typename O>
__device__ __forceinline__ void flush(const float (&acc)[CH], int lo, int hi,
                                      int a, int z, int sub, int ch, int c,
                                      O* row, float* head, float* tail) {
  if (lo == hi) return;  // no entry: the merge writes its zeros
  if (lo >= a && hi <= z) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if (ch + L * i < c) store(row + ch + L * i, acc[i]);
    return;
  }
  float* dst = lo < a ? head : tail;
#pragma unroll
  for (int i = 0; i < CH; ++i)
    if (ch + L * i < c) dst[sub + L * i] = acc[i];
}

// Launch: a grid of (ceil(n / (128 / L)), b) blocks of kSumThreads. The
// output is f32 or bf16 (O), the sums f32 in either case.
template <int L, int CH, typename T, typename O>
__device__ __forceinline__ void scatter_sum(const T* __restrict__ g,
                                            const int* __restrict__ offsets,
                                            const int* __restrict__ order,
                                            int n, int entries, int c,
                                            O* __restrict__ out) {
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
  const T* cloud = g + static_cast<long long>(b) * entries * c;
  O* rows_out = out + (static_cast<long long>(b) * n + j0) * c;

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
      unsigned v[kUnroll][CH];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* src = cloud + static_cast<long long>(e[u]) * c + ch;
#pragma unroll
        for (int i = 0; i < CH; ++i)
          v[u][i] =
              p + u < z && ch + L * i < c ? load_bits(src + L * i) : 0u;
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
          for (int i = 0; i < CH; ++i)
            acc[i] = __fadd_rn(acc[i], widen<T>(v[u][i]));
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
        O* dst = rows_out + static_cast<long long>(w) * c;
#pragma unroll
        for (int i = 0; i < CH; ++i)
          if (ch + L * i < c) store(dst + ch + L * i, s[i]);
      }
    }
    __syncthreads();
  }
}

// Sum<L, CH>::launch(grid, stream, g, offsets, order, n, entries, c, out)
// launches the including file's sum kernel for L lanes and CH channels.
template <template <int, int> class Sum, typename T, typename O, int CH = 1>
cudaError_t launch_sum_32(int chans, dim3 grid, cudaStream_t stream,
                          const T* g, const int* offsets, const int* order,
                          int n, int entries, int c, O* out) {
  if (chans == CH)
    return Sum<32, CH>::launch(grid, stream, g, offsets, order, n, entries,
                               c, out);
  if constexpr (CH < 8)
    return launch_sum_32<Sum, T, O, CH + 1>(chans, grid, stream, g, offsets,
                                         order, n, entries, c, out);
  return cudaErrorInvalidValue;
}

// Both launches: index_kernel (the including file's inverse_index) into
// offsets [b, n + 1] and order [b, entries], then the sum into out [b, n,
// c] (f32 or bf16), every row written. warps: the index's warps a cloud; lanes (4,
// 8, 16 or 32; 32 with chans > 1) and chans (1-8): the sum's lanes a row
// and channels a lane.
template <template <int, int> class Sum, typename T, typename O>
cudaError_t launch(void (*index_kernel)(const int*, int, int, int*, int*),
                   const T* g, const int* idx, int b, int n,
                   long long entries, int c, int warps, int lanes, int chans,
                   int* offsets, int* order, O* out, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || entries <= 0 || c <= 0 || warps < 1 ||
      warps > 32 || chans < 1 || chans > 8 || (lanes < 32 && chans != 1) ||
      entries > INT_MAX || b > 65535 ||
      static_cast<long long>(b) * n > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(warps) * n + n + 32) * sizeof(int);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const int e = static_cast<int>(entries);
  cudaError_t err = papc_launch(index_kernel, dim3(b), dim3(32 * warps), smem,
                                stream, idx, n, e, offsets, order);
  if (err != cudaSuccess) return err;
  const int rows = kSumThreads / lanes / 2;  // rows a sum block
  const dim3 grid((n + rows - 1) / rows, b);
  switch (lanes) {
    case 4:
      return Sum<4, 1>::launch(grid, stream, g, offsets, order, n, e, c, out);
    case 8:
      return Sum<8, 1>::launch(grid, stream, g, offsets, order, n, e, c, out);
    case 16:
      return Sum<16, 1>::launch(grid, stream, g, offsets, order, n, e, c,
                                out);
    case 32:
      return launch_sum_32<Sum, T, O>(chans, grid, stream, g, offsets, order,
                                      n, e, c, out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sorted
