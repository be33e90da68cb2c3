// Grouping gather of a set-abstraction stage, in row layout:
//   out[b, s, k, :] = concat(xyz, feats)[b, clip(idx[b, s, k]), :]
// with new_xyz[b, s] subtracted from the three xyz channels.
//
// Replaces: papc_tpu/ops/pallas/gather_t.py::gather_cols_pallas
// (_gather_t_kernel), the forward of gather_cols. On the TPU the gather
// is a one-hot product on the MXU in a channel-major [B, C, M] layout,
// exact through a hi/mid/lo bf16 split; the centring is the elementwise
// step that follows it (papc_tpu/ops/grouping.py:214-220). Fusing the
// centring here computes the same function.
//
// What bounds it on the H100: bytes. It writes the grouped tensor once
// (SA2: 32 x 128 x 64 x 131 x 4 B = 137 MB) and reads each gathered
// source row from L2 (a batch's source is at most 32 x 512 x 131 x 4 B =
// 8.6 MB); there is no arithmetic beyond one subtraction.
//
// Design (the plan is ops/kernels/gather.py::gather_plan; blocks of 256
// threads):
//  - A block takes `tile` consecutive groups (b, s). Their output is one
//    contiguous span of tile x K x C floats (C = 3 + D).
//  - Phase 1, once a row: a thread per gathered row (b, s, k) reads idx,
//    clamps it and leaves one 16-byte record in shared memory: the three
//    centred xyz channels (__fsub_rn, as the plain version) and the
//    source row b * N + j. This is all of a row's index math, in 32 bits.
//  - Phase 2: the block writes its span in chunks of V floats, one
//    16-byte streaming store (st.global.cs) a chunk where K * C % 4 == 0
//    (V = 4; the span then starts on 16 bytes), else coalesced 4-byte
//    stores (V = 1); neighbouring threads take neighbouring chunks. A
//    thread finds its first chunk's (row, channel) with one division and
//    steps to its next chunk by a fixed (rows, channels) increment. An
//    element costs a read of its row's record (a broadcast: a warp's
//    chunks cover one to three rows) and, for a feature channel, one
//    4-byte load of the source row, neighbouring lanes on neighbouring
//    channels. A row of the output starts 3 floats after the feature row
//    it copies, so a 16-byte output chunk straddles two 16-byte source
//    chunks: the loads stay 4 bytes wide and coalesced (the same sectors
//    as 16-byte loads), the stores take 16. Two chunks' loads are in
//    flight before their stores.
//  - A copy and one correctly rounded subtraction: the result equals the
//    plain version exactly.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// V output values from row r, channel c of the block's span onwards (the
// chunk may run into the next row). rows[r]: the centred xyz in x, y, z
// and the source row in w.
template <int V>
__device__ __forceinline__ void read_chunk(const float4* rows,
                                           const float* __restrict__ feats,
                                           int d, int c_all, int r, int c,
                                           float (&v)[V]) {
  float4 t = rows[r];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (c == c_all) {
      c = 0;
      t = rows[++r];
    }
    v[i] = c == 0   ? t.x
           : c == 1 ? t.y
           : c == 2 ? t.z
                    : feats[static_cast<long long>(__float_as_int(t.w)) * d +
                            (c - 3)];
    ++c;
  }
}

template <int V>
__device__ __forceinline__ void write_chunk(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// (r, c) advanced by (dr, dc) elements, dc < c_all.
__device__ __forceinline__ void advance(int& r, int& c, int dr, int dc,
                                        int c_all) {
  r += dr;
  c += dc;
  if (c >= c_all) {
    c -= c_all;
    ++r;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    group_gather_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ feats,
                        const int* __restrict__ idx,
                        const float* __restrict__ new_xyz, int n, int d, int s,
                        int k, int groups, int tile, float* __restrict__ out) {
  extern __shared__ float4 rows[];
  const int c_all = 3 + d;
  const int g0 = blockIdx.x * tile;  // the block's first group
  const int n_rows = min(tile, groups - g0) * k;
  const int* block_idx = idx + static_cast<long long>(g0) * k;
  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    const int q = g0 + r / k;  // flat (b, s)
    const int b = q / s;
    const int j = min(max(block_idx[r], 0), n - 1);
    const int src = b * n + j;
    const float* p = xyz + 3LL * src;
    const float* o = new_xyz + 3LL * q;
    rows[r] = make_float4(__fsub_rn(p[0], o[0]), __fsub_rn(p[1], o[1]),
                          __fsub_rn(p[2], o[2]), __int_as_float(src));
  }
  __syncthreads();

  float* span = out + static_cast<long long>(g0) * k * c_all;
  const int n_elems = n_rows * c_all;
  constexpr int kStep = V * kThreads;  // elements between a thread's chunks
  const int step_r = kStep / c_all, step_c = kStep - step_r * c_all;
  int e = V * threadIdx.x;
  int r = e / c_all, c = e - r * c_all;
  for (; e < n_elems; e += 2 * kStep) {
    float va[V], vb[V];
    int r2 = r, c2 = c;
    advance(r2, c2, step_r, step_c, c_all);
    const bool second = e + kStep < n_elems;
    read_chunk<V>(rows, feats, d, c_all, r, c, va);
    if (second) read_chunk<V>(rows, feats, d, c_all, r2, c2, vb);
    write_chunk<V>(span + e, va);
    if (second) write_chunk<V>(span + e + kStep, vb);
    r = r2;
    c = c2;
    advance(r, c, step_r, step_c, c_all);
  }
}

}  // namespace

// xyz [B, N, 3], feats [B, N, D] or null when D = 0, idx [B, S, K] i32,
// new_xyz [B, S, 3] -> out [B, S, K, 3 + D] f32. tile: groups a block;
// vec: floats a store, 4 (K * (3 + D) % 4 == 0 and out on 16 bytes) or 1.
PAPC_EXPORT int papc_group_gather(const float* xyz, const float* feats,
                                  const int* idx, const float* new_xyz,
                                  int b, int n, int d, int s, int k, int tile,
                                  int vec, float* out, void* stream) {
  const long long c_all = 3LL + d;
  if (b <= 0 || n <= 0 || d < 0 || s <= 0 || k <= 0 || tile <= 0 ||
      (d > 0 && feats == nullptr) || static_cast<long long>(b) * n > INT_MAX ||
      static_cast<long long>(b) * s > INT_MAX ||
      static_cast<long long>(tile) * k * c_all > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(tile) * k * sizeof(float4);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const int groups = b * s;
  const dim3 grid(static_cast<unsigned>((groups + tile - 1LL) / tile));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    if (k * c_all % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return cudaErrorInvalidValue;
    return papc_launch(group_gather_kernel<4>, grid, dim3(kThreads), smem, st,
                       xyz, feats, idx, new_xyz, n, d, s, k, groups, tile,
                       out);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  return papc_launch(group_gather_kernel<1>, grid, dim3(kThreads), smem, st,
                     xyz, feats, idx, new_xyz, n, d, s, k, groups, tile, out);
}
