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
//  - bf16 (the bf16 training step; the TPU kernel's bf16 branch gathers a
//    bf16 source in one exact pass and writes bf16): the same design on
//    2-byte elements. A chunk is 8 values (16 bytes) where K * C % 8 ==
//    0, else one (2-byte stores). Values travel as their raw bits, a
//    feature element as one 2-byte load, and are packed two to a word at
//    the store. The centring takes the difference of the two bf16 values
//    in f32, where it is exact unless their exponents lie more than 16
//    apart, and rounds it once to bf16 (__float2bfloat16_rn): the bits of
//    a bf16 subtraction, as JAX's (papc_tpu/ops/grouping.py:216-219) and
//    the plain version's. The record keeps that rounded value as a float.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The centred coordinate p - o, rounded once to T.
__device__ __forceinline__ float centre(float p, float o) {
  return __fsub_rn(p, o);
}
__device__ __forceinline__ float centre(__nv_bfloat16 p, __nv_bfloat16 o) {
  return __bfloat162float(
      __float2bfloat16_rn(__fsub_rn(__bfloat162float(p), __bfloat162float(o))));
}

// A value's bits as T stores them: f32 bits, or the high half of a float
// that holds a bf16 value exactly.
template <typename T>
__device__ __forceinline__ unsigned bits_of(float v) {
  return sizeof(T) == 2 ? __float_as_uint(v) >> 16 : __float_as_uint(v);
}
__device__ __forceinline__ unsigned load_bits(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ unsigned load_bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// V output values from row r, channel c of the block's span onwards (the
// chunk may run into the next row), as raw bits. rows[r]: the centred xyz
// in x, y, z and the source row in w.
template <typename T, int V>
__device__ __forceinline__ void read_chunk(const float4* rows,
                                           const T* __restrict__ feats,
                                           int d, int c_all, int r, int c,
                                           unsigned (&v)[V]) {
  float4 t = rows[r];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (c == c_all) {
      c = 0;
      t = rows[++r];
    }
    v[i] = c == 0   ? bits_of<T>(t.x)
           : c == 1 ? bits_of<T>(t.y)
           : c == 2 ? bits_of<T>(t.z)
                    : load_bits(feats +
                                static_cast<long long>(__float_as_int(t.w)) *
                                    d +
                                (c - 3));
    ++c;
  }
}

// One chunk's streaming store: 16 bytes (4 f32 or 8 bf16), or one value.
template <typename T, int V>
__device__ __forceinline__ void write_chunk(T* p, const unsigned (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 2)
      __stcs(reinterpret_cast<unsigned short*>(p),
             static_cast<unsigned short>(v[0]));
    else
      __stcs(reinterpret_cast<unsigned*>(p), v[0]);
  } else if constexpr (sizeof(T) == 2) {
    static_assert(V == 8, "a bf16 chunk is 8 values or one");
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                      v[4] | v[5] << 16, v[6] | v[7] << 16));
  } else {
    static_assert(V == 4, "an f32 chunk is 4 values or one");
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
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

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    group_gather_kernel(const T* __restrict__ xyz, const T* __restrict__ feats,
                        const int* __restrict__ idx,
                        const T* __restrict__ new_xyz, int n, int d, int s,
                        int k, int groups, int tile, T* __restrict__ out) {
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
    const T* p = xyz + 3LL * src;
    const T* o = new_xyz + 3LL * q;
    rows[r] = make_float4(centre(p[0], o[0]), centre(p[1], o[1]),
                          centre(p[2], o[2]), __int_as_float(src));
  }
  __syncthreads();

  T* span = out + static_cast<long long>(g0) * k * c_all;
  const int n_elems = n_rows * c_all;
  constexpr int kStep = V * kThreads;  // elements between a thread's chunks
  const int step_r = kStep / c_all, step_c = kStep - step_r * c_all;
  int e = V * threadIdx.x;
  int r = e / c_all, c = e - r * c_all;
  for (; e < n_elems; e += 2 * kStep) {
    unsigned va[V], vb[V];
    int r2 = r, c2 = c;
    advance(r2, c2, step_r, step_c, c_all);
    const bool second = e + kStep < n_elems;
    read_chunk<T, V>(rows, feats, d, c_all, r, c, va);
    if (second) read_chunk<T, V>(rows, feats, d, c_all, r2, c2, vb);
    write_chunk<T, V>(span + e, va);
    if (second) write_chunk<T, V>(span + e + kStep, vb);
    r = r2;
    c = c2;
    advance(r, c, step_r, step_c, c_all);
  }
}

template <typename T>
cudaError_t launch(const void* xyz, const void* feats, const int* idx,
                   const void* new_xyz, int n, int d, int s, int k,
                   int groups, int tile, int vec, void* out, size_t smem,
                   cudaStream_t st) {
  constexpr int kWide = 16 / sizeof(T);  // values a 16-byte chunk
  const dim3 grid(static_cast<unsigned>((groups + tile - 1LL) / tile));
  const T* x = static_cast<const T*>(xyz);
  const T* f = static_cast<const T*>(feats);
  const T* o = static_cast<const T*>(new_xyz);
  T* y = static_cast<T*>(out);
  if (vec == kWide) {
    if (static_cast<long long>(k) * (3 + d) % kWide != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return cudaErrorInvalidValue;
    return papc_launch(group_gather_kernel<T, kWide>, grid, dim3(kThreads),
                       smem, st, x, f, idx, o, n, d, s, k, groups, tile, y);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  return papc_launch(group_gather_kernel<T, 1>, grid, dim3(kThreads), smem,
                     st, x, f, idx, o, n, d, s, k, groups, tile, y);
}

}  // namespace

// xyz [B, N, 3], feats [B, N, D] or null when D = 0, idx [B, S, K] i32,
// new_xyz [B, S, 3] -> out [B, S, K, 3 + D], all f32 (bf16 = 0) or all
// bf16 (bf16 = 1). tile: groups a block; vec: values a store, 16 bytes'
// worth (4 f32 or 8 bf16: K * (3 + D) a multiple of it and out on 16
// bytes) or 1.
PAPC_EXPORT int papc_group_gather(const void* xyz, const void* feats,
                                  const int* idx, const void* new_xyz,
                                  int bf16, int b, int n, int d, int s, int k,
                                  int tile, int vec, void* out, void* stream) {
  const long long c_all = 3LL + d;
  if (b <= 0 || n <= 0 || d < 0 || s <= 0 || k <= 0 || tile <= 0 ||
      (d > 0 && feats == nullptr) || static_cast<long long>(b) * n > INT_MAX ||
      static_cast<long long>(b) * s > INT_MAX ||
      static_cast<long long>(tile) * k * c_all > INT_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(tile) * k * sizeof(float4);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const int groups = b * s;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(xyz, feats, idx, new_xyz, n, d, s, k, groups,
                                 tile, vec, out, smem, st);
  return launch<float>(xyz, feats, idx, new_xyz, n, d, s, k, groups, tile,
                       vec, out, smem, st);
}
