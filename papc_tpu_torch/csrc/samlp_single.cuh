// Shared pieces of the single-launch recompute passes (#15-18), the
// counterparts of papc_tpu/ops/pallas/samlp_single.py: each pass is ONE
// cooperative launch of persistent 8-warp blocks, as many as the card
// holds at once (launch_cooperative), each block walking one contiguous
// range of rows cut at group boundaries (block_rows: at k rows; 8 for the
// stats pass, which has no groups), and after a grid barrier the same
// launch adds the blocks' partials, each output element by one thread in
// block order (grid_sum): the same bits every run. A range never splits a
// group, so the max pass needs no merge across blocks: a group's key is
// carried from tile to tile inside the block.
//
// The forward passes (samlp_single_fwd.cu: stats, final max) run the wmma
// per-tile bodies of samlp_recompute.cuh and use the rest of this header:
// - the block stages the pass's constants once: bf16 packed weights,
//   biases and BN vectors (stage_constants), so no product reads a weight
//   fragment from device memory or L2;
// - it walks its range in tiles of tm rows (walk_tiles); while tile t
//   computes, tile t+1's g2 rows are in flight with cp.async into the
//   second of two buffers; its sums stay in shared memory across its
//   tiles and are written once.
// The backward passes (samlp_single_bwd.cu) run #13 and #14's tile body
// (samlp_rc_bwd.cuh) and take block_rows, grid_sum and the launch.
//
// Shared memory of a forward pass, after the tile chain's regions
// (samlp_rc::make_layout), each region on a 128-byte boundary
// (ops/kernels/samlp_single.py::smem_bytes computes the same bytes): W_1
// .. W_n bf16 [p_{j-1}, p_j]; bias_j f32 [c_j]; vec_j f32 [2, c_j] (the
// stats pass at level l stages the l-1 known ones); two g2 buffers of tm *
// c_0 bf16.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "samlp_recompute.cuh"

namespace samlp_single {

using samlp_rc::at;
using samlp_rc::bf16;
using samlp_rc::Chain;
using samlp_rc::kMaxLayers;
using samlp_rc::Layout;
using samlp_rc::Pass;
using samlp_rc::round128;

struct Single {
  Layout l;         // the tile chain's regions
  int nv;           // vectors staged (layers 1..nv), rows scale and shift
  int unit;         // rows a range is cut at
  unsigned w[kMaxLayers + 1], bias[kMaxLayers + 1], vec[kMaxLayers + 1];
  unsigned in[2], bytes;
};

// n: the layers the pass runs (upto for the stats pass).
inline Single make_single(Pass pass, const Chain& ch, int tm, int n) {
  Single s{};
  s.l = samlp_rc::make_layout(pass, ch, tm, n);
  s.nv = pass == samlp_rc::kStats ? n - 1 : n;
  s.unit = pass == samlp_rc::kStats ? 8 : ch.k;
  unsigned off = round128(s.l.bytes);
  for (int j = 1; j <= n; ++j) {
    s.w[j] = off;
    off += round128(static_cast<size_t>(ch.p[j - 1]) * ch.p[j] * 2);
  }
  for (int j = 1; j <= n; ++j) {
    s.bias[j] = off;
    off += round128(static_cast<size_t>(ch.c[j]) * 4);
  }
  for (int j = 1; j <= s.nv; ++j) {
    s.vec[j] = off;
    off += round128(static_cast<size_t>(2) * ch.c[j] * 4);
  }
  const unsigned in_bytes = round128(static_cast<size_t>(tm) * ch.c[0] * 2);
  for (int b = 0; b < 2; ++b) {
    s.in[b] = off;
    off += in_bytes;
  }
  s.bytes = off;
  return s;
}

// Whether the operands the passes copy in 16-byte pieces are aligned.
inline bool aligned16(const Chain& ch) {
  if (reinterpret_cast<uintptr_t>(ch.g2) % 16) return false;
  for (int j = 1; j <= ch.n; ++j)
    if (reinterpret_cast<uintptr_t>(ch.w[j]) % 16) return false;
  return true;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the pass's constants into shared memory once; sc is ch with its
// weight, bias and vector pointers moved there.
__device__ inline void stage_constants(const Chain& ch, const Single& s,
                                       int n, unsigned char* smem,
                                       Chain& sc) {
  sc = ch;
  for (int j = 1; j <= n; ++j) {
    const int words = ch.p[j - 1] * ch.p[j] / 8;  // 16-byte words
    const uint4* src = reinterpret_cast<const uint4*>(ch.w[j]);
    uint4* dst = at<uint4>(smem, s.w[j]);
    for (int e = threadIdx.x; e < words; e += blockDim.x) dst[e] = src[e];
    sc.w[j] = at<bf16>(smem, s.w[j]);
    float* bias = at<float>(smem, s.bias[j]);
    for (int e = threadIdx.x; e < ch.c[j]; e += blockDim.x)
      bias[e] = ch.bias[j][e];
    sc.bias[j] = bias;
    if (j <= s.nv) {
      float* vec = at<float>(smem, s.vec[j]);
      for (int e = threadIdx.x; e < 2 * ch.c[j]; e += blockDim.x)
        vec[e] = ch.vec[j][e];
      sc.vec[j] = vec;
    }
  }
}

// The block's rows [begin, end): units of `unit` rows split evenly.
__device__ inline void block_rows(int m, int unit, int& begin, int& end) {
  const long long units = (m + unit - 1) / unit;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  begin = static_cast<int>(min(static_cast<long long>(m), u0 * unit));
  end = static_cast<int>(min(static_cast<long long>(m), u1 * unit));
}

// The 16-byte-aligned part [a0, a1) of the bytes [b0, b1) of g2 that a
// tile of `rows` rows from row0 covers: it is copied with cp.async; the
// few elements before a0 and after a1 are read directly.
struct Span {
  size_t a0, a1;
};

__device__ inline Span input_span(const Chain& ch, int row0, int rows) {
  const size_t b0 = static_cast<size_t>(row0) * ch.c[0] * 2;
  const size_t b1 = b0 + static_cast<size_t>(rows) * ch.c[0] * 2;
  Span sp{(b0 + 15) & ~static_cast<size_t>(15), b1 & ~static_cast<size_t>(15)};
  if (sp.a1 < sp.a0) sp.a1 = sp.a0;
  return sp;
}

__device__ inline void fetch_input(const Chain& ch, const Single& s,
                                   unsigned char* smem, int buf, int row0,
                                   int rows) {
  const Span sp = input_span(ch, row0, rows);
  const char* src = reinterpret_cast<const char*>(ch.g2) + sp.a0;
  unsigned char* dst = smem + s.in[buf];
  for (size_t i = threadIdx.x * size_t{16}; i < sp.a1 - sp.a0;
       i += blockDim.x * size_t{16})
    cp_async16(dst + i, src + i);
}

// The tile's g2 rows from buffer `buf` into h_0 (zero past `rows` and in
// the channel padding).
__device__ inline void unpack_input(const Chain& ch, const Single& s,
                                    unsigned char* smem, int buf, int row0,
                                    int rows) {
  const Span sp = input_span(ch, row0, rows);
  const bf16* staged = at<bf16>(smem, s.in[buf]);
  bf16* x0 = at<bf16>(smem, s.l.h[0]);
  const int c0 = ch.c[0], p0 = ch.p[0];
  for (int e = threadIdx.x; e < s.l.tm * p0; e += blockDim.x) {
    const int r = e / p0, c = e - r * p0;
    bf16 v = __float2bfloat16_rn(0.f);
    if (r < rows && c < c0) {
      const size_t idx = static_cast<size_t>(row0 + r) * c0 + c;
      v = (2 * idx >= sp.a0 && 2 * idx < sp.a1) ? staged[idx - sp.a0 / 2]
                                                 : ch.g2[idx];
    }
    x0[r * s.l.ld[0] + c] = v;
  }
}

// Walks the block's range tile by tile with the next tile's g2 rows in
// flight: body(row0, end) runs with h_0 in place (after a block barrier).
// Ends with a block barrier.
template <typename Body>
__device__ void walk_tiles(const Chain& ch, const Single& s,
                           unsigned char* smem, Body body) {
  int begin, end;
  block_rows(ch.m, s.unit, begin, end);
  const int tm = s.l.tm;
  const int tiles = end > begin ? (end - begin + tm - 1) / tm : 0;
  auto fetch = [&](int i) {
    const int row0 = begin + i * tm, rows = min(tm, end - row0);
    fetch_input(ch, s, smem, i & 1, row0, rows);
  };
  if (tiles > 0) fetch(0);
  cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) fetch(i + 1);
    cp_async_commit();  // an empty group on the last tile keeps the count
    cp_async_wait<1>();  // tile i's copies have landed
    __syncthreads();     // ... from every thread; the last tile is done
    const int row0 = begin + i * tm;
    unpack_input(ch, s, smem, i & 1, row0, min(tm, end - row0));
    __syncthreads();
    body(row0, end);
    __syncthreads();  // buffer i & 1 is free for tile i + 2
  }
  cp_async_wait<0>();
  __syncthreads();  // also orders the caller's set-up before what follows
}

// After the grid barrier: out[r * cols + c] = sum over the blocks i, in
// order, of part[i * stride + r * ld + c], each element by one thread,
// eight blocks' loads issued before they are added in order.
__device__ inline void grid_sum(const float* part, size_t stride, int rows,
                                int cols, int ld, float* out) {
  const int total = rows * cols;
  const unsigned blocks = gridDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int r = e / cols, c = e - r * cols;
    const float* src = part + static_cast<size_t>(r) * ld + c;
    float acc = 0.f;
    unsigned i = 0;
    for (; i + 8 <= blocks; i += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(src + (i + u) * stride);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += v[u];
    }
    for (; i < blocks; ++i) acc += __ldcg(src + i * stride);
    out[e] = acc;
  }
}

// A cooperative launch of `kernel` on as many blocks as the card holds at
// once at `smem` bytes (cudaOccupancyMaxActiveBlocksPerMultiprocessor), at
// most max_blocks. A grid the card cannot hold at once is refused by the
// launch (a grid barrier would deadlock), never run.
template <typename Kernel, typename... Args>
inline cudaError_t launch_cooperative(Kernel kernel, int max_blocks,
                                      size_t smem, cudaStream_t stream,
                                      Args... args) {
  constexpr int kThreads = samlp_rc::kWarps * 32;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks = min(max_blocks, per_sm * sms);
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  void* argv[] = {static_cast<void*>(&args)...};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), argv, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace samlp_single
