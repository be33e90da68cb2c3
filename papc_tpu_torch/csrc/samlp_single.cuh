// Shared pieces of the single-launch recompute passes (#15-18), the
// counterparts of papc_tpu/ops/pallas/samlp_single.py: each pass is ONE
// cooperative launch of persistent 8-warp blocks, as many as the card
// holds at once (launch_cooperative), each block walking one contiguous
// range of rows cut at the plan's unit (block_rows: whole groups whose g2
// rows start on 16 bytes; 8 rows for the forward stats pass, which has no
// groups), and after a grid barrier the same launch adds the blocks'
// partials, each output element by one thread in block order (grid_sum):
// the same bits every run. A range never splits a group, so the max pass
// needs no merge across blocks: a group's keys are carried from tile to
// tile inside the block.
//
// The forward passes (samlp_single_fwd.cu) run #11 and #12's tile loop
// (samlp_rc_fwd.cuh), the backward passes (samlp_single_bwd.cu) #13 and
// #14's tile body (samlp_rc_bwd.cuh); both take block_rows, grid_sum and
// the launch from here.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "samlp_rc_bwd.cuh"

namespace samlp_single {

using samlp_rc::Chain;

// Whether the operands the passes copy in 16-byte pieces are aligned.
inline bool aligned16(const Chain& ch) {
  if (reinterpret_cast<uintptr_t>(ch.g2) % 16) return false;
  for (int j = 1; j <= ch.n; ++j)
    if (reinterpret_cast<uintptr_t>(ch.w[j]) % 16) return false;
  return true;
}

// The block's rows [begin, end): units of `unit` rows split evenly.
__device__ inline void block_rows(int m, int unit, int& begin, int& end) {
  const long long units = (m + unit - 1) / unit;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  begin = static_cast<int>(min(static_cast<long long>(m), u0 * unit));
  end = static_cast<int>(min(static_cast<long long>(m), u1 * unit));
}

// The block's rows [begin, end) and its tiles of tm rows from begin.
__device__ inline int block_tiles(int m, int unit, int tm, int& begin,
                                  int& end) {
  block_rows(m, unit, begin, end);
  return end > begin ? (end - begin + tm - 1) / tm : 0;
}

// Whether `unit` cuts block ranges at whole groups whose g2 rows start on
// 16 bytes (the tile loops read their input rows in 16-byte pieces).
inline bool unit_ok(const Chain& st, int unit) {
  return unit > 0 && unit % st.k == 0 &&
         static_cast<long long>(unit) * st.c[0] % 8 == 0;
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
  constexpr int kThreads = samlp_rcb::kThreads;
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
