// Greedy NMS over a precomputed IoU matrix in two launches:
//   keep = valid; for i in 0..K-1: if keep[i]: keep[j] = 0 for every
//   j > i with iou[i, j] > threshold.
//
// Replaces: papc_tpu/ops/pallas/nms.py::greedy_suppress_pallas
// (_greedy_kernel), which holds the padded [K, K] overlap matrix in
// VMEM and so serves K <= 1408 only.
//
// What bounds it on the H100: the sweep's K dependent decisions
// (nms_mask.cuh). The bytes are one read of the matrix's upper triangle
// (2 MB a frame at K = 1000, 0.6 us at 3.35 TB/s) and the operations one
// compare a pair.
//
// Design: greedy_mask_kernel thresholds the whole upper triangle at
// once across the card into nms_mask.cuh's bitmask (bit j of row i:
// iou[i, j] > threshold for valid i < j, compared in f32; NaN sets no
// bit), and the shared sweep resolves the greedy order over the bits. A
// warp takes one row and kChunks runs of 32 x V columns: where K % 4 == 0
// (and the matrix is 16-byte aligned) each lane reads 4 columns with one
// 16-byte load (V = 4), the warp 512 contiguous bytes a run, else one
// (V = 1); the bits of 8 lanes (V = 4) or of the warp (V = 1) make 32
// bits, half a word.
#include <cstdint>

#include "nms_mask.cuh"

namespace {

constexpr int kWarps = 8;   // rows a block of the mask kernel
constexpr int kChunks = 4;  // runs of 32 x V columns a warp, loads in flight

// Grid (ceil(K / kWarps), ceil(K / (kChunks x 32 x V)), B): warp w of
// block (x, y, b) takes row i = kWarps x + w of frame b and the columns
// from c0 = kChunks x 32 x V y on. Every row i < K writes all its words,
// zeros below the diagonal.
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
    greedy_mask_kernel(const float* __restrict__ iou,
                       const bool* __restrict__ valid, int k, float thr,
                       uint64_t* __restrict__ mask) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= k) return;  // the whole warp
  const int b = blockIdx.z, nw = nms::words(k);
  const int c0 = blockIdx.y * kChunks * 32 * V;
  const size_t frame = static_cast<size_t>(b) * k;
  const float* row = iou + (frame + i) * k;
  const bool live = valid[frame + i] && c0 + kChunks * 32 * V - 1 > i;
  unsigned got[kChunks];  // bit e: column c0 + 32 V chunk + V lane + e
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int c = c0 + 32 * V * q + V * lane;
    got[q] = 0;
    if (!live || c >= k || c + V - 1 <= i) continue;
    if (V == 4) {  // k % 4 == 0, so c + 3 < k and both loads are aligned
      const float4 v = *reinterpret_cast<const float4*>(row + c);
      const uchar4 ok = *reinterpret_cast<const uchar4*>(valid + frame + c);
      got[q] = (v.x > thr && ok.x && c > i) |
               (v.y > thr && ok.y && c + 1 > i) << 1 |
               (v.z > thr && ok.z && c + 2 > i) << 2 |
               (v.w > thr && ok.w && c + 3 > i) << 3;
    } else {
      got[q] = row[c] > thr && valid[frame + c];
    }
  }
  uint32_t* out = reinterpret_cast<uint32_t*>(
      mask + b * nms::frame_words(k) + static_cast<size_t>(i) * nw);
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int h = (c0 + 32 * V * q) / 32 + (V == 4 ? lane / 8 : 0);
    uint32_t bits;
    if (V == 4) {
      bits = got[q] << (4 * (lane & 7));
      bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
      bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
      bits |= __shfl_xor_sync(0xffffffffu, bits, 4);
    } else {
      bits = __ballot_sync(0xffffffffu, got[q] != 0);
    }
    if ((V == 4 ? (lane & 7) == 0 : lane == 0) && h < 2 * nw) out[h] = bits;
  }
}

__global__ void __launch_bounds__(1024)
    greedy_sweep_kernel(const uint64_t* __restrict__ mask,
                        const bool* __restrict__ valid, int k, bool staged,
                        bool* __restrict__ keep) {
  const size_t frame = static_cast<size_t>(blockIdx.x) * k;
  nms::sweep(mask + blockIdx.x * nms::frame_words(k), valid + frame, k,
             staged, keep + frame);
}

}  // namespace

// iou [B, K, K] f32, valid [B, K] bool -> keep [B, K] bool. scratch: the
// mask, B x nms::frame_words(K) 64-bit words
// (ops/kernels/nms.py::scratch_bytes).
PAPC_EXPORT int papc_nms_greedy(const float* iou, const bool* valid, int b,
                                int k, float thr, void* scratch, bool* keep,
                                void* stream) {
  if (b <= 0 || b > 65535 || k <= 0 || k > nms::kMaxK)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* mask = static_cast<uint64_t*>(scratch);
  const int rows = (k + kWarps - 1) / kWarps;
  // 16-byte rows of iou and 4-byte runs of valid
  const bool wide = k % 4 == 0 && reinterpret_cast<uintptr_t>(iou) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  cudaError_t err;
  if (wide)
    err = papc_launch(greedy_mask_kernel<4>,
                      dim3(rows, (k + kChunks * 128 - 1) / (kChunks * 128), b),
                      dim3(kWarps * 32), 0, s, iou, valid, k, thr, mask);
  else
    err = papc_launch(greedy_mask_kernel<1>,
                      dim3(rows, (k + kChunks * 32 - 1) / (kChunks * 32), b),
                      dim3(kWarps * 32), 0, s, iou, valid, k, thr, mask);
  if (err != cudaSuccess) return err;
  return nms::launch_sweep(greedy_sweep_kernel, mask, valid, b, k, keep, s);
}
