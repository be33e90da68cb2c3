// The two stages both greedy NMS kernels share: a suppression bitmask
// built across the card (each kernel's own mask kernel), then this
// header's sweep over it.
//
// The mask: row i of a frame holds ceil(K / 64) 64-bit words, and bit j
// of row i (word j / 64, bit j % 64) is set when i < j, both boxes are
// valid and box i's overlap with box j exceeds the threshold. A frame's
// rows are padded to 64 * words (whole 64-row blocks, 16-byte aligned
// frames); the padding rows are never written and never decide anything.
//
// The sweep (greedy suppression, rows score-sorted, best first):
//   removed = ~valid; for i in 0..K-1: if bit i of removed is clear,
//   box i is kept and removed |= row i.
// This is the keep mask of the loop "a kept box i suppresses every j > i
// whose overlap exceeds the threshold", because the mask decides each
// pair without the sweep.
//
// What bounds it: K dependent decisions. One block a frame walks the
// frame's 64-row blocks; a block's decisions use only the diagonal words
// D of its rows (word r of rows 64r..64r+63, strictly upper triangular).
// Warp 0 resolves them in registers: the kept set is the one fixpoint of
// kept = ~removed & ~OR{D[b] : b in kept}, which iterating from ~removed
// reaches after as many rounds as the longest chain of suppressions in
// the block (a round: each lane masks its two rows' words, two
// redux.sync ORs); after kRounds rounds without the fixpoint it decides
// the 64 rows serially instead (three dependent integer operations a
// row). Then all warps OR the kept rows' later words into `removed` in
// shared memory: a group of four warps takes 32 words a pass, each warp
// 16 rows, by shared-memory atomics. Two barriers a row block. Where
// three row blocks (3 x 64 x words x 8 bytes) fit in shared memory
// beside `removed`, warps 1.. stage them by cp.async two blocks ahead;
// otherwise a block's words are read from device memory (L2).
//
// Why so: on the H100 a predicated OR over a block's 64 rows in one lane
// paid a load's latency a row, and 64 serial decisions cost more than
// the few rounds in which the detection masks' blocks reach the fixpoint.
#pragma once

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace nms {

constexpr int kRows = 64;          // rows a block of the sweep: one word
constexpr int kStages = 3;         // row blocks in the cp.async ring
constexpr int kRounds = 8;         // fixpoint rounds before the serial path
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use
// the sweep's `removed` words and its kept word in shared memory
constexpr int kMaxWords = static_cast<int>((kSmemLimit - 8) / 8);
constexpr int kMaxK = kRows * kMaxWords;

__host__ __device__ inline int words(int k) { return (k + kRows - 1) / kRows; }

// 64-bit words of one frame's padded mask
__host__ __device__ inline size_t frame_words(int k) {
  return static_cast<size_t>(kRows) * words(k) * words(k);
}

struct SweepPlan {
  int threads;
  bool staged;
  size_t smem;
};

// Mirrored by ops/kernels/nms.py::sweep_plan: a group of four warps a 32
// words, up to 1024 threads.
inline SweepPlan sweep_plan(int k) {
  const int w = words(k);
  int threads = 128 * ((w + 31) / 32);
  if (threads > 1024) threads = 1024;
  const size_t fixed = static_cast<size_t>(w) * 8 + 8;  // removed + kept
  const size_t ring = static_cast<size_t>(kStages) * kRows * w * 8;
  const bool staged = fixed + ring <= kSmemLimit;
  return {threads, staged, fixed + (staged ? ring : 0)};
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

// all but the newest kStages - 2 groups of this thread have landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// Row `bit` of a 64-row block, serially: kept iff its bit of the running
// word (lo, hi) is clear, and then its diagonal word d is ORed in (d's
// bits all lie above `bit`, so a row of the high half touches only hi).
__device__ __forceinline__ void decide(int bit, uint32_t& lo, uint32_t& hi,
                                       uint64_t d) {
  const uint32_t half = bit < 32 ? lo : hi;
  // all ones where the row is removed
  const uint32_t gone = static_cast<uint32_t>(
      static_cast<int32_t>(half << (31 - (bit & 31))) >> 31);
  if (bit < 32) lo |= static_cast<uint32_t>(d) & ~gone;
  hi |= static_cast<uint32_t>(d >> 32) & ~gone;
}

// Warp 0: the removed bits of a 64-row block after its own decisions,
// from `r0` (removed before them) and the block's diagonal words
// blk[b * nw + r].
__device__ __forceinline__ uint64_t resolve(const uint64_t* blk, int nw,
                                            int r, uint64_t r0, int lane) {
  const uint64_t da = blk[lane * nw + r], db = blk[(lane + 32) * nw + r];
  uint64_t kept = ~r0;
  for (int round = 0; round < kRounds; ++round) {
    const uint64_t v = (((kept >> lane) & 1) ? da : 0) |
                       (((kept >> (lane + 32)) & 1) ? db : 0);
    const uint64_t hit =
        static_cast<uint64_t>(__reduce_or_sync(
            0xffffffffu, static_cast<uint32_t>(v >> 32))) << 32 |
        __reduce_or_sync(0xffffffffu, static_cast<uint32_t>(v));
    const uint64_t next = ~r0 & ~hit;
    if (next == kept) return ~kept;  // the fixpoint: uniform
    kept = next;
  }
  uint32_t lo = static_cast<uint32_t>(r0), hi = static_cast<uint32_t>(r0 >> 32);
#pragma unroll
  for (int c = 0; c < kRows; c += 16) {
    uint64_t d[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) d[b] = blk[(c + b) * nw + r];
#pragma unroll
    for (int b = 0; b < 16; ++b) decide(c + b, lo, hi, d[b]);
  }
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// The sweep of one frame: `mask` its padded [64 * words][words] words,
// `valid` and `keep` its K flags. One block, sweep_plan(k) threads and
// shared memory.
__device__ __forceinline__ void sweep(const uint64_t* __restrict__ mask,
                                      const bool* __restrict__ valid, int k,
                                      bool staged, bool* __restrict__ keep) {
  extern __shared__ __align__(16) uint64_t sweep_smem[];
  const int nw = words(k);
  const size_t block_words = static_cast<size_t>(kRows) * nw;
  uint64_t* ring = sweep_smem;  // [kStages][64][nw] when staged
  uint64_t* removed = sweep_smem + (staged ? kStages * block_words : 0);
  uint64_t* kept_word = removed + nw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int T = blockDim.x;
  const bool copier = staged && warp > 0;

  // row block r into its stage, by warps 1.., 16 bytes a copy
  auto stage_in = [&](int r) {
    if (r < nw) {
      const uint64_t* src = mask + r * block_words;
      uint64_t* dst = ring + (r % kStages) * block_words;
      for (size_t c = tid - 32; c < block_words / 2; c += T - 32)
        cp_async16(dst + 2 * c, src + 2 * c);
    }
    cp_async_commit();
  };
  if (copier)
    for (int r = 0; r < kStages - 1; ++r) stage_in(r);
  // removed = ~valid, rows >= k too: a warp's ballot over 32 rows makes
  // half a word (the low half first); eight rows' loads in flight
#pragma unroll 8
  for (int base = tid - lane; base < kRows * nw; base += T) {
    const int i = base + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, i >= k || !valid[i]);
    if (lane == 0) reinterpret_cast<uint32_t*>(removed)[base / 32] = bits;
  }

  // the OR's share of this thread: rows 16 q .. 16 q + 15 of a block,
  // words r + 1 + first, + stride, ...
  const int q = warp & 3, first = 32 * (warp / 4) + lane;
  const int stride = 32 * (T / 128);
  for (int r = 0; r < nw; ++r) {
    if (copier) cp_async_wait_ring();
    __syncthreads();  // block r staged; removed[r] final; kept_word read
    // the stage that block r - 1 used takes block r + kStages - 1
    if (copier) stage_in(r + kStages - 1);
    const uint64_t* blk =
        staged ? ring + (r % kStages) * block_words : mask + r * block_words;
    if (warp == 0) {
      const uint64_t cur = resolve(blk, nw, r, removed[r], lane);
      if (lane == 0) *kept_word = ~cur;
      for (int b = lane; b < kRows; b += 32) {
        const int i = kRows * r + b;
        if (i < k) keep[i] = !((cur >> b) & 1);
      }
    }
    __syncthreads();  // the kept word is out
    const uint64_t kept = *kept_word >> (16 * q) & 0xffffu;
    if (kept == 0) continue;  // uniform across the warp
    const uint64_t* rows = blk + 16 * q * nw;
    for (int w = r + 1 + first; w < nw; w += stride) {
      uint64_t acc = 0;
#pragma unroll
      for (int b = 0; b < 16; ++b)
        acc |= rows[b * nw + w] & (0ull - ((kept >> b) & 1));
      if (acc) atomicOr(reinterpret_cast<unsigned long long*>(removed + w),
                        static_cast<unsigned long long>(acc));
    }
  }
}

// One block a frame; `kernel` calls sweep() on its frame.
template <typename Kernel>
inline cudaError_t launch_sweep(Kernel kernel, const uint64_t* mask,
                                const bool* valid, int b, int k, bool* keep,
                                cudaStream_t stream) {
  const SweepPlan p = sweep_plan(k);
  return papc_launch(kernel, dim3(b), dim3(p.threads), p.smem, stream, mask,
                     valid, k, p.staged, keep);
}

}  // namespace nms
