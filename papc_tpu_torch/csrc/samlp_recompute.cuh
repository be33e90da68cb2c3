// Shared pieces of the recompute-mode set-abstraction passes: the chain of
// one stack (Chain, make_chain), which every recompute pass takes, and the
// wmma tile chain with each forward pass's per-tile body, which only the
// single-launch forward passes #15 and #16 still run (samlp_single_fwd.cu
// through samlp_single.cuh). The grid passes #11-14 and the single-launch
// backward passes #17 and #18 run their tile loops on samlp_mma.cuh
// (samlp_rc_fwd.cu, samlp_rc_bwd.cuh).
//
// Each pass re-derives the layer chain of a tile of rows from the block
// input g2 = bf16(grouped) alone: for layer j,
//   a_j = bf16(h_{j-1}) . bf16(W_j) + b_j           (f32 accumulation)
//   h_j = max(a_j * scale_j + shift_j, 0),  h_0 = g2
// No pre-activation is rounded to bf16, only the operands of a product
// (h_j as it is stored for the next product, da_j in the backward). The
// chain lives in shared memory; device memory sees g2, the weights and the
// vectors, and each pass's own outputs.
//
// Shared memory of a tile of tm rows (tm 16, 32, 64 or 128; the plan in
// ops/kernels/samlp_recompute.py computes the same bytes): two ping-pong
// bf16 buffers (h_0, h_2 / h_1, h_3), as samlp_eval.cu, then one 16 x 16
// f32 scratch a warp and the pass's sums (or pooled max keys). Each
// region starts on a 128-byte boundary.
#pragma once

#include "samlp_train.cuh"

namespace samlp_rc {

namespace wmma = nvcuda::wmma;
using samlp_train::affine;
using samlp_train::kWarps;
using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 4;
constexpr int kSkew = 8;  // bf16 elements of padding per row (bank spread)

enum Pass { kStats, kFinal };

// One set-abstraction stack. Layers are numbered 1..n; index 0 of the
// per-layer arrays is unused, c[0] / p[0] are the input's channels.
struct Chain {
  const bf16* g2;  // [m, c[0]]
  int m, k, n;     // rows, group size, layers
  int c[kMaxLayers + 1];  // widths
  int p[kMaxLayers + 1];  // widths padded to 16
  const bf16* w[kMaxLayers + 1];     // packed W_j [p[j-1], p[j]], zero-padded
  const float* bias[kMaxLayers + 1]; // [c[j]]
  const float* vec[kMaxLayers + 1];  // (scale, shift, mean, inv_std) x c[j]
  const float* mu[kMaxLayers + 1];   // rows (mean dy, mean dy * xhat) x c[j]
};

struct Layout {
  int tm, row_blocks, gpt;  // rows, 64-row units (>= 1), groups a tile meets
  int ld[kMaxLayers + 1];      // row stride of the bf16 buffer of h_i
  unsigned h[kMaxLayers + 1];  // its byte offset
  unsigned scratch, sums, bytes;
};

inline unsigned round128(size_t bytes) {
  return static_cast<unsigned>((bytes + 127) / 128 * 128);
}

// n: the layers the pass runs (upto for kStats).
inline Layout make_layout(Pass pass, const Chain& ch, int tm, int n) {
  Layout l{};
  l.tm = tm;
  l.row_blocks = tm >= 64 ? tm / 64 : 1;
  l.gpt = (tm + ch.k - 1) / ch.k + 1;
  int ld2[2] = {0, 0};
  for (int i = 0; i < n; ++i)
    ld2[i & 1] = ld2[i & 1] > ch.p[i] + kSkew ? ld2[i & 1] : ch.p[i] + kSkew;
  const unsigned y = round128(static_cast<size_t>(tm) * ld2[0] * 2);
  for (int i = 0; i < n; ++i) {
    l.ld[i] = ld2[i & 1];
    l.h[i] = (i & 1) ? y : 0;
  }
  unsigned off = y + round128(static_cast<size_t>(tm) * ld2[1] * 2);
  l.scratch = off;
  off += kWarps * 256 * 4;
  l.sums = off;
  if (pass == kStats)
    off += l.row_blocks * 2 * ch.p[n] * 4;
  else
    off += l.gpt * ch.p[n] * 8;
  l.bytes = off;
  return l;
}

// Builds the chain from the C arguments (per-layer arrays indexed from 0);
// false on a shape the kernels do not take.
inline bool make_chain(Chain& ch, const void* g2, int m, int k, int c0,
                       int n_layers, const int* widths, const void* const* w,
                       const float* const* bias, const float* const* vec,
                       const float* const* mu) {
  if (m <= 0 || k <= 0 || m % k != 0 || c0 <= 0 || n_layers < 1 ||
      n_layers > kMaxLayers)
    return false;
  ch = Chain{};
  ch.g2 = static_cast<const bf16*>(g2);
  ch.m = m;
  ch.k = k;
  ch.n = n_layers;
  ch.c[0] = c0;
  ch.p[0] = (c0 + 15) / 16 * 16;
  for (int j = 1; j <= n_layers; ++j) {
    if (widths[j - 1] <= 0) return false;
    ch.c[j] = widths[j - 1];
    ch.p[j] = (ch.c[j] + 15) / 16 * 16;
    ch.w[j] = static_cast<const bf16*>(w[j - 1]);
    ch.bias[j] = bias[j - 1];
    ch.vec[j] = vec[j - 1];
    ch.mu[j] = mu != nullptr ? mu[j - 1] : nullptr;
  }
  return true;
}

// Row frags a warp unit holds for tile rows tm: 16 * RF rows a unit.
template <typename F>
cudaError_t with_row_frags(int tm, F launch) {
  switch (tm) {
    case 16: return launch(std::integral_constant<int, 1>{});
    case 32: return launch(std::integral_constant<int, 2>{});
    case 64:
    case 128: return launch(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
__device__ __forceinline__ T* at(unsigned char* smem, unsigned offset) {
  return reinterpret_cast<T*>(smem + offset);
}

// Runs layers 1 .. n-1 of a tile whose h_0 is in place (after a block
// barrier): h_j in bf16 for the next product. Ends with a block barrier.
// Rows past the end carry what a zero input gives; the last layer's
// epilogue masks them.
template <int RF>
__device__ void run_hidden(const Chain& ch, const Layout& l,
                           unsigned char* smem, int n) {
  float* scratch = at<float>(smem, l.scratch);
  for (int j = 1; j < n; ++j) {
    bf16* h = at<bf16>(smem, l.h[j]);
    const int c = ch.c[j], p = ch.p[j], ld = l.ld[j];
    const float* bias = ch.bias[j];
    const float* vec = ch.vec[j];
    samlp_train::rows_times_matrix<RF>(
        at<bf16>(smem, l.h[j - 1]), l.ld[j - 1], ch.p[j - 1], ch.w[j], p, p,
        l.row_blocks, scratch, nullptr, [&](int r, int col, float acc) {
          float v = 0.f;
          if (col < c) {
            v = affine(__fadd_rn(acc, bias[col]), vec[col], vec[c + col]);
            v = v > 0.f ? v : 0.f;
          }
          h[r * ld + col] = __float2bfloat16_rn(v);
          return make_float2(0.f, 0.f);
        });
    __syncthreads();
  }
}

// The stats pass's last product (layer upto, after the hidden layers):
// the f32 a and a^2 of the rows below row_end into colsum.
template <int RF>
__device__ void stats_product(const Chain& ch, const Layout& l,
                              unsigned char* smem, int row0, int row_end,
                              int upto, float* colsum) {
  const int c = ch.c[upto], p = ch.p[upto];
  const float* bias = ch.bias[upto];
  samlp_train::rows_times_matrix<RF>(
      at<bf16>(smem, l.h[upto - 1]), l.ld[upto - 1], ch.p[upto - 1],
      ch.w[upto], p, p, l.row_blocks, at<float>(smem, l.scratch), colsum,
      [&](int r, int col, float acc) {
        if (row0 + r >= row_end || col >= c) return make_float2(0.f, 0.f);
        const float a = __fadd_rn(acc, bias[col]);
        return make_float2(a, __fmul_rn(a, a));
      });
}

// The final pass's last product: each ReLU output of the rows below
// row_end folded into its group's key, pooled[(g - g_base) * p + col].
// ReLU output is >= +0, so its float bits order like the floats; the key
// (bits << 32) | (k - 1 - row in group) is the max and its first argmax
// in one 64-bit word, and atomicMax gives it in any order.
template <int RF>
__device__ void final_pool(const Chain& ch, const Layout& l,
                           unsigned char* smem, int row0, int row_end,
                           int g_base, unsigned long long* pooled) {
  const int n = ch.n, k = ch.k, c = ch.c[n], p = ch.p[n];
  const float* bias = ch.bias[n];
  const float* vec = ch.vec[n];
  samlp_train::rows_times_matrix<RF>(
      at<bf16>(smem, l.h[n - 1]), l.ld[n - 1], ch.p[n - 1], ch.w[n], p, p,
      l.row_blocks, at<float>(smem, l.scratch), nullptr,
      [&](int r, int col, float acc) {
        const int row = row0 + r;
        if (row < row_end && col < c) {
          float h = affine(__fadd_rn(acc, bias[col]), vec[col], vec[c + col]);
          h = h > 0.f ? h : 0.f;  // +0 for -0 too: the keys compare bits
          const int g = row / k;
          const unsigned long long key =
              (static_cast<unsigned long long>(__float_as_uint(h)) << 32) |
              static_cast<unsigned>(k - 1 - (row - g * k));
          atomicMax(&pooled[(g - g_base) * p + col], key);
        }
        return make_float2(0.f, 0.f);
      });
}

}  // namespace samlp_rc
