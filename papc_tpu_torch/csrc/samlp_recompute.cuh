// Shared pieces of the recompute-mode set-abstraction passes
// (samlp_rc_fwd.cu: #11 stats, #12 final max; samlp_rc_bwd.cu: #13 bwd
// stats, #14 bwd final).
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
// ops/kernels/samlp_recompute.py computes the same bytes):
//   forward passes: two ping-pong bf16 buffers (h_0, h_2 / h_1, h_3), as
//     samlp_eval.cu;
//   backward passes: bf16 h_0 .. h_{n-1} (each later reused for that
//     layer's da), bf16 da_n, and f32 a_1 .. a_{n-1} for the gates and
//     x-hats of the walk down (a_n is consumed where it is computed);
//   then one 16 x 16 f32 scratch a warp and the pass's sums (or pooled
//   max keys). Each region starts on a 128-byte boundary.
#pragma once

#include "samlp_train.cuh"

namespace samlp_rc {

using samlp_train::affine;
using samlp_train::kWarps;
using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 4;
constexpr int kSkew = 8;  // bf16 elements of padding per row (bank spread)

enum Pass { kStats, kFinal, kBwdStats, kBwdFinal };

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
  int ld[kMaxLayers + 1];      // row stride of the bf16 buffer of h_i / da_n
  unsigned h[kMaxLayers + 1];  // its byte offset
  unsigned a[kMaxLayers + 1];  // byte offset of f32 a_j (backward, j < n)
  unsigned scratch, sums, bytes;
};

inline unsigned round128(size_t bytes) {
  return static_cast<unsigned>((bytes + 127) / 128 * 128);
}

// n: the layers the pass runs (upto for kStats); level: kBwdStats' layer.
inline Layout make_layout(Pass pass, const Chain& ch, int tm, int n,
                          int level) {
  Layout l{};
  l.tm = tm;
  l.row_blocks = tm >= 64 ? tm / 64 : 1;
  l.gpt = (tm + ch.k - 1) / ch.k + 1;
  unsigned off = 0;
  if (pass == kStats || pass == kFinal) {
    int ld2[2] = {0, 0};
    for (int i = 0; i < n; ++i)
      ld2[i & 1] = ld2[i & 1] > ch.p[i] + kSkew ? ld2[i & 1] : ch.p[i] + kSkew;
    const unsigned y = round128(static_cast<size_t>(tm) * ld2[0] * 2);
    for (int i = 0; i < n; ++i) {
      l.ld[i] = ld2[i & 1];
      l.h[i] = (i & 1) ? y : 0;
    }
    off = y + round128(static_cast<size_t>(tm) * ld2[1] * 2);
  } else {
    for (int i = 0; i <= n; ++i) {
      l.ld[i] = ch.p[i] + kSkew;
      l.h[i] = off;
      off += round128(static_cast<size_t>(tm) * l.ld[i] * 2);
    }
    for (int j = 1; j < n; ++j) {
      l.a[j] = off;
      off += round128(static_cast<size_t>(tm) * ch.p[j] * 4);
    }
  }
  l.scratch = off;
  off += kWarps * 256 * 4;
  l.sums = off;
  if (pass == kStats) {
    off += l.row_blocks * 2 * ch.p[n] * 4;
  } else if (pass == kFinal) {
    off += l.gpt * ch.p[n] * 8;
  } else if (pass == kBwdStats) {
    off += l.row_blocks * 2 * ch.p[level] * 4;
  } else {
    for (int j = 1; j <= n; ++j) off += l.row_blocks * ch.p[j] * 4;
  }
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

// Loads the tile's g2 rows into h_0 (zero past row m and in the channel
// padding), then runs layers 1 .. n-1: h_j in bf16 for the next product
// and, with keep_a, the f32 a_j. Starts and ends with a block barrier.
template <int RF>
__device__ void hidden_layers(const Chain& ch, const Layout& l,
                              unsigned char* smem, int row0, int n,
                              bool keep_a) {
  __syncthreads();  // the previous tile is done with every buffer
  bf16* x0 = at<bf16>(smem, l.h[0]);
  const int c0 = ch.c[0], p0 = ch.p[0];
  for (int e = threadIdx.x; e < l.tm * p0; e += blockDim.x) {
    const int r = e / p0, c = e - r * p0;
    const int row = row0 + r;
    x0[r * l.ld[0] + c] = (row < ch.m && c < c0)
                              ? ch.g2[static_cast<size_t>(row) * c0 + c]
                              : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  float* scratch = at<float>(smem, l.scratch);
  for (int j = 1; j < n; ++j) {
    bf16* h = at<bf16>(smem, l.h[j]);
    float* a_out = keep_a ? at<float>(smem, l.a[j]) : nullptr;
    const int c = ch.c[j], p = ch.p[j], ld = l.ld[j];
    const float* bias = ch.bias[j];
    const float* vec = ch.vec[j];
    samlp_train::rows_times_matrix<false, RF>(
        at<bf16>(smem, l.h[j - 1]), l.ld[j - 1], ch.p[j - 1], ch.w[j], p, p,
        l.row_blocks, scratch, nullptr, [&](int r, int col, float acc) {
          float a = 0.f, v = 0.f;
          if (col < c) {
            a = __fadd_rn(acc, bias[col]);
            v = affine(a, vec[col], vec[c + col]);
            v = v > 0.f ? v : 0.f;
          }
          if (a_out != nullptr) a_out[r * p + col] = a;
          h[r * ld + col] = __float2bfloat16_rn(v);
          return make_float2(0.f, 0.f);
        });
    __syncthreads();
  }
}

}  // namespace samlp_rc
