// The chain of one recompute-mode set-abstraction stack (Chain,
// make_chain), which every recompute pass takes: the grid passes #11-14
// (samlp_rc_fwd.cu, samlp_rc_bwd.cu) and the single-launch passes #15-18
// (samlp_single_fwd.cu, samlp_single_bwd.cu), all on the tile loops of
// samlp_rc_fwd.cuh and samlp_rc_bwd.cuh.
//
// Each pass re-derives the layer chain of a tile of rows from the block
// input g2 = bf16(grouped) alone: for layer j,
//   a_j = bf16(h_{j-1}) . bf16(W_j) + b_j           (f32 accumulation)
//   h_j = max(a_j * scale_j + shift_j, 0),  h_0 = g2
// No pre-activation is rounded to bf16, only the operands of a product
// (h_j as it is stored for the next product, da_j in the backward). The
// chain lives in shared memory; device memory sees g2, the weights and the
// vectors, and each pass's own outputs.
#pragma once

#include <cuda_bf16.h>

namespace samlp_rc {

using bf16 = __nv_bfloat16;

constexpr int kMaxLayers = 4;

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

}  // namespace samlp_rc
