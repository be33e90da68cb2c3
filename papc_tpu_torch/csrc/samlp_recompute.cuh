// Shared pieces of the wmma recompute-mode set-abstraction passes: the
// tile chain and each pass's per-tile body, used by the grid forward
// passes (samlp_rc_fwd.cu: #11 stats, #12 final max) and by the four
// single-launch passes (#15-18, samlp_single_{fwd,bwd}.cu through
// samlp_single.cuh). The grid backward passes #13 and #14
// (samlp_rc_bwd.cuh) run their own design on samlp_mma.cuh and take only
// Chain and make_chain from here; the backward layout, bwd_tile,
// accumulate_dw and run_hidden here serve #17 and #18.
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
//   backward passes (#17, #18): bf16 h_0 .. h_{n-1} (each later reused
//     for that layer's da), bf16 da_n, and f32 a_1 .. a_{n-1} for the
//     gates and x-hats of the walk down (a_n is consumed where it is
//     computed);
//   then one 16 x 16 f32 scratch a warp and the pass's sums (or pooled
//   max keys). Each region starts on a 128-byte boundary.
#pragma once

#include "samlp_train.cuh"

namespace samlp_rc {

namespace wmma = nvcuda::wmma;
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

// Runs layers 1 .. n-1 of a tile whose h_0 is in place (after a block
// barrier): h_j in bf16 for the next product and, with keep_a, the f32
// a_j. Ends with a block barrier. Rows past the end carry what a zero
// input gives; the last layer's epilogue masks them.
template <int RF>
__device__ void run_hidden(const Chain& ch, const Layout& l,
                           unsigned char* smem, int n, bool keep_a) {
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

// Loads the tile's g2 rows from device memory into h_0 (zero past row m
// and in the channel padding), then runs layers 1 .. n-1 (run_hidden).
// Starts and ends with a block barrier.
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
  run_hidden<RF>(ch, l, smem, n, keep_a);
}

// The stats pass's last product (layer upto, after the hidden layers):
// the f32 a and a^2 of the rows below row_end into colsum.
template <int RF>
__device__ void stats_product(const Chain& ch, const Layout& l,
                              unsigned char* smem, int row0, int row_end,
                              int upto, float* colsum) {
  const int c = ch.c[upto], p = ch.p[upto];
  const float* bias = ch.bias[upto];
  samlp_train::rows_times_matrix<false, RF>(
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
  samlp_train::rows_times_matrix<false, RF>(
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

// slot [cin_p, cout_p] f32 += h^T . da over the tile's rows (set on the
// block's first tile). Fragment (i, j) always belongs to the same warp.
__device__ inline void accumulate_dw(const bf16* h, int ldh, int cin_p,
                                     const bf16* da, int ldd, int cout_p,
                                     int tm, float* slot, bool first) {
  const int warp = threadIdx.x >> 5;
  const int col_tiles = cout_p / 16;
  const int units = (cin_p / 16) * col_tiles;
  for (int u = warp; u < units; u += kWarps) {
    const int ci = u / col_tiles, co = u - ci * col_tiles;
    float* out = slot + static_cast<size_t>(ci) * 16 * cout_p + co * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (first)
      wmma::fill_fragment(acc, 0.f);
    else
      wmma::load_matrix_sync(acc, out, cout_p, wmma::mem_row_major);
    for (int kk = 0; kk < tm; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
          af;  // h^T: element (cin i, row r) at h[r][i]
      wmma::load_matrix_sync(af, h + kk * ldh + ci * 16, ldh);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, da + kk * ldd + co * 16, ldd);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(out, acc, cout_p, wmma::mem_row_major);
  }
}

// Offsets of layer j's sums in a backward pass's shared sums: bwd stats
// keeps one layer's (level's) [row_blocks][2][p]; bwd final every layer's
// db, [row_blocks][p_j] at row_blocks * (p_1 + .. + p_{j-1}).
template <bool kFinal>
__device__ inline float* bwd_sums_of(const Chain& ch, const Layout& l,
                                     unsigned char* smem, int level, int j) {
  float* sums = at<float>(smem, l.sums);
  if (!kFinal) return j == level ? sums : nullptr;
  if (j < 1) return nullptr;
  int off = 0;
  for (int i = 1; i < j; ++i) off += ch.p[i];
  return sums + l.row_blocks * off;
}

// One tile of a backward pass, after hidden_layers (keep_a) or
// run_hidden: a_n in the last forward product's epilogue, the max's
// cotangent and da_n, then the walk down to `level` (bwd stats, its sums
// in shared memory) or to the input (bwd final: every dW_j added into
// slot[j], db_j into the shared sums, dg written when not null). The
// cotangent of group g is dout[(g - g_base) * c_n + col] (amax alike);
// rows at and past row_end carry da = 0.
template <int RF, bool kFinal>
__device__ void bwd_tile(const Chain& ch, const Layout& l,
                         unsigned char* smem, int row0, int row_end,
                         int level, const float* dout, const int* amax,
                         int g_base, float* dg, float* const* slot,
                         bool first) {
  constexpr int kSums = kFinal ? 1 : 2;
  float* scratch = at<float>(smem, l.scratch);
  const int n = ch.n, k = ch.k, rb = l.row_blocks;
  {  // layer n: a_n, the max's cotangent and da_n, in one epilogue
    const int c = ch.c[n], p = ch.p[n], ld = l.ld[n];
    const float* bias = ch.bias[n];
    const float* vec = ch.vec[n];
    const float* mu = ch.mu[n];
    bf16* da = at<bf16>(smem, l.h[n]);
    const bool at_level = !kFinal && level == n;
    samlp_train::rows_times_matrix<false, RF, kSums>(
        at<bf16>(smem, l.h[n - 1]), l.ld[n - 1], ch.p[n - 1], ch.w[n], p, p,
        rb, scratch, bwd_sums_of<kFinal>(ch, l, smem, level, n),
        [&](int r, int col, float acc) {
          const int row = row0 + r;
          if (row >= row_end || col >= c) {
            if (!at_level) da[r * ld + col] = __float2bfloat16_rn(0.f);
            return make_float2(0.f, 0.f);
          }
          const float a = __fadd_rn(acc, bias[col]);
          const float xhat =
              __fmul_rn(__fsub_rn(a, vec[2 * c + col]), vec[3 * c + col]);
          const int g = row / k;
          const size_t gc = static_cast<size_t>(g - g_base) * c + col;
          const float dy = (affine(a, vec[col], vec[c + col]) > 0.f &&
                            amax[gc] == row - g * k)
                               ? dout[gc]
                               : 0.f;
          if (at_level) return make_float2(dy, __fmul_rn(dy, xhat));
          const float d = __fmul_rn(
              vec[col], __fsub_rn(__fsub_rn(dy, mu[col]),
                                  __fmul_rn(xhat, mu[c + col])));
          da[r * ld + col] = __float2bfloat16_rn(d);
          return make_float2(d, 0.f);
        });
    __syncthreads();
    if (at_level) return;
  }
  for (int j = n; j > (kFinal ? 0 : level); --j) {
    const bf16* da = at<bf16>(smem, l.h[j]);
    bf16* below = at<bf16>(smem, l.h[j - 1]);  // h_{j-1}, then da_{j-1}
    if (kFinal) {
      accumulate_dw(below, l.ld[j - 1], ch.p[j - 1], da, l.ld[j], ch.p[j],
                    l.tm, slot[j], first);
      __syncthreads();
      if (j == 1 && dg == nullptr) break;
    }
    const int c = ch.c[j - 1], p = ch.p[j - 1], ld = l.ld[j - 1];
    const float* vec = ch.vec[j - 1];
    const float* mu = ch.mu[j - 1];
    const float* a_prev = j > 1 ? at<float>(smem, l.a[j - 1]) : nullptr;
    const bool at_level = !kFinal && j - 1 == level;
    samlp_train::rows_times_matrix<true, RF, kSums>(
        da, l.ld[j], ch.p[j], ch.w[j], ch.p[j], p, rb, scratch,
        bwd_sums_of<kFinal>(ch, l, smem, level, j - 1),
        [&](int r, int col, float acc) {
          const int row = row0 + r;
          if (j == 1) {  // dg: the gradient of the raw block input
            if (row < row_end && col < c)
              dg[static_cast<size_t>(row) * c + col] = acc;
            return make_float2(0.f, 0.f);
          }
          if (row >= row_end || col >= c) {
            if (!at_level) below[r * ld + col] = __float2bfloat16_rn(0.f);
            return make_float2(0.f, 0.f);
          }
          const float a = a_prev[r * p + col];
          const float dy =
              affine(a, vec[col], vec[c + col]) > 0.f ? acc : 0.f;
          const float xhat =
              __fmul_rn(__fsub_rn(a, vec[2 * c + col]), vec[3 * c + col]);
          if (at_level) return make_float2(dy, __fmul_rn(dy, xhat));
          const float d = __fmul_rn(
              vec[col], __fsub_rn(__fsub_rn(dy, mu[col]),
                                  __fmul_rn(xhat, mu[c + col])));
          below[r * ld + col] = __float2bfloat16_rn(d);
          return make_float2(d, 0.f);
        });
    __syncthreads();
  }
}

// The block's db sums (kFinal) over its row units, in order: layer j's
// at part + (p_1 + .. + p_{j-1}) * blocks + block * p_j.
__device__ inline void write_block_db(const Chain& ch, const Layout& l,
                                      unsigned char* smem, float* part) {
  const float* sums = at<float>(smem, l.sums);
  size_t off = 0;
  for (int j = 1; j <= ch.n; ++j) {
    const float* src = sums + l.row_blocks * off;
    float* dst = part + off * gridDim.x +
                 static_cast<size_t>(blockIdx.x) * ch.p[j];
    for (int e = threadIdx.x; e < ch.p[j]; e += blockDim.x) {
      float s = 0.f;
      for (int b = 0; b < l.row_blocks; ++b) s += src[b * ch.p[j] + e];
      dst[e] = s;
    }
    off += ch.p[j];
  }
}

}  // namespace samlp_rc
