// The forward tile loop of the recompute passes, shared by the grid passes
// #11 / #12 (samlp_rc_fwd.cu: row tiles b, b + grid, ... of M) and the
// single-launch passes #15 / #16 (samlp_single_fwd.cu: one contiguous
// range of rows a block). It is the forward half of #13 / #14's tile loop
// (samlp_rc_bwd.cuh::bwd_tiles) on that header's free functions and on the
// product core of samlp_mma.cuh (ldmatrix + mma.sync m16n8k16, f32
// accumulators in registers on 32 x 64 warp tiles):
//  - Warps tile tm x chunk outputs as tm / 32 row warps by 8 / (tm / 32)
//    column warps; the plan gives the tile's products (a_1 .. a_l, or a_1
//    .. a_n) and each last chunk's split over the column warps, and the
//    kernel runs that table as it is.
//  - Each product reads h_{j-1} from shared memory (two ping-pong bf16
//    regions, rows skewed by 8) and W_j through ldmatrix.trans as stored:
//    from one cp.async ring of k-slices whose steps run over the tile's
//    products and on into the block's next tile (a product's first slices
//    arrive during the previous epilogue), or, where the plan says so
//    (w_res), from every W_j staged once a block (one barrier a product).
//    The k16 steps accumulate in ascending order from zero, so every pass
//    on this loop derives the same a and h bits.
//  - Epilogues work on the accumulators in registers, straight-line
//    (loads at clamped columns, then selects): a hidden layer's bias,
//    affine and ReLU into bf16 pairs of the next product's buffer; stats:
//    a and a^2 of the rows below the tile's row_end summed over the warp's
//    32 rows in a fixed order (for_each_pair_sums) into per-row-warp sums
//    in shared memory, each column owned by one warp, across the block's
//    tiles.
//  - Final: h = max(affine(a), 0) >= +0, whose float bits order like the
//    floats, folded into the key (bits << 32) | (k - 1 - row in group): the
//    max and its first argmax in one 64-bit word, so any merge order gives
//    the same result. Where k is a multiple of 8, a warp's keys are merged
//    in registers over its 8-row blocks of one group, then over the 8
//    lanes of a column by shuffles, and one lane a column and group takes
//    an atomicMax into the tile's pooled keys in shared memory (each row
//    warp once); else (ragged test stacks) each element does. After the
//    tile, every group complete below min(row0 + tm, row_end) is written
//    as out and amax; a group that runs on into the block's next tile
//    (the single-launch walk, where k does not divide tm) keeps its keys
//    in shared memory, carried to the first slot; or, where the grid walk
//    gives a group to several blocks (keys), each tile writes its pooled
//    keys to its own slot of a device buffer for a merge launch.
//  - Rows from row_end on belong to the next block (or lie past M): they
//    are loaded as zeros, added to no sum, and pooled only into groups
//    that are never written.
#pragma once

#include "samlp_rc_bwd.cuh"

namespace samlp_rcf {

namespace mma = samlp_mma;
using samlp_rc::Chain;
using samlp_rcb::at;
using samlp_rcb::kSkew;
using samlp_rcb::kThreads;
using samlp_rcb::kWarps;
using samlp_rcb::Layout;
using samlp_train::affine;
using bf16 = __nv_bfloat16;
using u64 = unsigned long long;

// A forward block: the tile's buffers, weights and products in
// samlp_rcb::Layout's fields (what issue, advance and stage_weights read;
// the chain's n is the pass's last layer), then the pooled keys of the
// final pass.
struct Fwd {
  Layout l;
  int whole;  // final: every tile holds whole groups (k divides tm)
  int gpt;    // final: pooled key slots a tile (the groups it can touch)
};

// The block's layout (ops/kernels/samlp_recompute.py::fwd_smem_bytes
// computes the same bytes): h_0 .. h_{n-1} in two ping-pong regions (h_i
// in region i % 2), the ring of `stages` slices or, w_res, W_1 .. W_n in
// rows of p_j + kSkew, then the stats pass's per-row-warp sums [rw][2]
// [p_n] f32 or the final pass's pooled keys [gpt][p_n] u64. Regions start
// on 128 bytes. sched: the plan's products (layer, walk, span), which
// must be a_1 .. a_n in order with spans of 16..64 by 16.
inline bool make_fwd_layout(Fwd& f, const Chain& st, bool final, int tm,
                            int stages, int w_res, const int* sched,
                            int nprod) {
  f = Fwd{};
  Layout& l = f.l;
  const int n = st.n;
  l.tm = tm;
  l.rw = tm / 32;
  l.cw = kWarps / l.rw;
  l.chunk = 64 * l.cw;
  l.ks = tm == 32 ? 16 : 32;
  l.stages = stages;
  l.w_res = w_res;
  int wid[2] = {0, 0};
  for (int i = 0; i < n; ++i)
    wid[i & 1] = wid[i & 1] > st.p[i] ? wid[i & 1] : st.p[i];
  const unsigned r0 =
      samlp_rcb::round128(static_cast<size_t>(tm) * (wid[0] + kSkew) * 2);
  const unsigned r1 =
      wid[1] ? samlp_rcb::round128(static_cast<size_t>(tm) *
                                   (wid[1] + kSkew) * 2)
             : 0;
  for (int i = 0; i < n; ++i) {
    l.ld[i] = wid[i & 1] + kSkew;
    l.h[i] = (i & 1) ? r0 : 0;
  }
  unsigned off = r0 + r1;
  l.stage_elems = l.ks * (l.chunk + kSkew);
  l.ring = off;
  if (w_res) {
    for (int j = 1; j <= n; ++j) {
      l.w[j] = off;
      off += samlp_rcb::round128(static_cast<size_t>(st.p[j - 1]) *
                                 (st.p[j] + kSkew) * 2);
    }
  } else {
    off += samlp_rcb::round128(static_cast<size_t>(stages) * l.stage_elems *
                               2);
  }
  l.sums = off;
  if (final) {
    const int k = st.k;
    f.whole = tm % k == 0;
    f.gpt = f.whole ? tm / k : k % tm == 0 ? 1 : (tm + k - 1) / k + 1;
    off += samlp_rcb::round128(static_cast<size_t>(f.gpt) * st.p[n] * 8);
  } else {
    off += samlp_rcb::round128(static_cast<size_t>(l.rw) * 2 * st.p[n] * 4);
  }
  l.bytes = off;
  if (sched == nullptr || nprod != n) return false;
  for (int q = 0; q < nprod; ++q) {
    const int j = sched[3 * q], walk = sched[3 * q + 1];
    const int span = sched[3 * q + 2];
    if (j != q + 1 || walk != 0 || span < 16 || span > 64 || span % 16)
      return false;
    l.prod[q] = samlp_rcb::Prod{j, 0, st.p[j - 1], st.p[j], span};
    l.steps += ((st.p[j] + l.chunk - 1) / l.chunk) *
               ((st.p[j - 1] + l.ks - 1) / l.ks);
  }
  l.nprod = nprod;
  return true;
}

// The bias pair of layer j's columns (col, col + 1), 0 past c_j.
__device__ __forceinline__ float2 bias_pair(const Chain& st, int j, int col) {
  const int cj = st.c[j];
  const bool in0 = col < cj, in1 = col + 1 < cj;
  const float b0 = __ldg(st.bias[j] + (in0 ? col : cj - 1));
  const float b1 = __ldg(st.bias[j] + (in1 ? col + 1 : cj - 1));
  return make_float2(in0 ? b0 : 0.f, in1 ? b1 : 0.f);
}

__device__ __forceinline__ u64 key_max(u64 a, u64 b) { return a > b ? a : b; }

// The final pass's last epilogue: each ReLU output of the warp tile
// folded into its group's key and merged into pooled[(g - g_first) * p_n
// + col]. k8: k is a multiple of 8, so each 8-row block of the warp tile
// (rows 8 (2 i + h) + lane / 4) lies in one group.
__device__ __forceinline__ void pool_keys(const Chain& st,
                                          const mma::WarpTile& acc, int pairs,
                                          int cbase, int wrow0, int g_first,
                                          int k_shift, bool k8,
                                          u64* pooled) {
  const int n = st.n, k = st.k, pn = st.p[n];
  const int lane = threadIdx.x & 31;
  // the groups of the warp's four 8-row blocks (warp-uniform)
  int g[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int r = wrow0 + 8 * b;
    g[b] = k_shift >= 0 ? r >> k_shift : r / k;
  }
#pragma unroll 2
  for (int jn = 0; jn < 2 * mma::kPairs; ++jn) {
    if (jn >= 2 * pairs) break;
    float w[2][4];
    mma::pick_tile(acc, jn, w);
    const int cc = cbase + mma::lane_col(jn);
    const samlp_rcb::Cols cp = samlp_rcb::cols_of<true, false>(st, n, cc);
    u64 key[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = 2 * i + h;
        const int row = wrow0 + mma::lane_row(i, h);
        const int rk = k_shift >= 0 ? row - ((row >> k_shift) << k_shift)
                                    : row - (row / k) * k;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = __fadd_rn(w[i][2 * h + e], cp.b[e]);
          float v = affine(a, cp.scale[e], cp.shift[e]);
          v = v > 0.f ? v : 0.f;  // +0 for -0 too: the keys compare bits
          key[e][b] = (static_cast<u64>(__float_as_uint(v)) << 32) |
                      static_cast<unsigned>(k - 1 - rk);
        }
      }
    if (!k8) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wrow0 + mma::lane_row(i, h);
          const int gi = (k_shift >= 0 ? row >> k_shift : row / k) - g_first;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            atomicMax(&pooled[gi * pn + cc + e], key[e][2 * i + h]);
        }
      continue;
    }
    // blocks of one group merged in registers, in block order
#pragma unroll
    for (int b = 1; b < 4; ++b)
      if (g[b] == g[b - 1])
#pragma unroll
        for (int e = 0; e < 2; ++e)
          key[e][b] = key_max(key[e][b], key[e][b - 1]);
    // a block that ends its group in the warp: over the column's 8 lanes,
    // then into the pool from lanes 0-3
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < 3 && g[b + 1] == g[b]) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        u64 v = key[e][b];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          v = key_max(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (lane < 4) atomicMax(&pooled[(g[b] - g_first) * pn + cc + e], v);
      }
    }
  }
}

struct FwdOuts {
  float* part;  // stats: [blocks][2][p_n] partial sums
  float* out;   // final: [M / k, c_n] the max
  int* amax;    // final: [M / k, c_n] its first row in the group
  u64* keys;    // final, grid walk, !whole: [tiles][gpt][c_n] each tile's
                // pooled keys (null: every group is written from a tile)
};

// A block's row tiles: tile i covers [first_row + i * row_step, + tm),
// its rows from row_end on masked (row_end: M for the grid walk of #11 /
// #12, the end of the block's range for #15 / #16, which walk a
// contiguous range from its start). Each tile: the input rows, the
// products a_1 .. a_n with the hidden layers' h_j, and the last product's
// epilogue: stats (kFinal false) into the shared per-row-warp sums; final
// into the tile's pooled keys, then out and amax of the groups it
// completes, the open group carried in shared memory, or (o.keys) the
// tile's key slot. W from the ring, whose steps run over the tiles, or,
// kResident, from the block's resident copy. Ends with a block barrier,
// the ring drained.
template <bool kFinal, bool kResident>
__device__ __forceinline__ void fwd_tiles(const Chain& st, const Fwd& f,
                                          const FwdOuts& o,
                                          unsigned char* smem, int first_row,
                                          int row_step, int tiles,
                                          int row_end) {
  const Layout& l = f.l;
  const int n = st.n, k = st.k, tm = l.tm, pn = st.p[n];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp / l.cw, wc = warp % l.cw;
  bf16* ring = at<bf16>(smem, l.ring);
  float* sums = at<float>(smem, l.sums);
  u64* pooled = at<u64>(smem, l.sums);
  const int total = kResident ? 0 : tiles * l.steps;
  const int k_shift = samlp_rcb::group_shift(k);
  const bool k8 = k % 8 == 0;

  // the ring: steps t + 1 .. t + stages - 1 in flight while step t runs.
  // The prologue and the two step lambdas are bwd_tiles' own, kept inline
  // here too: its ring state moved into shared helpers cost #13 / #14 2-6 %
  // on the H100 (PERF.md §6).
  mma::RingCursor load_at;
  if (!kResident) {
    for (int i = 0; i < l.stages - 1; ++i) {
      if (i < total) {
        samlp_rcb::issue(st, l, load_at, ring + i * l.stage_elems);
        samlp_rcb::advance(l, load_at);
      }
      mma::cp_async_commit();
    }
  }
  int t = 0;
  // step t's slice, once it landed and every warp is done with step t - 1
  auto ring_next = [&]() -> const bf16* {
    if (l.stages == 4)
      mma::cp_async_wait<2>();
    else if (l.stages == 3)
      mma::cp_async_wait<1>();
    else
      mma::cp_async_wait<0>();
    __syncthreads();
    return ring + (t % l.stages) * l.stage_elems;
  };
  // then, after step t's products, step t + stages - 1 into the stage that
  // step t - 1 used (free since the barrier)
  auto ring_refill = [&]() {
    if (t + l.stages - 1 < total) {
      samlp_rcb::issue(st, l, load_at,
                       ring + ((t + l.stages - 1) % l.stages) * l.stage_elems);
      samlp_rcb::advance(l, load_at);
    }
    mma::cp_async_commit();
    ++t;
  };

  mma::WarpTile acc;
  for (int ti = 0; ti < tiles; ++ti) {
    const int row0 = first_row + ti * row_step;
    const int g_first = row0 / k;
    __syncthreads();  // the previous tile is done with every buffer
    samlp_rcb::load_input(st, row0, min(tm, row_end - row0), tm,
                          at<bf16>(smem, l.h[0]), l.ld[0]);
    for (int q = 0; q < l.nprod; ++q) {
      const samlp_rcb::Prod p = l.prod[q];
      const int j = p.layer;
      // with no ring step to wait for, one barrier a product: the previous
      // product's outputs are complete
      if (kResident) __syncthreads();
      const bf16* a_buf = at<bf16>(smem, l.h[j - 1]);
      const int lda = l.ld[j - 1];
      const bf16* w_res = kResident ? at<bf16>(smem, l.w[j]) : nullptr;
      const int ldw = st.p[j] + kSkew;
      const int chunks = (p.ndim + l.chunk - 1) / l.chunk;
      const int slices = (p.kdim + l.ks - 1) / l.ks;
      for (int c = 0; c < chunks; ++c) {
        // the chunk's columns over the column warps in n16 pairs: span
        // each, the plan's in the last chunk
        const int width = min(l.chunk, p.ndim - c * l.chunk);
        const int span = c + 1 < chunks ? mma::kWarpCols : p.span;
        const int col0 = wc * span;
        const int pairs = max(0, min(span, width - col0)) / 16;
        mma::zero(acc);
        for (int s = 0; s < slices; ++s) {
          if (kResident) {
            if (pairs > 0)
              mma::mma_slice(acc, a_buf + wr * 32 * lda + s * l.ks, lda,
                             w_res + s * l.ks * ldw + c * l.chunk + col0, ldw,
                             min(l.ks, p.kdim - s * l.ks) / 16, pairs);
            continue;
          }
          const bf16* stage = ring_next();
          if (pairs > 0)
            mma::mma_slice(acc, a_buf + wr * 32 * lda + s * l.ks, lda,
                           stage + col0, l.chunk + kSkew,
                           min(l.ks, p.kdim - s * l.ks) / 16, pairs);
          ring_refill();
        }
        if (pairs == 0) continue;
        const int cbase = c * l.chunk + col0;  // the warp's first column
        const int rbase = wr * 32;             // its first row in the tile
        if (j < n) {
          // hidden layer: h_j = max(affine(a_j), 0) as the next operand;
          // past c_j the product and the constants are 0: h = +0
          bf16* h = at<bf16>(smem, l.h[j]);
          const int ld = l.ld[j];
          mma::for_each_pair_loop(
              acc, pairs,
              [&](int col) {
                return samlp_rcb::cols_of<true, false>(st, j, cbase + col);
              },
              [&](int r, int col, const samlp_rcb::Cols& cp, float v0,
                  float v1) {
                float hv[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float a = __fadd_rn(e ? v1 : v0, cp.b[e]);
                  const float v = affine(a, cp.scale[e], cp.shift[e]);
                  hv[e] = v > 0.f ? v : 0.f;
                }
                *reinterpret_cast<__nv_bfloat162*>(
                    h + (rbase + r) * ld + cbase + col) =
                    __floats2bfloat162_rn(hv[0], hv[1]);
              });
        } else if (!kFinal) {
          // a_n and a_n^2 of the rows below row_end (0 past c_n) into the row
          // warp's sums, which this warp alone updates for these columns
          float* my = sums + wr * 2 * pn;
          mma::for_each_pair_sums(
              acc, pairs,
              [&](int col) { return bias_pair(st, n, cbase + col); },
              [&](int r, int, const float2& b, float v0, float v1) {
                const bool in = row0 + rbase + r < row_end;
                const float a0 = in ? __fadd_rn(v0, b.x) : 0.f;
                const float a1 = in ? __fadd_rn(v1, b.y) : 0.f;
                return make_float4(a0, a1, __fmul_rn(a0, a0),
                                   __fmul_rn(a1, a1));
              },
              [&](int col, float4 s) {
                const int cc = cbase + col;
                my[cc] += s.x;
                my[cc + 1] += s.y;
                my[pn + cc] += s.z;
                my[pn + cc + 1] += s.w;
              });
        } else {
          pool_keys(st, acc, pairs, cbase, row0 + rbase, g_first, k_shift,
                    k8, pooled);
        }
      }
    }
    if (kFinal) {
      // the tile's keys, complete: each group that ends below stop split
      // into out and amax, the group that runs on into the block's next
      // tile kept, the rest zeroed; or all into the tile's slot
      __syncthreads();
      const int c = st.c[n];
      if (o.keys == nullptr) {
        const int stop = min(row0 + tm, row_end);
        const int open = stop % k != 0 ? stop / k - g_first : -1;
        for (int e = tid; e < f.gpt * c; e += blockDim.x) {
          const int gi = e / c, col = e - gi * c;
          if (gi == open) continue;
          const u64 v = pooled[gi * pn + col];
          pooled[gi * pn + col] = 0ull;
          const int g = g_first + gi;
          if ((g + 1) * k <= stop) {
            const size_t d = static_cast<size_t>(g) * c + col;
            o.out[d] = __uint_as_float(static_cast<unsigned>(v >> 32));
            o.amax[d] = k - 1 - static_cast<int>(v & 0xffffffffull);
          }
        }
        if (open > 0) {  // the open group's keys into the first slot
          __syncthreads();
          for (int col = tid; col < c; col += blockDim.x) {
            pooled[col] = pooled[open * pn + col];
            pooled[open * pn + col] = 0ull;
          }
        }
      } else {
        u64* dst = o.keys + static_cast<size_t>(row0 / tm) * f.gpt * c;
        for (int e = tid; e < f.gpt * c; e += blockDim.x) {
          const int gi = e / c, col = e - gi * c;
          dst[e] = pooled[gi * pn + col];
          pooled[gi * pn + col] = 0ull;
        }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();
}

// Zeroes the block's sums (stats) or pooled keys (final), then, kResident,
// stages every W_j (stage_weights ends with a block barrier).
template <bool kFinal, bool kResident>
__device__ __forceinline__ void fwd_prologue(const Chain& st, const Fwd& f,
                                             unsigned char* smem) {
  const int pn = st.p[st.n];
  if (kFinal) {
    u64* pooled = at<u64>(smem, f.l.sums);
    for (int e = threadIdx.x; e < f.gpt * pn; e += blockDim.x)
      pooled[e] = 0ull;
  } else {
    float* sums = at<float>(smem, f.l.sums);
    for (int e = threadIdx.x; e < f.l.rw * 2 * pn; e += blockDim.x)
      sums[e] = 0.f;
  }
  if (kResident) samlp_rcb::stage_weights(st, f.l, smem);
}

// The stats pass's block partials part[block][2][p_n]: its row warps'
// sums added in order.
__device__ __forceinline__ void write_fwd_partials(const Chain& st,
                                                   const Fwd& f,
                                                   unsigned char* smem,
                                                   float* part) {
  const int pn = st.p[st.n];
  const float* sums = at<float>(smem, f.l.sums);
  float* dst = part + static_cast<size_t>(blockIdx.x) * 2 * pn;
  for (int e = threadIdx.x; e < 2 * pn; e += blockDim.x) {
    float s = sums[e];
    for (int r = 1; r < f.l.rw; ++r) s += sums[r * 2 * pn + e];
    dst[e] = s;
  }
}

}  // namespace samlp_rcf
