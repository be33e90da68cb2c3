// The two forward passes of a recompute-mode training set-abstraction MLP:
//   stats (layer l): re-derive a_1 .. a_l from g2 with the l-1 BN affines
//     already known and return (sum a_l, sum a_l^2) per column, of the f32
//     a_l, over every row;
//   final: the whole chain, the last BN + ReLU and the max over each group
//     of k rows with its first argmax: out [M/k, C] f32, amax [M/k, C] i32.
//
// Replaces: papc_tpu/ops/pallas/samlp.py::recompute_stats (_rc_stats_kernel,
// #11) and ::recompute_final_max (_rc_final_kernel, #12), the forward of
// fused_mlp's "recompute" mode. Numeric contract kept from them and their
// twins (fused_mlp._jnp_rc_stats, _jnp_rc_final; here
// ops/kernels/samlp_recompute.py::rc_stats_plain, rc_final_plain): bf16
// operands, f32 accumulation, f32 bias, affine and ReLU, no pre-activation
// rounded; a = acc + b, the affine and the bf16 rounding of h use the _rn
// intrinsics op for op as the plain version.
//
// What bounds them on the H100: the tensor-core products, which every pass
// repeats from layer 1 (SSG clas at B = 32: chip_smoke.py's _rc_work, 0.116
// ms of stats and 0.071 ms of final a step); device memory sees only g2
// (6 B a row at SA1), the weights and the outputs.
//
// Design, on the product core of samlp_mma.cuh (ldmatrix + mma.sync
// m16n8k16, f32 accumulators in registers on 32 x 64 warp tiles), the
// forward half of #13 / #14's tile loop (samlp_rc_bwd.cuh::bwd_tiles):
//  - Persistent blocks of 8 warps walk row tiles b, b + grid, ... of tm =
//    128, 64 or 32 rows (the plan, ops/kernels/samlp_recompute.py::
//    fwd_plan: the largest that fits and still gives every SM a tile),
//    two blocks an SM where there are more tiles than SMs and shared
//    memory holds two (on the H100 at SSG SA1 and SA2: 28-38 % less
//    device time than one block an SM with the weights resident; one
//    block of 8 warps leaves every phase of a tile waiting on latency).
//    Warps tile tm x chunk outputs as tm / 32 row warps by 8 / (tm / 32)
//    column warps; the plan gives the tile's products (a_1 .. a_l, or a_1
//    .. a_n) and each last chunk's split over the column warps, and the
//    kernel runs that table as it is.
//  - Each product reads h_{j-1} from shared memory (two ping-pong bf16
//    regions, rows skewed by 8) and W_j through ldmatrix.trans as stored:
//    from one cp.async ring of k-slices whose steps run over the tile's
//    products and on into the next tile (a product's first slices arrive
//    during the previous epilogue), or, where the plan says so (w_res),
//    from every W_j staged once a block (one barrier a product). The k16
//    steps accumulate in ascending order from zero, with the same
//    m16n8k16 instruction as #16's wmma chain: the same a and h bits.
//  - Epilogues work on the accumulators in registers, straight-line
//    (loads at clamped columns, then selects): a hidden layer's bias,
//    affine and ReLU into bf16 pairs of the next product's buffer; stats:
//    a and a^2 summed over the warp's 32 rows in a fixed order
//    (for_each_pair_sums) into per-row-warp sums in shared memory, each
//    column owned by one warp; the block's partials are written in block
//    order and one split_reduce launch adds them in order, so repeated
//    runs give the same bits (two launches a call).
//  - Final: h = max(affine(a), 0) >= +0, whose float bits order like the
//    floats, folded into the key (bits << 32) | (k - 1 - row in group): the
//    max and its first argmax in one 64-bit word, so any merge order gives
//    the same result. Where k is a multiple of 8, a warp's keys are merged
//    in registers over its 8-row blocks of one group, then over the 8
//    lanes of a column by shuffles, and one lane a column and group takes
//    an atomicMax into the tile's pooled keys in shared memory (each
//    row warp once); else (ragged test stacks) each element does. Where a
//    tile holds whole groups (k divides tm: every SA1 and SA2 stack of the
//    registry) the tile writes out and amax itself: one launch a call, no
//    device key buffer. Where a group spans tiles (the group_all SA3
//    stacks, 32-row tiles at k = 128) or k does not divide tm, each tile
//    writes its pooled keys to its own slot of a device buffer (no fill
//    needed) and rc_key_merge_kernel takes each group's max over its
//    tiles and splits it: two launches.
#include "samlp_rc_bwd.cuh"

namespace {

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

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

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
bool make_fwd_layout(Fwd& f, const Chain& st, bool final, int tm, int stages,
                     int w_res, const int* sched, int nprod) {
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
  u64* keys;    // final, !whole: [tiles][gpt][c_n] each tile's pooled keys
};

// A block's row tiles b, b + grid, ...: the input rows, the products a_1
// .. a_n with the hidden layers' h_j, and the last product's epilogue:
// stats (kFinal false) into the shared per-row-warp sums; final into the
// tile's pooled keys, then out and amax (whole groups) or the tile's key
// slot. W from the ring, whose steps run over the tiles, or, kResident,
// from the block's resident copy. Ends with a block barrier, the ring
// drained.
template <bool kFinal, bool kResident>
__device__ __forceinline__ void fwd_tiles(const Chain& st, const Fwd& f,
                                          const FwdOuts& o,
                                          unsigned char* smem) {
  const Layout& l = f.l;
  const int n = st.n, k = st.k, tm = l.tm, pn = st.p[n];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp / l.cw, wc = warp % l.cw;
  bf16* ring = at<bf16>(smem, l.ring);
  float* sums = at<float>(smem, l.sums);
  u64* pooled = at<u64>(smem, l.sums);
  const int all_tiles = (st.m + tm - 1) / tm;
  const int tiles = (all_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = kResident ? 0 : tiles * l.steps;
  const int k_shift = samlp_rcb::group_shift(k);
  const bool k8 = k % 8 == 0;

  // the ring: steps t + 1 .. t + stages - 1 in flight while step t runs.
  // The prologue and the two step lambdas are bwd_tiles' own, kept inline
  // here too: its ring state moved into shared helpers cost #13 / #14 2-6 %
  // on the H100 (PERF.md, PR 20).
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
    const int tile = blockIdx.x + ti * gridDim.x;
    const int row0 = tile * tm;
    const int g_first = row0 / k;
    __syncthreads();  // the previous tile is done with every buffer
    samlp_rcb::load_input(st, row0, min(tm, st.m - row0), tm,
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
          // a_n and a_n^2 of the rows below M (0 past c_n) into the row
          // warp's sums, which this warp alone updates for these columns
          float* my = sums + wr * 2 * pn;
          mma::for_each_pair_sums(
              acc, pairs,
              [&](int col) { return bias_pair(st, n, cbase + col); },
              [&](int r, int, const float2& b, float v0, float v1) {
                const bool in = row0 + rbase + r < st.m;
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
      // the tile's keys, complete: split into out and amax where the tile
      // holds whole groups, else into the tile's slot; the pool zeroed
      __syncthreads();
      const int c = st.c[n];
      if (f.whole) {
        const int groups = st.m / k;
        for (int e = tid; e < f.gpt * c; e += blockDim.x) {
          const int gi = e / c, col = e - gi * c;
          const u64 v = pooled[gi * pn + col];
          pooled[gi * pn + col] = 0ull;
          const int g = g_first + gi;
          if (g < groups) {
            const size_t d = static_cast<size_t>(g) * c + col;
            o.out[d] = __uint_as_float(static_cast<unsigned>(v >> 32));
            o.amax[d] = k - 1 - static_cast<int>(v & 0xffffffffull);
          }
        }
      } else {
        u64* dst = o.keys + static_cast<size_t>(tile) * f.gpt * c;
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

// Both kernels are compiled for two blocks an SM (at most 128 registers a
// thread, no spills): where the plan runs one block an SM (SSG SA3), that
// build measured as fast on the H100 as one for a single block (143-145
// registers).

// #11: the block's partials [block][2][p_n], its row warps' sums in order.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
    rc_fwd_stats_kernel(Chain st, Fwd f, FwdOuts o) {
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_prologue<false, kResident>(st, f, smem);
  fwd_tiles<false, kResident>(st, f, o, smem);
  const int pn = st.p[st.n];
  const float* sums = at<float>(smem, f.l.sums);
  float* dst = o.part + static_cast<size_t>(blockIdx.x) * 2 * pn;
  for (int e = threadIdx.x; e < 2 * pn; e += blockDim.x) {
    float s = sums[e];
    for (int r = 1; r < f.l.rw; ++r) s += sums[r * 2 * pn + e];
    dst[e] = s;
  }
}

// #12: out and amax, or every tile's keys for rc_key_merge_kernel.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
    rc_fwd_final_kernel(Chain st, Fwd f, FwdOuts o) {
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_prologue<true, kResident>(st, f, smem);
  fwd_tiles<true, kResident>(st, f, o, smem);
}

// Each group's key: the max over the tiles that touch it (tile t's slot
// g - t * tm / k), split into out and amax.
__global__ void rc_key_merge_kernel(const u64* __restrict__ keys, int m,
                                    int k, int tm, int gpt, int c,
                                    float* __restrict__ out,
                                    int* __restrict__ amax) {
  const long long total = static_cast<long long>(m / k) * c;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(e / c), col = static_cast<int>(e % c);
    const long long r0 = static_cast<long long>(g) * k;
    const int t0 = static_cast<int>(r0 / tm);
    const int t1 = static_cast<int>((r0 + k - 1) / tm);
    u64 v = 0ull;
    for (int t = t0; t <= t1; ++t) {
      const int slot = g - static_cast<int>(static_cast<long long>(t) * tm / k);
      v = key_max(v, keys[(static_cast<size_t>(t) * gpt + slot) * c + col]);
    }
    out[e] = __uint_as_float(static_cast<unsigned>(v >> 32));
    amax[e] = k - 1 - static_cast<int>(v & 0xffffffffull);
  }
}

// The common checks of both entries: g2 on 16 bytes, the layout of the
// plan and a grid the kernels take.
bool fwd_ok(const void* g2, const Fwd& f, bool laid, int blocks) {
  return laid && aligned16(g2) &&
         samlp_rcb::plan_ok(f.l.tm, f.l.stages, blocks, f.l);
}

}  // namespace

// g2 [M, C0] bf16, 16-byte aligned; per layer j < n_layers (arrays indexed
// from 0): width c_j, w packed bf16 [pad16(c_{j-1}), pad16(c_j)], bias f32
// [c_j], vec f32 rows (scale, shift, ...) x c_j (read for the layers below
// upto only). upto: the layer whose sums are wanted (1-based). The plan
// (ops/kernels/samlp_recompute.py::fwd_plan): tm rows a tile (32, 64,
// 128), ring stages (2-4) or w_res (stages 0), blocks (the grid, which
// fixes the order of the sums) and the tile's nprod products, (layer,
// walk, span) each in sched.
// -> partials [blocks, 2, pad16(c_upto)] (scratch), sums [2, c_upto] f32.
PAPC_EXPORT int papc_samlp_rc_stats(const void* g2, int m, int c0,
                                    int n_layers, int upto,
                                    const int* widths, const void* const* w,
                                    const float* const* bias,
                                    const float* const* vec, int tm,
                                    int stages, int w_res, int blocks,
                                    const int* sched, int nprod,
                                    float* partials, float* sums,
                                    void* stream) {
  Chain st;
  if (!samlp_rc::make_chain(st, g2, m, 1, c0, n_layers, widths, w, bias, vec,
                            nullptr) ||
      upto < 1 || upto > n_layers)
    return cudaErrorInvalidValue;
  st.n = upto;  // the chain up to the level
  Fwd f;
  const bool laid = make_fwd_layout(f, st, false, tm, stages, w_res, sched,
                                    nprod);
  if (!fwd_ok(g2, f, laid, blocks)) return cudaErrorInvalidValue;
  const FwdOuts o{partials, nullptr, nullptr, nullptr};
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = papc_launch(
      w_res ? rc_fwd_stats_kernel<true> : rc_fwd_stats_kernel<false>,
      dim3(blocks), dim3(kThreads), f.l.bytes, s, st, f, o);
  if (err != cudaSuccess) return err;
  const samlp_train::SplitSum job{partials, blocks, 2,      st.p[upto],
                                  2,        st.c[upto], sums};
  return samlp_train::split_reduce(&job, 1, 32, s);
}

// As papc_samlp_rc_stats, every layer's vec read (rows scale, shift), and
// k the group size (M a multiple of k). keys: u64 [tiles, gpt, c_last]
// scratch where the plan's tiles do not hold whole groups (k does not
// divide tm), else unused; gpt (fwd_plan's "gpt") = tm / k where k
// divides tm, 1 where tm divides k, else ceil(tm / k) + 1.
// -> out [M/k, c_last] f32 (the max), amax [M/k, c_last] i32 (the first
// row of the group that attains it).
PAPC_EXPORT int papc_samlp_rc_final(const void* g2, int m, int c0, int k,
                                    int n_layers, const int* widths,
                                    const void* const* w,
                                    const float* const* bias,
                                    const float* const* vec, int tm,
                                    int stages, int w_res, int blocks,
                                    const int* sched, int nprod, void* keys,
                                    float* out, int* amax, void* stream) {
  Chain st;
  if (!samlp_rc::make_chain(st, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            nullptr))
    return cudaErrorInvalidValue;
  Fwd f;
  const bool laid = make_fwd_layout(f, st, true, tm, stages, w_res, sched,
                                    nprod);
  if (!fwd_ok(g2, f, laid, blocks) || (!f.whole && keys == nullptr))
    return cudaErrorInvalidValue;
  const FwdOuts o{nullptr, out, amax, static_cast<u64*>(keys)};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = papc_launch(
      w_res ? rc_fwd_final_kernel<true> : rc_fwd_final_kernel<false>,
      dim3(blocks), dim3(kThreads), f.l.bytes, s, st, f, o);
  if (err != cudaSuccess || f.whole) return err;
  const long long total = static_cast<long long>(m / k) * st.c[n_layers];
  long long grid = (total + 255) / 256;
  if (grid > 132 * 16) grid = 132 * 16;
  return papc_launch(rc_key_merge_kernel, dim3(static_cast<int>(grid)),
                     dim3(256), 0, s, static_cast<const u64*>(keys), m, k, tm,
                     f.gpt, st.c[n_layers], out, amax);
}
