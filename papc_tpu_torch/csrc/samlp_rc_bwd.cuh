// The two backward passes of a recompute-mode training set-abstraction MLP.
// Each re-derives the chain a_1 .. a_n from g2, then walks the cotangent
// down in f32 from the max:
//   a_j  = bf16(h_{j-1}) . bf16(W_j) + b_j
//   h_j  = max(a_j * scale_j + shift_j, 0),  h_0 = g2
//   dy_n = (row == amax and a_n * scale_n + shift_n > 0) ? dout : 0
//   da_j = scale_j * ((dy_j - mu_j[0]) - xhat_j * mu_j[1]),
//          xhat_j = (a_j - mean_j) * inv_std_j
//   dhp  = bf16(da_j) . bf16(W_j)^T
//   dy_{j-1} = (a_{j-1} * scale_{j-1} + shift_{j-1} > 0) ? dhp : 0
// where mu_j = (sum dy_j, sum dy_j * xhat_j) / M comes from the stats pass
// of layer j, run before.
//   bwd stats (level l): returns s_l = (sum dy_l, sum dy_l * xhat_l).
//   bwd final: dW_j = bf16(h_{j-1})^T . bf16(da_j), db_j = sum da_j for
//     every layer, and dg = dhp at j = 1 (f32, no gate), only if asked.
//
// Replaces: papc_tpu/ops/pallas/samlp.py::recompute_bwd_stats
// (_rc_bwd_stats_kernel, #13) and ::recompute_bwd_final
// (_rc_bwd_final_kernel, #14), the backward of fused_mlp's "recompute"
// mode. Its tile body (bwd_tiles) also runs the single-launch passes #17
// and #18 (samlp_single_bwd.cu, mode "recompute1"). Numeric contract kept
// from them and their twins (fused_mlp._jnp_chain_bwd, _jnp_rc_bwd_stats,
// _jnp_rc_bwd_final; here ops/kernels/samlp_recompute.py::
// chain_bwd_plain): only the operands of
// the products are rounded to bf16 (h, da); a, dy, da, the sums, dW, db
// and dg are f32; every gate, x-hat and da uses the _rn intrinsics op for
// op as the plain version.
//
// What bounds them on the H100: the tensor-core products, the forward
// chain again plus the walk down (and dW in bwd final), then the f32
// epilogues (chip_smoke.py's _rc_work: 0.318 ms of bwd stats and 0.205
// ms of bwd final a SSG clas step at B = 32). Device memory sees g2,
// dout, amax, the weights and vectors, dg and the partial sums.
//
// Design, on the product core of samlp_mma.cuh (ldmatrix + mma.sync
// m16n8k16, f32 accumulators in registers on 32 x 64 warp tiles):
//  - One persistent block of 8 warps an SM walks row tiles of tm = 128,
//    64 or 32 rows (the plan, ops/kernels/samlp_recompute.py::bwd_plan:
//    the largest that fits and still gives every SM a tile): #13 / #14
//    take tiles b, b + grid, ...; #17 / #18 one contiguous range of whole
//    groups a block. Warps tile tm x chunk outputs as tm / 32 row warps by 8 / (tm / 32) column
//    warps, chunk = 64 columns a column warp. The plan also gives the
//    tile's products in order (the chain forward, then the walk down) and
//    how each product's last chunk is split over the column warps; the
//    kernel runs that table as it is (make_layout refuses one that would
//    leave its buffers), and a CPU test holds the table to taking every
//    product and output column once.
//  - Every product of a tile reads its A operand from shared memory: the
//    chain forward a_j = h_{j-1} . W_j (mma_slice, W through
//    ldmatrix.trans as stored), the walk down dhp = da_j . W_j^T
//    (mma_slice<true>, W's [Cin][Cout] rows as the [n][k] operand) and
//    dW_j += h_{j-1}^T . da_j (mma_slice_at, h read transposed from its
//    rows). Where the plan says so (w_res, #17 / #18 only) the block
//    stages W_1 .. W_n once in the ring's place, rows skewed as the
//    ring's, and a product reads its slices there (one barrier a product
//    instead of one a step). Else the W_j stream through ONE cp.async
//    ring of k-slices (ks = 32 rows, 16 at tm = 32; 4 stages, 3 or 2
//    where shared memory is short:
//    only the slot mode at SA3 widths and 524 288 rows; a card test holds
//    3 and 2 stages bit for bit against 4 at every tested stack)
//    whose step sequence runs over all products of a tile and on into the
//    next tile, so a product's first slices arrive during the previous
//    one's epilogue. The k16 steps of a product accumulate in ascending
//    order from zero, as the forward tile loop of #11, #12, #15 and #16
//    (samlp_rc_fwd.cuh, on this core) does; with the same m16n8k16
//    instruction underneath, the a re-derived here is expected
//    to carry their bits (not checked bit for bit: a gate within an ulp
//    of 0 may flip, as between any two recomputations).
//  - Epilogues work on the accumulators in registers (for_each_pair_loop,
//    for_each_pair_sums): bias, a, the gate a * scale + shift > 0, x-hat,
//    da and the max's cotangent at amax (the tile's groups' amax and dout
//    rows staged in shared memory with the input rows), bf16 pairs into
//    the next product's buffer, and column sums (sum dy and sum dy * xhat,
//    or db) over the warp's 32 rows in a fixed order, added into per-row-
//    warp sums in shared memory that each column's one owning warp
//    updates tile after tile. Rows past M carry dy = da = 0.
//  - Buffers (bf16, rows skewed by 8: an odd number of 16-byte units):
//    bwd stats (and bwd final with dW from device memory) keep two
//    ping-pong regions, h_i and da_i in region i % 2; bwd final with dW on
//    chip or in a slot keeps h_0 .. h_{n-1} and da_n, each da_j written
//    over h_j once dW_j has read it. The f32 a_1 .. a_{n-1} for the gates
//    stay in shared memory where a tile of 128 or 64 rows still fits,
//    else in the block's own tile of device scratch (SSG SA2 at 128 rows;
//    SA3, c0 259-643 with widths 256-512-1024, at 32 rows).
//  - dW in bwd final (the plan's mode), its device bytes a pass and its
//    scratch at the SSG clas stacks (B = 32 x 1024): kDwSmem keeps the
//    block's f32 dW in shared memory over all its tiles (SA1: 53 KB; 7.0
//    MB of block partials written and reduced once); kDwSlot adds each
//    tile's products from registers into the block's slot in device
//    memory, every old value loaded before any add (SA2: 270 KB a block,
//    35.7 MB of slots, 2048 tiles of 128 rows: about 1.1 GB read and
//    written a pass); kDwRows writes the bf16 h_{j-1} and da_j of every
//    row once (SA3: 23.2 MB) and rc_dw_rows_kernel forms dW over all
//    rows with its accumulators in registers, into 6 split partials (17.4
//    MB): 40.6 MB of scratch against 383.7 MB of slots.
//    The plan takes the rows wherever they and their partials need fewer
//    bytes than the slots would (the group_all SA3 stacks and the small
//    ones), so neither scratch nor traffic grows where it chooses them.
//  - Cross-block sums: each block writes its partials in block order; one
//    split_reduce launch adds them (bwd stats: the level's two sums; bwd
//    final: every dW and db) in a fixed order, so repeated runs give the
//    same bits. Launches a call: bwd stats 2, bwd final 2 (3 with kDwRows).
//    (#17 / #18 add them in the same launch after a grid barrier.)
//    The entries are in samlp_rc_bwd.cu; this header holds the pieces
//    the four kernels share (zero_sums, bwd_tiles, write_block_partials).
//    Moving the tile loop into bwd_tiles kept #13 / #14's code as it was:
//    a per-tile function with the ring's state in a struct, or the B
//    operand picked before the product, made them 3-6 % slower on the
//    card.
//
// What a tile's time went to (a clock64 probe of a scratch copy, not
// kept; NVIDIA H100 80GB HBM3): with one block of 8 warps an SM, every
// phase is latency-bound, and the epilogues took the most. Epilogue code
// is therefore straight-line: every load is made at a clamped or padded
// address and then selected (a cotangent or gate load under a branch
// waited out its latency element by element: twice the time), and the
// loop over n8 tiles is unrolled by two, not 8-fold, which keeps the
// kernel small. Tried and dropped: atomic adds (red) for the dW slots
// (slower than loading a unit's old values before adding), two blocks an
// SM at 128 registers (spills).
#pragma once

#include <cstdint>
#include <type_traits>

#include "samlp_mma.cuh"
#include "samlp_recompute.cuh"
#include "samlp_train.cuh"

namespace samlp_rcb {

namespace mma = samlp_mma;
using bf16 = __nv_bfloat16;
using samlp_rc::Chain;  // one SA stack: layers 1..n, index 0 the input
using samlp_rc::kMaxLayers;
using samlp_train::affine;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSkew = 8;  // bf16 (or f32) elements of padding a row
constexpr int kSmemLimit = 232448;
enum DwMode { kDwNone = 0, kDwSmem = 1, kDwSlot = 2, kDwRows = 3 };

inline unsigned round128(size_t bytes) {
  return static_cast<unsigned>((bytes + 127) / 128 * 128);
}

// One product of the tile's sequence: the forward a_j (B = W_j [k][n]) or
// the walk down from layer j (B = W_j^T: W_j's rows are the [n][k] tiles);
// span: the columns each column warp takes of the product's last chunk
// (64 of every other chunk).
struct Prod {
  int layer, walk, kdim, ndim, span;
};

struct Layout {
  int tm, rw, cw, chunk, ks, stages, stage_elems;
  int level;          // bwd stats' level; 0 in bwd final
  int dw;             // DwMode
  int a_smem;         // f32 a_j in shared memory, else in a_scr
  int w_res;          // W_j resident in shared memory (no ring)
  int ld[kMaxLayers + 1];      // bf16 row stride of layer i's buffers
  unsigned h[kMaxLayers + 1];  // byte offset of h_i (i < n)
  unsigned d[kMaxLayers + 1];  // byte offset of da_j (j >= 1)
  unsigned a[kMaxLayers + 1];  // byte offset of f32 a_j (j < n), a_smem
  unsigned w[kMaxLayers + 1];  // byte offset of resident W_j, w_res
  int a_off[kMaxLayers + 1];   // a_j's floats before it in a scratch row
  int a_row;                   // floats of a_1 .. a_{n-1} a row
  int db_off[kMaxLayers + 2];  // db_j's columns before it (p_1 + ..)
  size_t dw_off[kMaxLayers + 2];  // dW_j's floats before it
  unsigned ring, sums, dwo, bytes;
  unsigned cot, cot_f;  // the tile's groups' amax rows, dout rows after cot_f
  Prod prod[2 * kMaxLayers];
  int nprod, steps;  // products and ring steps a tile
};

// The layout of one block (ops/kernels/samlp_recompute.py::bwd_smem_bytes
// computes the same bytes) and its products from the plan's schedule
// (bwd_plan's "prods": layer, walk, span each). Regions start on 128
// bytes. With w_res, W_1 .. W_n take the ring's place, each [p_{j-1}]
// rows of p_j + kSkew (stages is then 0). False on a schedule the kernel
// cannot run without leaving its buffers: a layer out of range, a walk
// from layer 1 with no dg to write or below bwd stats' level, a span not
// in 16..64 by 16.
inline bool make_layout(Layout& l, const Chain& st, int tm, int stages,
                        int keep_h, int a_smem, int w_res, int dw, int level,
                        const int* sched, int nprod, bool dg) {
  l = Layout{};
  const int n = st.n;
  l.tm = tm;
  l.rw = tm / 32;
  l.cw = kWarps / l.rw;
  l.chunk = 64 * l.cw;
  l.ks = tm == 32 ? 16 : 32;
  l.stages = stages;
  l.level = level;
  l.dw = dw;
  l.a_smem = a_smem;
  l.w_res = w_res;
  unsigned off = 0;
  if (keep_h) {
    for (int i = 0; i <= n; ++i) {
      l.ld[i] = st.p[i] + kSkew;
      if (i < n) l.h[i] = off;
      if (i >= 1) l.d[i] = off;
      off += round128(static_cast<size_t>(tm) * l.ld[i] * 2);
    }
  } else {
    int wid[2] = {0, 0};
    for (int i = 0; i <= n; ++i)
      wid[i & 1] = wid[i & 1] > st.p[i] ? wid[i & 1] : st.p[i];
    const unsigned r1 =
        round128(static_cast<size_t>(tm) * (wid[0] + kSkew) * 2);
    for (int i = 0; i <= n; ++i) {
      l.ld[i] = wid[i & 1] + kSkew;
      l.h[i] = l.d[i] = (i & 1) ? r1 : 0;
    }
    off = r1 + round128(static_cast<size_t>(tm) * (wid[1] + kSkew) * 2);
  }
  for (int j = 1; j < n; ++j) {
    l.a_off[j] = l.a_row;
    l.a_row += st.p[j];
    if (a_smem) {
      l.a[j] = off;
      off += round128(static_cast<size_t>(tm) * (st.p[j] + kSkew) * 4);
    }
  }
  const int fwd_stage = l.ks * (l.chunk + kSkew);
  const int walk_stage = l.chunk * (l.ks + kSkew);
  l.stage_elems = fwd_stage > walk_stage ? fwd_stage : walk_stage;
  l.ring = off;
  if (w_res) {
    for (int j = 1; j <= n; ++j) {
      l.w[j] = off;
      off += round128(static_cast<size_t>(st.p[j - 1]) * (st.p[j] + kSkew) *
                      2);
    }
  } else {
    off += round128(static_cast<size_t>(stages) * l.stage_elems * 2);
  }
  l.sums = off;
  for (int j = 1; j <= n; ++j) {
    l.db_off[j + 1] = l.db_off[j] + st.p[j];
    l.dw_off[j + 1] =
        l.dw_off[j] + static_cast<size_t>(st.p[j - 1]) * st.p[j];
  }
  if (level > 0)
    off += round128(static_cast<size_t>(l.rw) * 2 * st.p[level] * 4);
  else
    off += round128(static_cast<size_t>(l.rw) * l.db_off[n + 1] * 4);
  l.dwo = off;
  if (dw == kDwSmem) off += round128(l.dw_off[n + 1] * 4);
  // the amax (i32) and dout (f32) rows of the groups a tile can touch,
  // and 16 floats past them: a padding column's lookup stays inside
  l.cot = off;
  const int groups = (tm + st.k - 1) / st.k + 1;
  l.cot_f = round128((static_cast<size_t>(groups) * st.c[n] + 16) * 4);
  off += 2 * l.cot_f;
  l.bytes = off;
  if (sched == nullptr || nprod < 1 || nprod > 2 * kMaxLayers) return false;
  const int lowest_walk = level > 0 ? level + 1 : dg ? 1 : 2;
  for (int q = 0; q < nprod; ++q) {
    const int j = sched[3 * q], walk = sched[3 * q + 1];
    const int span = sched[3 * q + 2];
    if (j < 1 || j > n || (walk != 0 && walk != 1) ||
        (walk && j < lowest_walk) || span < 16 || span > 64 || span % 16)
      return false;
    l.prod[q] = walk ? Prod{j, 1, st.p[j], st.p[j - 1], span}
                     : Prod{j, 0, st.p[j - 1], st.p[j], span};
    l.steps += ((l.prod[q].ndim + l.chunk - 1) / l.chunk) *
               ((l.prod[q].kdim + l.ks - 1) / l.ks);
  }
  l.nprod = nprod;
  return true;
}

template <typename T>
__device__ __forceinline__ T* at(unsigned char* smem, unsigned offset) {
  return reinterpret_cast<T*>(smem + offset);
}

// The ring's step sequence runs over the tile's products and after the
// last one on to the next tile's first.
__device__ __forceinline__ void advance(const Layout& l,
                                        mma::RingCursor& cur) {
  const Prod& p = l.prod[cur.q];
  if (cur.advance(p.kdim, p.ndim, l.ks, l.chunk) && cur.q == l.nprod)
    cur.q = 0;
}

// W's slice of a step into a ring stage: forward [ks][chunk] of W_j
// (row stride chunk + 8), walk [chunk][ks] of W_j's rows (ks + 8).
__device__ __forceinline__ void issue(const Chain& st, const Layout& l,
                                      const mma::RingCursor& cur,
                                      bf16* stage) {
  const Prod& p = l.prod[cur.q];
  if (!p.walk)
    mma::issue_slice<false>(stage, l.chunk + kSkew, st.w[p.layer],
                            st.p[p.layer], p.kdim, p.ndim, l.ks, l.chunk,
                            cur);
  else
    mma::issue_slice<true>(stage, l.ks + kSkew, st.w[p.layer], st.p[p.layer],
                           p.kdim, p.ndim, l.ks, l.chunk, cur);
}

// w_res: every W_j into its skewed rows, once a block (ends with a block
// barrier).
__device__ inline void stage_weights(const Chain& st, const Layout& l,
                                     unsigned char* smem) {
  for (int j = 1; j <= st.n; ++j)
    mma::load_tile_async(at<bf16>(smem, l.w[j]), st.p[j] + kSkew, st.w[j],
                         st.p[j], st.p[j - 1], st.p[j]);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
}

// The tile's g2 rows [row0, row0 + rows) into h_0 (row stride ld); zero
// in the channel padding and below the last row. Where the rows start on
// 16 bytes (row0 a multiple of 8) they are read as 16-byte chunks and
// placed 8 elements at a time, else element by element.
__device__ inline void load_input(const Chain& st, int row0, int rows, int tm,
                                  bf16* h0, int ld) {
  const int c0 = st.c[0], p0 = st.p[0];
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int padc = p0 - c0;
  for (int e = threadIdx.x; e < tm * padc; e += blockDim.x) {
    const int r = e / padc;
    h0[r * ld + c0 + (e - r * padc)] = zero;
  }
  for (int e = threadIdx.x; e < (tm - rows) * c0; e += blockDim.x) {
    const int r = e / c0;
    h0[(rows + r) * ld + (e - r * c0)] = zero;
  }
  const bf16* src = st.g2 + static_cast<size_t>(row0) * c0;
  const int n = rows * c0;
  const float inv_c0 = 1.f / static_cast<float>(c0);
  for (int q = threadIdx.x; q < n / 8; q += blockDim.x) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + q);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
    const int e = 8 * q;
    int r = static_cast<int>((static_cast<float>(e) + 0.5f) * inv_c0);
    int c = e - r * c0;
    if (c < 0) {
      --r;
      c += c0;
    } else if (c >= c0) {
      ++r;
      c -= c0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned short bits =
          static_cast<unsigned short>(words[u >> 1] >> (16 * (u & 1)));
      h0[r * ld + c] = __ushort_as_bfloat16(bits);
      if (++c == c0) {
        c = 0;
        ++r;
      }
    }
  }
  for (int e = (n / 8) * 8 + threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / c0;
    h0[r * ld + (e - r * c0)] = src[e];
  }
}

struct Outs {
  const float* dout;  // [M / k, c_n]
  const int* amax;    // [M / k, c_n]
  float* dg;          // [M, c_0] or null
  float* a_scr;       // a_1 .. a_{n-1} of each block's tile, unless a_smem
  bf16* rows;     // kDwRows: h_0 .. h_{n-1}, then da_1 .. da_n, [m_pad][p]
  int m_pad;
  float* part;    // bwd stats [blocks][2][p_level]; final db [blocks][sum p]
  float* dw_part;  // kDwSmem / kDwSlot: layer j at dw_off[j] * blocks
};

// Constants of a column pair of layer j (0 past c_j): the bias
// (kBias), scale and shift, and for the walk (kBn) mean, inv_std and the
// gradient means.
struct Cols {
  float b[2], scale[2], shift[2], mean[2], inv_std[2], mu0[2], mu1[2];
};

// Every load is made (at a clamped column) and then selected: a load
// under a branch would wait out its latency before the next one issues.
template <bool kBias, bool kBn>
__device__ __forceinline__ Cols cols_of(const Chain& st, int j, int col) {
  Cols c{};
  const int cj = st.c[j];
  const float* v = st.vec[j];
  const float* mu = st.mu[j];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool in = col + e < cj;
    const int q = in ? col + e : cj - 1;
    auto sel = [&](float x) { return in ? x : 0.f; };
    c.scale[e] = sel(__ldg(v + q));
    c.shift[e] = sel(__ldg(v + cj + q));
    if (kBias) c.b[e] = sel(__ldg(st.bias[j] + q));
    if (kBn) {
      c.mean[e] = sel(__ldg(v + 2 * cj + q));
      c.inv_std[e] = sel(__ldg(v + 3 * cj + q));
      if (mu != nullptr) {
        c.mu0[e] = sel(__ldg(mu + q));
        c.mu1[e] = sel(__ldg(mu + cj + q));
      }
    }
  }
  return c;
}

// da = scale * ((dy - mu0) - xhat * mu1), op for op as the plain version.
__device__ __forceinline__ float da_of(float dy, float xhat, const Cols& c,
                                       int e) {
  return __fmul_rn(c.scale[e], __fsub_rn(__fsub_rn(dy, c.mu0[e]),
                                         __fmul_rn(xhat, c.mu1[e])));
}

// The block's per-row-warp sums (kFinal false: bwd stats' level, [rw][2]
// [p_level]; true: every db, [rw][p_1 + .. + p_n]) set to zero.
template <bool kFinal>
__device__ __forceinline__ void zero_sums(const Chain& st, const Layout& l,
                                          unsigned char* smem) {
  float* sums = at<float>(smem, l.sums);
  const int nsums =
      kFinal ? l.rw * l.db_off[st.n + 1] : l.rw * 2 * st.p[l.level];
  for (int e = threadIdx.x; e < nsums; e += blockDim.x) sums[e] = 0.f;
}

// log2(k) where k is a power of two, else -1.
__device__ __forceinline__ int group_shift(int k) {
  return (k & (k - 1)) == 0 ? __ffs(k) - 1 : -1;
}

// A block's row tiles: tile i covers [first_row + i * row_step, + tm),
// its rows from row_end on carrying dy = da = 0 (row_end: M for #13 /
// #14, the end of the block's range for #17 / #18). Each tile: the input
// rows and its groups' cotangent rows, the chain forward, the max's
// cotangent, the walk down and, in bwd final, dW by the layout's mode
// (stored on the block's first tile, added on later ones). kFinal false:
// bwd stats at l.level (its sums into the shared per-row-warp sums);
// true: bwd final (db there, dg when o.dg is not null). The weights come
// from the ring, whose steps run over the tiles, or, kResident, from the
// block's resident copy (stage_weights). Ends with a block barrier, the
// ring drained.
template <bool kFinal, bool kResident>
__device__ __forceinline__ void bwd_tiles(const Chain& st, const Layout& l,
                                          const Outs& o, unsigned char* smem,
                                          int first_row, int row_step,
                                          int tiles, int row_end) {
  const int n = st.n, k = st.k, tm = l.tm;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp / l.cw, wc = warp % l.cw;
  bf16* ring = at<bf16>(smem, l.ring);
  float* sums = at<float>(smem, l.sums);
  const int total = kResident ? 0 : tiles * l.steps;
  float* a_blk = o.a_scr + static_cast<size_t>(blockIdx.x) * tm * l.a_row;
  const int* cot_a = at<int>(smem, l.cot);
  const float* cot_d = at<float>(smem, l.cot + l.cot_f);
  const int k_shift = group_shift(k);

  // the ring: steps t + 1 .. t + stages - 1 in flight while step t runs
  mma::RingCursor load_at;
  if (!kResident) {
    for (int i = 0; i < l.stages - 1; ++i) {
      if (i < total) {
        issue(st, l, load_at, ring + i * l.stage_elems);
        advance(l, load_at);
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
      issue(st, l, load_at,
            ring + ((t + l.stages - 1) % l.stages) * l.stage_elems);
      advance(l, load_at);
    }
    mma::cp_async_commit();
    ++t;
  };

  // dW_j (+)= h_{j-1}^T . da_j over the tile's rows: warp tiles of 32 Cin
  // x 64 Cout, unit u always warp u % 8; added from the registers into
  // the block's dW (shared memory or its slot), stored on its first tile:
  // each element has one owning thread, so the sum runs tile by tile in a
  // fixed order.
  auto dw_tile = [&](int j, bool first) {
    const int cin_p = st.p[j - 1], cout_p = st.p[j];
    const bf16* h = at<bf16>(smem, l.h[j - 1]);
    const bf16* da = at<bf16>(smem, l.d[j]);
    const int ldh = l.ld[j - 1], ldd = l.ld[j];
    float* dst = l.dw == kDwSmem
                     ? at<float>(smem, l.dwo) + l.dw_off[j]
                     : o.dw_part + l.dw_off[j] * gridDim.x +
                           static_cast<size_t>(blockIdx.x) * cin_p * cout_p;
    const int col_units = (cout_p + 63) / 64;
    const int units = ((cin_p + 31) / 32) * col_units;
    for (int u = warp; u < units; u += kWarps) {
      const int ci = u / col_units, co = u - ci * col_units;
      const int pairs = min(64, cout_p - co * 64) / 16;
      mma::WarpTile acc;
      mma::zero(acc);
      for (int kk = 0; kk < tm; kk += 32)
        mma::mma_slice_at(acc, h + kk * ldh + ci * 32, ldh,
                          da + kk * ldd + co * 64, ldd, 2, pairs);
      // the unit's old values all loaded before any is added, so the
      // loads overlap (a load per element, waited for in turn, left the
      // block idle for an L2 round trip each)
      float* base = dst + static_cast<size_t>(ci) * 32 * cout_p + co * 64;
      const int rows = cin_p - ci * 32;
      float2 old[2][2 * mma::kPairs][2];
#pragma unroll
      for (int jj = 0; jj < 2 * mma::kPairs; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = mma::lane_row(i, hh);
            old[i][jj][hh] =
                !first && jj < 2 * pairs && r < rows
                    ? *reinterpret_cast<const float2*>(
                          base + static_cast<size_t>(r) * cout_p +
                          mma::lane_col(jj))
                    : make_float2(0.f, 0.f);
          }
#pragma unroll
      for (int jj = 0; jj < 2 * mma::kPairs; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = mma::lane_row(i, hh);
            if (jj < 2 * pairs && r < rows)
              *reinterpret_cast<float2*>(
                  base + static_cast<size_t>(r) * cout_p +
                  mma::lane_col(jj)) =
                  make_float2(old[i][jj][hh].x + acc.acc[i][jj][2 * hh],
                              old[i][jj][hh].y + acc.acc[i][jj][2 * hh + 1]);
          }
    }
  };

  // kDwRows: h_i's rows at rows_off[i], da_j's at rows_off[n - 1 + j]
  size_t rows_off[2 * kMaxLayers + 1];
  {
    size_t off = 0;
    for (int i = 0; i < n; ++i) {
      rows_off[i] = off;
      off += static_cast<size_t>(o.m_pad) * st.p[i];
    }
    for (int j = 1; j <= n; ++j) {
      rows_off[n - 1 + j] = off;
      off += static_cast<size_t>(o.m_pad) * st.p[j];
    }
  }

  mma::WarpTile acc;
  for (int ti = 0; ti < tiles; ++ti) {
    const int row0 = first_row + ti * row_step;
    __syncthreads();  // the previous tile is done with every buffer
    bf16* h0 = at<bf16>(smem, l.h[0]);
    const int g_first = row0 / k;
    {  // the tile's groups' amax and dout rows, one contiguous span each
      const int cn = st.c[n];
      const int cnt = ((min(row0 + tm, row_end) - 1) / k - g_first + 1) * cn;
      const size_t src = static_cast<size_t>(g_first) * cn;
      int* am = at<int>(smem, l.cot);
      float* dv = at<float>(smem, l.cot + l.cot_f);
#pragma unroll 4
      for (int e = tid; e < cnt; e += blockDim.x) {
        am[e] = __ldg(o.amax + src + e);
        dv[e] = __ldg(o.dout + src + e);
      }
    }
    load_input(st, row0, min(tm, row_end - row0), tm, h0, l.ld[0]);
    if (kFinal && l.dw == kDwRows) {
      __syncthreads();
      bf16* dst = o.rows + rows_off[0] + static_cast<size_t>(row0) * st.p[0];
      const int segs = st.p[0] / 8;
      for (int e = tid; e < tm * segs; e += blockDim.x) {
        const int r = e / segs, q = e - r * segs;
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * st.p[0] +
                                  8 * q) =
            *reinterpret_cast<const uint4*>(h0 + r * l.ld[0] + 8 * q);
      }
    }
    int last_walk = n + 1;
    for (int q = 0; q < l.nprod; ++q) {
      const Prod p = l.prod[q];
      const int j = p.layer;
      if (p.walk) {
        last_walk = j;
        if (kFinal && l.dw != kDwRows) {
          __syncthreads();  // da_j is complete
          dw_tile(j, ti == 0);
        }
      }
      // with no ring step to wait for, one barrier a product: the previous
      // product's outputs (and dW_j's reads of h_{j-1}) are complete
      if (kResident) __syncthreads();
      // A operand: h_{j-1} forward, da_j walking down
      const bf16* a_buf = at<bf16>(smem, p.walk ? l.d[j] : l.h[j - 1]);
      const int lda = l.ld[p.walk ? j : j - 1];
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
            if (pairs > 0) {
              const int ksteps = min(l.ks, p.kdim - s * l.ks) / 16;
              const bf16* a_ptr = a_buf + wr * 32 * lda + s * l.ks;
              if (!p.walk)
                mma::mma_slice(acc, a_ptr, lda,
                               w_res + s * l.ks * ldw + c * l.chunk + col0,
                               ldw, ksteps, pairs);
              else
                mma::mma_slice<true>(
                    acc, a_ptr, lda,
                    w_res + (c * l.chunk + col0) * ldw + s * l.ks, ldw,
                    ksteps, pairs);
            }
            continue;
          }
          const bf16* stage = ring_next();
          if (pairs > 0) {
            const int ksteps = min(l.ks, p.kdim - s * l.ks) / 16;
            const bf16* a_ptr = a_buf + wr * 32 * lda + s * l.ks;
            if (!p.walk)
              mma::mma_slice(acc, a_ptr, lda, stage + col0, l.chunk + kSkew,
                             ksteps, pairs);
            else
              mma::mma_slice<true>(acc, a_ptr, lda,
                                   stage + col0 * (l.ks + kSkew),
                                   l.ks + kSkew, ksteps, pairs);
          }
          ring_refill();
        }
        if (pairs == 0) continue;
        const int cbase = c * l.chunk + col0;  // the warp's first column
        const int rbase = wr * 32;             // its first row in the tile
        if (!p.walk && j < n) {
          // hidden layer: a (kept for the walk down) and h_j
          bf16* h = at<bf16>(smem, l.h[j]);
          const int ld = l.ld[j];
          // a_j is read by the walk down from layer j + 1, which bwd stats
          // runs only above its level
          float* a_dst =
              j < l.level ? nullptr
              : l.a_smem  ? at<float>(smem, l.a[j])
                          : a_blk + static_cast<size_t>(tm) * l.a_off[j];
          const int lda = l.a_smem ? st.p[j] + kSkew : st.p[j];
          bf16* hg = kFinal && l.dw == kDwRows
                         ? o.rows + rows_off[j] +
                               static_cast<size_t>(row0) * st.p[j]
                         : nullptr;
          mma::for_each_pair_loop(
              acc, pairs,
              [&](int col) {
                return cols_of<true, false>(st, j, cbase + col);
              },
              [&](int r, int col, const Cols& cp, float v0, float v1) {
                // past c_j the product and the bias are 0: a = h = +0
                const int cc = cbase + col, rt = rbase + r;
                float a[2], hv[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  a[e] = __fadd_rn(e ? v1 : v0, cp.b[e]);
                  const float v = affine(a[e], cp.scale[e], cp.shift[e]);
                  hv[e] = v > 0.f ? v : 0.f;
                }
                const __nv_bfloat162 hb = __floats2bfloat162_rn(hv[0], hv[1]);
                *reinterpret_cast<__nv_bfloat162*>(h + rt * ld + cc) = hb;
                if (a_dst != nullptr)
                  *reinterpret_cast<float2*>(a_dst + rt * lda + cc) =
                      make_float2(a[0], a[1]);
                if (hg != nullptr)
                  *reinterpret_cast<__nv_bfloat162*>(
                      hg + static_cast<size_t>(rt) * st.p[j] + cc) = hb;
              });
          continue;
        }
        if (kFinal && p.walk && j == 1) {  // dg, f32, no gate
          const int c0 = st.c[0];
          mma::for_each_pair_loop(
              acc, pairs, [](int) { return 0; },
              [&](int r, int col, int, float v0, float v1) {
                const int row = row0 + rbase + r, cc = cbase + col;
                if (row >= row_end) return;
                float* dst = o.dg + static_cast<size_t>(row) * c0 + cc;
                if (cc < c0) dst[0] = v0;
                if (cc + 1 < c0) dst[1] = v1;
              });
          continue;
        }
        // layer i's dy: the max's cotangent at the top, the gated dhp
        // below it; then its sums (bwd stats at the level) or da_i
        const int i = p.walk ? j - 1 : n;
        const int ci = st.c[i];
        const bool at_level = !kFinal && i == l.level;
        bf16* dab = at<bf16>(smem, l.d[i]);
        const int ld = l.ld[i];
        bf16* da_rows = kFinal && l.dw == kDwRows
                            ? o.rows + rows_off[n - 1 + i] +
                                  static_cast<size_t>(row0) * st.p[i]
                            : nullptr;
        // the walk reads a_i back (a generic pointer: shared memory or
        // the block's scratch)
        const float* a_src =
            !p.walk    ? nullptr
            : l.a_smem ? at<float>(smem, l.a[i])
                       : a_blk + static_cast<size_t>(tm) * l.a_off[i];
        const int lda = l.a_smem ? st.p[i] + kSkew : st.p[i];
        // the terms of the sums of one element pair: (dy, dy * xhat) at
        // bwd stats' level, else (da, 0) with da written as the next
        // product's operand; straight-line code (loads at padded
        // addresses, then selects), rows from row_end on and columns past
        // c_i 0
        auto terms = [&](auto top, auto level, int r, int col, const Cols& cp,
                         float v0, float v1) {
          constexpr bool kTop = decltype(top)::value;
          constexpr bool kLevel = decltype(level)::value;
          const int cc = cbase + col, rt = rbase + r, row = row0 + rt;
          const float vv[2] = {v0, v1};
          float a[2];
          int gi = 0, rk = 0;  // the row's group in the tile, row in group
          if constexpr (kTop) {
            a[0] = __fadd_rn(v0, cp.b[0]);
            a[1] = __fadd_rn(v1, cp.b[1]);
            const int g = k_shift >= 0 ? row >> k_shift : row / k;
            gi = (g - g_first) * ci;
            rk = row - g * k;
          } else {
            const float2 av =
                *reinterpret_cast<const float2*>(a_src + rt * lda + cc);
            a[0] = av.x;
            a[1] = av.y;
          }
          float4 out;
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool valid = row < row_end && cc + e < ci;
            const bool open = affine(a[e], cp.scale[e], cp.shift[e]) > 0.f;
            float dy;
            if constexpr (kTop) {
              const int am = cot_a[gi + cc + e];
              const float dv = cot_d[gi + cc + e];
              dy = valid && open && am == rk ? dv : 0.f;
            } else {
              dy = valid && open ? vv[e] : 0.f;
            }
            const float xhat =
                __fmul_rn(__fsub_rn(a[e], cp.mean[e]), cp.inv_std[e]);
            if constexpr (kLevel) {
              (e ? out.y : out.x) = dy;
              (e ? out.w : out.z) = __fmul_rn(dy, xhat);
            } else {
              d[e] = valid ? da_of(dy, xhat, cp, e) : 0.f;
              (e ? out.y : out.x) = d[e];
              (e ? out.w : out.z) = 0.f;
            }
          }
          if constexpr (!kLevel) {
            const __nv_bfloat162 db2 = __floats2bfloat162_rn(d[0], d[1]);
            *reinterpret_cast<__nv_bfloat162*>(dab + rt * ld + cc) = db2;
            if (da_rows != nullptr)
              *reinterpret_cast<__nv_bfloat162*>(
                  da_rows + static_cast<size_t>(rt) * st.p[i] + cc) = db2;
          }
          return out;
        };
        auto epilogue = [&](auto top, auto level) {
          constexpr bool kTop = decltype(top)::value;
          auto at_col = [&](int col) {
            return cols_of<kTop, true>(st, i, cbase + col);
          };
          if constexpr (kFinal || decltype(level)::value) {
            float* my = kFinal ? sums + wr * l.db_off[n + 1] + l.db_off[i]
                               : sums + wr * 2 * st.p[i];
            const int pi = st.p[i];
            mma::for_each_pair_sums(
                acc, pairs, at_col,
                [&](int r, int col, const Cols& cp, float v0, float v1) {
                  return terms(top, level, r, col, cp, v0, v1);
                },
                [&](int col, float4 s) {
                  const int cc = cbase + col;
                  my[cc] += s.x;
                  my[cc + 1] += s.y;
                  if (!kFinal) {
                    my[pi + cc] += s.z;
                    my[pi + cc + 1] += s.w;
                  }
                });
          } else {
            mma::for_each_pair_loop(
                acc, pairs, at_col,
                [&](int r, int col, const Cols& cp, float v0, float v1) {
                  terms(top, level, r, col, cp, v0, v1);
                });
          }
        };
        // compiled for each of: the top or a walk, at bwd stats' level or
        // forming da
        if (p.walk && at_level)
          epilogue(std::false_type{}, std::true_type{});
        else if (p.walk)
          epilogue(std::false_type{}, std::false_type{});
        else if (at_level)
          epilogue(std::true_type{}, std::true_type{});
        else
          epilogue(std::true_type{}, std::false_type{});
      }
    }
    if (kFinal && l.dw != kDwRows && last_walk > 1) {
      __syncthreads();  // da_1 is complete
      dw_tile(1, ti == 0);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();
}

// The block's partials, after its last tile and a block barrier: its row
// warps' sums in order (bwd stats: the level's two sums into part[block]
// [2][p_level]; bwd final: every db into part[block][p_1 + .. + p_n]) and
// in bwd final its dW: the on-chip dW into its slot, or zero into the slot
// of a block that had no rows (any false).
template <bool kFinal>
__device__ __forceinline__ void write_block_partials(const Chain& st,
                                                     const Layout& l,
                                                     unsigned char* smem,
                                                     const Outs& o, bool any) {
  const int tid = threadIdx.x;
  const float* sums = at<float>(smem, l.sums);
  if (!kFinal) {
    const int pl = st.p[l.level];
    float* dst = o.part + static_cast<size_t>(blockIdx.x) * 2 * pl;
    for (int e = tid; e < 2 * pl; e += blockDim.x) {
      float s = sums[e];
      for (int r = 1; r < l.rw; ++r) s += sums[r * 2 * pl + e];
      dst[e] = s;
    }
    return;
  }
  const int n = st.n;
  const int tot = l.db_off[n + 1];
  float* dst = o.part + static_cast<size_t>(blockIdx.x) * tot;
  for (int e = tid; e < tot; e += blockDim.x) {
    float s = sums[e];
    for (int r = 1; r < l.rw; ++r) s += sums[r * tot + e];
    dst[e] = s;
  }
  if (l.dw == kDwSmem || (!any && l.dw == kDwSlot)) {
    const float* dws = at<float>(smem, l.dwo);
    for (int j = 1; j <= n; ++j) {
      const size_t cnt = static_cast<size_t>(st.p[j - 1]) * st.p[j];
      const float4* src = reinterpret_cast<const float4*>(dws + l.dw_off[j]);
      float4* out = reinterpret_cast<float4*>(
          o.dw_part + l.dw_off[j] * gridDim.x + blockIdx.x * cnt);
      for (size_t e = tid; e < cnt / 4; e += blockDim.x)
        out[e] = any ? src[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// #13 / #14. Grid: persistent blocks, block b taking tiles b, b + grid,
// ... kFinal false: bwd stats at l.level; true: bwd final (dg when o.dg
// is not null). A split_reduce launch adds the partials.
template <bool kFinal>
static __global__ void __launch_bounds__(kThreads, 1)
    rc_bwd_kernel(Chain st, Layout l, Outs o) {
  extern __shared__ __align__(128) unsigned char smem[];
  zero_sums<kFinal>(st, l, smem);
  const int tiles = (st.m + l.tm - 1) / l.tm;
  const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  bwd_tiles<kFinal, false>(st, l, o, smem, blockIdx.x * l.tm,
                           gridDim.x * l.tm, my_tiles, st.m);
  write_block_partials<kFinal>(st, l, smem, o, true);
}

// kDwRows: dW_j = h_{j-1}^T . da_j over all m_pad rows from the bf16 rows
// the main kernel wrote. Block (tile, split): a 64 (Cin) x 256 (Cout)
// tile of one layer's dW (2 x 4 warp tiles, accumulators in registers)
// over one split of the rows, walked in chunks of 32 rows through a
// 3-stage cp.async ring of h's and da's rows; the f32 tile goes to
// part[j] [splits][p_{j-1}][p_j].
struct DwRows {
  const bf16* h[kMaxLayers];
  const bf16* da[kMaxLayers];
  float* part[kMaxLayers];
  int cin_p[kMaxLayers], cout_p[kMaxLayers];
  int first[kMaxLayers + 1];  // the layers' first tile
  int n, rows_per_split, m_pad;
};
constexpr int kDwChunk = 32, kDwTm = 64, kDwTn = 256, kDwStages = 3;
constexpr int kDwLdH = kDwTm + kSkew, kDwLdD = kDwTn + kSkew;
constexpr int kDwStage = kDwChunk * (kDwLdH + kDwLdD);

static __global__ void __launch_bounds__(kThreads, 2)
    rc_dw_rows_kernel(DwRows a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  int q = 0;
  while (q + 1 < a.n && a.first[q + 1] <= static_cast<int>(blockIdx.x)) ++q;
  const int cin_p = a.cin_p[q], cout_p = a.cout_p[q];
  const int tiles_n = (cout_p + kDwTn - 1) / kDwTn;
  const int local = blockIdx.x - a.first[q];
  const int ti = local / tiles_n, tn = local - ti * tiles_n;
  const int c0 = ti * kDwTm, n0 = tn * kDwTn;
  const int win = min(kDwTm, cin_p - c0), cols = min(kDwTn, cout_p - n0);
  const int warp = threadIdx.x >> 5, wm = warp / 4, wn = warp % 4;
  const int pairs = max(0, min(64, cols - wn * 64)) / 16;
  const bool active = pairs > 0 && wm * 32 < win;
  const int r_begin = blockIdx.y * a.rows_per_split;
  const int chunks = (min(a.m_pad, r_begin + a.rows_per_split) - r_begin) /
                     kDwChunk;
  const bf16* h = a.h[q];
  const bf16* da = a.da[q];
  auto issue_chunk = [&](int t) {
    bf16* st = ring + (t % kDwStages) * kDwStage;
    const size_t r0 = r_begin + static_cast<size_t>(t) * kDwChunk;
    mma::load_tile_async(st, kDwLdH, h + r0 * cin_p + c0, cin_p, kDwChunk,
                         win);
    mma::load_tile_async(st + kDwChunk * kDwLdH, kDwLdD,
                         da + r0 * cout_p + n0, cout_p, kDwChunk, cols);
  };
  for (int i = 0; i < kDwStages - 1; ++i) {
    if (i < chunks) issue_chunk(i);
    mma::cp_async_commit();
  }
  mma::WarpTile acc;
  mma::zero(acc);
  for (int t = 0; t < chunks; ++t) {
    mma::cp_async_wait<kDwStages - 2>();
    __syncthreads();
    if (t + kDwStages - 1 < chunks) issue_chunk(t + kDwStages - 1);
    mma::cp_async_commit();
    if (!active) continue;
    const bf16* st = ring + (t % kDwStages) * kDwStage;
    mma::mma_slice_at(acc, st + wm * 32, kDwLdH,
                      st + kDwChunk * kDwLdH + wn * 64, kDwLdD, 2, pairs);
  }
  mma::cp_async_wait<0>();
  if (!active) return;
  float* out = a.part[q] +
               (static_cast<size_t>(blockIdx.y) * cin_p + c0 + wm * 32) *
                   cout_p +
               n0 + wn * 64;
  const int row_end = cin_p - c0 - wm * 32;
  mma::for_each_pair(acc, pairs, [](int) { return 0; },
                     [&](int r, int c, int, float& v0, float& v1) {
                       if (r < row_end)
                         *reinterpret_cast<float2*>(
                             out + static_cast<size_t>(r) * cout_p + c) =
                             make_float2(v0, v1);
                     });
}

// A plan the kernels take: a ring of 2-4 stages, or none (stages 0) with
// the weights resident.
inline bool plan_ok(int tm, int stages, int blocks, const Layout& l) {
  return (tm == 32 || tm == 64 || tm == 128) &&
         (l.w_res ? stages == 0 : stages >= 2 && stages <= 4) &&
         blocks > 0 && l.bytes <= static_cast<unsigned>(kSmemLimit);
}

}  // namespace samlp_rcb
