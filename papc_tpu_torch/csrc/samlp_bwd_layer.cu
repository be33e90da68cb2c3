// One training-backward layer pass of a set-abstraction MLP, walking down:
//   xhat = (a - mean) * inv_std
//   da   = scale * ((dy - s_in[0] / M) - (xhat * s_in[1]) / M)   (BN backward)
//   h    = a_prev (first layer) or max(a_prev * scale' + shift', 0)
//   dW   = bf16(h)^T . bf16(da),   db = sum of da (f32)
//   then, on a later layer, the gradient one layer down through its gate,
//   dy'  = (a_prev * scale' + shift' > 0) ? bf16(da) . bf16(W)^T : 0
//   stored bf16, with the previous BN's sums (sum dy', sum dy' * xhat');
//   on the first layer dg = bf16(da) . bf16(W)^T in f32, no gate.
//
// Replaces: papc_tpu/ops/pallas/samlp.py::bwd_layer (_bwd_layer_kernel).
// Numeric contract kept from it and from its twin fused_mlp._jnp_bwd_layer:
// da in f32, rounded to bf16 once and used by both products; f32
// accumulation, db and sums from the f32 values.
//
// What bounds it on the H100: the bytes of dy, a, a_prev and da read and
// da and dy' (or dg) written, 2 bytes a value (dg 4): 2.35 GB for da + dh
// and 0.90 GB for dW over a SSG step at B=32, 0.70 + 0.27 ms at 3.35
// TB/s; the two products (53.4 GFLOP each) take 0.054 ms each at the
// bf16 peak.
//
// Design, in four launches on the stream:
// 1. da_dh_kernel (csrc/samlp_mma.cuh's ldmatrix + mma.sync core): one
//    pass per row tile. A block of 8 warps owns TM = 32 rw rows (rw row
//    warps by 8 / rw column warps) and a run of Cin tiles of TN = 64 x 8
//    / rw columns; Cout is the k dimension. The plan
//    (samlp_train._da_dh_tile) takes the largest TM that keeps two blocks
//    on an SM: a block's time goes mostly to fixed round trips (its
//    loads, W's slices in turn), so fewer, larger tiles win.
//    - First, all in flight at once: W's first two k-slices and, on a
//      later layer, a_prev's rows at the block's Cin columns into a
//      shared tile (cp.async of 16, 8 or 4 bytes as Cin's rows align).
//    - da: the block reads the tile's dy and a (16-, 8- or 2-byte loads
//      by Cout's alignment, 4 or 8 rows in flight a thread),
//      computes da with the _rn intrinsics op for op as the plain version
//      (the same f32 value), rounds it to bf16 once into a skewed shared
//      tile [TM][cout_p + 8] and, in the block that owns the tile's da
//      (the first of its Cin splits), stores the same rows to the da
//      scratch [m_pad, cout_p] for dw_kernel, zero from row M and column
//      Cout on, with db's f32 column partials of the tile (each thread
//      sums its rows in order, then the threads of a column in order).
//    - dh = da . W^T: W's packed rows [Cin, Cout] are the B operand as
//      [n][k], read by ldmatrix.x4 without .trans (mma_slice<true>);
//      they stream through a 3-stage cp.async ring of [TN][32] k-slices,
//      the A fragments come from the shared da tile, the f32
//      accumulators stay in registers on 32 x 64 warp tiles over all of
//      Cout.
//    - Epilogue: each warp passes its tile through a small stage in
//      shared memory, 8 rows x 32 columns at a time, so that a lane owns
//      one column and each row leaves as one coalesced run (the first
//      layers' odd Cin, 131 to 643, included: a value a lane). On a later
//      layer the gate a_prev * scale' + shift' > 0 (_rn; a_prev from its
//      shared tile), the bf16 dy' store and the column sums (sum dy',
//      sum dy' * xhat') of the f32 dy', each lane's in row order, then
//      the row warps' in warp order through shared memory, into the
//      tile's partial [tiles, 2, cin_p]; on the first layer the f32 dg,
//      no gate, no sums.
//    - SA3 (4096 rows) has few row tiles: blocks that share one split
//      Cin between them, each computing the tile's da again from dy and
//      a, so that the grid reaches the SMs.
// 2. dw_kernel (the same core): dW is a
//    sum over all M rows (524288 in SA1), bound by the bytes of a_prev
//    and da. A block owns a [32 wm x 64 wn] tile of [Cin, Cout] (every
//    Cin channel wherever 16 warps allow, so a_prev comes from device
//    memory once and a second Cout tile's read of the same rows, launched
//    beside it, hits L2) and one range of rows, which it walks in chunks
//    of `rows` through a 3-stage cp.async ring of a_prev and da: chunk
//    t + 2 is in flight while the warps multiply chunk t. The warps read
//    h = a_prev's rows as the transposed A operand (ldmatrix.trans from
//    rows x channels) and da as B, as stored.
//    - Cin a multiple of 8 (rows on 16 bytes): the tile's channels of
//      each row land by 16-byte copies in skewed rows of the stage and
//      are read there. The stages start zeroed, so a row past M (whose
//      da is 0) or a channel past Cin holds a finite value.
//    - Other Cin (3, 6, 131, 196, 259, 323, 515, 643: rows 2-, 4- or
//      8-byte aligned): a chunk of rows is one span 16-byte aligned at
//      its start (chunks start at multiples of 32 rows), copied whole,
//      its tail zero-filled; all threads then copy it into skewed rows
//      of h [rows][tm + 8], 8 channels a step (two 16-byte loads shifted
//      into place), 0 past M and past Cin.
//    The previous layer's affine + ReLU (_rn intrinsics, rounded to bf16
//    as the plain version's h) is applied to the A fragments in
//    registers, each of whose registers holds one channel.
//    Where the tile has fewer than 8 warp tiles, wk warps share each
//    tile, each taking a contiguous part of every chunk's rows, and add
//    their registers in order through shared memory at the end. The
//    block writes its f32 tile from the registers as float2 into
//    dw_part[split], and a reduce adds the splits in a fixed order: 8
//    lanes of a column each sum every 8th split in order, then the 8
//    sums in order (split_reduce_kernel, which adds db's and the sums'
//    tile partials the same way, 32 lanes a column).
// 3. split_reduce_kernel: dW's splits added in a fixed order.
// 4. split_reduce_kernel again, for db's and the sums' tile partials.
// Without dy' or dg (the first layer of SA1, whose input is data), the
// pass computes da and db only.
#include <cstdint>
#include <cstring>

#include "samlp_mma.cuh"
#include "samlp_train.cuh"

namespace {

using samlp_train::affine;
using samlp_train::bf2f;
using samlp_train::relu_affine;
using samlp_train::split_reduce;
using samlp_train::SplitSum;

namespace mma = samlp_mma;

constexpr int kStages = 3;  // ring stages (dW's and W's)
constexpr int kSkew = 8;    // bf16 of padding per shared-memory row
constexpr int kMaxWarps = 16;
constexpr int kDhWarps = 8;  // the da + dh pass's block
constexpr int kDhThreads = kDhWarps * 32;
constexpr int kSlice = 32;            // W's Cout (k) columns a ring stage
constexpr int kLdW = kSlice + kSkew;  // its row stride
// a warp's epilogue stage: 8 rows x 32 f32 columns (a stride of 8 mod 32
// floats: the float2 stores of a quarter's 8 rows hit 32 distinct banks)
constexpr int kStageLd = 40;
constexpr int kStageFloats = 8 * kStageLd;

// The dW product's plan (ops/kernels/samlp_train.py::bwd_layer_plan):
// warp tiles down Cin (wm) and across Cout (wn), warps sharing each
// warp tile (wk), rows a chunk, rows a split.
struct DwShape {
  int wm, wn, wk, rows, rows_per_split;
  __host__ __device__ int tm() const { return 32 * wm; }
  __host__ __device__ int tn() const { return 64 * wn; }
  // a_prev's rows, cin wide, start on 16 bytes: each chunk's rows are
  // copied into skewed rows of the stage and read from there; else the
  // chunk is copied as one span and laid out into h
  __host__ __device__ static bool aligned(int cin) { return cin % 8 == 0; }
  __host__ __device__ int ld_a(int cin) const {
    return aligned(cin) ? tm() + kSkew : cin;
  }
  // a span is read 16 bytes at a time up to 8 elements past its end
  __host__ __device__ int a_elems(int cin) const {
    return (rows * ld_a(cin) + 7) / 8 * 8 + (aligned(cin) ? 0 : 8);
  }
  __host__ __device__ int stage_elems(int cin) const {
    return a_elems(cin) + rows * (tn() + kSkew);
  }
  // h [rows][tm + 8] unless aligned, then the ring; the wk warps' sums
  // reuse both at the end
  size_t smem(int cin) const {
    const size_t h =
        aligned(cin) ? 0 : static_cast<size_t>(rows) * (tm() + kSkew);
    const size_t main =
        2 * (h + static_cast<size_t>(kStages) * stage_elems(cin));
    const size_t sums = 4 * static_cast<size_t>(wk - 1) * wm * wn *
                        mma::kWarpRows * mma::kWarpCols;
    return main > sums ? main : sums;
  }
};

// The da + dh pass's plan (ops/kernels/samlp_train.py::_da_dh_tile): rw
// row warps of 32 rows by kDhWarps / rw column warps of 64 Cin columns,
// tiles_per_split Cin tiles a block; gate: a later layer, whose a_prev
// rows for the block's Cin columns are staged in shared memory. v: Cout
// columns a thread of the da phase takes (8, 4 or 1: the widest load
// Cout's rows align to).
struct DaDhShape {
  int rw, tiles_per_split, gate;
  __host__ __device__ int tm() const { return mma::kWarpRows * rw; }
  __host__ __device__ int cw() const { return kDhWarps / rw; }
  __host__ __device__ int tn() const { return mma::kWarpCols * cw(); }
  __host__ __device__ static int k_slices(int cout_p) {
    return (cout_p + kSlice - 1) / kSlice;
  }
  // a W slice holds the rows of one Cin tile: at most Cin's
  __host__ __device__ int ring_rows(int cin_p) const {
    return tn() < cin_p ? tn() : cin_p;
  }
  // the Cin tiles of a split (the last may have fewer)
  __host__ __device__ int split_tiles(int cin_p) const {
    const int n = (cin_p + tn() - 1) / tn();
    return tiles_per_split < n ? tiles_per_split : n;
  }
  // a_prev's tile [tm][ld_ap]: the block's Cin columns and a skew
  __host__ __device__ int ld_ap(int cin_p) const {
    const int cols = split_tiles(cin_p) * tn();
    return gate ? (cols < cin_p ? cols : cin_p) + kSkew : 0;
  }
  __host__ __device__ static int vec_cols(int cout) {
    return cout % 8 == 0 ? 8 : cout % 4 == 0 ? 4 : 1;
  }
  // the da phase's row phases: the threads that share one column group
  __host__ __device__ static int phases(int cout_p, int v) {
    const int groups = cout_p / v;
    return groups >= kDhThreads ? 1 : kDhThreads / groups;
  }
  // floats of db's per-phase column sums, later of each warp's epilogue
  // stage, where the warp leaves its two column sums of a Cin tile
  __host__ __device__ static int red_floats(int cout_p, int v) {
    const int db = phases(cout_p, v) * cout_p;
    const int stages = kDhWarps * kStageFloats;
    return db > stages ? db : stages;
  }
  // the da tile [tm][cout_p + 8], the W ring, the sums, a_prev's tile
  size_t smem(int cin_p, int cout_p, int v) const {
    return 2 * (static_cast<size_t>(tm()) * (cout_p + kSkew) +
                static_cast<size_t>(kStages) * ring_rows(cin_p) * kLdW +
                static_cast<size_t>(tm()) * ld_ap(cin_p)) +
           4 * static_cast<size_t>(red_floats(cout_p, v));
  }
};

// V bf16 values as one load or store.
template <int V>
struct Bf16s;
template <>
struct Bf16s<8> {
  using T = uint4;
};
template <>
struct Bf16s<4> {
  using T = uint2;
};
template <>
struct Bf16s<1> {
  using T = unsigned short;
};

__device__ __forceinline__ float bits2f(unsigned short h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// The row tile's da: rows row0 + r (r < tm) of dy and a, V columns a
// thread (rows r = phase, phase + phases, ..., kBatch of them in flight),
// rounded to bf16 into da_s [tm][ld_s] and, given da_g, into the same
// rows of the da scratch [m_pad, cout_p]; 0 from row M and column Cout
// on. Each thread sums its f32 values (rows below M) in row order into
// red[phase][cout_p]. Where M is a power of two (every layer of the
// models at B=32), x / M is x * (1 / M): both round the same exact
// quotient, so the bits are the division's, at a fraction of its cost.
template <int V>
__device__ __forceinline__ void da_tile(
    const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ a,
    int m, int cout, int cout_p, const float* __restrict__ vec,
    const float* __restrict__ s_in, int row0, int tm, __nv_bfloat16* da_s,
    int ld_s, __nv_bfloat16* __restrict__ da_g, float* red) {
  using T = typename Bf16s<V>::T;
  constexpr int kBatch = V == 8 ? 4 : 8;
  const int groups = cout_p / V;
  const int phases = DaDhShape::phases(cout_p, V);
  const float fm = static_cast<float>(m);
  const bool pow2 = (m & (m - 1)) == 0;
  const float inv_m = __frcp_rn(fm);  // exact where pow2
  auto over_m = [&](float x) {
    return pow2 ? __fmul_rn(x, inv_m) : __fdiv_rn(x, fm);
  };
  for (int e = threadIdx.x; e < groups * phases; e += blockDim.x) {
    const int g = e % groups, p = e / groups, c0 = g * V;
    const bool in = c0 < cout;  // V divides Cout: all of a group or none
    float scale[V], mean[V], inv_std[V], mu1[V], s2[V], sum[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = in ? c0 + v : 0;
      scale[v] = vec[c];
      mean[v] = vec[2 * cout + c];
      inv_std[v] = vec[3 * cout + c];
      mu1[v] = over_m(s_in[c]);
      s2[v] = s_in[cout + c];
      sum[v] = 0.f;
    }
    for (int r = p; r < tm; r += kBatch * phases) {
      T dyr[kBatch], ar[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int rr = r + b * phases;
        if (in && rr < tm && row0 + rr < m) {
          const size_t i = static_cast<size_t>(row0 + rr) * cout + c0;
          dyr[b] = __ldg(reinterpret_cast<const T*>(dy + i));
          ar[b] = __ldg(reinterpret_cast<const T*>(a + i));
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int rr = r + b * phases;
        if (rr >= tm) break;
        const bool live = in && row0 + rr < m;
        unsigned short dyh[V], ah[V], out[V];
        if (live) {
          memcpy(dyh, &dyr[b], sizeof(T));
          memcpy(ah, &ar[b], sizeof(T));
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float d = 0.f;
          if (live) {
            const float xhat =
                __fmul_rn(__fsub_rn(bits2f(ah[v]), mean[v]), inv_std[v]);
            d = __fmul_rn(scale[v],
                          __fsub_rn(__fsub_rn(bits2f(dyh[v]), mu1[v]),
                                    over_m(__fmul_rn(xhat, s2[v]))));
            sum[v] += d;
          }
          out[v] = __bfloat16_as_ushort(__float2bfloat16_rn(d));
        }
        T o;
        memcpy(&o, out, sizeof(T));
        *reinterpret_cast<T*>(da_s + rr * ld_s + c0) = o;
        if (da_g != nullptr)
          *reinterpret_cast<T*>(da_g + static_cast<size_t>(row0 + rr) * cout_p +
                                c0) = o;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) red[p * cout_p + c0 + v] = sum[v];
  }
}

// Grid: (row tiles, Cin splits). Block tile's rows row0 = blockIdx.x * tm
// on; Cin tiles [blockIdx.y * tiles_per_split, + tiles_per_split). The
// first split of a tile writes its da rows and db partial.
template <int V>
__global__ void __launch_bounds__(kDhThreads, 2)
    da_dh_kernel(const __nv_bfloat16* __restrict__ dy,
                 const __nv_bfloat16* __restrict__ a, int m, int cout,
                 int cout_p, const float* __restrict__ vec,
                 const float* __restrict__ s_in,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ a_prev, int cin, int cin_p,
                 const float* __restrict__ vec_prev, DaDhShape sh,
                 __nv_bfloat16* __restrict__ da, float* __restrict__ db_part,
                 __nv_bfloat16* __restrict__ dy_prev, float* __restrict__ dg,
                 float* __restrict__ s_part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tm = sh.tm(), tn = sh.tn(), cw = sh.cw();
  const int ld_da = cout_p + kSkew, ld_ap = sh.ld_ap(cin_p);
  __nv_bfloat16* da_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = da_s + tm * ld_da;
  const int stage_elems = sh.ring_rows(cin_p) * kLdW;
  float* red = reinterpret_cast<float*>(ring + kStages * stage_elems);
  __nv_bfloat16* ap_s = reinterpret_cast<__nv_bfloat16*>(
      red + DaDhShape::red_floats(cout_p, V));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, row0 = tile * tm;
  const bool owner = blockIdx.y == 0;
  const bool gate = dy_prev != nullptr;
  const int nt_begin = blockIdx.y * sh.tiles_per_split;
  const int nt_end =
      min((cin_p + tn - 1) / tn, nt_begin + sh.tiles_per_split);
  const int c_begin = nt_begin * tn;  // the block's first Cin column
  const int k_slices = DaDhShape::k_slices(cout_p);
  const int steps =
      gate || dg != nullptr ? (nt_end - nt_begin) * k_slices : 0;

  // W's k-slice t of the block's sequence (Cin tiles, then k-slices)
  auto issue = [&](int t) {
    const int n0 = (nt_begin + t / k_slices) * tn;
    const int k0 = (t % k_slices) * kSlice;
    mma::load_tile_async(ring + (t % kStages) * stage_elems, kLdW,
                         w + static_cast<size_t>(n0) * cout_p + k0, cout_p,
                         min(tn, cin_p - n0), min(kSlice, cout_p - k0));
  };
  // The first group: W's first slice and, on a later layer, a_prev's rows
  // at the block's Cin columns, by copies of 16, 8 or 4 bytes as Cin's
  // rows align (an odd Cin, which no later layer of the models has, by
  // plain loads), all in flight while da is computed.
  if (steps > 0) issue(0);
  if (gate) {
    const int cols =
        min(min(ld_ap - kSkew, (nt_end - nt_begin) * tn), cin - c_begin);
    const int rows = min(tm, m - row0);
    const int seg = cin % 8 == 0 ? 8 : cin % 4 == 0 ? 4 : cin % 2 == 0 ? 2 : 1;
    const int per_row = (cols + seg - 1) / seg;
    for (int e = tid; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e - r * per_row) * seg;
      __nv_bfloat16* dst = ap_s + r * ld_ap + c;
      const __nv_bfloat16* src =
          a_prev + static_cast<size_t>(row0 + r) * cin + c_begin + c;
      if (seg == 8)
        mma::cp_async16(dst, src);
      else if (seg == 4)
        mma::cp_async8(dst, src);
      else if (seg == 2)
        mma::cp_async4(dst, src, true);
      else
        *dst = *src;
    }
  }
  mma::cp_async_commit();
  if (1 < steps) issue(1);
  mma::cp_async_commit();

  da_tile<V>(dy, a, m, cout, cout_p, vec, s_in, row0, tm, da_s, ld_da,
             owner ? da : nullptr, red);
  __syncthreads();  // the da tile and db's phase sums are complete
  if (owner) {
    const int phases = DaDhShape::phases(cout_p, V);
    for (int c = tid; c < cout_p; c += blockDim.x) {
      float s = red[c];
      for (int q = 1; q < phases; ++q) s += red[q * cout_p + c];
      db_part[static_cast<size_t>(tile) * cout_p + c] = s;
    }
  }

  const int wr = warp / cw, wc = warp % cw;
  const int rbase = row0 + wr * mma::kWarpRows;
  mma::WarpTile acc;
  for (int t = 0; t < steps; ++t) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // slice t landed; every warp is done with slice t - 1
    if (t + kStages - 1 < steps) issue(t + kStages - 1);
    mma::cp_async_commit();
    const int nt = nt_begin + t / k_slices, ks = t % k_slices;
    const int n0 = nt * tn + wc * mma::kWarpCols;  // the warp's Cin columns
    const int pairs = max(0, min(mma::kWarpCols, cin_p - n0)) / 16;
    if (ks == 0) mma::zero(acc);
    if (pairs > 0)
      mma::mma_slice<true>(
          acc, da_s + wr * mma::kWarpRows * ld_da + ks * kSlice, ld_da,
          ring + (t % kStages) * stage_elems + wc * mma::kWarpCols * kLdW,
          kLdW, min(kSlice, cout_p - ks * kSlice) / 16, pairs);
    if (ks + 1 < k_slices) continue;

    // Epilogue: the warp's tile goes out 8 rows by 32 columns at a time
    // through its stage in shared memory, so that each row's 32 columns
    // leave (and a_prev's arrive) as one coalesced run, a column a lane:
    // column 32 q + lane of the warp tile, rows in order (i, h, row).
    float* stage = red + warp * kStageFloats;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (32 * q >= 16 * pairs) continue;  // warp-uniform
      const int col = n0 + 32 * q + lane;
      const bool in = 32 * q + lane < 16 * pairs && col < cin;
      float scale = 0.f, shift = 0.f, mean = 0.f, inv_std = 0.f;
      if (gate && in) {
        scale = vec_prev[col];
        shift = vec_prev[cin + col];
        mean = vec_prev[2 * cin + col];
        inv_std = vec_prev[3 * cin + col];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __syncwarp();  // the last rows were read
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (4 * q + jj < 2 * pairs)
              *reinterpret_cast<float2*>(
                  stage + (lane >> 2) * kStageLd + 8 * jj + 2 * (lane & 3)) =
                  make_float2(acc.acc[i][4 * q + jj][2 * h],
                              acc.acc[i][4 * q + jj][2 * h + 1]);
          __syncwarp();
          const int rt = wr * mma::kWarpRows + 16 * i + 8 * h;  // tile row
          const int rows = in ? min(8, m - row0 - rt) : 0;
          const float* v = stage + lane;
          const size_t g = static_cast<size_t>(row0 + rt) * cin + col;
          if (!gate) {
#pragma unroll 2
            for (int r = 0; r < rows; ++r)
              dg[g + static_cast<size_t>(r) * cin] = v[r * kStageLd];
            continue;
          }
          const __nv_bfloat16* x = ap_s + rt * ld_ap + col - c_begin;
#pragma unroll 2
          for (int r = 0; r < rows; ++r) {
            const float ap = bf2f(x[r * ld_ap]);
            const float y =
                affine(ap, scale, shift) > 0.f ? v[r * kStageLd] : 0.f;
            dy_prev[g + static_cast<size_t>(r) * cin] =
                __float2bfloat16_rn(y);
            s1[q] += y;
            s2[q] += __fmul_rn(y, __fmul_rn(__fsub_rn(ap, mean), inv_std));
          }
        }
    }
    if (!gate) continue;
    // the warp's column sums over its 32 rows, where its stage was
    __syncwarp();
    stage[lane] = s1[0];
    stage[32 + lane] = s1[1];
    stage[mma::kWarpCols + lane] = s2[0];
    stage[mma::kWarpCols + 32 + lane] = s2[1];
    __syncthreads();  // every warp's sums of this Cin tile are in red
    // the tile's partial: the row warps' sums of each column in warp order
    for (int q = tid; q < 2 * tn; q += blockDim.x) {
      const int k = q / tn, col = q - k * tn;
      const int n = nt * tn + col;
      if (n >= cin_p) continue;
      const int at = (col / mma::kWarpCols) * kStageFloats +
                     k * mma::kWarpCols + col % mma::kWarpCols;
      float s = red[at];
      for (int r = 1; r < sh.rw; ++r) s += red[r * cw * kStageFloats + at];
      s_part[(static_cast<size_t>(tile) * 2 + k) * cin_p + n] = s;
    }
  }
  mma::cp_async_wait<0>();
}

// The same on a register of two bf16 of one channel.
__device__ __forceinline__ unsigned relu_affine2(unsigned x, float scale,
                                                 float shift) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&x);
  h.x = relu_affine(h.x, scale, shift);
  h.y = relu_affine(h.y, scale, shift);
  return *reinterpret_cast<unsigned*>(&h);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    dw_kernel(const __nv_bfloat16* __restrict__ a_prev, int m, int cin,
              int cin_p, const float* __restrict__ vec_prev,
              const __nv_bfloat16* __restrict__ da, int cout_p, DwShape sh,
              int tiles_n, float* __restrict__ dw_part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tm = sh.tm(), tn = sh.tn(), rows = sh.rows;
  const bool aligned = DwShape::aligned(cin);
  const int ld_a = sh.ld_a(cin), a_elems = sh.a_elems(cin);
  const int ld_h = tm + kSkew, ld_d = tn + kSkew;
  const int stage_elems = sh.stage_elems(cin);
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = hbuf + (aligned ? 0 : rows * ld_h);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ti = blockIdx.x / tiles_n;
  const int c0 = ti * tm, n0 = (blockIdx.x - ti * tiles_n) * tn;
  const int split = blockIdx.y;
  const int r_begin = split * sh.rows_per_split;
  const int r_end = min(m, r_begin + sh.rows_per_split);
  const int chunks = (r_end - r_begin + rows - 1) / rows;
  const int win = min(tm, cin - c0);      // the tile's Cin channels
  const int cols = min(tn, cout_p - n0);  // its da columns (16-multiple)
  // warp -> (wk_i, wm_i, wn_i); a warp whose rows or columns all lie
  // past the layer skips its products and its stores
  const int wn_i = warp % sh.wn, wm_i = (warp / sh.wn) % sh.wm;
  const int wk_i = warp / (sh.wn * sh.wm);
  const int pairs = max(0, min(mma::kWarpCols, cols - wn_i * 64)) / 16;
  const bool active = pairs > 0 && wm_i * 32 < win;
  const int ksteps = rows / 16 / sh.wk;  // k16 steps of a warp a chunk

  // Aligned rows are read where they land: the stages start zeroed, so
  // rows past M (whose da is 0) and channels past Cin hold finite values.
  if (aligned) {
    for (int e = tid; e < kStages * stage_elems / 8; e += nthreads)
      reinterpret_cast<uint4*>(ring)[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  auto issue = [&](int t) {
    __nv_bfloat16* dst = ring + (t % kStages) * stage_elems;
    const int r0 = r_begin + t * rows;
    const int here = min(rows, r_end - r0);
    if (aligned) {
      const int segs = win / 8;
      for (int e = tid; e < here * segs; e += nthreads) {
        const int r = e / segs, q = e - r * segs;
        mma::cp_async16(dst + r * ld_a + q * 8,
                        a_prev + static_cast<size_t>(r0 + r) * cin + c0 +
                            q * 8);
      }
    } else {
      const __nv_bfloat16* src = a_prev + static_cast<size_t>(r0) * cin;
      const int bytes = here * cin * 2;
      for (int q = tid; q * 16 < bytes; q += nthreads)
        mma::cp_async16_zfill(dst + q * 8, src + q * 8,
                              min(16, bytes - q * 16));
    }
    // all `rows` rows of da: it has m_pad rows, zero from m on
    mma::load_tile_async(dst + a_elems, ld_d,
                         da + static_cast<size_t>(r0) * cout_p + n0, cout_p,
                         rows, cols);
  };

  // the previous layer's affine + ReLU on the A fragments in registers,
  // rounded to bf16 as the plain version's h; this lane's channels
  // 16 i + 8 j + lane / 4 of the warp tile at 2 i + j (0 past Cin)
  float ch_scale[4], ch_shift[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = wm_i * 32 + 16 * (q >> 1) + 8 * (q & 1) + (lane >> 2);
    const bool in = vec_prev != nullptr && c < win;
    ch_scale[q] = in ? vec_prev[c0 + c] : 0.f;
    ch_shift[q] = in ? vec_prev[cin + c0 + c] : 0.f;
  }
  auto relu_affine_a = [&](unsigned (&af)[2][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        af[i][r] = relu_affine2(af[i][r], ch_scale[2 * i + (r & 1)],
                                ch_shift[2 * i + (r & 1)]);
  };

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < chunks) issue(i);
    mma::cp_async_commit();
  }
  mma::WarpTile acc;
  mma::zero(acc);
  for (int t = 0; t < chunks; ++t) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk t landed; every warp is done with chunk t - 1
    if (t + kStages - 1 < chunks) issue(t + kStages - 1);
    mma::cp_async_commit();
    const __nv_bfloat16* stage = ring + (t % kStages) * stage_elems;
    const __nv_bfloat16* h = aligned ? stage : hbuf;
    const int ldh = aligned ? ld_a : ld_h;
    if (!aligned) {
      mma::lay_out_chunk(stage, cin, c0, hbuf, ld_h, rows, tm,
                         min(rows, r_end - (r_begin + t * rows)), win, tid,
                         nthreads);
      __syncthreads();
    }
    if (!active) continue;
    const __nv_bfloat16* d = stage + a_elems;
    for (int s = wk_i * ksteps; s < (wk_i + 1) * ksteps; s += 2) {
      const __nv_bfloat16* a = h + s * 16 * ldh + wm_i * 32;
      const __nv_bfloat16* b = d + s * 16 * ld_d + wn_i * 64;
      const int ks = min(2, (wk_i + 1) * ksteps - s);
      if (vec_prev != nullptr)
        mma::mma_slice_at(acc, a, ldh, b, ld_d, ks, pairs, relu_affine_a);
      else
        mma::mma_slice_at(acc, a, ldh, b, ld_d, ks, pairs);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // the wk warps of a warp tile, added in order of wk_i
  if (sh.wk > 1) {
    float* sums = reinterpret_cast<float*>(hbuf);
    constexpr int kTile = mma::kWarpRows * mma::kWarpCols;
    // warp j > 0 of a warp tile in slot j - 1, each value at 32 v + lane
    auto slot = [&](int j) {
      return sums + ((j - 1) * sh.wm * sh.wn + wm_i * sh.wn + wn_i) * kTile +
             lane;
    };
    if (wk_i > 0) {
      float* mine = slot(wk_i);
#pragma unroll
      for (int v = 0; v < 64; ++v)
        mine[32 * v] = acc.acc[v >> 5][(v >> 2) & 7][v & 3];
    }
    __syncthreads();
    if (wk_i == 0)
      for (int j = 1; j < sh.wk; ++j) {
        const float* other = slot(j);
#pragma unroll
        for (int v = 0; v < 64; ++v)
          acc.acc[v >> 5][(v >> 2) & 7][v & 3] += other[32 * v];
      }
  }
  if (wk_i != 0 || !active) return;
  float* out = dw_part +
               (static_cast<size_t>(split) * cin_p + c0 + wm_i * 32) * cout_p +
               n0 + wn_i * 64;
  const int row_end = cin_p - c0 - wm_i * 32;
  mma::for_each_pair(
      acc, pairs, [](int) { return 0; },
      [&](int r, int c, int, float& v0, float& v1) {
        if (r < row_end)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * cout_p +
                                     c) = make_float2(v0, v1);
      });
}

}  // namespace

// dy, a [M, Cout] bf16, 16-byte aligned; a_prev [M, Cin] bf16, 16-byte
// aligned (the previous pre-activation, or the block input on the first
// layer); w bf16 [cin_p, cout_p] packed (zero-padded to multiples of 16);
// vec f32 [4, Cout] (scale, shift, mean, inv_std); s_in f32 [2, Cout];
// vec_prev f32 [4, Cin] or null on the first layer. Plan (see
// ops/kernels/samlp_train.py::bwd_layer_plan): m_pad = M rounded up to a
// multiple of the da + dh pass's 32 dh_rw rows and of dw_rows; that
// pass's dh_rw row warps (1, 2, 4 or 8) and dh_tiles_per_split Cin tiles
// a block; the dW product's warp tiles dw_wm x dw_wn with dw_wk warps
// each, chunks of dw_rows rows (32, 64 or 128, a multiple of 16 dw_wk),
// splits x rows_per_split (a multiple of dw_rows) covering M once.
// Scratch: da [m_pad, cout_p] bf16, db_part [tiles, cout_p], dw_part
// [splits, cin_p, cout_p], s_part [tiles, 2, cin_p], tiles = m_pad / (32
// dh_rw).
// -> dw [Cin, Cout], db [Cout] f32; and dy_prev [M, Cin] bf16 with s_prev
// [2, Cin] (vec_prev given), or dg [M, Cin] f32 (first layer), or neither.
PAPC_EXPORT int papc_samlp_bwd_layer(
    const void* dy, const void* a, const void* a_prev, int m, int m_pad,
    int cin, int cout, const void* w, int cin_p, int cout_p, const float* vec,
    const float* s_in, const float* vec_prev, int dh_rw,
    int dh_tiles_per_split, int dw_wm, int dw_wn, int dw_wk, int dw_rows,
    int splits, int rows_per_split, void* da, float* db_part, float* dw_part,
    float* s_part, float* dw, float* db, void* dy_prev, float* dg,
    float* s_prev, void* stream) {
  const DwShape sh{dw_wm, dw_wn, dw_wk, dw_rows, rows_per_split};
  const DaDhShape dh{dh_rw, dh_tiles_per_split, dy_prev != nullptr};
  const int v = DaDhShape::vec_cols(cout);
  if (m <= 0 || cin <= 0 || cout <= 0 || cin_p % 16 != 0 ||
      cout_p % 16 != 0 || cin_p < cin || cout_p < cout ||
      (dh_rw != 1 && dh_rw != 2 && dh_rw != 4 && dh_rw != 8) ||
      dh_tiles_per_split <= 0 || m_pad < m || m_pad % dh.tm() != 0 ||
      dh.smem(cin_p, cout_p, v) > 232448 || dw_wm <= 0 || dw_wn <= 0 ||
      dw_wk <= 0 || dw_wm * dw_wn * dw_wk > kMaxWarps ||
      (dw_rows != 32 && dw_rows != 64 && dw_rows != 128) ||
      m_pad % dw_rows != 0 || dw_rows % (16 * dw_wk) != 0 || splits <= 0 ||
      rows_per_split <= 0 || rows_per_split % dw_rows != 0 ||
      static_cast<long long>(splits) * rows_per_split < m ||
      static_cast<long long>(splits - 1) * rows_per_split >= m ||
      reinterpret_cast<std::uintptr_t>(a_prev) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(dy) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(a) % 16 != 0 ||
      (vec_prev != nullptr && dg != nullptr) ||
      (vec_prev == nullptr && dy_prev != nullptr) ||
      ((dy_prev == nullptr) != (s_prev == nullptr)))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* dy_b = static_cast<const __nv_bfloat16*>(dy);
  const auto* a_b = static_cast<const __nv_bfloat16*>(a);
  const auto* ap_b = static_cast<const __nv_bfloat16*>(a_prev);
  const auto* w_b = static_cast<const __nv_bfloat16*>(w);
  auto* da_b = static_cast<__nv_bfloat16*>(da);
  auto* dyp_b = static_cast<__nv_bfloat16*>(dy_prev);

  const int tiles = m_pad / dh.tm();
  const int n_tiles = (cin_p + dh.tn() - 1) / dh.tn();
  const bool product = dy_prev != nullptr || dg != nullptr;
  const dim3 grid(tiles, product ? (n_tiles + dh_tiles_per_split - 1) /
                                       dh_tiles_per_split
                                 : 1);
  const size_t smem = dh.smem(cin_p, cout_p, v);
  cudaError_t err;
  if (v == 8)
    err = papc_launch(da_dh_kernel<8>, grid, dim3(kDhThreads), smem, s, dy_b,
                      a_b, m, cout, cout_p, vec, s_in, w_b, ap_b, cin, cin_p,
                      vec_prev, dh, da_b, db_part, dyp_b, dg, s_part);
  else if (v == 4)
    err = papc_launch(da_dh_kernel<4>, grid, dim3(kDhThreads), smem, s, dy_b,
                      a_b, m, cout, cout_p, vec, s_in, w_b, ap_b, cin, cin_p,
                      vec_prev, dh, da_b, db_part, dyp_b, dg, s_part);
  else
    err = papc_launch(da_dh_kernel<1>, grid, dim3(kDhThreads), smem, s, dy_b,
                      a_b, m, cout, cout_p, vec, s_in, w_b, ap_b, cin, cin_p,
                      vec_prev, dh, da_b, db_part, dyp_b, dg, s_part);
  if (err != cudaSuccess) return err;
  const int tiles_m = (cin + sh.tm() - 1) / sh.tm();
  const int tiles_n = (cout_p + sh.tn() - 1) / sh.tn();
  err = papc_launch(dw_kernel, dim3(tiles_m * tiles_n, splits),
                    dim3(32 * dw_wm * dw_wn * dw_wk), sh.smem(cin), s, ap_b,
                    m, cin, cin_p, vec_prev,
                    static_cast<const __nv_bfloat16*>(da_b), cout_p, sh,
                    tiles_n, dw_part);
  if (err != cudaSuccess) return err;
  const SplitSum none{nullptr, 0, 0, 0, 0, 0, nullptr};
  err = split_reduce({dw_part, splits, cin_p, cout_p, cin, cout, dw}, none, 8,
                     s);
  if (err != cudaSuccess) return err;
  // the row tiles' partials: up to thousands a column, 32 lanes each
  const SplitSum db_sum{db_part, tiles, 1, cout_p, 1, cout, db};
  if (dy_prev == nullptr) return split_reduce(db_sum, none, 32, s);
  return split_reduce(db_sum, {s_part, tiles, 2, cin_p, 2, cin, s_prev}, 32,
                      s);
}
