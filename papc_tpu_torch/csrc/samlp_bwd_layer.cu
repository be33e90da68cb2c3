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
// What bounds it on the H100: the two products (the same FLOPs as the
// forward layer's, twice) and the bytes of dy, a and a_prev read and dy'
// written, 2 bytes a value. The dW product alone is bound by the bytes
// of a_prev and da read once (0.90 GB over a SSG step at B=32, 0.27 ms
// at 3.35 TB/s; its 53.6 GFLOP take 0.054 ms at the bf16 peak).
//
// Design, in four steps on the stream:
// 1. da_kernel: one thread per (row slice, channel); writes bf16 da
//    [m_pad, cout_p] (zero in the padding, so the products need no masks)
//    and per-slice f32 partials of db. The affine, x-hat and da use the
//    _rn intrinsics, so da equals the plain version's before rounding.
// 2. dw_kernel (csrc/samlp_mma.cuh's ldmatrix + mma.sync core): dW is a
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
//    sums in order.
// 3. dh_kernel (skipped when neither dy' nor dg is wanted): da . W^T over
//    tiles of 128 rows, operands read by the tensor-core loads straight
//    from device memory (W^T as a column-major B of the packed W); the
//    epilogue gates, stores and sums as in samlp_linear_stats.cu.
// 4. The fixed-order reduces of db, dW and the sums.
#include <cstdint>

#include "samlp_mma.cuh"
#include "samlp_train.cuh"

namespace {

using samlp_train::affine;
using samlp_train::bf2f;

namespace mma = samlp_mma;

constexpr int kStages = 3;  // dW ring stages
constexpr int kSkew = 8;    // bf16 of padding per shared-memory row
constexpr int kMaxWarps = 16;

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

__global__ void da_kernel(const __nv_bfloat16* __restrict__ dy,
                          const __nv_bfloat16* __restrict__ a, int m,
                          int m_pad, int cout, int cout_p,
                          const float* __restrict__ vec,
                          const float* __restrict__ s_in, int slices,
                          __nv_bfloat16* __restrict__ da,
                          float* __restrict__ db_part) {
  const long long total = static_cast<long long>(slices) * cout_p;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float fm = static_cast<float>(m);
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += stride) {
    const int p = static_cast<int>(t / cout_p);
    const int ch = static_cast<int>(t - static_cast<long long>(p) * cout_p);
    float sum = 0.f;
    if (ch < cout) {
      const float scale = vec[ch], mean = vec[2 * cout + ch];
      const float inv_std = vec[3 * cout + ch];
      const float mu1 = __fdiv_rn(s_in[ch], fm), s2 = s_in[cout + ch];
      for (int r = p; r < m_pad; r += slices) {
        float v = 0.f;
        if (r < m) {
          const size_t i = static_cast<size_t>(r) * cout + ch;
          const float xhat = __fmul_rn(__fsub_rn(bf2f(a[i]), mean), inv_std);
          v = __fmul_rn(scale,
                        __fsub_rn(__fsub_rn(bf2f(dy[i]), mu1),
                                  __fdiv_rn(__fmul_rn(xhat, s2), fm)));
          sum += v;
        }
        da[static_cast<size_t>(r) * cout_p + ch] = __float2bfloat16_rn(v);
      }
    } else {
      for (int r = p; r < m_pad; r += slices)
        da[static_cast<size_t>(r) * cout_p + ch] = __float2bfloat16_rn(0.f);
    }
    db_part[static_cast<size_t>(p) * cout_p + ch] = sum;
  }
}

// max(x * scale + shift, 0) rounded to bf16, as the plain version's h.
__device__ __forceinline__ __nv_bfloat16 relu_affine(__nv_bfloat16 x,
                                                     float scale,
                                                     float shift) {
  const float v = affine(bf2f(x), scale, shift);
  return __float2bfloat16_rn(v > 0.f ? v : 0.f);
}

// The same on a register of two bf16 of one channel.
__device__ __forceinline__ unsigned relu_affine2(unsigned x, float scale,
                                                 float shift) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&x);
  h.x = relu_affine(h.x, scale, shift);
  h.y = relu_affine(h.y, scale, shift);
  return *reinterpret_cast<unsigned*>(&h);
}

// Eight consecutive bf16 from element o (any o) of a 16-byte-aligned
// buffer: two 16-byte loads, then a shift by o % 8 elements (whole words,
// then half a word by a funnel shift).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* base, int o) {
  const uint4* p = reinterpret_cast<const uint4*>(base) + (o >> 3);
  const uint4 a = p[0], b = p[1];
  const unsigned v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int ws = (o & 7) >> 1;
  unsigned u[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    u[k] = ws == 0 ? v[k] : ws == 1 ? v[k + 1] : ws == 2 ? v[k + 2] : v[k + 3];
  if (o & 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) u[k] = __funnelshift_r(u[k], u[k + 1], 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// One staged span of a_prev (row r, channel c at span[r * cin + c], rows
// not 16-byte aligned; the buffer holds 8 elements past the span) copied
// into rows [rows][ld_h] for the tile's tm channels from c0, 8 a thread
// step, 0 in rows from `here` on and channels from `win` on.
__device__ __forceinline__ void lay_out_chunk(const __nv_bfloat16* span,
                                              int cin, int c0,
                                              __nv_bfloat16* hbuf, int ld_h,
                                              int rows, int tm, int here,
                                              int win) {
  const int per_row = tm / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e - r * per_row) * 8;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < here && c < win) {
      out = load8(span, r * cin + c0 + c);
      unsigned* w = reinterpret_cast<unsigned*>(&out);
      // zero the channels from win on
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int keep = win - c - 2 * k;  // of word k's two channels
        if (keep <= 0)
          w[k] = 0u;
        else if (keep == 1)
          w[k] &= 0xffffu;
      }
    }
    *reinterpret_cast<uint4*>(hbuf + r * ld_h + c) = out;
  }
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
      lay_out_chunk(stage, cin, c0, hbuf, ld_h, rows, tm,
                    min(rows, r_end - (r_begin + t * rows)), win);
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

// dw[r, c] = the sum over splits of part[split, r, c] in a fixed order:
// lane row y of a block sums splits y, y + 8, ... of 32 columns in order,
// then row 0 adds the 8 sums in order. Grid: (column blocks, Cin).
__global__ void dw_reduce_kernel(const float* __restrict__ part, int splits,
                                 int cin_p, int cout, int cout_p,
                                 float* __restrict__ dw) {
  __shared__ float sums[8][33];
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  const int r = blockIdx.y, c = blockIdx.x * 32 + x;
  float s = 0.f;
  if (c < cout) {
    const float* p = part + static_cast<size_t>(r) * cout_p + c;
    const size_t step = static_cast<size_t>(cin_p) * cout_p;
#pragma unroll 4
    for (int i = y; i < splits; i += 8) s += p[i * step];
  }
  sums[y][x] = s;
  __syncthreads();
  if (y != 0 || c >= cout) return;
  s = sums[0][x];
#pragma unroll
  for (int j = 1; j < 8; ++j) s += sums[j][x];
  dw[static_cast<size_t>(r) * cout + c] = s;
}

__global__ void __launch_bounds__(samlp_train::kWarps * 32)
    dh_kernel(const __nv_bfloat16* __restrict__ da, int m, int cout_p,
              const __nv_bfloat16* __restrict__ w, int cin, int cin_p,
              const __nv_bfloat16* __restrict__ a_prev,
              const float* __restrict__ vec_prev, int tm,
              __nv_bfloat16* __restrict__ dy_prev, float* __restrict__ dg,
              float* __restrict__ s_part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);
  float* colsum = scratch + samlp_train::kWarps * 256;
  const bool gate = vec_prev != nullptr;
  const int row_blocks = tm / samlp_train::kUnitRows;
  if (gate)
    for (int e = threadIdx.x; e < row_blocks * 2 * cin_p; e += blockDim.x)
      colsum[e] = 0.f;
  __syncthreads();
  const int tiles = (m + tm - 1) / tm;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * tm;
    samlp_train::rows_times_matrix<true>(
        da + static_cast<size_t>(row0) * cout_p, cout_p, cout_p, w, cout_p,
        cin_p, row_blocks, scratch, gate ? colsum : nullptr,
        [&](int rl, int col, float acc) {
          const int row = row0 + rl;
          if (row >= m || col >= cin) return make_float2(0.f, 0.f);
          const size_t i = static_cast<size_t>(row) * cin + col;
          if (!gate) {
            dg[i] = acc;
            return make_float2(0.f, 0.f);
          }
          const float ap = bf2f(a_prev[i]);
          const float v =
              affine(ap, vec_prev[col], vec_prev[cin + col]) > 0.f ? acc : 0.f;
          dy_prev[i] = __float2bfloat16_rn(v);
          const float xhat = __fmul_rn(__fsub_rn(ap, vec_prev[2 * cin + col]),
                                       vec_prev[3 * cin + col]);
          return make_float2(v, __fmul_rn(v, xhat));
        });
  }
  if (gate) {
    __syncthreads();
    samlp_train::write_block_sums(colsum, row_blocks, cin_p, s_part);
  }
}

int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  return static_cast<int>(blocks > 132 * 64 ? 132 * 64 : blocks);
}

}  // namespace

// dy, a [M, Cout] bf16; a_prev [M, Cin] bf16, 16-byte aligned (the
// previous pre-activation, or the block input on the first layer); w
// bf16 [cin_p, cout_p] packed (zero-padded to multiples of 16); vec f32
// [4, Cout] (scale, shift, mean, inv_std); s_in f32 [2, Cout]; vec_prev
// f32 [4, Cin] or null on the first layer. Plan (see
// ops/kernels/samlp_train.py::bwd_layer_plan): m_pad = rows rounded up to
// tm (a multiple of 64), slices, the dW product's warp tiles dw_wm x
// dw_wn with dw_wk warps each, chunks of dw_rows rows (32, 64 or 128,
// dividing tm, a multiple of 16 dw_wk), splits x rows_per_split (a
// multiple of dw_rows) covering M once, blocks of the dh product.
// Scratch: da [m_pad, cout_p] bf16, db_part [slices, cout_p], dw_part
// [splits, cin_p, cout_p], s_part [blocks, 2, cin_p].
// -> dw [Cin, Cout], db [Cout] f32; and dy_prev [M, Cin] bf16 with s_prev
// [2, Cin] (vec_prev given), or dg [M, Cin] f32 (first layer), or neither.
PAPC_EXPORT int papc_samlp_bwd_layer(
    const void* dy, const void* a, const void* a_prev, int m, int m_pad,
    int cin, int cout, const void* w, int cin_p, int cout_p, const float* vec,
    const float* s_in, const float* vec_prev, int slices, int dw_wm,
    int dw_wn, int dw_wk, int dw_rows, int splits, int rows_per_split,
    int tm, int blocks, void* da, float* db_part, float* dw_part,
    float* s_part, float* dw, float* db, void* dy_prev, float* dg,
    float* s_prev, void* stream) {
  const DwShape sh{dw_wm, dw_wn, dw_wk, dw_rows, rows_per_split};
  if (m <= 0 || cin <= 0 || cout <= 0 || cin_p % 16 != 0 ||
      cout_p % 16 != 0 || cin_p < cin || cout_p < cout || tm <= 0 ||
      tm % samlp_train::kUnitRows != 0 || m_pad < m || m_pad % tm != 0 ||
      slices <= 0 || blocks <= 0 || dw_wm <= 0 || dw_wn <= 0 || dw_wk <= 0 ||
      dw_wm * dw_wn * dw_wk > kMaxWarps ||
      (dw_rows != 32 && dw_rows != 64 && dw_rows != 128) ||
      tm % dw_rows != 0 || dw_rows % (16 * dw_wk) != 0 || splits <= 0 ||
      rows_per_split <= 0 || rows_per_split % dw_rows != 0 ||
      static_cast<long long>(splits) * rows_per_split < m ||
      static_cast<long long>(splits - 1) * rows_per_split >= m ||
      reinterpret_cast<std::uintptr_t>(a_prev) % 16 != 0 ||
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

  cudaError_t err = papc_launch(
      da_kernel, dim3(grid_for(static_cast<long long>(slices) * cout_p, 256)),
      dim3(256), 0, s, dy_b, a_b, m, m_pad, cout, cout_p, vec, s_in, slices,
      da_b, db_part);
  if (err != cudaSuccess) return err;
  const int tiles_m = (cin + sh.tm() - 1) / sh.tm();
  const int tiles_n = (cout_p + sh.tn() - 1) / sh.tn();
  err = papc_launch(dw_kernel, dim3(tiles_m * tiles_n, splits),
                    dim3(32 * dw_wm * dw_wn * dw_wk), sh.smem(cin), s, ap_b,
                    m, cin, cin_p, vec_prev,
                    static_cast<const __nv_bfloat16*>(da_b), cout_p, sh,
                    tiles_n, dw_part);
  if (err != cudaSuccess) return err;
  err = papc_launch(dw_reduce_kernel, dim3((cout + 31) / 32, cin), dim3(256),
                    0, s, static_cast<const float*>(dw_part), splits, cin_p,
                    cout, cout_p, dw);
  if (err != cudaSuccess) return err;
  err = samlp_train::reduce_partials(db_part, slices, 1, cout, 1, cout_p, db,
                                     s);
  if (err != cudaSuccess) return err;
  if (dy_prev == nullptr && dg == nullptr) return cudaSuccess;
  const bool gate = vec_prev != nullptr;
  const size_t smem =
      samlp_train::kWarps * 256 * sizeof(float) +
      (gate ? static_cast<size_t>(tm / samlp_train::kUnitRows) * 2 * cin_p *
                  sizeof(float)
            : 0);
  err = papc_launch(dh_kernel, dim3(blocks), dim3(samlp_train::kWarps * 32),
                    smem, s, static_cast<const __nv_bfloat16*>(da_b), m,
                    cout_p, w_b, cin, cin_p, ap_b, vec_prev, tm,
                    static_cast<__nv_bfloat16*>(dy_prev), dg, s_part);
  if (err != cudaSuccess || !gate) return err;
  return samlp_train::reduce_partials(s_part, blocks, 2, cin, 2, cin_p,
                                      s_prev, s);
}
