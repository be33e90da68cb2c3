// One training-forward layer pass of a set-abstraction MLP:
//   h = x                                  (first layer: the raw block input)
//   h = max(x * scale + shift, 0)          (later layers: the previous BN + ReLU)
//   a = bf16(h) . bf16(W) + b    -> stored as bf16
//   sums = (sum of a, sum of a^2) per column, over every row, from the f32 a
//
// Replaces: papc_tpu/ops/pallas/samlp.py::linear_stats (_linear_stats_kernel),
// one pass per layer of fused_mlp's stream-mode training forward. Numeric
// contract kept from it: bf16 operands, f32 accumulation, f32 bias and
// affine (__fmul_rn / __fadd_rn, so h equals the plain version's bit for
// bit), statistics of the f32 pre-activation before its bf16 rounding.
//
// What bounds it on the H100: the bytes of x read once and a written once,
// 2 bytes a value. Over one SSG step at B = 32 (M x Cin -> Cout):
//   SA1 524288 x 3 -> 64     70 MB  0.021 ms      (at 3.35 TB/s)
//       524288 x 64 -> 64   134 MB  0.040 ms
//       524288 x 64 -> 128  201 MB  0.060 ms
//   SA2 262144 x 131 -> 128 136 MB  0.041 ms
//       262144 x 128 -> 128 134 MB  0.040 ms
//       262144 x 128 -> 256 201 MB  0.060 ms
//   SA3 4096 x 259/256/512 -> 256/512/1024, 23 MB, 0.007 ms
// 0.268 ms in all; the products (0.02-0.04 ms at the bf16 peak) are not
// the bound.
//
// Design (csrc/samlp_mma.cuh's ldmatrix + mma.sync core; the plan is
// ops/kernels/samlp_train.py::linear_stats_plan):
//  - Persistent blocks of rw x cw product warps (8, 4 or 2) and two store
//    warps. A product warp owns a warp tile of 32 rows x 16 wp columns: a
//    block owns one column tile of TN = 16 wp cw columns and walks row
//    tiles of TM = 32 rw rows, t = g, g + G, ... (G blocks on its column
//    tile), one or two blocks an SM. It loads its slice of the packed W,
//    [cin_p][TN], into shared memory once, with the bias and the previous
//    layer's scale and shift, by cp.async. Where all of W does not fit
//    beside the input ring, or the row tiles alone leave SMs idle (SA3's
//    4096 rows), Cout is split over column tiles, whose blocks walk the
//    same row tiles in step (x's second read comes from L2).
//  - x's rows arrive through a cp.async ring of 2 or 3 row tiles, the next
//    in flight while this one's products run. Rows that start on 16 bytes
//    (Cin % 8 == 0) land in skewed stage rows (an odd number of 16-byte
//    units) and, on a later layer, get the affine + ReLU in place, once
//    per element; other rows (Cin 3, 131, 196, 259, 323, 643) come as one
//    span a tile and are laid out 8 channels at a time into skewed rows of
//    h, the affine + ReLU on the way (lay_out_chunk). Channel padding is
//    0; rows past M are never stored or summed.
//  - Products: mma_slice on the tile's rows and W's slice, f32
//    accumulators in registers over all of Cin.
//  - Epilogue from the registers: the bias added (__fadd_rn), a put as
//    bf16x2 into one of two [TM][TN + 8] buffers in shared memory, which
//    the store warps write out in 16-byte pieces (8 or 4 bytes where
//    Cout's rows are not 16-byte aligned) while the product warps go on
//    with the next tile: named barriers hand each buffer over and back, so
//    the stores of one tile overlap the loads, products and epilogue of
//    the next (as the card measured, the stores were a third of the time
//    when the same warps issued them). The sums: a and a^2 per lane over
//    its rows in order, then over the 8 lanes of a column by a halving
//    butterfly (each step sends half the values, so every lane ends with
//    its share of the column sums), added to the lane's totals tile after
//    tile in row order; at the end the warp rows' totals in order give the
//    block's partial [G][2][cout_p] (rows of a column tile with fewer
//    blocks are zeroed), and split_reduce (samlp_train.cuh) adds the G
//    partials of each column in a fixed order. Two calls give the same
//    bits.
#include <cstdint>

#include "samlp_mma.cuh"
#include "samlp_train.cuh"

namespace {

namespace mma = samlp_mma;

constexpr int kSkew = 8;         // bf16 of padding per shared-memory row
constexpr int kMaxWarps = 8;     // product warps of a block
constexpr int kStoreWarps = 2;   // warps that write a out
constexpr int kMaxThreads = 32 * (kMaxWarps + kStoreWarps);
// named barriers: the product warps' own, then a's two buffers, full and
// empty (0 is __syncthreads)
constexpr int kBarMma = 1, kBarFull = 2, kBarEmpty = 4;

// The plan: rw row warps of 32 rows by cw column warps of 16 wp columns,
// a ring of `stages` row tiles.
struct LsShape {
  int rw, cw, wp, stages;
  __host__ __device__ int warps() const { return rw * cw; }
  __host__ __device__ int threads() const { return 32 * (warps() + kStoreWarps); }
  __host__ __device__ int tm() const { return mma::kWarpRows * rw; }
  __host__ __device__ int tn() const { return cw * 16 * wp; }
  __host__ __device__ int ld_w() const { return tn() + kSkew; }
  __host__ __device__ static bool aligned(int cin) { return cin % 8 == 0; }
  __host__ __device__ static int ld_h(int cin_p) { return cin_p + kSkew; }
  // a ring stage: the tile's rows where they land (aligned), else one
  // span of tm rows and 8 elements to spare (load8 reads past the span)
  __host__ __device__ int stage_elems(int cin, int cin_p) const {
    return aligned(cin) ? tm() * ld_h(cin_p) : (tm() * cin + 7) / 8 * 8 + 8;
  }
  // h [tm][cin_p + 8] laid out from the span (unaligned rows only)
  __host__ __device__ int h_elems(int cin, int cin_p) const {
    return aligned(cin) ? 0 : tm() * ld_h(cin_p);
  }
  // a's two buffers [tm][tn + 8]; at the end, the warps' column sums
  __host__ __device__ int out_elems() const { return tm() * ld_w(); }
  // W's slice, the ring, h and a's buffers (bf16), then the bias [tn] and
  // the scale and shift [cin_p] (f32)
  size_t smem(int cin, int cin_p) const {
    return 2 * (static_cast<size_t>(cin_p) * ld_w() +
                static_cast<size_t>(stages) * stage_elems(cin, cin_p) +
                h_elems(cin, cin_p) + 2 * static_cast<size_t>(out_elems())) +
           4 * (static_cast<size_t>(tn()) + 2 * cin_p);
  }
};

// Named barriers (the non-aligned forms: the two roles reach them from
// different code).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(threads)
               : "memory");
}

// The scale and shift of 8 consecutive channels (16-byte aligned).
struct Affine8 {
  float s[8], t[8];
  __device__ __forceinline__ Affine8(const float* scale, const float* shift) {
    const float4* sc = reinterpret_cast<const float4*>(scale);
    const float4* sh = reinterpret_cast<const float4*>(shift);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float4 a = sc[k], b = sh[k];
      s[4 * k] = a.x, s[4 * k + 1] = a.y, s[4 * k + 2] = a.z;
      s[4 * k + 3] = a.w;
      t[4 * k] = b.x, t[4 * k + 1] = b.y, t[4 * k + 2] = b.z;
      t[4 * k + 3] = b.w;
    }
  }
  // max(x * scale + shift, 0) rounded to bf16 on the 8 channels of v
  // (__fmul_rn / __fadd_rn, as samlp_train::relu_affine)
  __device__ __forceinline__ void apply(uint4& v) const {
    unsigned* words = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&words[k]));
      const float lo = samlp_train::affine(f.x, s[2 * k], t[2 * k]);
      const float hi = samlp_train::affine(f.y, s[2 * k + 1], t[2 * k + 1]);
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(lo > 0.f ? lo : 0.f, hi > 0.f ? hi : 0.f);
      words[k] = *reinterpret_cast<const unsigned*>(&h);
    }
  }
};

// rows x cols bf16 of a's buffer (row stride lds) to dst (row stride ld),
// v elements a store (v divides cols, ld and dst's offset), spread over
// the store warps' threads tid of kStoreWarps * 32: thread t takes piece
// t % per of rows t / per, + n / per, ... where the per pieces of a row
// divide their count n, else pieces t, t + n, ....
__device__ __forceinline__ void store_rows(const __nv_bfloat16* st, int lds,
                                           __nv_bfloat16* dst, int ld,
                                           int rows, int cols, int v,
                                           int tid) {
  constexpr int n = kStoreWarps * 32;
  const int per = cols / v;
  auto put = [&](int r, int q) {
    const __nv_bfloat16* s = st + r * lds + q;
    __nv_bfloat16* d = dst + static_cast<size_t>(r) * ld + q;
    if (v == 8)
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    else if (v == 4)
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
    else if (v == 2)
      *reinterpret_cast<unsigned*>(d) = *reinterpret_cast<const unsigned*>(s);
    else
      *d = *s;
  };
  if (n % per == 0) {
    const int q = (tid % per) * v, step = n / per;
    for (int r = tid / per; r < rows; r += step) put(r, q);
  } else {
    for (int e = tid; e < rows * per; e += n) {
      const int r = e / per;
      put(r, (e - r * per) * v);
    }
  }
}

// Block b: column tile b % col_tiles, group g = b / col_tiles of the
// blocks on it, row tiles g, g + groups, .... The first rw * cw warps
// load x, run the products and the sums and put a into one of two
// buffers in shared memory; the last kStoreWarps write each buffer out
// while the others fill the next. WP: n16 pairs of a full warp tile (the
// last column warp may have fewer).
template <int WP>
__global__ void __launch_bounds__(kMaxThreads, 1)
    linear_stats_kernel(const __nv_bfloat16* __restrict__ x, int m, int cin,
                        int cin_p, const float* __restrict__ vec,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, int cout, int cout_p,
                        LsShape sh, int col_tiles,
                        __nv_bfloat16* __restrict__ a_out,
                        float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kWcols = 16 * WP;
  const int tm = sh.tm(), tn = sh.tn();
  const bool aligned = LsShape::aligned(cin);
  const int ld_w = sh.ld_w(), ld_h = LsShape::ld_h(cin_p);
  const int stage_elems = sh.stage_elems(cin, cin_p);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = w_s + cin_p * ld_w;
  __nv_bfloat16* hbuf = ring + sh.stages * stage_elems;
  __nv_bfloat16* outbuf = hbuf + sh.h_elems(cin, cin_p);
  float* bias_s = reinterpret_cast<float*>(outbuf + 2 * sh.out_elems());
  float* scale_s = bias_s + tn;
  float* shift_s = scale_s + cin_p;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nmma = 32 * sh.warps();   // the product warps' threads
  const int nall = sh.threads();
  const int ct = blockIdx.x % col_tiles, g = blockIdx.x / col_tiles;
  const int groups = (gridDim.x - ct + col_tiles - 1) / col_tiles;
  const int n0 = ct * tn;                          // the tile's first column
  const int tn_here = min(tn, cout_p - n0);        // its columns (16-multiple)
  const int row_tiles = (m + tm - 1) / tm;
  const int tiles = (row_tiles - g + groups - 1) / groups;  // the block's

  if (warp >= sh.warps()) {
    // The store warps: buffer i % 2 holds row tile i's a once the product
    // warps arrive on its `full` barrier; its rows (below M) and columns
    // (below Cout) leave, then the buffer is handed back.
    const int cols = min(tn, cout - n0);
    const int v =
        cout % 8 == 0 ? 8 : cout % 4 == 0 ? 4 : cout % 2 == 0 ? 2 : 1;
    for (int i = 0; i < tiles; ++i) {
      const int b = i & 1, r0 = (g + i * groups) * tm;
      bar_sync(kBarFull + b, nall);
      store_rows(outbuf + b * sh.out_elems(), ld_w,
                 a_out + static_cast<size_t>(r0) * cout + n0, cout,
                 min(tm, m - r0), cols, v, tid - nmma);
      if (i + 2 < tiles) bar_arrive(kBarEmpty + b, nall);
    }
  } else {
    const int wr = warp / sh.cw, wc = warp % sh.cw;
    const int wcol0 = wc * kWcols;                 // the warp's, in the tile
    const int pairs = max(0, min(kWcols, tn_here - wcol0)) / 16;

    // Aligned rows are read where they land: the stages start zeroed, so
    // the channel padding is 0 (rows past M are never stored or summed).
    if (aligned) {
      for (int e = tid; e < sh.stages * stage_elems / 8; e += nmma)
        reinterpret_cast<uint4*>(ring)[e] = make_uint4(0u, 0u, 0u, 0u);
      bar_sync(kBarMma, nmma);
    }

    // the block's i-th row tile into stage i % stages
    auto issue = [&](int i) {
      __nv_bfloat16* dst = ring + (i % sh.stages) * stage_elems;
      const int r0 = (g + i * groups) * tm;
      const int here = min(tm, m - r0);
      if (aligned) {
        const int segs = cin / 8;
        for (int e = tid; e < here * segs; e += nmma) {
          const int r = e / segs, q = e - r * segs;
          mma::cp_async16(dst + r * ld_h + q * 8,
                          x + static_cast<size_t>(r0 + r) * cin + q * 8);
        }
      } else {  // one span, 16-byte aligned at its start (tm * cin * 2
                // bytes a tile, tm a multiple of 32)
        const __nv_bfloat16* src = x + static_cast<size_t>(r0) * cin;
        const int bytes = here * cin * 2;
        for (int q = tid; q * 16 < bytes; q += nmma)
          mma::cp_async16_zfill(dst + q * 8, src + q * 8,
                                min(16, bytes - q * 16));
      }
    };

    // The first group: W's slice, the bias, the affine and row tile 0.
    const int segs_w = tn_here / 8;
    for (int e = tid; e < cin_p * segs_w; e += nmma) {
      const int r = e / segs_w, q = e - r * segs_w;
      mma::cp_async16(w_s + r * ld_w + q * 8,
                      w + static_cast<size_t>(r) * cout_p + n0 + q * 8);
    }
    for (int c = tid; c < tn; c += nmma) {
      const bool in = n0 + c < cout;
      mma::cp_async4(bias_s + c, bias + (in ? n0 + c : 0), in);
    }
    if (vec != nullptr)
      for (int c = tid; c < cin_p; c += nmma) {
        const bool in = c < cin;
        mma::cp_async4(scale_s + c, vec + (in ? c : 0), in);
        mma::cp_async4(shift_s + c, vec + (in ? cin + c : 0), in);
      }
    for (int i = 0; i < sh.stages - 1; ++i) {
      if (i < tiles) issue(i);
      mma::cp_async_commit();
    }

    // the previous layer's BN + ReLU on a chunk of 8 channels from c
    auto fix = [&](uint4& u, int c) {
      Affine8(scale_s + c, shift_s + c).apply(u);
    };
    // an aligned tile's rows, in place: where the threads divide into
    // whole rows of 8-channel chunks, each keeps its chunk's affine
    const int segs = cin / 8;
    const bool fixed_chunk = aligned && nmma % segs == 0;
    float tot[WP];  // this lane's share of the warp's column sums
#pragma unroll
    for (int q = 0; q < WP; ++q) tot[q] = 0.f;
    mma::WarpTile acc;
    for (int i = 0; i < tiles; ++i) {
      if (sh.stages == 3)  // tile i landed: stages - 2 still in flight
        mma::cp_async_wait<1>();
      else
        mma::cp_async_wait<0>();
      bar_sync(kBarMma, nmma);  // tile i landed; tile i - 1 is done with
      if (i + sh.stages - 1 < tiles) issue(i + sh.stages - 1);
      mma::cp_async_commit();
      __nv_bfloat16* stage = ring + (i % sh.stages) * stage_elems;
      const int r0 = (g + i * groups) * tm;
      const int here = min(tm, m - r0);
      const __nv_bfloat16* h = stage;
      if (!aligned) {
        if (vec != nullptr)
          mma::lay_out_chunk(stage, cin, 0, hbuf, ld_h, tm, cin_p, here, cin,
                             tid, nmma, fix);
        else
          mma::lay_out_chunk(stage, cin, 0, hbuf, ld_h, tm, cin_p, here, cin,
                             tid, nmma);
        h = hbuf;
        bar_sync(kBarMma, nmma);
      } else if (vec != nullptr) {
        if (fixed_chunk) {
          const int c = (tid % segs) * 8;
          const Affine8 f(scale_s + c, shift_s + c);
          for (int r = tid / segs; r < here; r += nmma / segs) {
            uint4* q = reinterpret_cast<uint4*>(stage + r * ld_h + c);
            uint4 u = *q;
            f.apply(u);
            *q = u;
          }
        } else {
          for (int e = tid; e < here * segs; e += nmma) {
            const int r = e / segs, c = (e - r * segs) * 8;
            uint4* q = reinterpret_cast<uint4*>(stage + r * ld_h + c);
            uint4 u = *q;
            fix(u, c);
            *q = u;
          }
        }
        bar_sync(kBarMma, nmma);
      }
      if (pairs > 0) {
        mma::zero(acc);
        const __nv_bfloat16* hw = h + wr * mma::kWarpRows * ld_h;
        for (int k = 0; k < cin_p; k += 32)
          mma::mma_slice<false, WP>(acc, hw + k, ld_h,
                                    w_s + k * ld_w + wcol0, ld_w,
                                    min(2, (cin_p - k) / 16), pairs);
      }

      // Epilogue: a = acc + bias into buffer i % 2 once the store warps
      // are done with it (tile i - 2); the sums of this lane's rows (below
      // M) in row order, as u = 4 j + 2 e + s for column 8 j + 2 (lane %
      // 4) + e of the warp tile and sum s (a, a^2).
      const int b = i & 1;
      if (i >= 2) bar_sync(kBarEmpty + b, nall);
      if (pairs > 0) {
        __nv_bfloat16* ob = outbuf + b * sh.out_elems() +
                            wr * mma::kWarpRows * ld_w + wcol0;
        const int row_w = r0 + wr * mma::kWarpRows;  // the warp's first row
        float s[8 * WP];
#pragma unroll
        for (int u = 0; u < 8 * WP; ++u) s[u] = 0.f;
#pragma unroll
        for (int j = 0; j < 2 * WP; ++j) {
          if (j >= 2 * pairs) continue;
          const int c = mma::lane_col(j);
          const float2 bb = *reinterpret_cast<const float2*>(bias_s + wcol0 + c);
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int r = mma::lane_row(i2, h2);
              const float a0 = __fadd_rn(acc.acc[i2][j][2 * h2], bb.x);
              const float a1 = __fadd_rn(acc.acc[i2][j][2 * h2 + 1], bb.y);
              if (row_w + r < m) {
                s[4 * j] += a0;
                s[4 * j + 1] = __fmaf_rn(a0, a0, s[4 * j + 1]);
                s[4 * j + 2] += a1;
                s[4 * j + 3] = __fmaf_rn(a1, a1, s[4 * j + 3]);
              }
              *reinterpret_cast<__nv_bfloat162*>(ob + r * ld_w + c) =
                  __floats2bfloat162_rn(a0, a1);
            }
        }
        // Over the 8 lanes of a column (xor 4, 8, 16): each step sends
        // half of the values; the lane ends with u = base + q, q < WP.
#pragma unroll
        for (int st = 0; st < 3; ++st) {
          const int half = (4 * WP) >> st;
          const bool hi = (lane >> (2 + st)) & 1;
#pragma unroll
          for (int u = 0; u < 4 * WP; ++u) {
            if (u >= half) break;
            const float send = hi ? s[u] : s[half + u];
            const float mine = hi ? s[half + u] : s[u];
            s[u] = mine + __shfl_xor_sync(0xffffffffu, send, 4 << st);
          }
        }
#pragma unroll
        for (int q = 0; q < WP; ++q) tot[q] += s[q];
      }
      bar_arrive(kBarFull + b, nall);
    }
    mma::cp_async_wait<0>();
    // each warp's column sums, [warp][2][16 WP], where a's first buffer
    // was (once the store warps are done with it)
    bar_sync(0, nall);
    float* colsum = reinterpret_cast<float*>(outbuf);
    const int base = WP * (4 * ((lane >> 2) & 1) + 2 * ((lane >> 3) & 1) +
                           (lane >> 4));
#pragma unroll
    for (int q = 0; q < WP; ++q) {
      const int u = base + q;  // column 8 j + 2 (lane % 4) + e, sum s
      colsum[(warp * 2 + (u & 1)) * kWcols + 8 * (u >> 2) + 2 * (lane & 3) +
             ((u >> 1) & 1)] = tot[q];
    }
  }
  if (warp >= sh.warps()) bar_sync(0, nall);  // the product warps' above
  bar_sync(0, nall);
  // the block's partial: the warp rows' sums of each column in order; the
  // first block of the column tile zeroes the rows no block of it fills
  const float* colsum = reinterpret_cast<const float*>(outbuf);
  const int rows_all = (gridDim.x + col_tiles - 1) / col_tiles;
  for (int e = tid; e < 2 * tn_here; e += nall) {
    const int k = e / tn_here, c = e - k * tn_here;
    const int wcc = c / kWcols, cc = c - wcc * kWcols;
    float t = colsum[(wcc * 2 + k) * kWcols + cc];
    for (int r = 1; r < sh.rw; ++r)
      t += colsum[((r * sh.cw + wcc) * 2 + k) * kWcols + cc];
    partials[(static_cast<size_t>(g) * 2 + k) * cout_p + n0 + c] = t;
    if (g == 0)
      for (int gg = groups; gg < rows_all; ++gg)
        partials[(static_cast<size_t>(gg) * 2 + k) * cout_p + n0 + c] = 0.f;
  }
}

template <int WP>
cudaError_t launch(const __nv_bfloat16* x, int m, int cin, int cin_p,
                   const float* vec, const __nv_bfloat16* w,
                   const float* bias, int cout, int cout_p, LsShape sh,
                   int col_tiles, int blocks, __nv_bfloat16* a,
                   float* partials, cudaStream_t s) {
  return papc_launch(linear_stats_kernel<WP>, dim3(blocks), dim3(sh.threads()),
                     sh.smem(cin, cin_p), s, x, m, cin, cin_p, vec, w, bias,
                     cout, cout_p, sh, col_tiles, a, partials);
}

}  // namespace

// x [M, Cin] bf16, 16-byte aligned; vec: null (first layer) or f32 rows
// (scale, shift, ...) of width Cin, of which rows 0 and 1 are read; w bf16
// [cin_p, cout_p] packed (zero-padded to multiples of 16); bias f32
// [Cout]. Plan (ops/kernels/samlp_train.py::linear_stats_plan): rw x cw
// product warps (2, 4 or 8) on warp tiles of 32 x 16 wp, a ring of
// `stages` (2 or 3) row tiles, `blocks` (at least the column tiles, at
// most the units) persistent blocks, which fixes the order of the sums.
// -> a [M, Cout] bf16 (16-byte aligned), partials [ceil(blocks /
//    col_tiles), 2, cout_p] f32 (scratch), sums [2, Cout] f32.
PAPC_EXPORT int papc_samlp_linear_stats(const void* x, int m, int cin,
                                        const float* vec, const void* w,
                                        const float* bias, int cout,
                                        int cin_p, int cout_p, int rw, int cw,
                                        int wp, int stages, int blocks,
                                        void* a, float* partials, float* sums,
                                        void* stream) {
  const LsShape sh{rw, cw, wp, stages};
  if (m <= 0 || cin <= 0 || cout <= 0 || cin_p % 16 != 0 ||
      cout_p % 16 != 0 || cin_p < cin || cin_p >= cin + 16 || cout_p < cout ||
      rw <= 0 || cw <= 0 ||
      (sh.warps() != 2 && sh.warps() != 4 && sh.warps() != 8) ||
      (wp != 1 && wp != 2 && wp != 4) || (stages != 2 && stages != 3))
    return cudaErrorInvalidValue;
  const int col_tiles = (cout_p + sh.tn() - 1) / sh.tn();
  const long long units =
      static_cast<long long>(col_tiles) * ((m + sh.tm() - 1) / sh.tm());
  if (blocks < col_tiles || blocks > units || sh.smem(cin, cin_p) > 232448 ||
      reinterpret_cast<std::uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(a) % 16 != 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x_b = static_cast<const __nv_bfloat16*>(x);
  const auto* w_b = static_cast<const __nv_bfloat16*>(w);
  auto* a_b = static_cast<__nv_bfloat16*>(a);
  cudaError_t err;
  if (wp == 4)
    err = launch<4>(x_b, m, cin, cin_p, vec, w_b, bias, cout, cout_p, sh,
                    col_tiles, blocks, a_b, partials, s);
  else if (wp == 2)
    err = launch<2>(x_b, m, cin, cin_p, vec, w_b, bias, cout, cout_p, sh,
                    col_tiles, blocks, a_b, partials, s);
  else
    err = launch<1>(x_b, m, cin, cin_p, vec, w_b, bias, cout, cout_p, sh,
                    col_tiles, blocks, a_b, partials, s);
  if (err != cudaSuccess) return err;
  const samlp_train::SplitSum none{nullptr, 0, 0, 0, 0, 0, nullptr};
  return samlp_train::split_reduce(
      {partials, (blocks + col_tiles - 1) / col_tiles, 2, cout_p, 2, cout,
       sums},
      none, 32, s);
}
