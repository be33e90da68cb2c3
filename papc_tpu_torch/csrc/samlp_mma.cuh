// Tensor-core product core for the set-abstraction kernels on Hopper SMs:
// bf16 operands in shared memory, f32 accumulators held in registers.
//
// Pieces, all with fixed, documented PTX register layouts:
//  - cp.async.cg 16-byte copies, grouped and awaited (a ring of weight
//    tiles: load_tile_async fills one stage while the warps run the MMAs of
//    another; RingCursor and issue_slice walk the slices of a sequence of
//    products), 8-byte cp.async.ca copies, and 4-byte ones that zero-fill;
//  - ldmatrix.x4 for A fragments from a row-major bf16 buffer [m][k]
//    (mma_slice), ldmatrix.x4.trans for A fragments from a row-major
//    [k][m] buffer, i.e. the transpose of the buffer is the A operand
//    (mma_slice_at: dW = h^T . da with h staged as rows x channels), and
//    ldmatrix.x4.trans for B fragments from a row-major [k, n] tile (the
//    weights W [Cin, Cout] as stored, or da [rows, Cout]: no transposed
//    copy), and ldmatrix.x4 (no .trans) for B fragments from a row-major
//    [n, k] tile, i.e. B given transposed (mma_slice<true>: da . W^T with
//    W [Cin, Cout] as stored, Cin the n and Cout the k dimension);
//  - mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32;
//  - rows that do not start on 16 bytes (a layer input of odd width):
//    a tile's rows are copied as one 16-byte-aligned span and laid out
//    into skewed rows 8 channels at a time (load8, lay_out_chunk), an
//    elementwise function of the channels applied on the way.
//
// A warp tile is 32 rows x up to 64 columns: two m16 row tiles by up to
// eight n8 column tiles, taken in n16 pairs (one ldmatrix.x4.trans feeds
// two n8 tiles). Per k16 step a warp issues 2 A loads and up to 4 B loads
// for up to 16 MMAs: each A fragment feeds up to 8 MMAs, each B fragment 2.
//
// Accumulator layout (mma m16n8 C fragment): acc[i][j][2h + e] is row
// 16 i + 8 h + lane / 4 and column 8 j + 2 (lane % 4) + e of the warp tile.
// for_each_pair hands (row, column, the column pair's constants, the two
// values of columns col and col + 1) to an epilogue callable, which may
// change them in place; the constants (a bias, a scale) are fetched once
// per column pair by a second callable. for_each_pair_loop does the same
// in a loop over the n8 tiles (the epilogue compiled 4 times, not 32), and
// for_each_pair_sums also adds two column sums of what the epilogue
// returns over the warp tile's 32 rows in a fixed order. A caller that
// reduces over rows in another way (a max) reads the registers in that
// layout (see lane_row / lane_col).
//
// Shared-memory rows handed to ldmatrix must start on 16 bytes: row
// strides are multiples of 8 bf16. A stride of an odd number of 16-byte
// units (a width padded to 16 plus a skew of 8) puts the 8 rows of one
// 8x8 matrix in 8 different bank groups.
#pragma once

#include <cuda_bf16.h>

namespace samlp_mma {

constexpr int kWarpRows = 32;
constexpr int kWarpCols = 64;
constexpr int kPairs = kWarpCols / 16;  // n16 pairs of a warp tile

struct WarpTile {
  float acc[2][2 * kPairs][4];
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes from src into dst in shared memory, or 4 zero bytes when
// !valid (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 8 bytes from src (8-byte aligned) into dst in shared memory.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes into dst in shared memory, of which the first `bytes` (0-16)
// come from src and the rest are zero: a span whose end is not a
// multiple of 16 bytes is copied without reading past it. src is 16-byte
// aligned.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows x cols bf16 (cols a multiple of 8) of a row-major matrix with
// row stride ld into a ring stage with row stride lds, 16 bytes a
// cp.async, spread over the block's threads. Source rows must start on 16
// bytes (ld and the column offset multiples of 8).
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* stage, int lds,
                                                const __nv_bfloat16* src,
                                                int ld, int rows, int cols) {
  const int segs = cols >> 3;
  for (int e = threadIdx.x; e < rows * segs; e += blockDim.x) {
    const int r = e / segs, q = e - r * segs;
    cp_async16(stage + r * lds + q * 8,
               src + static_cast<size_t>(r) * ld + q * 8);
  }
}

// Position in a weight ring's flat sequence of slices: product q, column
// chunk c, k slice s (slices innermost). advance() steps over a product
// kdim deep and ndim wide, in slices of ks rows and chunks of chunk
// columns, and returns true when it moves on to product q + 1.
struct RingCursor {
  int q = 0, c = 0, s = 0;
  __device__ bool advance(int kdim, int ndim, int ks, int chunk) {
    if (++s * ks < kdim) return false;
    s = 0;
    if (++c * chunk < ndim) return false;
    c = 0;
    ++q;
    return true;
  }
};

// The cursor's slice of a product's B operand into a ring stage of row
// stride lds: B [kdim, ndim] row-major (row stride ldb) as [ks][chunk]
// rows, or, kTrans, B given transposed as [ndim, kdim] row-major (W's rows
// for da . W^T) as [chunk][ks] rows. The last slice and chunk are cut.
template <bool kTrans>
__device__ __forceinline__ void issue_slice(__nv_bfloat16* stage, int lds,
                                            const __nv_bfloat16* b, int ldb,
                                            int kdim, int ndim, int ks,
                                            int chunk, const RingCursor& at) {
  const int rows = min(ks, kdim - at.s * ks);
  const int cols = min(chunk, ndim - at.c * chunk);
  if (!kTrans)
    load_tile_async(stage, lds,
                    b + static_cast<size_t>(at.s) * ks * ldb + at.c * chunk,
                    ldb, rows, cols);
  else
    load_tile_async(stage, lds,
                    b + static_cast<size_t>(at.c) * chunk * ldb + at.s * ks,
                    ldb, cols, rows);
}

__device__ __forceinline__ void zero(WarpTile& t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2 * kPairs; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) t.acc[i][j][v] = 0.f;
}

// One k16 step: t += A (fragments af[0], af[1] of rows 0-15 and 16-31)
// times the first `pairs` n16 pairs of B, whose lane address at the
// step's first k is b_addr: ldmatrix.x4.trans from [k][n] rows, the next
// pair 16 columns (32 bytes) on; or, kBT, ldmatrix.x4 from [n][k] rows,
// the next pair pair_bytes (16 rows) on. pairs <= kMaxPairs: a caller
// whose warp tiles are narrower names their width, and the accumulators
// past it are never touched (nor kept in registers).
template <bool kBT = false, int kMaxPairs = kPairs>
__device__ __forceinline__ void mma_kstep(WarpTile& t,
                                          const unsigned (&af)[2][4],
                                          unsigned b_addr, int pairs,
                                          int pair_bytes = 32) {
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    if (p < pairs) {
      unsigned bf[4];
      if (kBT)
        ldmatrix_x4(bf, b_addr + p * pair_bytes);
      else
        ldmatrix_x4_trans(bf, b_addr + p * 32);
      mma_16816(t.acc[0][2 * p], af[0], bf[0], bf[1]);
      mma_16816(t.acc[0][2 * p + 1], af[0], bf[2], bf[3]);
      mma_16816(t.acc[1][2 * p], af[1], bf[0], bf[1]);
      mma_16816(t.acc[1][2 * p + 1], af[1], bf[2], bf[3]);
    }
  }
}

// ldmatrix.x4.trans lane address of B: lanes 0-15 give k rows 0-15 at n
// 0, lanes 16-31 at n 8 (b0b1, b2b3 of n8 tile 0, then of n8 tile 1).
__device__ __forceinline__ unsigned b_lane_addr(const __nv_bfloat16* b,
                                                int ldb) {
  const int lane = threadIdx.x & 31;
  return smem_u32(b + (lane & 15) * ldb + (lane >> 4) * 8);
}

// ldmatrix.x4 (no .trans) lane address of B given transposed, as [n][k]
// rows (row stride ldb elements): each 8x8 matrix is 8 n rows of 8 k
// values, handed out as the col-major B fragment wants them. Lanes 0-7
// give n rows 0-7 at k 0 (b0b1 of n8 tile 0), lanes 8-15 n 0-7 at k 8
// (its b2b3), lanes 16-23 n 8-15 at k 0 and lanes 24-31 n 8-15 at k 8
// (n8 tile 1): the same four registers as b_lane_addr's.
__device__ __forceinline__ unsigned bt_lane_addr(const __nv_bfloat16* b,
                                                 int ldb) {
  const int lane = threadIdx.x & 31;
  return smem_u32(b + ((lane & 7) + ((lane >> 4) << 3)) * ldb +
                  ((lane >> 3) & 1) * 8);
}

// t += A[32 rows, ksteps * 16] * B[ksteps * 16, 16 * pairs]. a: the warp's
// first A row at its first k column (row stride lda elements); b: the
// first B row of the slice at the warp's first column (row stride ldb),
// or, kBT (B stored as [n][k]), the warp's first n row at the slice's
// first k. ksteps <= 2 and pairs <= kMaxPairs are warp-uniform.
template <bool kBT = false, int kMaxPairs = kPairs>
__device__ __forceinline__ void mma_slice(WarpTile& t,
                                          const __nv_bfloat16* a, int lda,
                                          const __nv_bfloat16* b, int ldb,
                                          int ksteps, int pairs) {
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4: lanes 0-15 give rows 0-15 at k 0, lanes 16-31 at k 8
  // (matrices a0a1, a2a3, a4a5, a6a7 of the m16k16 A fragment).
  const unsigned a_addr = smem_u32(a + (lane & 15) * lda + (lane >> 4) * 8);
  const unsigned b_addr = kBT ? bt_lane_addr(b, ldb) : b_lane_addr(b, ldb);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (kk < ksteps) {
      unsigned af[2][4];
      ldmatrix_x4(af[0], a_addr + kk * 32);
      ldmatrix_x4(af[1], a_addr + (16 * lda + kk * 16) * 2);
      if (kBT)
        mma_kstep<true, kMaxPairs>(t, af, b_addr + kk * 32, pairs,
                                   16 * ldb * 2);
      else
        mma_kstep<false, kMaxPairs>(t, af, b_addr + kk * 16 * ldb * 2,
                                    pairs);
    }
  }
}

// No change to the A fragments (mma_slice_at's default).
struct KeepA {
  __device__ __forceinline__ void operator()(unsigned (&)[2][4]) const {}
};

// The same product with A stored transposed: A[i][k] = a[k * lda + i], a
// row-major [k][m] buffer (rows of the layer input, channels along the
// row) whose transpose is the warp's 32 x (ksteps * 16) A operand. a: the
// first k row at the warp's first m column. ksteps <= 2 and pairs <=
// kPairs are warp-uniform. fix(af) runs on the two A fragments after
// each load, before the products (an elementwise function of A, such as
// a per-channel affine): register r of af[i] holds two k values of the
// one m row 16 i + 8 (r & 1) + lane / 4.
template <typename FixA = KeepA>
__device__ __forceinline__ void mma_slice_at(WarpTile& t,
                                             const __nv_bfloat16* a, int lda,
                                             const __nv_bfloat16* b, int ldb,
                                             int ksteps, int pairs,
                                             FixA fix = FixA()) {
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4.trans, each 8x8 matrix read as 8 k rows of 8 m values and
  // handed out transposed: lanes 0-7 give k rows 0-7 at m 0 (a0a1), lanes
  // 8-15 k rows 0-7 at m 8 (a2a3), lanes 16-23 k rows 8-15 at m 0 (a4a5),
  // lanes 24-31 k rows 8-15 at m 8 (a6a7); the second m16 tile is 16
  // columns on.
  const unsigned a_addr = smem_u32(
      a + ((lane & 7) + ((lane >> 4) << 3)) * lda + ((lane >> 3) & 1) * 8);
  const unsigned b_addr = b_lane_addr(b, ldb);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (kk < ksteps) {
      unsigned af[2][4];
      ldmatrix_x4_trans(af[0], a_addr + kk * 16 * lda * 2);
      ldmatrix_x4_trans(af[1], a_addr + (kk * 16 * lda + 16) * 2);
      fix(af);
      mma_kstep(t, af, b_addr + kk * 16 * ldb * 2, pairs);
    }
  }
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

// No change to a laid-out chunk (lay_out_chunk's default).
struct KeepChunk {
  __device__ __forceinline__ void operator()(uint4&, int) const {}
};

// One staged span of a layer input (row r, channel c at span[r * cin + c],
// rows not 16-byte aligned; the buffer holds 8 elements past the span)
// copied into rows [rows][ld_h] for the tile's tm channels from c0, 8 a
// thread step, 0 in rows from `here` on and channels from `win` on.
// Spread over threads tid of nthreads; fix(v, c) runs on each loaded
// chunk (its channels c0 + c, ..., + 7) before the channels from win on
// are zeroed.
template <typename FixChunk = KeepChunk>
__device__ __forceinline__ void lay_out_chunk(const __nv_bfloat16* span,
                                              int cin, int c0,
                                              __nv_bfloat16* hbuf, int ld_h,
                                              int rows, int tm, int here,
                                              int win, int tid, int nthreads,
                                              FixChunk fix = FixChunk()) {
  const int per_row = tm / 8;
  for (int e = tid; e < rows * per_row; e += nthreads) {
    const int r = e / per_row, c = (e - r * per_row) * 8;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < here && c < win) {
      out = load8(span, r * cin + c0 + c);
      fix(out, c);
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

// Row of acc[i][j][2h + e] in the warp tile (independent of j and e).
__device__ __forceinline__ int lane_row(int i, int h) {
  return 16 * i + 8 * h + ((threadIdx.x & 31) >> 2);
}

// Column of acc[i][j][2h] in the warp tile (independent of i and h);
// acc[i][j][2h + 1] is the next column.
__device__ __forceinline__ int lane_col(int j) {
  return 8 * j + 2 * (threadIdx.x & 3);
}

// For each column pair (col, col + 1) of this lane in the first `pairs`
// n16 pairs: c = at_col(col) once, then epi(row, col, c, v0, v1) for the
// pair's four rows, v0 and v1 by reference.
template <typename AtCol, typename Epilogue>
__device__ __forceinline__ void for_each_pair(WarpTile& t, int pairs,
                                              AtCol at_col, Epilogue epi) {
#pragma unroll
  for (int j = 0; j < 2 * kPairs; ++j) {
    if (j < 2 * pairs) {
      const auto c = at_col(lane_col(j));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          epi(lane_row(i, h), lane_col(j), c, t.acc[i][j][2 * h],
              t.acc[i][j][2 * h + 1]);
    }
  }
}

template <int J>
__device__ __forceinline__ void pick_tile_at(const WarpTile& t,
                                             float (&w)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) w[i][v] = t.acc[i][J][v];
}

// The registers of n8 tile j (0-7, any value) of a warp tile: w[i][v] =
// t.acc[i][j][v]. A switch keeps the accumulators in registers where j
// is not a compile-time constant.
__device__ __forceinline__ void pick_tile(const WarpTile& t, int j,
                                          float (&w)[2][4]) {
  switch (j) {
    case 0: pick_tile_at<0>(t, w); break;
    case 1: pick_tile_at<1>(t, w); break;
    case 2: pick_tile_at<2>(t, w); break;
    case 3: pick_tile_at<3>(t, w); break;
    case 4: pick_tile_at<4>(t, w); break;
    case 5: pick_tile_at<5>(t, w); break;
    case 6: pick_tile_at<6>(t, w); break;
    default: pick_tile_at<7>(t, w); break;
  }
}

// for_each_pair as a loop over the n8 tiles, unrolled by two: the
// epilogue is compiled 8 times instead of 32 (a kernel with several large
// epilogues stays small), and two tiles' loads and arithmetic still
// overlap (measured 7 % faster on #13 than one tile a turn). epi gets the
// values by value and cannot change the accumulators.
template <typename AtCol, typename Epilogue>
__device__ __forceinline__ void for_each_pair_loop(const WarpTile& t,
                                                   int pairs, AtCol at_col,
                                                   Epilogue epi) {
#pragma unroll 2
  for (int j = 0; j < 2 * kPairs; ++j) {
    if (j >= 2 * pairs) break;
    float w[2][4];
    pick_tile(t, j, w);
    const auto c = at_col(lane_col(j));
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(lane_row(i, h), lane_col(j), c, w[i][2 * h], w[i][2 * h + 1]);
  }
}

// for_each_pair_loop with two column sums: epi(row, col, c, v0, v1)
// returns the terms of (sum 0 of col, sum 0 of col + 1, sum 1 of col,
// sum 1 of col + 1) as a float4. They are added over the pair's four rows
// in order (i, h), then over the eight lanes of the column by a butterfly
// (xor 4, 8, 16: every lane ends with the same bits), and sink(col, sums)
// runs on lanes 0-3 with the warp's 32-row sums of their column pair.
template <typename AtCol, typename Epilogue, typename Sink>
__device__ __forceinline__ void for_each_pair_sums(const WarpTile& t,
                                                   int pairs, AtCol at_col,
                                                   Epilogue epi, Sink sink) {
#pragma unroll 2
  for (int j = 0; j < 2 * kPairs; ++j) {
    if (j >= 2 * pairs) break;
    float w[2][4];
    pick_tile(t, j, w);
    const auto c = at_col(lane_col(j));
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 d = epi(lane_row(i, h), lane_col(j), c, w[i][2 * h],
                             w[i][2 * h + 1]);
        s.x += d.x;
        s.y += d.y;
        s.z += d.z;
        s.w += d.w;
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
    }
    if ((threadIdx.x & 31) < 4) sink(lane_col(j), s);
  }
}

}  // namespace samlp_mma
