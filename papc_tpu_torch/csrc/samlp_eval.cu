// Eval-mode set-abstraction MLP + max over each K-row group, fused:
//   h_0 = x;  h_l = max((bf16(h_{l-1}) . bf16(W_l) + b_l) * scale_l + shift_l, 0)
//   out[g, :] = max over the k rows of group g of h_L
// BatchNorm with running statistics is folded into (scale, shift).
//
// Replaces: papc_tpu/ops/pallas/samlp.py::eval_mlp_max (_eval_kernel),
// which runs the whole stack for a tile of rows in VMEM and writes only
// the pooled output. Numeric contract kept from it: the input and every
// hidden activation are rounded to bf16 as the next layer's operand,
// products accumulate in f32, bias, affine and ReLU are f32
// (__fadd_rn / __fmul_rn, +0 for -0), and the max is over each group of k
// consecutive rows.
//
// What bounds it on the H100: the matrix products (SSG at B = 32: SA1
// 14 GFLOP, SA2 35 GFLOP, SA3 6 GFLOP at the padded widths, 0.056 ms at
// the bf16 peak). Device-memory traffic is only the f32 input and the
// pooled output (0.002 / 0.041 / 0.001 ms); the weights are re-read by
// every block from L2.
//
// Design (samlp_mma.cuh holds the product core):
//  - A first, small launch packs every layer's f32 W at the strides the
//    caller holds it (the model passes the Linear weight's transpose)
//    into one zero-padded bf16 buffer, so the call costs the
//    host one entry point and no tensor operations for the weights.
//  - A block of 8 warps takes TM rows (32, 64 or 128, picked by the
//    wrapper's plan for at least one wave of blocks where M allows). The
//    f32 input tile, one contiguous span, is read as float4, its first
//    batch in flight before the block issues anything else and each next
//    batch while one is unpacked, and stored as bf16 into a skewed
//    buffer; activations stay in shared memory as bf16 in two ping-pong
//    buffers. Every layer's bias, scale and shift come by cp.async with
//    the first weight tile (zero in the channel padding).
//  - Each layer's W [Cin, Cout] streams through a 3-stage ring of
//    [32 x kChunk] tiles copied with cp.async.cg: the block issues tile
//    t + 2 while the warps multiply tile t. The tile sequence runs across
//    layers, so the next layer's weights arrive during this one's
//    epilogue.
//  - Warps tile the block's TM x kChunk output as 32 x 64 warp tiles
//    (TM / 32 by 8 / (TM / 32)); a narrower chunk gives each warp fewer
//    n16 pairs. Products are mma.sync m16n8k16 on ldmatrix fragments, the
//    accumulators stay in registers over the whole K.
//  - Epilogue straight from the registers: bias, affine and ReLU, then a
//    bf16x2 store into the next layer's buffer, or for the last layer the
//    max over each aligned run of gcd(k, 32) rows: folded in the thread,
//    then a butterfly over the lanes of a column that halves the values a
//    lane holds at each xor step, so every lane ends with a few columns'
//    maxima and issues one shared-memory red.max each on the value's bits
//    (ReLU output is >= +0, and non-negative floats order like their
//    bits).
//  - A group that lies wholly in the block is stored; one that spans
//    blocks (k % TM == 0 at SA3's 32-row tiles, or any k that does not
//    divide TM) is merged with a global atomicMax on the same bits into
//    the zero-filled output, which gives the same bits in any order.
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "samlp_mma.cuh"

namespace {

namespace mma = samlp_mma;

constexpr int kMaxLayers = 4;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 32;  // weight rows a ring stage holds
constexpr int kStages = 3;
constexpr int kSkew = 8;  // bf16 elements of padding per shared-memory row

struct MlpParams {
  int n_layers;
  int cin[kMaxLayers];   // padded to a multiple of 16
  int cout[kMaxLayers];  // padded to a multiple of 16
  int width[kMaxLayers];  // output channels before padding
  const __nv_bfloat16* w[kMaxLayers];  // [cin, cout] row-major, zero-padded
  const float* bias[kMaxLayers];       // [width]
  const float* scale[kMaxLayers];
  const float* shift[kMaxLayers];
};

template <int TM>
struct Shape {
  static constexpr int kRowWarps = TM / mma::kWarpRows;
  static constexpr int kColWarps = kWarps / kRowWarps;
  static constexpr int kChunk = mma::kWarpCols * kColWarps;  // ring columns
  static constexpr int kLdRing = kChunk + kSkew;
  static constexpr int kRingElems = kStages * kSlice * kLdRing;
};

// Groups a block of TM rows can touch: TM / k when k divides TM, 1 when
// TM divides k, else at most (TM - 1) / k + 2 (the block straddles).
__host__ __device__ inline int pool_slots(int tm, int k) {
  if (tm % k == 0) return tm / k;
  if (k % tm == 0) return 1;
  return (tm - 1) / k + 2;
}

__host__ __device__ inline int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Floats of [bias | scale | shift] before layer l's in shared memory.
__host__ __device__ inline int vec_offset(const MlpParams& prm, int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += 3 * prm.cout[i];
  return off;
}

// The ring's slice at `at` (product q = layer q) into a stage.
template <int TM>
__device__ __forceinline__ void issue_tile(const MlpParams& prm,
                                           const mma::RingCursor& at,
                                           __nv_bfloat16* stage) {
  const int cout = prm.cout[at.q];
  mma::issue_slice<false>(stage, Shape<TM>::kLdRing, prm.w[at.q], cout,
                          prm.cin[at.q], cout, kSlice, Shape<TM>::kChunk, at);
}

// The ring's next slice after `at`.
template <int TM>
__device__ __forceinline__ void advance(const MlpParams& prm,
                                        mma::RingCursor& at) {
  at.advance(prm.cin[at.q], prm.cout[at.q], kSlice, Shape<TM>::kChunk);
}

// Bias, scale and shift of a column pair, from the block's copy in shared
// memory ([bias | scale | shift] of cout floats a layer, 0 in the channel
// padding, whose W columns are 0 too, so h is +0 there).
struct ColPair {
  float b[2], scale[2], shift[2];
};

__device__ __forceinline__ ColPair col_pair(const float* vec, int cout,
                                            int col) {
  ColPair c;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    c.b[e] = vec[col + e];
    c.scale[e] = vec[cout + col + e];
    c.shift[e] = vec[2 * cout + col + e];
  }
  return c;
}

// h = max((acc + b) * scale + shift, 0), +0 for -0, without contraction.
__device__ __forceinline__ float bn_relu(float acc, const ColPair& c, int e) {
  const float h =
      __fadd_rn(__fmul_rn(__fadd_rn(acc, c.b[e]), c.scale[e]), c.shift[e]);
  return h > 0.f ? h : 0.f;
}

// *p = max(*p, v) in shared memory, no value returned.
__device__ __forceinline__ void red_max_shared(unsigned* p, unsigned v) {
  asm volatile("red.shared.max.u32 [%0], %1;\n" ::"r"(mma::smem_u32(p)),
               "r"(v)
               : "memory");
}

__host__ __device__ inline int pad16(int c) { return (c + 15) / 16 * 16; }

// Each layer's f32 W as the caller holds it ([C_l, width] at any element
// strides) and its zero-padded bf16 block in the weight buffer.
struct PackArgs {
  const float* src[kMaxLayers];
  long long row_stride[kMaxLayers], col_stride[kMaxLayers];
  __nv_bfloat16* dst[kMaxLayers];
};

// Layer blockIdx.y's W into its [cin, cout] block, the layout the ring
// copies from, rounded to nearest even as the plain version rounds it;
// zero in the padding.
__global__ void pack_weights_kernel(PackArgs a, int c0, MlpParams prm) {
  const int l = blockIdx.y;
  const int cout = prm.cout[l];
  const int rows = l == 0 ? c0 : prm.width[l - 1], cols = prm.width[l];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < prm.cin[l] * cout;
       e += gridDim.x * blockDim.x) {
    const int r = e / cout, c = e - r * cout;
    float v = 0.f;
    if (r < rows && c < cols)
      v = a.src[l][r * a.row_stride[l] + c * a.col_stride[l]];
    a.dst[l][e] = __float2bfloat16_rn(v);
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
    samlp_eval_kernel(const float* __restrict__ x, int m, int c0, int k,
                      int ld_x, int ld_y, int c_last, int n_tiles,
                      MlpParams prm, float* __restrict__ out) {
  using S = Shape<TM>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* buf_x = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* buf_y = buf_x + TM * ld_x;
  __nv_bfloat16* ring = buf_y + TM * ld_y;
  float* vecs = reinterpret_cast<float*>(ring + S::kRingElems);
  unsigned* pooled =
      reinterpret_cast<unsigned*>(vecs + vec_offset(prm, prm.n_layers));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp / S::kColWarps;  // warp row: rows from kWarpRows wr
  const int wc = warp % S::kColWarps;
  const int row0 = blockIdx.x * TM;
  const int rows_here = min(TM, m - row0);
  const int g_first = row0 / k;
  const int n_pool = (row0 + rows_here - 1) / k - g_first + 1;
  const int c_last_pad = prm.cout[prm.n_layers - 1];

  // The input tile's rows are one contiguous span of rows_here * c0
  // floats from a multiple of 32 c0 (16-byte aligned: the wrapper passes a
  // 16-byte-aligned x), read as float4 in batches of kBatch a thread; the
  // first batch is in flight before anything else is issued.
  const float* src = x + static_cast<size_t>(row0) * c0;
  const int n = rows_here * c0;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  constexpr int kBatch = 4;
  auto load = [&](float4(&v)[kBatch], int q0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (q0 + u * kThreads < n / 4) v[u] = __ldg(src4 + q0 + u * kThreads);
  };
  float4 cur[kBatch];
  load(cur, tid);

  // every layer's bias, scale and shift (zero in the channel padding) and
  // the weights of the first kStages - 1 tiles, by cp.async: the first
  // group holds the vectors and tile 0
  for (int l = 0, off = 0; l < prm.n_layers; off += 3 * prm.cout[l++]) {
    const int cout = prm.cout[l], width = prm.width[l];
    for (int c = tid; c < cout; c += kThreads) {
      const bool in = c < width;
      const int at_c = in ? c : 0;
      mma::cp_async4(vecs + off + c, prm.bias[l] + at_c, in);
      mma::cp_async4(vecs + off + cout + c, prm.scale[l] + at_c, in);
      mma::cp_async4(vecs + off + 2 * cout + c, prm.shift[l] + at_c, in);
    }
  }
  mma::RingCursor load_at;
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) {
      issue_tile<TM>(prm, load_at, ring + i * kSlice * S::kLdRing);
      advance<TM>(prm, load_at);
    }
    mma::cp_async_commit();
  }

  // the input buffer zeroed (it keeps zero in the channel padding and
  // below the last row) before the tile is stored into it; the pooled
  // maxima zeroed
  for (int e = tid; e < TM * ld_x / 8; e += kThreads)
    reinterpret_cast<uint4*>(buf_x)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < n_pool * c_last_pad; e += kThreads) pooled[e] = 0u;
  __syncthreads();

  // input -> bf16, the next batch in flight while one is unpacked
  {
    const float inv_c0 = 1.f / static_cast<float>(c0);
    // element e's place in the buffer and its column: e / c0 by a float
    // reciprocal, corrected to the exact quotient
    auto place = [&](int e, int& c) {
      int r = static_cast<int>((static_cast<float>(e) + 0.5f) * inv_c0);
      c = e - r * c0;
      if (c < 0) {
        --r;
        c += c0;
      } else if (c >= c0) {
        ++r;
        c -= c0;
      }
      return buf_x + r * ld_x + c;
    };
    // a float4: its first element placed, the next three following along
    // the row (and on to the next one)
    auto put4 = [&](int q, const float4& v) {
      int c;
      __nv_bfloat16* p = place(4 * q, c);
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        *p = __float2bfloat16_rn(f[u]);
        if (++c == c0) {
          c = 0;
          p += ld_x - c0 + 1;
        } else {
          ++p;
        }
      }
    };
    for (int q0 = tid; q0 < n / 4; q0 += kBatch * kThreads) {
      float4 next[kBatch];
      load(next, q0 + kBatch * kThreads);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (q0 + u * kThreads < n / 4) put4(q0 + u * kThreads, cur[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) cur[u] = next[u];
    }
    for (int e = (n / 4) * 4 + tid; e < n; e += kThreads) {
      int c;
      *place(e, c) = __float2bfloat16_rn(__ldg(src + e));
    }
  }

  // rows of one register run of the max: aligned runs of gcd(k, 32) rows
  // never cross a group (the warp's rows start at a multiple of 32)
  const int run = gcd(k, mma::kWarpRows);
  mma::WarpTile tile;
  mma::RingCursor at;
  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + kStages - 1 < n_tiles) {
      issue_tile<TM>(prm, load_at,
                     ring + ((t + kStages - 1) % kStages) * kSlice * S::kLdRing);
      advance<TM>(prm, load_at);
    }
    mma::cp_async_commit();

    const int l = at.q;
    const int cin = prm.cin[l], cout = prm.cout[l];
    const __nv_bfloat16* in = (l & 1) ? buf_y : buf_x;
    const int ld_in = (l & 1) ? ld_y : ld_x;
    // the chunk's columns, split evenly over the column warps in n16 pairs
    const int chunk0 = at.c * S::kChunk;
    const int width = min(S::kChunk, cout - chunk0);
    const int span =
        ((width + S::kColWarps - 1) / S::kColWarps + 15) / 16 * 16;
    const int col0 = wc * span;
    const int pairs = max(0, min(span, width - col0)) / 16;
    if (at.s == 0) mma::zero(tile);
    if (pairs > 0) {
      const int ks = min(kSlice, cin - at.s * kSlice);
      mma::mma_slice(tile, in + wr * mma::kWarpRows * ld_in + at.s * kSlice,
                     ld_in,
                     ring + (t % kStages) * kSlice * S::kLdRing + col0,
                     S::kLdRing, ks / 16, pairs);
    }
    const bool chunk_done = (at.s + 1) * kSlice >= cin;
    advance<TM>(prm, at);
    if (!chunk_done || pairs == 0) continue;

    const int cbase = chunk0 + col0;
    const float* vec = vecs + vec_offset(prm, l);
    auto at_col = [&](int c) { return col_pair(vec, cout, cbase + c); };
    if (l + 1 < prm.n_layers) {
      __nv_bfloat16* dst = ((l & 1) ? buf_x : buf_y) + cbase;
      const int ld_dst = (l & 1) ? ld_x : ld_y;
      mma::for_each_pair(
          tile, pairs, at_col,
          [&](int r, int c, const ColPair& cp, float& v0, float& v1) {
            *reinterpret_cast<__nv_bfloat162*>(
                dst + (wr * mma::kWarpRows + r) * ld_dst + c) =
                __floats2bfloat162_rn(bn_relu(v0, cp, 0), bn_relu(v1, cp, 1));
          });
      continue;
    }
    // last layer: the activations in place, then the max over each run
    mma::for_each_pair(tile, pairs, at_col,
                       [&](int, int, const ColPair& cp, float& v0, float& v1) {
                         v0 = bn_relu(v0, cp, 0);
                         v1 = bn_relu(v1, cp, 1);
                       });
    // The max over each aligned run of `run` rows (never across a group):
    // the rows of it a thread holds fold in its registers, then a
    // butterfly over the lanes of a column (xor 4, 8, 16: rows 1, 2, 4
    // apart) halves at each step the 16 (n8 tile, column) values a lane
    // holds for its (i, h), so every lane ends with 16 >> steps of them
    // and issues their shared-memory max (values from index `base`).
    const int steps = run >= 8 ? 3 : run >= 4 ? 2 : run >= 2 ? 1 : 0;
    const int first = (lane >> 2) & ~((1 << steps) - 1);  // run's first row
    int base = 0;
    for (int s = 0; s < steps; ++s) base += ((lane >> (2 + s)) & 1) * (8 >> s);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if ((run >= 16 && h == 1) || (run >= 32 && i == 1)) continue;
        const auto& a = tile.acc;
        float w[16];  // (n8 tile j, column e) as u = 2 j + e
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int j = u >> 1, e = u & 1;
          w[u] = a[i][j][2 * h + e];
          if (run >= 16) w[u] = fmaxf(w[u], a[i][j][2 + e]);
          if (run >= 32)
            w[u] = fmaxf(w[u], fmaxf(a[1][j][e], a[1][j][2 + e]));
        }
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          if (s >= steps) break;
          const int half = 8 >> s;
          const bool hi = (lane >> (2 + s)) & 1;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (u >= half) break;
            const float send = hi ? w[u] : w[half + u];
            const float mine = hi ? w[half + u] : w[u];
            w[u] = fmaxf(mine, __shfl_xor_sync(0xffffffffu, send, 4 << s));
          }
        }
        const int row = row0 + wr * mma::kWarpRows + 16 * i + 8 * h + first;
        if (row >= m) continue;
        unsigned* dst = pooled + (row / k - g_first) * c_last_pad + cbase +
                        2 * (lane & 3);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (u >= (16 >> steps)) break;
          const int j = (base + u) >> 1;
          if (j < 2 * pairs)
            red_max_shared(dst + 8 * j + ((base + u) & 1),
                           __float_as_uint(w[u]));
        }
      }
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  for (int e = tid; e < n_pool * c_last; e += kThreads) {
    const int gi = e / c_last, c = e - gi * c_last;
    const int g = g_first + gi;
    const size_t o = static_cast<size_t>(g) * c_last + c;
    const unsigned v = pooled[gi * c_last_pad + c];
    if (g * k >= row0 && (g + 1) * k <= row0 + TM)
      out[o] = __uint_as_float(v);
    else
      atomicMax(reinterpret_cast<unsigned*>(out) + o, v);
  }
}

template <int TM>
cudaError_t launch(const float* x, int m, int c0, int k, int ld_x, int ld_y,
                   const MlpParams& prm, float* out, cudaStream_t stream) {
  using S = Shape<TM>;
  int n_tiles = 0;
  for (int l = 0; l < prm.n_layers; ++l)
    n_tiles += ((prm.cout[l] + S::kChunk - 1) / S::kChunk) *
               ((prm.cin[l] + kSlice - 1) / kSlice);
  const size_t smem =
      static_cast<size_t>(TM) * (ld_x + ld_y) * 2 + S::kRingElems * 2 +
      static_cast<size_t>(vec_offset(prm, prm.n_layers)) * sizeof(float) +
      static_cast<size_t>(pool_slots(TM, k)) * prm.cout[prm.n_layers - 1] *
          sizeof(unsigned);
  const int c_last = prm.width[prm.n_layers - 1];
  if (TM % k != 0) {  // the blocks of a group merge into +0.0 bits
    const cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(m / k) * c_last, stream);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (m + TM - 1) / TM;
  return papc_launch(samlp_eval_kernel<TM>, dim3(blocks), dim3(kThreads),
                     smem, stream, x, m, c0, k, ld_x, ld_y, c_last, n_tiles,
                     prm, out);
}

}  // namespace

// x [M, C0] f32 row-major, 16-byte aligned. Per layer l < n_layers: w[l]
// [C_l, width[l]] (C_0 = c0, C_l = width[l - 1]) f32 as the caller holds
// it, at element strides w_strides[2 l] (rows) and w_strides[2 l + 1] (columns); bias, scale, shift f32
// [width[l]]. wbuf: bf16 scratch of sum_l pad16(C_l) * pad16(width[l])
// elements, 16-byte aligned, into which the weights are packed first.
// tm: rows per block, 32, 64 or 128. ld_x / ld_y: shared-memory row
// strides in bf16 elements (multiples of 8) of the buffers holding the
// inputs of layers 0, 2, ... and 1, 3, .... -> out [M / k, width[n - 1]]
// f32.
PAPC_EXPORT int papc_samlp_eval(const float* x, int m, int c0, int k,
                                int n_layers, const int* width,
                                const float* const* w,
                                const long long* w_strides,
                                const float* const* bias,
                                const float* const* scale,
                                const float* const* shift, int tm, int ld_x,
                                int ld_y, void* wbuf, float* out,
                                void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || m <= 0 || k <= 0 ||
      m % k != 0 || c0 <= 0 || ld_x % 8 != 0 || ld_y % 8 != 0 ||
      (tm != 32 && tm != 64 && tm != 128) ||
      reinterpret_cast<std::uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(wbuf) % 16 != 0)
    return cudaErrorInvalidValue;
  MlpParams prm{};
  PackArgs pack{};
  prm.n_layers = n_layers;
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(wbuf);
  int biggest = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int rows = l == 0 ? c0 : width[l - 1];
    if (width[l] <= 0 || ((l & 1) ? ld_y : ld_x) < pad16(rows))
      return cudaErrorInvalidValue;
    prm.cin[l] = pad16(rows);
    prm.cout[l] = pad16(width[l]);
    prm.width[l] = width[l];
    prm.w[l] = dst;
    prm.bias[l] = bias[l];
    prm.scale[l] = scale[l];
    prm.shift[l] = shift[l];
    pack.src[l] = w[l];
    pack.row_stride[l] = w_strides[2 * l];
    pack.col_stride[l] = w_strides[2 * l + 1];
    pack.dst[l] = dst;
    dst += prm.cin[l] * prm.cout[l];
    biggest = std::max(biggest, prm.cin[l] * prm.cout[l]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = papc_launch(
      pack_weights_kernel, dim3(std::min((biggest + 255) / 256, 1024), n_layers),
      dim3(256), 0, s, pack, c0, prm);
  if (err != cudaSuccess) return err;
  switch (tm) {
    case 32:
      return launch<32>(x, m, c0, k, ld_x, ld_y, prm, out, s);
    case 64:
      return launch<64>(x, m, c0, k, ld_x, ld_y, prm, out, s);
    default:
      return launch<128>(x, m, c0, k, ld_x, ld_y, prm, out, s);
  }
}
