// The two forward passes of fused_mlp's "recompute1" mode, each ONE
// cooperative launch (samlp_single.cuh):
//   stats (layer l): re-derive a_1 .. a_l from g2 with the l-1 BN affines
//     already known and return (sum a_l, sum a_l^2) per column, of the f32
//     a_l, over every row;
//   final: the whole chain, the last BN + ReLU and the max over each group
//     of k rows with its first argmax: out [M/k, C] f32, amax [M/k, C] i32.
//
// Replaces: papc_tpu/ops/pallas/samlp_single.py::recompute_stats (#15) and
// ::recompute_final_max (#16). Same arithmetic as the grid passes #11 and
// #12 (samlp_rc_fwd.cu), on the wmma per-tile bodies of
// samlp_recompute.cuh: bf16 operands, f32 accumulation, f32 bias, affine
// and ReLU, no pre-activation rounded.
//
// What bounds them on the H100: the tensor-core products, which every pass
// repeats from layer 1; device memory sees g2 once (6 B a row at SSG SA1),
// the weights once a block, and the outputs.
//
// Design: the grid is one persistent block per SM slot; each block stages
// the weights, biases and BN vectors once, walks its contiguous range of
// rows with the next tile's g2 rows in flight (cp.async), keeps its column
// sums in shared memory, and after a grid barrier the launch adds the
// blocks' sums in block order. The max pass cuts ranges at group bounds, so
// each group's 64-bit key ((ReLU bits << 32) | (k - 1 - row)) is pooled in
// shared memory, carried into the next tile while the group continues,
// and written as out and amax once complete: no atomics in device memory,
// no zero fill, no second kernel.
#include "samlp_single.cuh"

namespace {

namespace cg = cooperative_groups;
using samlp_rc::at;
using samlp_rc::Chain;
using samlp_rc::Layout;
using samlp_single::Single;

template <int RF>
__global__ void __launch_bounds__(samlp_rc::kWarps * 32)
    rc1_stats_kernel(Chain ch, Single s, int upto,
                     float* __restrict__ partials, float* __restrict__ sums) {
  extern __shared__ __align__(128) unsigned char smem[];
  Chain sc;
  samlp_single::stage_constants(ch, s, upto, smem, sc);
  const Layout& l = s.l;
  float* colsum = at<float>(smem, l.sums);
  const int p = ch.p[upto];
  for (int e = threadIdx.x; e < l.row_blocks * 2 * p; e += blockDim.x)
    colsum[e] = 0.f;
  samlp_single::walk_tiles(sc, s, smem, [&](int row0, int end) {
    samlp_rc::run_hidden<RF>(sc, l, smem, upto);
    samlp_rc::stats_product<RF>(sc, l, smem, row0, end, upto, colsum);
  });
  samlp_train::write_block_sums(colsum, l.row_blocks, p, partials);
  cg::this_grid().sync();
  samlp_single::grid_sum(partials, 2 * static_cast<size_t>(p), 2,
                         ch.c[upto], p, sums);
}

template <int RF>
__global__ void __launch_bounds__(samlp_rc::kWarps * 32)
    rc1_final_kernel(Chain ch, Single s, float* __restrict__ out,
                     int* __restrict__ amax) {
  extern __shared__ __align__(128) unsigned char smem[];
  Chain sc;
  samlp_single::stage_constants(ch, s, ch.n, smem, sc);
  const Layout& l = s.l;
  auto* pooled = at<unsigned long long>(smem, l.sums);
  const int n = ch.n, k = ch.k, c = ch.c[n], p = ch.p[n];
  for (int e = threadIdx.x; e < l.gpt * p; e += blockDim.x) pooled[e] = 0ull;
  samlp_single::walk_tiles(
      sc, s, smem, [&](int row0, int end) {
        const int g0 = row0 / k;
        samlp_rc::run_hidden<RF>(sc, l, smem, n);
        samlp_rc::final_pool<RF>(sc, l, smem, row0, end, g0, pooled);
        __syncthreads();
        const int stop = min(row0 + l.tm, end);
        const int groups = (stop - 1) / k - g0 + 1;
        // ranges end on group bounds: only the tile's last group can go on
        // into the block's next tile
        const bool carry = stop % k != 0;
        const int done = carry ? groups - 1 : groups;
        for (int e = threadIdx.x; e < done * c; e += blockDim.x) {
          const int gl = e / c, col = e - gl * c;
          const unsigned long long v = pooled[gl * p + col];
          pooled[gl * p + col] = 0ull;
          const size_t o = static_cast<size_t>(g0 + gl) * c + col;
          out[o] = __uint_as_float(static_cast<unsigned>(v >> 32));
          amax[o] = k - 1 - static_cast<int>(v & 0xffffffffull);
        }
        if (carry && groups > 1) {
          __syncthreads();
          for (int col = threadIdx.x; col < p; col += blockDim.x) {
            pooled[col] = pooled[(groups - 1) * p + col];
            pooled[(groups - 1) * p + col] = 0ull;
          }
        }
      });
}

}  // namespace

// g2 [M, C0] bf16 (16-byte aligned); per layer j < n_layers (arrays indexed
// from 0): width, w packed bf16 [pad16(c_{j-1}), pad16(c_j)] (16-byte
// aligned), bias f32 [c_j], vec f32 rows (scale, shift, ...) x c_j (read
// for j < upto - 1 only). upto: the layer whose sums are wanted (1-based).
// tm: rows per tile (16, 32, 64, 128); max_blocks: the most blocks the
// launch may take (it takes as many as the card holds at once).
// -> partials [max_blocks, 2, pad16(c_upto)] (scratch), sums [2, c_upto].
PAPC_EXPORT int papc_samlp_rc1_stats(const void* g2, int m, int c0,
                                     int n_layers, int upto,
                                     const int* widths, const void* const* w,
                                     const float* const* bias,
                                     const float* const* vec, int tm,
                                     int max_blocks, float* partials,
                                     float* sums, void* stream) {
  Chain ch;
  if (!samlp_rc::make_chain(ch, g2, m, 1, c0, n_layers, widths, w, bias, vec,
                            nullptr) ||
      upto < 1 || upto > n_layers || max_blocks <= 0)
    return cudaErrorInvalidValue;
  if (!samlp_single::aligned16(ch)) return cudaErrorMisalignedAddress;
  const Single s =
      samlp_single::make_single(samlp_rc::kStats, ch, tm, upto);
  const auto st = static_cast<cudaStream_t>(stream);
  return samlp_rc::with_row_frags(tm, [&](auto rf) {
    return samlp_single::launch_cooperative(
        rc1_stats_kernel<decltype(rf)::value>, max_blocks, s.bytes, st, ch, s,
        upto, partials, sums);
  });
}

// As papc_samlp_rc1_stats, every layer's vec read (rows scale, shift), and
// k the group size (M a multiple of k).
// -> out [M/k, c_last] f32 (the max), amax [M/k, c_last] i32 (the first
// row of the group that attains it).
PAPC_EXPORT int papc_samlp_rc1_final(const void* g2, int m, int c0, int k,
                                     int n_layers, const int* widths,
                                     const void* const* w,
                                     const float* const* bias,
                                     const float* const* vec, int tm,
                                     int max_blocks, float* out, int* amax,
                                     void* stream) {
  Chain ch;
  if (!samlp_rc::make_chain(ch, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            nullptr) ||
      max_blocks <= 0)
    return cudaErrorInvalidValue;
  if (!samlp_single::aligned16(ch)) return cudaErrorMisalignedAddress;
  const Single s =
      samlp_single::make_single(samlp_rc::kFinal, ch, tm, n_layers);
  const auto st = static_cast<cudaStream_t>(stream);
  return samlp_rc::with_row_frags(tm, [&](auto rf) {
    return samlp_single::launch_cooperative(
        rc1_final_kernel<decltype(rf)::value>, max_blocks, s.bytes, st, ch, s,
        out, amax);
  });
}
