// The two forward passes of a recompute-mode training set-abstraction MLP:
//   stats (layer l): re-derive a_1 .. a_l from g2 with the l-1 BN affines
//     already known and return (sum a_l, sum a_l^2) per column, of the f32
//     a_l, over every row;
//   final: the whole chain, the last BN + ReLU and the max over each group
//     of k rows with its first argmax: out [M/k, C] f32, amax [M/k, C] i32.
//
// Replaces: papc_tpu/ops/pallas/samlp.py::recompute_stats (_rc_stats_kernel)
// and ::recompute_final_max (_rc_final_kernel), the forward of fused_mlp's
// "recompute" mode. Numeric contract kept from them and their twins
// (fused_mlp._jnp_rc_stats, _jnp_rc_final): bf16 operands, f32
// accumulation, f32 bias, affine and ReLU, no pre-activation rounded.
//
// What bounds them on the H100: the tensor-core products, which every pass
// repeats from layer 1 (SSG at B = 32: stats 86.6 GFLOP a step, final 53.6,
// 0.088 and 0.054 ms at 989 TFLOP/s); device memory sees only g2 (6 B a row
// at SA1), the weights and the outputs.
//
// Design: blocks walk tiles of tm rows (b, b + gridDim.x, ...); per tile
// the chain runs on tensor cores out of shared memory (samlp_recompute.cuh)
// and the last layer's epilogue either adds a and a^2 into the block's
// column sums (fixed order: written to partials[block] and reduced in
// order by a second kernel) or folds the ReLU output into the group's max.
// The max: ReLU output is >= +0, so its float bits order like the floats;
// the key (bits << 32) | (k - 1 - row in group) is the max and its first
// argmax in one 64-bit word. Each tile pools keys with shared-memory
// atomicMax, then merges them into a zeroed device buffer with global
// atomicMax (a group may span tiles and blocks), which gives the same
// result in any order; a last kernel splits the keys into out and amax.
#include "samlp_recompute.cuh"

namespace {

using samlp_rc::at;
using samlp_rc::Chain;
using samlp_rc::Layout;

template <int RF>
__global__ void __launch_bounds__(samlp_rc::kWarps * 32)
    rc_stats_kernel(Chain ch, Layout l, int upto,
                    float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* colsum = at<float>(smem, l.sums);
  const int p = ch.p[upto];
  for (int e = threadIdx.x; e < l.row_blocks * 2 * p; e += blockDim.x)
    colsum[e] = 0.f;
  const int tiles = (ch.m + l.tm - 1) / l.tm;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * l.tm;
    samlp_rc::hidden_layers<RF>(ch, l, smem, row0, upto);
    samlp_rc::stats_product<RF>(ch, l, smem, row0, ch.m, upto, colsum);
  }
  __syncthreads();
  samlp_train::write_block_sums(colsum, l.row_blocks, p, partials);
}

template <int RF>
__global__ void __launch_bounds__(samlp_rc::kWarps * 32)
    rc_final_kernel(Chain ch, Layout l,
                    unsigned long long* __restrict__ keys) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* pooled = at<unsigned long long>(smem, l.sums);
  const int n = ch.n, k = ch.k, c = ch.c[n], p = ch.p[n];
  const int groups = ch.m / k;
  for (int e = threadIdx.x; e < l.gpt * p; e += blockDim.x) pooled[e] = 0ull;
  const int tiles = (ch.m + l.tm - 1) / l.tm;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * l.tm;
    const int g0 = row0 / k;
    samlp_rc::hidden_layers<RF>(ch, l, smem, row0, n);
    samlp_rc::final_pool<RF>(ch, l, smem, row0, ch.m, g0, pooled);
    __syncthreads();
    for (int e = threadIdx.x; e < l.gpt * c; e += blockDim.x) {
      const int gl = e / c, col = e - gl * c;
      const unsigned long long v = pooled[gl * p + col];
      pooled[gl * p + col] = 0ull;
      if (v != 0ull && g0 + gl < groups)
        atomicMax(&keys[static_cast<size_t>(g0 + gl) * c + col], v);
    }
  }
}

__global__ void split_keys_kernel(const unsigned long long* __restrict__ keys,
                                  long long total, int k,
                                  float* __restrict__ out,
                                  int* __restrict__ amax) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned long long v = keys[e];
    out[e] = __uint_as_float(static_cast<unsigned>(v >> 32));
    amax[e] = k - 1 - static_cast<int>(v & 0xffffffffull);
  }
}

}  // namespace

// g2 [M, C0] bf16; per layer j < n_layers (arrays indexed from 0): width,
// w packed bf16 [pad16(c_{j-1}), pad16(c_j)], bias f32 [c_j], vec f32 rows
// (scale, shift, ...) x c_j (read for j < upto - 1 only). upto: the layer
// whose sums are wanted (1-based). tm: rows per tile (16, 32, 64, 128);
// blocks: the grid, which fixes the order of the sums.
// -> partials [blocks, 2, pad16(c_upto)] (scratch), sums [2, c_upto] f32.
PAPC_EXPORT int papc_samlp_rc_stats(const void* g2, int m, int c0,
                                    int n_layers, int upto,
                                    const int* widths, const void* const* w,
                                    const float* const* bias,
                                    const float* const* vec, int tm,
                                    int blocks, float* partials, float* sums,
                                    void* stream) {
  Chain ch;
  if (!samlp_rc::make_chain(ch, g2, m, 1, c0, n_layers, widths, w, bias, vec,
                            nullptr) ||
      upto < 1 || upto > n_layers || blocks <= 0)
    return cudaErrorInvalidValue;
  const Layout l = samlp_rc::make_layout(samlp_rc::kStats, ch, tm, upto);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = samlp_rc::with_row_frags(tm, [&](auto rf) {
    return papc_launch(rc_stats_kernel<decltype(rf)::value>, dim3(blocks),
                       dim3(samlp_rc::kWarps * 32), l.bytes, s, ch, l, upto,
                       partials);
  });
  if (err != cudaSuccess) return err;
  return samlp_train::reduce_partials(partials, blocks, 2, ch.c[upto], 2,
                                      ch.p[upto], sums, s);
}

// As papc_samlp_rc_stats, every layer's vec read (rows scale, shift), and
// k the group size (M a multiple of k). keys: [M/k, c_last] u64 scratch.
// -> out [M/k, c_last] f32 (the max), amax [M/k, c_last] i32 (the first
// row of the group that attains it).
PAPC_EXPORT int papc_samlp_rc_final(const void* g2, int m, int c0, int k,
                                    int n_layers, const int* widths,
                                    const void* const* w,
                                    const float* const* bias,
                                    const float* const* vec, int tm,
                                    int blocks, void* keys, float* out,
                                    int* amax, void* stream) {
  Chain ch;
  if (!samlp_rc::make_chain(ch, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            nullptr) ||
      blocks <= 0)
    return cudaErrorInvalidValue;
  const Layout l =
      samlp_rc::make_layout(samlp_rc::kFinal, ch, tm, n_layers);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(m / k) * ch.c[n_layers];
  auto* key = static_cast<unsigned long long*>(keys);
  cudaError_t err = cudaMemsetAsync(key, 0, total * sizeof(*key), s);
  if (err != cudaSuccess) return err;
  err = samlp_rc::with_row_frags(tm, [&](auto rf) {
    return papc_launch(rc_final_kernel<decltype(rf)::value>, dim3(blocks),
                       dim3(samlp_rc::kWarps * 32), l.bytes, s, ch, l, key);
  });
  if (err != cudaSuccess) return err;
  long long grid = (total + 255) / 256;
  if (grid > 132 * 64) grid = 132 * 64;
  return papc_launch(split_keys_kernel, dim3(static_cast<int>(grid)),
                     dim3(256), 0, s, key, total, k, out, amax);
}
