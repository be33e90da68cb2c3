// The two backward passes of a recompute-mode training set-abstraction MLP.
// Each re-derives the chain a_1 .. a_n from g2, then walks the cotangent
// down in f32 from the max:
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
// (_rc_bwd_stats_kernel) and ::recompute_bwd_final (_rc_bwd_final_kernel),
// the backward of fused_mlp's "recompute" mode. Numeric contract kept from
// them and their twins (fused_mlp._jnp_rc_bwd_stats, _jnp_rc_bwd_final):
// only the operands of the products are rounded to bf16 (h, da); a, dy,
// da, the sums, dW, db and dg are f32.
//
// What bounds them on the H100: the tensor-core products, the forward chain
// again plus the walk down (SSG at B = 32: bwd stats 234.8 GFLOP a step,
// bwd final 160.7 GFLOP, 0.237 and 0.162 ms at 989 TFLOP/s). Device memory
// sees g2, dout, amax, the weights and vectors, dg and the dW partials.
//
// Design: blocks walk tiles of tm rows; the f32 a_j of every layer but the
// last stay in shared memory for the gates and x-hats (SSG SA3: 3 KB a row,
// so tm is 16 there; the plan picks tm from the card's shared memory). The
// top of the walk is the last forward product's epilogue, so a_n is never
// stored. Each dhp product's epilogue gates, forms da_{j-1} and writes its
// bf16 operand over h_{j-1}, once dW_j has used h_{j-1}. All sums are
// per-block column sums in a fixed warp order, reduced across blocks in
// order by second kernels. dW is a sum over all M rows and too large for
// shared memory (SA3's last layer alone is 2 MB in f32): each block owns a
// dW slot in device memory, adds every tile's h^T . da into it on tensor
// cores (accumulator fragments loaded from and stored to the slot), and
// the slots are reduced in order. Rows past M carry da = 0. Repeated runs
// give the same bits.
#include "samlp_recompute.cuh"

namespace {

using samlp_rc::at;
using samlp_rc::Chain;
using samlp_rc::Layout;

// kFinal false: the bwd stats pass at `level`, sums [row_blocks][2][p_level]
// -> partials [blocks][2][p_level]. kFinal true: db sums [row_blocks][p_j]
// per layer -> db_part (layer j at p_1 + .. + p_{j-1} times blocks, then
// [blocks][p_j]), dW slots in dw_part (layer j at the sum of p_{i-1} p_i
// over i < j, times blocks, then [blocks][p_{j-1}][p_j]), dg if not null.
template <int RF, bool kFinal>
__global__ void __launch_bounds__(samlp_rc::kWarps * 32)
    rc_bwd_kernel(Chain ch, Layout l, int level,
                  const float* __restrict__ dout,
                  const int* __restrict__ amax, float* __restrict__ dg,
                  float* __restrict__ dw_part, float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sums = at<float>(smem, l.sums);
  const int n = ch.n, m = ch.m;
  const int rb = l.row_blocks;
  float* slot[samlp_rc::kMaxLayers + 1] = {};  // layer j's dW slot
  int total = 0;
  size_t dw_off = 0;
  for (int j = 1; j <= n; ++j) {
    total += ch.p[j];
    if (kFinal)
      slot[j] = dw_part + dw_off * gridDim.x +
                static_cast<size_t>(blockIdx.x) * ch.p[j - 1] * ch.p[j];
    dw_off += static_cast<size_t>(ch.p[j - 1]) * ch.p[j];
  }
  const int nsums = kFinal ? rb * total : rb * 2 * ch.p[level];
  for (int e = threadIdx.x; e < nsums; e += blockDim.x) sums[e] = 0.f;
  const int tiles = (m + l.tm - 1) / l.tm;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * l.tm;
    samlp_rc::hidden_layers<RF>(ch, l, smem, row0, n, true);
    samlp_rc::bwd_tile<RF, kFinal>(ch, l, smem, row0, m, level, dout, amax,
                                   0, dg, slot, t == blockIdx.x);
  }
  __syncthreads();
  if (kFinal)
    samlp_rc::write_block_db(ch, l, smem, partials);
  else
    samlp_train::write_block_sums(sums, rb, ch.p[level], partials);
}

bool bwd_args_ok(int tm, int blocks, const float* const* mu, int n,
                 int level) {
  if (blocks <= 0 || mu == nullptr) return false;
  for (int j = level + 1; j <= n; ++j)
    if (mu[j - 1] == nullptr) return false;
  return tm == 16 || tm == 32 || tm == 64 || tm == 128;
}

}  // namespace

// g2 [M, C0] bf16; per layer j (arrays indexed from 0): width c_j, w packed
// bf16 [pad16(c_{j-1}), pad16(c_j)], bias f32 [c_j], vec f32 [4, c_j]
// (scale, shift, mean, inv_std), mu f32 [2, c_j] (sums / M of the stats
// passes; read above `level` only, may be null below); dout f32 and amax
// i32 [M/k, c_n]. level: 1-based. tm: rows per tile (16, 32, 64, 128);
// blocks: the grid, which fixes the order of the sums.
// -> partials [blocks, 2, pad16(c_level)] (scratch), sums [2, c_level] f32
//    (sum dy, sum dy * xhat at the level).
PAPC_EXPORT int papc_samlp_rc_bwd_stats(
    const void* g2, int m, int c0, int k, int n_layers, int level,
    const int* widths, const void* const* w, const float* const* bias,
    const float* const* vec, const float* const* mu, const float* dout,
    const int* amax, int tm, int blocks, float* partials, float* sums,
    void* stream) {
  Chain ch;
  if (!samlp_rc::make_chain(ch, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            mu) ||
      level < 1 || level > n_layers ||
      !bwd_args_ok(tm, blocks, mu, n_layers, level))
    return cudaErrorInvalidValue;
  const Layout l =
      samlp_rc::make_layout(samlp_rc::kBwdStats, ch, tm, n_layers, level);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = samlp_rc::with_row_frags(tm, [&](auto rf) {
    return papc_launch(rc_bwd_kernel<decltype(rf)::value, false>,
                       dim3(blocks), dim3(samlp_rc::kWarps * 32), l.bytes, s,
                       ch, l, level, dout, amax, nullptr, nullptr, partials);
  });
  if (err != cudaSuccess) return err;
  return samlp_train::reduce_partials(partials, blocks, 2, ch.c[level], 2,
                                      ch.p[level], sums, s);
}

// As papc_samlp_rc_bwd_stats with every mu given. Scratch: db_part
// [sum of pad16(c_j)] x blocks f32, dw_part [sum of pad16(c_{j-1}) *
// pad16(c_j)] x blocks f32. -> db[j] [c_j], dw[j] [c_{j-1}, c_j] f32 per
// layer, and dg [M, C0] f32 when dg is not null.
PAPC_EXPORT int papc_samlp_rc_bwd_final(
    const void* g2, int m, int c0, int k, int n_layers, const int* widths,
    const void* const* w, const float* const* bias, const float* const* vec,
    const float* const* mu, const float* dout, const int* amax, int tm,
    int blocks, float* db_part, float* dw_part, float* const* db,
    float* const* dw, float* dg, void* stream) {
  Chain ch;
  if (!samlp_rc::make_chain(ch, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            mu) ||
      !bwd_args_ok(tm, blocks, mu, n_layers, 0))
    return cudaErrorInvalidValue;
  const Layout l =
      samlp_rc::make_layout(samlp_rc::kBwdFinal, ch, tm, n_layers, 0);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = samlp_rc::with_row_frags(tm, [&](auto rf) {
    return papc_launch(rc_bwd_kernel<decltype(rf)::value, true>, dim3(blocks),
                       dim3(samlp_rc::kWarps * 32), l.bytes, s, ch, l, 0,
                       dout, amax, dg, dw_part, db_part);
  });
  size_t db_off = 0, dw_off = 0;
  for (int j = 1; j <= n_layers && err == cudaSuccess; ++j) {
    err = samlp_train::reduce_partials(dw_part + dw_off * blocks, blocks,
                                       ch.c[j - 1], ch.c[j], ch.p[j - 1],
                                       ch.p[j], dw[j - 1], s);
    if (err == cudaSuccess)
      err = samlp_train::reduce_partials(db_part + db_off * blocks, blocks, 1,
                                         ch.c[j], 1, ch.p[j], db[j - 1], s);
    db_off += ch.p[j];
    dw_off += static_cast<size_t>(ch.p[j - 1]) * ch.p[j];
  }
  return err;
}
