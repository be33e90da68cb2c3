// The two backward passes of fused_mlp's "recompute1" mode, each ONE
// cooperative launch (samlp_single.cuh). Each re-derives the chain a_1 ..
// a_n from g2 and walks the cotangent down in f32 from the max, computing
// what the grid passes #13 and #14 (samlp_rc_bwd.cuh) compute, with the
// wmma per-tile body samlp_rc::bwd_tile (samlp_recompute.cuh):
//   bwd stats (level l): s_l = (sum dy_l, sum dy_l * xhat_l) [2, c_l];
//   bwd final: dW_j = bf16(h_{j-1})^T . bf16(da_j), db_j = sum da_j for
//     every layer, and dg = dhp at j = 1 (f32, no gate), only if asked.
//
// Replaces: papc_tpu/ops/pallas/samlp_single.py::recompute_bwd_stats (#17)
// and ::recompute_bwd_final (#18). Numeric contract kept from them: only
// the operands of the products are rounded to bf16 (h, da); a, dy, da,
// the sums, dW, db and dg are f32.
//
// What bounds them on the H100: the tensor-core products, the forward chain
// again plus the walk down; device memory sees g2, dout and amax once, the
// weights once a block, dg, and dW's per-block partials.
//
// Design: one persistent block per SM slot stages the weights, biases, BN
// vectors and gradient means once and walks its contiguous range of rows
// (cut at group bounds), with the next tile's g2 rows and its groups' dout
// and amax rows in flight (cp.async). Column sums stay in shared memory
// across the block's tiles. dW is a sum over all M rows: where the plan
// has room (ops/kernels/samlp_single.py::plan, dw_on_chip) the block keeps
// its f32 dW in shared memory and writes it once; else it accumulates into
// its own slot in device memory tile by tile (SSG SA2: 270 KB a block).
// After a grid barrier the launch adds the blocks' partials (sums, db, dW)
// in block order, so repeated runs give the same bits.
#include "samlp_single.cuh"

namespace {

namespace cg = cooperative_groups;
using samlp_rc::at;
using samlp_rc::Chain;
using samlp_rc::kMaxLayers;
using samlp_rc::Layout;
using samlp_single::Single;

struct Grads {  // bwd final's outputs, layer j at index j - 1
  float* db[kMaxLayers];
  float* dw[kMaxLayers];
};

// kFinal false: the bwd stats pass at `level`: partials [blocks][2][p_level]
// -> sums [2, c_level]. kFinal true: db partials as write_block_db, dW
// partials [blocks][sum of p_{j-1} p_j] (layer j after the layers below
// it) -> grads; dg written when not null.
template <int RF, bool kFinal>
__global__ void __launch_bounds__(samlp_rc::kWarps * 32)
    rc1_bwd_kernel(Chain ch, Single s, int level,
                   const float* __restrict__ dout,
                   const int* __restrict__ amax, float* __restrict__ dg,
                   float* __restrict__ dw_part, float* __restrict__ partials,
                   float* __restrict__ sums_out, Grads grads) {
  extern __shared__ __align__(128) unsigned char smem[];
  Chain sc;
  samlp_single::stage_constants(ch, s, ch.n, smem, sc);
  const Layout& l = s.l;
  const int n = ch.n, rb = l.row_blocks;
  size_t dw_total = 0;
  for (int j = 1; j <= n; ++j)
    dw_total += static_cast<size_t>(ch.p[j - 1]) * ch.p[j];
  float* dw_block = dw_part + blockIdx.x * dw_total;
  float* dw_acc = s.dw_on_chip ? at<float>(smem, s.dw) : dw_block;
  float* slot[kMaxLayers + 1] = {};
  for (int j = 1, off = 0; j <= n; ++j) {
    slot[j] = dw_acc + off;
    off += ch.p[j - 1] * ch.p[j];
  }
  int total = 0;
  for (int j = 1; j <= n; ++j) total += ch.p[j];
  float* sums = at<float>(smem, l.sums);
  const int nsums = kFinal ? rb * total : rb * 2 * ch.p[level];
  for (int e = threadIdx.x; e < nsums; e += blockDim.x) sums[e] = 0.f;
  bool first = true;
  const bool any = samlp_single::walk_tiles(
      sc, s, smem, dout, amax, [&](int row0, int end, int buf) {
        samlp_rc::run_hidden<RF>(sc, l, smem, n, true);
        samlp_rc::bwd_tile<RF, kFinal>(
            sc, l, smem, row0, end, level, at<float>(smem, s.dout[buf]),
            at<int>(smem, s.amax[buf]), row0 / ch.k, dg, slot, first);
        first = false;
      });
  if (!kFinal) {
    samlp_train::write_block_sums(sums, rb, ch.p[level], partials);
    cg::this_grid().sync();
    samlp_single::grid_sum(partials, 2 * static_cast<size_t>(ch.p[level]),
                           2, ch.c[level], ch.p[level], sums_out);
    return;
  }
  samlp_rc::write_block_db(ch, l, smem, partials);
  if (!any) {  // a block without rows adds a zero dW
    for (size_t e = threadIdx.x; e < dw_total; e += blockDim.x)
      dw_block[e] = 0.f;
  } else if (s.dw_on_chip) {
    for (size_t e = threadIdx.x; e < dw_total; e += blockDim.x)
      dw_block[e] = dw_acc[e];
  }
  cg::this_grid().sync();
  size_t off = 0, db_off = 0;
  for (int j = 1; j <= n; ++j) {
    samlp_single::grid_sum(dw_part + off, dw_total, ch.c[j - 1], ch.c[j],
                           ch.p[j], grads.dw[j - 1]);
    samlp_single::grid_sum(partials + db_off * gridDim.x, ch.p[j], 1,
                           ch.c[j], ch.p[j], grads.db[j - 1]);
    off += static_cast<size_t>(ch.p[j - 1]) * ch.p[j];
    db_off += ch.p[j];
  }
}

bool bwd_args_ok(int tm, int max_blocks, const float* const* mu, int n,
                 int level) {
  if (max_blocks <= 0 || mu == nullptr) return false;
  for (int j = level + 1; j <= n; ++j)
    if (mu[j - 1] == nullptr) return false;
  return tm == 16 || tm == 32 || tm == 64 || tm == 128;
}

}  // namespace

// g2 [M, C0] bf16 (16-byte aligned); per layer j (arrays indexed from 0):
// width c_j, w packed bf16 [pad16(c_{j-1}), pad16(c_j)] (16-byte aligned),
// bias f32 [c_j], vec f32 [4, c_j] (scale, shift, mean, inv_std), mu f32
// [2, c_j] (sums / M of the stats passes; read above `level` only, may be
// null below); dout f32 and amax i32 [M/k, c_n]. level: 1-based. tm: rows
// per tile (16, 32, 64, 128); max_blocks: the most blocks the launch may
// take. -> partials [max_blocks, 2, pad16(c_level)] (scratch), sums
// [2, c_level] f32 (sum dy, sum dy * xhat at the level).
PAPC_EXPORT int papc_samlp_rc1_bwd_stats(
    const void* g2, int m, int c0, int k, int n_layers, int level,
    const int* widths, const void* const* w, const float* const* bias,
    const float* const* vec, const float* const* mu, const float* dout,
    const int* amax, int tm, int max_blocks, float* partials, float* sums,
    void* stream) {
  Chain ch;
  if (!samlp_rc::make_chain(ch, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            mu) ||
      level < 1 || level > n_layers ||
      !bwd_args_ok(tm, max_blocks, mu, n_layers, level))
    return cudaErrorInvalidValue;
  if (!samlp_single::aligned16(ch)) return cudaErrorMisalignedAddress;
  const Single s = samlp_single::make_single(samlp_rc::kBwdStats, ch, tm,
                                             n_layers, level, false);
  const auto st = static_cast<cudaStream_t>(stream);
  return samlp_rc::with_row_frags(tm, [&](auto rf) {
    return samlp_single::launch_cooperative(
        rc1_bwd_kernel<decltype(rf)::value, false>, max_blocks, s.bytes, st,
        ch, s, level, dout, amax, static_cast<float*>(nullptr),
        static_cast<float*>(nullptr), partials, sums, Grads{});
  });
}

// As papc_samlp_rc1_bwd_stats with every mu given. dw_on_chip: the plan's
// choice (1: dW in shared memory). Scratch: db_part [sum of pad16(c_j)] x
// max_blocks f32, dw_part [sum of pad16(c_{j-1}) * pad16(c_j)] x max_blocks
// f32. -> db[j] [c_j], dw[j] [c_{j-1}, c_j] f32 per layer, and dg [M, C0]
// f32 when dg is not null.
PAPC_EXPORT int papc_samlp_rc1_bwd_final(
    const void* g2, int m, int c0, int k, int n_layers, const int* widths,
    const void* const* w, const float* const* bias, const float* const* vec,
    const float* const* mu, const float* dout, const int* amax, int tm,
    int max_blocks, int dw_on_chip, float* db_part, float* dw_part,
    float* const* db, float* const* dw, float* dg, void* stream) {
  Chain ch;
  if (!samlp_rc::make_chain(ch, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            mu) ||
      !bwd_args_ok(tm, max_blocks, mu, n_layers, 0))
    return cudaErrorInvalidValue;
  if (!samlp_single::aligned16(ch)) return cudaErrorMisalignedAddress;
  const Single s = samlp_single::make_single(samlp_rc::kBwdFinal, ch, tm,
                                             n_layers, 0, dw_on_chip != 0);
  Grads grads{};
  for (int j = 0; j < n_layers; ++j) {
    grads.db[j] = db[j];
    grads.dw[j] = dw[j];
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return samlp_rc::with_row_frags(tm, [&](auto rf) {
    return samlp_single::launch_cooperative(
        rc1_bwd_kernel<decltype(rf)::value, true>, max_blocks, s.bytes, st,
        ch, s, 0, dout, amax, dg, dw_part, db_part,
        static_cast<float*>(nullptr), grads);
  });
}
