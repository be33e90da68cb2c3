// The two backward passes of fused_mlp's "recompute1" mode, each ONE
// cooperative launch. Each re-derives the chain a_1 .. a_n from g2 and
// walks the cotangent down in f32 from the max, computing what the grid
// passes #13 and #14 compute, on their tile body (samlp_rc_bwd.cuh:
// bwd_tiles, on the mma.sync core of samlp_mma.cuh):
//   bwd stats (level l): s_l = (sum dy_l, sum dy_l * xhat_l) [2, c_l];
//   bwd final: dW_j = bf16(h_{j-1})^T . bf16(da_j), db_j = sum da_j for
//     every layer, and dg = dhp at j = 1 (f32, no gate), only if asked.
//
// Replaces: papc_tpu/ops/pallas/samlp_single.py::recompute_bwd_stats (#17)
// and ::recompute_bwd_final (#18). Numeric contract kept from them: only
// the operands of the products are rounded to bf16 (h, da); a, dy, da,
// the sums, dW, db and dg are f32; every gate, x-hat and da uses the _rn
// intrinsics op for op as the plain version.
//
// What bounds them on the H100: the tensor-core products, the forward chain
// again plus the walk down (and dW in bwd final), then the f32 epilogues;
// device memory sees g2, dout and amax once, the weights once a block (or
// once a tile through the ring), dg, and the per-block partials.
//
// Design: one persistent block of 8 warps an SM (the grid the card holds
// at once, at most the plan's blocks). Each block takes one contiguous
// range of whole groups (samlp_single::block_rows, cut at the plan's
// unit: k rows, or a multiple of k where k groups of g2 would not start on
// 16 bytes) and runs bwd_tiles on it, tile after tile from its start
// (the plan, ops/kernels/samlp_single.py::bwd_plan: #13 / #14's row tile,
// a_smem and dW choices; the rows mode is never taken). Where W_1 .. W_n
// fit beside the tile at that tile size (SSG SA1, the MSG SA1 branches)
// the block stages them once in the skewed rows the core's ldmatrix
// loaders read, and the tile's products read them there with one barrier
// a product; elsewhere they stream through #13 / #14's cp.async ring.
// dW stays in shared memory where it fits (SSG SA1: 53 KB), else it is
// added tile by tile into the block's slot in device memory (SSG SA2: 270
// KB, about 16 tiles of 128 rows a block). After this_grid().sync() the
// same launch adds the blocks' partials (the level's two sums; every dW
// and db) element by element in block order: no reduce launch, no memset,
// and repeated calls give the same bits.
#include "samlp_rc_bwd.cuh"
#include "samlp_single.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace samlp_rcb;

struct Grads {  // bwd final's outputs, layer j at index j - 1
  float* db[kMaxLayers];
  float* dw[kMaxLayers];
};

// kFinal false: bwd stats at l.level, partials o.part [blocks][2][p_level]
// -> sums [2, c_level]. kFinal true: db partials o.part [blocks][p_1 + ..
// + p_n], dW partials o.dw_part (layer j at dw_off[j] * blocks) -> grads;
// dg written when o.dg is not null. kResident: the weights staged once.
// unit: the rows the block ranges are cut at.
template <bool kResident, bool kFinal>
__global__ void __launch_bounds__(kThreads, 1)
    rc1_bwd_kernel(Chain st, Layout l, int unit, Outs o,
                   float* __restrict__ sums, Grads grads) {
  extern __shared__ __align__(128) unsigned char smem[];
  zero_sums<kFinal>(st, l, smem);
  if (kResident) stage_weights(st, l, smem);
  int begin, end;
  const int tiles = samlp_single::block_tiles(st.m, unit, l.tm, begin, end);
  bwd_tiles<kFinal, kResident>(st, l, o, smem, begin, l.tm, tiles, end);
  write_block_partials<kFinal>(st, l, smem, o, tiles > 0);
  cg::this_grid().sync();
  const int n = st.n;
  if (!kFinal) {
    const int pl = st.p[l.level];
    samlp_single::grid_sum(o.part, 2 * static_cast<size_t>(pl), 2,
                           st.c[l.level], pl, sums);
    return;
  }
  for (int j = 1; j <= n; ++j) {
    samlp_single::grid_sum(o.dw_part + l.dw_off[j] * gridDim.x,
                           static_cast<size_t>(st.p[j - 1]) * st.p[j],
                           st.c[j - 1], st.c[j], st.p[j], grads.dw[j - 1]);
    samlp_single::grid_sum(o.part + l.db_off[j], l.db_off[n + 1], 1, st.c[j],
                           st.p[j], grads.db[j - 1]);
  }
}

template <bool kFinal>
cudaError_t launch(const Layout& l, int unit, int max_blocks,
                   cudaStream_t s, const Chain& st, const Outs& o,
                   float* sums, const Grads& grads) {
  return l.w_res ? samlp_single::launch_cooperative(
                       rc1_bwd_kernel<true, kFinal>, max_blocks, l.bytes, s,
                       st, l, unit, o, sums, grads)
                 : samlp_single::launch_cooperative(
                       rc1_bwd_kernel<false, kFinal>, max_blocks, l.bytes, s,
                       st, l, unit, o, sums, grads);
}

}  // namespace

// g2 [M, C0] bf16 (16-byte aligned); per layer j (arrays indexed from 0):
// width c_j, w packed bf16 [pad16(c_{j-1}), pad16(c_j)] (16-byte aligned),
// bias f32 [c_j], vec f32 [4, c_j] (scale, shift, mean, inv_std), mu f32
// [2, c_j] (sums / M of the stats passes; read above `level` only, may be
// null below); dout f32 and amax i32 [M/k, c_n]. level: 1-based. The plan
// (ops/kernels/samlp_single.py::bwd_plan): tm rows a tile (32, 64, 128),
// ring stages (2-4, or 0 with w_res: the weights resident), a_smem (else
// a_scratch [max_blocks, tm, p_1 + .. + p_{n-1}] f32), max_blocks (the
// most blocks the launch may take; it takes as many as the card holds at
// once), unit (the rows block ranges are cut at: a multiple of k with unit
// * c0 a multiple of 8) and the tile's nprod products, (layer, walk, span)
// each in sched.
// -> partials [max_blocks, 2, pad16(c_level)] (scratch), sums [2, c_level]
//    f32 (sum dy, sum dy * xhat at the level).
PAPC_EXPORT int papc_samlp_rc1_bwd_stats(
    const void* g2, int m, int c0, int k, int n_layers, int level,
    const int* widths, const void* const* w, const float* const* bias,
    const float* const* vec, const float* const* mu, const float* dout,
    const int* amax, int tm, int stages, int a_smem, int w_res,
    int max_blocks, int unit, const int* sched, int nprod,
    float* a_scratch, float* partials, float* sums, void* stream) {
  Chain st;
  if (!samlp_rc::make_chain(st, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            mu) ||
      level < 1 || level > n_layers)
    return cudaErrorInvalidValue;
  for (int j = level + 1; j <= n_layers; ++j)
    if (st.mu[j] == nullptr) return cudaErrorInvalidValue;
  if (!samlp_single::aligned16(st)) return cudaErrorMisalignedAddress;
  Layout l;
  if (!make_layout(l, st, tm, stages, 0, a_smem, w_res, kDwNone, level,
                   sched, nprod, false) ||
      !plan_ok(tm, stages, max_blocks, l) ||
      !samlp_single::unit_ok(st, unit) ||
      (!a_smem && l.a_row > 0 && a_scratch == nullptr))
    return cudaErrorInvalidValue;
  const Outs o{dout, amax, nullptr, a_scratch, nullptr, 0, partials, nullptr};
  return launch<false>(l, unit, max_blocks,
                       static_cast<cudaStream_t>(stream), st, o, sums,
                       Grads{});
}

// As papc_samlp_rc1_bwd_stats with every mu given (sched walking down to
// layer 1 exactly when dg is asked for), and the plan's dW mode (1 in
// shared memory, 2 a slot a block). Scratch: db_part [max_blocks, p_1 +
// .. + p_n] f32; dw_part: layer j's [max_blocks, p_{j-1}, p_j] f32 one
// after the other. -> db[j] [c_j], dw[j] [c_{j-1}, c_j] f32 per layer,
// and dg [M, C0] f32 when dg is not null.
PAPC_EXPORT int papc_samlp_rc1_bwd_final(
    const void* g2, int m, int c0, int k, int n_layers, const int* widths,
    const void* const* w, const float* const* bias, const float* const* vec,
    const float* const* mu, const float* dout, const int* amax, int tm,
    int stages, int a_smem, int w_res, int dw_mode, int max_blocks,
    int unit, const int* sched, int nprod, float* a_scratch, float* db_part,
    float* dw_part, float* const* db, float* const* dw, float* dg,
    void* stream) {
  Chain st;
  if (!samlp_rc::make_chain(st, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            mu) ||
      (dw_mode != kDwSmem && dw_mode != kDwSlot))
    return cudaErrorInvalidValue;
  for (int j = 1; j <= n_layers; ++j)
    if (st.mu[j] == nullptr) return cudaErrorInvalidValue;
  if (!samlp_single::aligned16(st)) return cudaErrorMisalignedAddress;
  Layout l;
  const bool walk_to_1 =
      nprod > 0 && sched != nullptr && sched[3 * (nprod - 1)] == 1 &&
      sched[3 * (nprod - 1) + 1] == 1;
  if (walk_to_1 != (dg != nullptr) ||
      !make_layout(l, st, tm, stages, 1, a_smem, w_res, dw_mode, 0, sched,
                   nprod, dg != nullptr) ||
      !plan_ok(tm, stages, max_blocks, l) ||
      !samlp_single::unit_ok(st, unit) ||
      (!a_smem && l.a_row > 0 && a_scratch == nullptr))
    return cudaErrorInvalidValue;
  Grads grads{};
  for (int j = 0; j < n_layers; ++j) {
    grads.db[j] = db[j];
    grads.dw[j] = dw[j];
  }
  const Outs o{dout, amax, dg, a_scratch, nullptr, 0, db_part, dw_part};
  return launch<true>(l, unit, max_blocks, static_cast<cudaStream_t>(stream),
                      st, o, nullptr, grads);
}
