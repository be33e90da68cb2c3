// C entries of the two backward passes of a recompute-mode training
// set-abstraction MLP: #13 (papc_samlp_rc_bwd_stats, replacing
// papc_tpu/ops/pallas/samlp.py::recompute_bwd_stats) and #14
// (papc_samlp_rc_bwd_final, replacing ::recompute_bwd_final). The design,
// the kernels and their tile body are in samlp_rc_bwd.cuh.

#include "samlp_rc_bwd.cuh"

namespace {

using namespace samlp_rcb;
using samlp_rc::make_chain;
using samlp_train::SplitSum;

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// g2 [M, C0] bf16, 16-byte aligned; per layer j (arrays indexed from 0):
// width c_j, w packed bf16 [pad16(c_{j-1}), pad16(c_j)], bias f32 [c_j],
// vec f32 [4, c_j] (scale, shift, mean, inv_std), mu f32 [2, c_j] (sums /
// M of the stats passes; read above `level` only, may be null below);
// dout f32 and amax i32 [M/k, c_n]. level: 1-based. The plan
// (ops/kernels/samlp_recompute.py::bwd_plan): tm rows a tile (32, 64,
// 128), ring stages (2-4), a_smem (else a_scratch [blocks, tm, p_1 + ..
// + p_{n-1}] f32), blocks (the grid, which fixes the order of the sums),
// and the tile's nprod products, (layer, walk, span) each in sched.
// -> partials [blocks, 2, pad16(c_level)] (scratch), sums [2, c_level]
//    f32 (sum dy, sum dy * xhat at the level).
PAPC_EXPORT int papc_samlp_rc_bwd_stats(
    const void* g2, int m, int c0, int k, int n_layers, int level,
    const int* widths, const void* const* w, const float* const* bias,
    const float* const* vec, const float* const* mu, const float* dout,
    const int* amax, int tm, int stages, int a_smem, int blocks,
    const int* sched, int nprod, float* a_scratch, float* partials,
    float* sums, void* stream) {
  Chain st;
  if (!make_chain(st, g2, m, k, c0, n_layers, widths, w, bias, vec, mu) ||
      !aligned16(g2) || level < 1 || level > n_layers)
    return cudaErrorInvalidValue;
  for (int j = level + 1; j <= n_layers; ++j)
    if (st.mu[j] == nullptr) return cudaErrorInvalidValue;
  Layout l;
  if (!make_layout(l, st, tm, stages, 0, a_smem, 0, kDwNone, level, sched,
                   nprod, false) ||
      !plan_ok(tm, stages, blocks, l) ||
      (!a_smem && l.a_row > 0 && a_scratch == nullptr))
    return cudaErrorInvalidValue;
  Outs o{dout, amax, nullptr, a_scratch, nullptr, 0, partials, nullptr};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = papc_launch(rc_bwd_kernel<false>, dim3(blocks),
                                dim3(kThreads), l.bytes, s, st, l, o);
  if (err != cudaSuccess) return err;
  const SplitSum job{partials, blocks, 2, st.p[level], 2, st.c[level], sums};
  return samlp_train::split_reduce(&job, 1, 32, s);
}

// As papc_samlp_rc_bwd_stats with every mu given (sched walking down to
// layer 1 exactly when dg is asked for), and the plan's dW mode
// (1 on chip, 2 a slot a block, 3 from the rows) and, for mode 3,
// dw_splits of the rows. Scratch: db_part [blocks, p_1 + .. + p_n] f32;
// dw_part: layer j's [parts, p_{j-1}, p_j] f32 one after the other
// (parts: blocks, or dw_splits in mode 3); rows (mode 3): bf16 [m_pad,
// p_0 + .. + p_{n-1}] then [m_pad, p_1 + .. + p_n], m_pad = the tiles'
// rows. -> db[j] [c_j], dw[j] [c_{j-1}, c_j] f32 per layer, and dg [M, C0]
// f32 when dg is not null.
PAPC_EXPORT int papc_samlp_rc_bwd_final(
    const void* g2, int m, int c0, int k, int n_layers, const int* widths,
    const void* const* w, const float* const* bias, const float* const* vec,
    const float* const* mu, const float* dout, const int* amax, int tm,
    int stages, int a_smem, int dw_mode, int blocks, int dw_splits,
    const int* sched, int nprod, float* a_scratch, void* rows,
    float* db_part, float* dw_part, float* const* db, float* const* dw,
    float* dg, void* stream) {
  Chain st;
  if (!make_chain(st, g2, m, k, c0, n_layers, widths, w, bias, vec, mu) ||
      !aligned16(g2) || dw_mode < kDwSmem || dw_mode > kDwRows)
    return cudaErrorInvalidValue;
  for (int j = 1; j <= n_layers; ++j)
    if (st.mu[j] == nullptr) return cudaErrorInvalidValue;
  Layout l;
  const bool walk_to_1 =
      nprod > 0 && sched != nullptr && sched[3 * (nprod - 1)] == 1 &&
      sched[3 * (nprod - 1) + 1] == 1;
  if (walk_to_1 != (dg != nullptr) ||
      !make_layout(l, st, tm, stages, dw_mode != kDwRows, a_smem, 0,
                   dw_mode, 0, sched, nprod, dg != nullptr))
    return cudaErrorInvalidValue;
  const int tiles = (m + tm - 1) / tm;
  const int m_pad = tiles * tm;
  const int rows_per_split = dw_splits > 0
                                 ? (m_pad / kDwChunk + dw_splits - 1) /
                                       dw_splits * kDwChunk
                                 : 0;
  if (!plan_ok(tm, stages, blocks, l) ||
      (!a_smem && l.a_row > 0 && a_scratch == nullptr) ||
      (dw_mode == kDwRows &&
       (rows == nullptr || dw_splits <= 0 ||
        static_cast<long long>(dw_splits - 1) * rows_per_split >= m_pad)))
    return cudaErrorInvalidValue;
  Outs o{dout, amax, dg, a_scratch, static_cast<bf16*>(rows), m_pad,
         db_part, dw_part};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = papc_launch(rc_bwd_kernel<true>, dim3(blocks),
                                dim3(kThreads), l.bytes, s, st, l, o);
  if (err != cudaSuccess) return err;
  const int parts = dw_mode == kDwRows ? dw_splits : blocks;
  if (dw_mode == kDwRows) {
    DwRows a{};
    a.n = n_layers;
    a.rows_per_split = rows_per_split;
    a.m_pad = m_pad;
    size_t h_off = 0, d_off = 0;
    for (int i = 0; i < n_layers; ++i)
      d_off += static_cast<size_t>(m_pad) * st.p[i];
    for (int j = 1; j <= n_layers; ++j) {
      a.h[j - 1] = static_cast<const bf16*>(rows) + h_off;
      a.da[j - 1] = static_cast<const bf16*>(rows) + d_off;
      a.part[j - 1] = dw_part + l.dw_off[j] * parts;
      a.cin_p[j - 1] = st.p[j - 1];
      a.cout_p[j - 1] = st.p[j];
      a.first[j] = a.first[j - 1] + ((st.p[j - 1] + kDwTm - 1) / kDwTm) *
                                        ((st.p[j] + kDwTn - 1) / kDwTn);
      h_off += static_cast<size_t>(m_pad) * st.p[j - 1];
      d_off += static_cast<size_t>(m_pad) * st.p[j];
    }
    err = papc_launch(rc_dw_rows_kernel, dim3(a.first[n_layers], dw_splits),
                      dim3(kThreads), kDwStages * kDwStage * 2, s, a);
    if (err != cudaSuccess) return err;
  }
  SplitSum jobs[2 * kMaxLayers];
  for (int j = 1; j <= n_layers; ++j) {
    jobs[j - 1] = {dw_part + l.dw_off[j] * parts, parts, st.p[j - 1],
                   st.p[j], st.c[j - 1], st.c[j], dw[j - 1]};
    jobs[n_layers + j - 1] = {db_part + l.db_off[j], blocks, 1,
                              l.db_off[n_layers + 1], 1, st.c[j], db[j - 1]};
  }
  // 8 lanes a column: the dW jobs have only a few split partials
  return samlp_train::split_reduce(jobs, 2 * n_layers, 8, s);
}
