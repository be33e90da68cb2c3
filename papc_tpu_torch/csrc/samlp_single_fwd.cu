// The two forward passes of fused_mlp's "recompute1" mode, each ONE
// cooperative launch:
//   stats (layer l): re-derive a_1 .. a_l from g2 with the l-1 BN affines
//     already known and return (sum a_l, sum a_l^2) per column, of the f32
//     a_l, over every row;
//   final: the whole chain, the last BN + ReLU and the max over each group
//     of k rows with its first argmax: out [M/k, C] f32, amax [M/k, C] i32.
//
// Replaces: papc_tpu/ops/pallas/samlp_single.py::recompute_stats (#15) and
// ::recompute_final_max (#16). Same arithmetic as the grid passes #11 and
// #12 (samlp_rc_fwd.cu), on their tile loop: bf16 operands, f32
// accumulation, f32 bias, affine and ReLU, no pre-activation rounded; a =
// acc + b, the affine and the bf16 rounding of h use the _rn intrinsics op
// for op as the plain version. #16's out and amax equal #12's bit for bit.
//
// What bounds them on the H100: the tensor-core products, which every pass
// repeats from layer 1; device memory sees g2 once (6 B a row at SSG SA1),
// the weights once a block (resident) or once a tile (ring), and the
// outputs.
//
// Design: the forward tile loop of samlp_rc_fwd.cuh (fwd_tiles, on the
// mma.sync core of samlp_mma.cuh), walked over one contiguous range of
// rows a block, as #17 / #18 walk bwd_tiles:
//  - The grid is as many persistent blocks of 8 warps as the card holds at
//    once (samlp_single::launch_cooperative), at most the plan's (two an SM
//    where there are more units than SMs and shared memory holds two).
//    Block b takes the rows samlp_single::block_rows gives it, cut at the
//    plan's unit (stats: 8 rows, so every tile's g2 rows start on 16
//    bytes; final: samlp_single::range_unit, whole groups that start on 16
//    bytes), in tiles of tm = 128, 64 or 32 rows from its start (the plan,
//    ops/kernels/samlp_single.py::fwd_plan, on #11 / #12's layout and
//    candidates: the weights resident where the block's range holds
//    several tiles, else #11 / #12's ring).
//  - Rows from the range's end on belong to the next block: the tile loop
//    masks them (no sum, no group written).
//  - Stats: each block adds its rows' a and a^2 from registers into
//    per-row-warp sums in shared memory across its tiles and writes one
//    partial row in block order; after this_grid().sync() the same launch
//    adds the partials element by element in block order
//    (samlp_single::grid_sum): one launch a call, no reduce launch, the
//    same bits every run.
//  - Final: the max and its first argmax are pooled on chip as 64-bit keys
//    (registers, shuffles, one shared-memory atomicMax a column and group a
//    row warp), and each tile writes out and amax of the groups it
//    completes. A range never splits a group, so where a group runs on
//    into the block's next tile (k does not divide tm, or k > tm) its keys
//    stay in shared memory: no device key buffer, no merge launch.
#include "samlp_rc_fwd.cuh"
#include "samlp_single.cuh"

namespace {

namespace cg = cooperative_groups;
using samlp_rc::Chain;
using samlp_rcb::kThreads;
using samlp_rcf::Fwd;
using samlp_rcf::FwdOuts;

// Both kernels are compiled for two blocks an SM, as #11 / #12.

// #15: the block's partials o.part [block][2][p_n], then, after the grid
// barrier, sums [2, c_n] added in block order.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
    rc1_fwd_stats_kernel(Chain st, Fwd f, int unit, FwdOuts o,
                         float* __restrict__ sums) {
  extern __shared__ __align__(128) unsigned char smem[];
  samlp_rcf::fwd_prologue<false, kResident>(st, f, smem);
  int begin, end;
  const int tiles =
      samlp_single::block_tiles(st.m, unit, f.l.tm, begin, end);
  samlp_rcf::fwd_tiles<false, kResident>(st, f, o, smem, begin, f.l.tm,
                                         tiles, end);
  samlp_rcf::write_fwd_partials(st, f, smem, o.part);
  cg::this_grid().sync();
  const int pn = st.p[st.n];
  samlp_single::grid_sum(o.part, 2 * static_cast<size_t>(pn), 2,
                         st.c[st.n], pn, sums);
}

// #16: out and amax of every group, each written by the block whose range
// holds it.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
    rc1_fwd_final_kernel(Chain st, Fwd f, int unit, FwdOuts o) {
  extern __shared__ __align__(128) unsigned char smem[];
  samlp_rcf::fwd_prologue<true, kResident>(st, f, smem);
  int begin, end;
  const int tiles =
      samlp_single::block_tiles(st.m, unit, f.l.tm, begin, end);
  samlp_rcf::fwd_tiles<true, kResident>(st, f, o, smem, begin, f.l.tm, tiles,
                                        end);
}

// The common checks of both entries: the chain's operands on 16 bytes,
// the layout of the plan, a grid the kernels take, and a unit of whole
// groups whose g2 rows start on 16 bytes (so ranges also start on 8 rows
// where k is a multiple of 8, as the tile loop's 8-row key merge needs).
cudaError_t fwd_checks(const Chain& st, const Fwd& f, bool laid,
                       int max_blocks, int unit) {
  if (!samlp_single::aligned16(st)) return cudaErrorMisalignedAddress;
  return laid && samlp_single::unit_ok(st, unit) &&
                 samlp_rcb::plan_ok(f.l.tm, f.l.stages, max_blocks, f.l)
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace

// g2 [M, C0] bf16 (16-byte aligned); per layer j < n_layers (arrays indexed
// from 0): width c_j, w packed bf16 [pad16(c_{j-1}), pad16(c_j)] (16-byte
// aligned), bias f32 [c_j], vec f32 rows (scale, shift, ...) x c_j (read for
// the layers below upto only). upto: the layer whose sums are wanted
// (1-based). The plan (ops/kernels/samlp_single.py::fwd_plan): tm rows a
// tile (32, 64, 128), ring stages (2-4) or w_res (stages 0), max_blocks
// (the most blocks the launch may take; it takes as many as the card holds
// at once), unit (the rows block ranges are cut at: a multiple of 8 rows)
// and the tile's nprod products, (layer, walk, span) each in sched.
// -> partials [max_blocks, 2, pad16(c_upto)] (scratch), sums [2, c_upto].
PAPC_EXPORT int papc_samlp_rc1_stats(const void* g2, int m, int c0,
                                     int n_layers, int upto,
                                     const int* widths, const void* const* w,
                                     const float* const* bias,
                                     const float* const* vec, int tm,
                                     int stages, int w_res, int max_blocks,
                                     int unit, const int* sched, int nprod,
                                     float* partials, float* sums,
                                     void* stream) {
  Chain st;
  if (!samlp_rc::make_chain(st, g2, m, 1, c0, n_layers, widths, w, bias, vec,
                            nullptr) ||
      upto < 1 || upto > n_layers)
    return cudaErrorInvalidValue;
  st.n = upto;  // the chain up to the level
  Fwd f;
  const bool laid = samlp_rcf::make_fwd_layout(f, st, false, tm, stages,
                                               w_res, sched, nprod);
  const cudaError_t bad = fwd_checks(st, f, laid, max_blocks, unit);
  if (bad != cudaSuccess) return bad;
  const FwdOuts o{partials, nullptr, nullptr, nullptr};
  const auto s = static_cast<cudaStream_t>(stream);
  return w_res ? samlp_single::launch_cooperative(
                     rc1_fwd_stats_kernel<true>, max_blocks, f.l.bytes, s, st,
                     f, unit, o, sums)
               : samlp_single::launch_cooperative(
                     rc1_fwd_stats_kernel<false>, max_blocks, f.l.bytes, s,
                     st, f, unit, o, sums);
}

// As papc_samlp_rc1_stats, every layer's vec read (rows scale, shift), k
// the group size (M a multiple of k) and unit a multiple of k with unit *
// c0 a multiple of 8 (samlp_single.range_unit).
// -> out [M/k, c_last] f32 (the max), amax [M/k, c_last] i32 (the first
// row of the group that attains it).
PAPC_EXPORT int papc_samlp_rc1_final(const void* g2, int m, int c0, int k,
                                     int n_layers, const int* widths,
                                     const void* const* w,
                                     const float* const* bias,
                                     const float* const* vec, int tm,
                                     int stages, int w_res, int max_blocks,
                                     int unit, const int* sched, int nprod,
                                     float* out, int* amax, void* stream) {
  Chain st;
  if (!samlp_rc::make_chain(st, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            nullptr))
    return cudaErrorInvalidValue;
  Fwd f;
  const bool laid = samlp_rcf::make_fwd_layout(f, st, true, tm, stages,
                                               w_res, sched, nprod);
  const cudaError_t bad = fwd_checks(st, f, laid, max_blocks, unit);
  if (bad != cudaSuccess) return bad;
  const FwdOuts o{nullptr, out, amax, nullptr};  // groups carried on chip
  const auto s = static_cast<cudaStream_t>(stream);
  return w_res ? samlp_single::launch_cooperative(
                     rc1_fwd_final_kernel<true>, max_blocks, f.l.bytes, s, st,
                     f, unit, o)
               : samlp_single::launch_cooperative(
                     rc1_fwd_final_kernel<false>, max_blocks, f.l.bytes, s,
                     st, f, unit, o);
}
