// The two forward passes of a recompute-mode training set-abstraction MLP:
//   stats (layer l): re-derive a_1 .. a_l from g2 with the l-1 BN affines
//     already known and return (sum a_l, sum a_l^2) per column, of the f32
//     a_l, over every row;
//   final: the whole chain, the last BN + ReLU and the max over each group
//     of k rows with its first argmax: out [M/k, C] f32, amax [M/k, C] i32.
//
// Replaces: papc_tpu/ops/pallas/samlp.py::recompute_stats (_rc_stats_kernel,
// #11) and ::recompute_final_max (_rc_final_kernel, #12), the forward of
// fused_mlp's "recompute" mode. Numeric contract kept from them and their
// twins (fused_mlp._jnp_rc_stats, _jnp_rc_final; here
// ops/kernels/samlp_recompute.py::rc_stats_plain, rc_final_plain): bf16
// operands, f32 accumulation, f32 bias, affine and ReLU, no pre-activation
// rounded; a = acc + b, the affine and the bf16 rounding of h use the _rn
// intrinsics op for op as the plain version.
//
// What bounds them on the H100: the tensor-core products, which every pass
// repeats from layer 1 (SSG clas at B = 32: chip_smoke.py's _rc_work, 0.116
// ms of stats and 0.071 ms of final a step); device memory sees only g2
// (6 B a row at SA1), the weights and the outputs.
//
// Design: the forward tile loop of samlp_rc_fwd.cuh (fwd_tiles, shared
// with #15 / #16), walked as a grid:
//  - Persistent blocks of 8 warps walk row tiles b, b + grid, ... of tm =
//    128, 64 or 32 rows (the plan, ops/kernels/samlp_recompute.py::
//    fwd_plan: the largest that fits and still gives every SM a tile),
//    two blocks an SM where there are more tiles than SMs and shared
//    memory holds two (on the H100 at SSG SA1 and SA2: 28-38 % less
//    device time than one block an SM with the weights resident; one
//    block of 8 warps leaves every phase of a tile waiting on latency).
//  - Stats: the block's partials are written in block order and one
//    split_reduce launch adds them in order, so repeated runs give the
//    same bits (two launches a call).
//  - Final: where a tile holds whole groups (k divides tm: every SA1 and
//    SA2 stack of the registry) the tile writes out and amax itself: one
//    launch a call, no device key buffer. Where a group spans tiles (the
//    group_all SA3 stacks, 32-row tiles at k = 128) or k does not divide
//    tm, the grid gives one group to several blocks: each tile writes its
//    pooled keys to its own slot of a device buffer (no fill needed) and
//    rc_key_merge_kernel takes each group's max over its tiles and splits
//    it: two launches.
#include "samlp_rc_fwd.cuh"

namespace {

using samlp_rc::Chain;
using samlp_rcb::kThreads;
using samlp_rcf::Fwd;
using samlp_rcf::FwdOuts;
using samlp_rcf::make_fwd_layout;
using u64 = unsigned long long;

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Both kernels are compiled for two blocks an SM (at most 128 registers a
// thread, no spills): where the plan runs one block an SM (SSG SA3), that
// build measured as fast on the H100 as one for a single block (143-145
// registers).

// The block's tiles of the grid walk: b, b + grid, ... of M.
__device__ __forceinline__ int grid_tiles(const Chain& st, int tm) {
  const int all_tiles = (st.m + tm - 1) / tm;
  return (all_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
         gridDim.x;
}

// #11: the block's partials [block][2][p_n], its row warps' sums in order.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
    rc_fwd_stats_kernel(Chain st, Fwd f, FwdOuts o) {
  extern __shared__ __align__(128) unsigned char smem[];
  samlp_rcf::fwd_prologue<false, kResident>(st, f, smem);
  samlp_rcf::fwd_tiles<false, kResident>(st, f, o, smem, blockIdx.x * f.l.tm,
                                         gridDim.x * f.l.tm,
                                         grid_tiles(st, f.l.tm), st.m);
  samlp_rcf::write_fwd_partials(st, f, smem, o.part);
}

// #12: out and amax, or every tile's keys for rc_key_merge_kernel.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
    rc_fwd_final_kernel(Chain st, Fwd f, FwdOuts o) {
  extern __shared__ __align__(128) unsigned char smem[];
  samlp_rcf::fwd_prologue<true, kResident>(st, f, smem);
  samlp_rcf::fwd_tiles<true, kResident>(st, f, o, smem, blockIdx.x * f.l.tm,
                                        gridDim.x * f.l.tm,
                                        grid_tiles(st, f.l.tm), st.m);
}

// Each group's key: the max over the tiles that touch it (tile t's slot
// g - t * tm / k), split into out and amax.
__global__ void rc_key_merge_kernel(const u64* __restrict__ keys, int m,
                                    int k, int tm, int gpt, int c,
                                    float* __restrict__ out,
                                    int* __restrict__ amax) {
  const long long total = static_cast<long long>(m / k) * c;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(e / c), col = static_cast<int>(e % c);
    const long long r0 = static_cast<long long>(g) * k;
    const int t0 = static_cast<int>(r0 / tm);
    const int t1 = static_cast<int>((r0 + k - 1) / tm);
    u64 v = 0ull;
    for (int t = t0; t <= t1; ++t) {
      const int slot = g - static_cast<int>(static_cast<long long>(t) * tm / k);
      v = samlp_rcf::key_max(
          v, keys[(static_cast<size_t>(t) * gpt + slot) * c + col]);
    }
    out[e] = __uint_as_float(static_cast<unsigned>(v >> 32));
    amax[e] = k - 1 - static_cast<int>(v & 0xffffffffull);
  }
}

// The common checks of both entries: g2 on 16 bytes, the layout of the
// plan and a grid the kernels take.
bool fwd_ok(const void* g2, const Fwd& f, bool laid, int blocks) {
  return laid && aligned16(g2) &&
         samlp_rcb::plan_ok(f.l.tm, f.l.stages, blocks, f.l);
}

}  // namespace

// g2 [M, C0] bf16, 16-byte aligned; per layer j < n_layers (arrays indexed
// from 0): width c_j, w packed bf16 [pad16(c_{j-1}), pad16(c_j)], bias f32
// [c_j], vec f32 rows (scale, shift, ...) x c_j (read for the layers below
// upto only). upto: the layer whose sums are wanted (1-based). The plan
// (ops/kernels/samlp_recompute.py::fwd_plan): tm rows a tile (32, 64,
// 128), ring stages (2-4) or w_res (stages 0), blocks (the grid, which
// fixes the order of the sums) and the tile's nprod products, (layer,
// walk, span) each in sched.
// -> partials [blocks, 2, pad16(c_upto)] (scratch), sums [2, c_upto] f32.
PAPC_EXPORT int papc_samlp_rc_stats(const void* g2, int m, int c0,
                                    int n_layers, int upto,
                                    const int* widths, const void* const* w,
                                    const float* const* bias,
                                    const float* const* vec, int tm,
                                    int stages, int w_res, int blocks,
                                    const int* sched, int nprod,
                                    float* partials, float* sums,
                                    void* stream) {
  Chain st;
  if (!samlp_rc::make_chain(st, g2, m, 1, c0, n_layers, widths, w, bias, vec,
                            nullptr) ||
      upto < 1 || upto > n_layers)
    return cudaErrorInvalidValue;
  st.n = upto;  // the chain up to the level
  Fwd f;
  const bool laid = make_fwd_layout(f, st, false, tm, stages, w_res, sched,
                                    nprod);
  if (!fwd_ok(g2, f, laid, blocks)) return cudaErrorInvalidValue;
  const FwdOuts o{partials, nullptr, nullptr, nullptr};
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = papc_launch(
      w_res ? rc_fwd_stats_kernel<true> : rc_fwd_stats_kernel<false>,
      dim3(blocks), dim3(kThreads), f.l.bytes, s, st, f, o);
  if (err != cudaSuccess) return err;
  const samlp_train::SplitSum job{partials, blocks, 2,      st.p[upto],
                                  2,        st.c[upto], sums};
  return samlp_train::split_reduce(&job, 1, 32, s);
}

// As papc_samlp_rc_stats, every layer's vec read (rows scale, shift), and
// k the group size (M a multiple of k). keys: u64 [tiles, gpt, c_last]
// scratch where the plan's tiles do not hold whole groups (k does not
// divide tm), else unused; gpt (fwd_plan's "gpt") = tm / k where k
// divides tm, 1 where tm divides k, else ceil(tm / k) + 1.
// -> out [M/k, c_last] f32 (the max), amax [M/k, c_last] i32 (the first
// row of the group that attains it).
PAPC_EXPORT int papc_samlp_rc_final(const void* g2, int m, int c0, int k,
                                    int n_layers, const int* widths,
                                    const void* const* w,
                                    const float* const* bias,
                                    const float* const* vec, int tm,
                                    int stages, int w_res, int blocks,
                                    const int* sched, int nprod, void* keys,
                                    float* out, int* amax, void* stream) {
  Chain st;
  if (!samlp_rc::make_chain(st, g2, m, k, c0, n_layers, widths, w, bias, vec,
                            nullptr))
    return cudaErrorInvalidValue;
  Fwd f;
  const bool laid = make_fwd_layout(f, st, true, tm, stages, w_res, sched,
                                    nprod);
  if (!fwd_ok(g2, f, laid, blocks) || (!f.whole && keys == nullptr))
    return cudaErrorInvalidValue;
  // whole groups: every group written from its tile, no key slots
  const FwdOuts o{nullptr, out, amax,
                  f.whole ? nullptr : static_cast<u64*>(keys)};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = papc_launch(
      w_res ? rc_fwd_final_kernel<true> : rc_fwd_final_kernel<false>,
      dim3(blocks), dim3(kThreads), f.l.bytes, s, st, f, o);
  if (err != cudaSuccess || f.whole) return err;
  const long long total = static_cast<long long>(m / k) * st.c[n_layers];
  long long grid = (total + 255) / 256;
  if (grid > 132 * 16) grid = 132 * 16;
  return papc_launch(rc_key_merge_kernel, dim3(static_cast<int>(grid)),
                     dim3(256), 0, s, static_cast<const u64*>(keys), m, k, tm,
                     f.gpt, st.c[n_layers], out, amax);
}
