// One training-backward layer pass of a set-abstraction MLP, walking down:
//   xhat = (a - mean) * inv_std
//   da   = scale * ((dy - s_in[0] / M) - (xhat * s_in[1]) / M)   (BN backward)
//   h    = a_prev (first layer) or max(a_prev * scale' + shift', 0)
//   dW   = bf16(h)^T . bf16(da),   db = sum of da (f32)
//   then, on a later layer, the gradient one layer down through its gate,
//   dy'  = (a_prev * scale' + shift' > 0) ? bf16(da) . bf16(W)^T : 0
//   stored bf16, with the previous BN's sums (sum dy', sum dy' * xhat');
//   on the first layer dg = bf16(da) . bf16(W)^T in f32, no gate.
//
// Replaces: papc_tpu/ops/pallas/samlp.py::bwd_layer (_bwd_layer_kernel).
// Numeric contract kept from it and from its twin fused_mlp._jnp_bwd_layer:
// da in f32, rounded to bf16 once and used by both products; f32
// accumulation, db and sums from the f32 values.
//
// What bounds it on the H100: the two products (the same FLOPs as the
// forward layer's, twice) and the bytes of dy, a and a_prev read and dy'
// written, 2 bytes a value.
//
// Design, in four steps on the stream:
// 1. da_kernel: one thread per (row slice, channel); writes bf16 da
//    [m_pad, cout_p] (zero in the padding, so the products need no masks)
//    and per-slice f32 partials of db. The affine, x-hat and da use the
//    _rn intrinsics, so da equals the plain version's before rounding.
// 2. dw_kernel: dW is a sum over all M rows (524288 in SA1). Each block
//    takes one 64 x 64 tile of [Cin, Cout] and one range of rows, stages
//    32 rows of h (affine + ReLU applied on the way in) and of da in shared
//    memory, and accumulates h^T . da on tensor cores (h read as a
//    column-major A operand). Its tile goes to dw_part[split]; a reduce
//    adds the splits in order.
// 3. dh_kernel (skipped when neither dy' nor dg is wanted): da . W^T over
//    tiles of 128 rows, operands read by the tensor-core loads straight
//    from device memory (W^T as a column-major B of the packed W); the
//    epilogue gates, stores and sums as in samlp_linear_stats.cu.
// 4. The fixed-order reduces of db, dW and the sums.
#include "samlp_train.cuh"

namespace {

using namespace nvcuda;
using samlp_train::affine;
using samlp_train::bf2f;

constexpr int kDwTile = 64;  // dW tile edge
constexpr int kDwRows = 32;  // rows staged per step
constexpr int kDwLd = kDwTile + 16;  // keeps every fragment 32-byte aligned

__global__ void da_kernel(const __nv_bfloat16* __restrict__ dy,
                          const __nv_bfloat16* __restrict__ a, int m,
                          int m_pad, int cout, int cout_p,
                          const float* __restrict__ vec,
                          const float* __restrict__ s_in, int slices,
                          __nv_bfloat16* __restrict__ da,
                          float* __restrict__ db_part) {
  const long long total = static_cast<long long>(slices) * cout_p;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float fm = static_cast<float>(m);
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += stride) {
    const int p = static_cast<int>(t / cout_p);
    const int ch = static_cast<int>(t - static_cast<long long>(p) * cout_p);
    float sum = 0.f;
    if (ch < cout) {
      const float scale = vec[ch], mean = vec[2 * cout + ch];
      const float inv_std = vec[3 * cout + ch];
      const float mu1 = __fdiv_rn(s_in[ch], fm), s2 = s_in[cout + ch];
      for (int r = p; r < m_pad; r += slices) {
        float v = 0.f;
        if (r < m) {
          const size_t i = static_cast<size_t>(r) * cout + ch;
          const float xhat = __fmul_rn(__fsub_rn(bf2f(a[i]), mean), inv_std);
          v = __fmul_rn(scale,
                        __fsub_rn(__fsub_rn(bf2f(dy[i]), mu1),
                                  __fdiv_rn(__fmul_rn(xhat, s2), fm)));
          sum += v;
        }
        da[static_cast<size_t>(r) * cout_p + ch] = __float2bfloat16_rn(v);
      }
    } else {
      for (int r = p; r < m_pad; r += slices)
        da[static_cast<size_t>(r) * cout_p + ch] = __float2bfloat16_rn(0.f);
    }
    db_part[static_cast<size_t>(p) * cout_p + ch] = sum;
  }
}

__global__ void __launch_bounds__(samlp_train::kWarps * 32)
    dw_kernel(const __nv_bfloat16* __restrict__ a_prev, int m, int cin,
              const float* __restrict__ vec_prev,
              const __nv_bfloat16* __restrict__ da, int cout_p,
              int rows_per_split, int cout_pp, int cin_pp,
              float* __restrict__ dw_part) {
  __shared__ __align__(128) __nv_bfloat16 hs[kDwRows * kDwLd];
  __shared__ __align__(128) __nv_bfloat16 ds[kDwRows * kDwLd];
  const int tiles_c = cout_pp / kDwTile;
  const int tr = blockIdx.x / tiles_c, tc = blockIdx.x - tr * tiles_c;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;  // 4 x 16 Cin rows, 2 x 32 Cout
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int r0 = r_begin; r0 < r_end; r0 += kDwRows) {
    __syncthreads();
    for (int e = threadIdx.x; e < kDwRows * kDwTile; e += blockDim.x) {
      const int rr = e / kDwTile, cc = e - rr * kDwTile;
      const int row = r0 + rr;
      const int ci = tr * kDwTile + cc, co = tc * kDwTile + cc;
      float h = 0.f;
      __nv_bfloat16 d = __float2bfloat16_rn(0.f);
      if (row < r_end) {
        if (ci < cin) {
          h = bf2f(a_prev[static_cast<size_t>(row) * cin + ci]);
          if (vec_prev != nullptr) {
            h = affine(h, vec_prev[ci], vec_prev[cin + ci]);
            h = h > 0.f ? h : 0.f;
          }
        }
        if (co < cout_p) d = da[static_cast<size_t>(row) * cout_p + co];
      }
      hs[rr * kDwLd + cc] = __float2bfloat16_rn(h);
      ds[rr * kDwLd + cc] = d;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDwRows; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          af;  // h^T: element (cin i, row j) at hs[j][i]
      wmma::load_matrix_sync(af, hs + kk * kDwLd + wr * 16, kDwLd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(bf, ds + kk * kDwLd + wc * 32 + j * 16, kDwLd);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
  }
  float* out = dw_part +
               (static_cast<size_t>(split) * cin_pp + tr * kDwTile + wr * 16) *
                   cout_pp +
               tc * kDwTile + wc * 32;
  wmma::store_matrix_sync(out, acc[0], cout_pp, wmma::mem_row_major);
  wmma::store_matrix_sync(out + 16, acc[1], cout_pp, wmma::mem_row_major);
}

__global__ void __launch_bounds__(samlp_train::kWarps * 32)
    dh_kernel(const __nv_bfloat16* __restrict__ da, int m, int cout_p,
              const __nv_bfloat16* __restrict__ w, int cin, int cin_p,
              const __nv_bfloat16* __restrict__ a_prev,
              const float* __restrict__ vec_prev, int tm,
              __nv_bfloat16* __restrict__ dy_prev, float* __restrict__ dg,
              float* __restrict__ s_part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);
  float* colsum = scratch + samlp_train::kWarps * 256;
  const bool gate = vec_prev != nullptr;
  const int row_blocks = tm / samlp_train::kUnitRows;
  if (gate)
    for (int e = threadIdx.x; e < row_blocks * 2 * cin_p; e += blockDim.x)
      colsum[e] = 0.f;
  __syncthreads();
  const int tiles = (m + tm - 1) / tm;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * tm;
    samlp_train::rows_times_matrix<true>(
        da + static_cast<size_t>(row0) * cout_p, cout_p, cout_p, w, cout_p,
        cin_p, row_blocks, scratch, gate ? colsum : nullptr,
        [&](int rl, int col, float acc) {
          const int row = row0 + rl;
          if (row >= m || col >= cin) return make_float2(0.f, 0.f);
          const size_t i = static_cast<size_t>(row) * cin + col;
          if (!gate) {
            dg[i] = acc;
            return make_float2(0.f, 0.f);
          }
          const float ap = bf2f(a_prev[i]);
          const float v =
              affine(ap, vec_prev[col], vec_prev[cin + col]) > 0.f ? acc : 0.f;
          dy_prev[i] = __float2bfloat16_rn(v);
          const float xhat = __fmul_rn(__fsub_rn(ap, vec_prev[2 * cin + col]),
                                       vec_prev[3 * cin + col]);
          return make_float2(v, __fmul_rn(v, xhat));
        });
  }
  if (gate) {
    __syncthreads();
    samlp_train::write_block_sums(colsum, row_blocks, cin_p, s_part);
  }
}

int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  return static_cast<int>(blocks > 132 * 64 ? 132 * 64 : blocks);
}

}  // namespace

// dy, a [M, Cout] bf16; a_prev [M, Cin] bf16 (the previous pre-activation,
// or the block input on the first layer); w bf16 [cin_p, cout_p] packed
// (zero-padded to multiples of 16); vec f32 [4, Cout] (scale, shift, mean,
// inv_std); s_in f32 [2, Cout]; vec_prev f32 [4, Cin] or null on the
// first layer. Plan (see ops/kernels/samlp_train.py::bwd_layer_plan):
// m_pad = rows rounded up to tm, slices, splits x rows_per_split (a
// multiple of 32) >= M, tm (a multiple of 64), blocks of the dh product.
// Scratch: da [m_pad, cout_p] bf16, db_part [slices, cout_p],
// dw_part [splits, cin_pp, cout_pp] (64-multiples), s_part [blocks, 2, cin_p].
// -> dw [Cin, Cout], db [Cout] f32; and dy_prev [M, Cin] bf16 with s_prev
// [2, Cin] (vec_prev given), or dg [M, Cin] f32 (first layer), or neither.
PAPC_EXPORT int papc_samlp_bwd_layer(
    const void* dy, const void* a, const void* a_prev, int m, int m_pad,
    int cin, int cout, const void* w, int cin_p, int cout_p, const float* vec,
    const float* s_in, const float* vec_prev, int slices, int splits,
    int rows_per_split, int tm, int blocks, void* da, float* db_part,
    float* dw_part, float* s_part, float* dw, float* db, void* dy_prev,
    float* dg, float* s_prev, void* stream) {
  const int cin_pp = (cin + kDwTile - 1) / kDwTile * kDwTile;
  const int cout_pp = (cout + kDwTile - 1) / kDwTile * kDwTile;
  if (m <= 0 || cin <= 0 || cout <= 0 || cin_p % 16 != 0 ||
      cout_p % 16 != 0 || cin_p < cin || cout_p < cout || tm <= 0 ||
      tm % samlp_train::kUnitRows != 0 || m_pad < m || m_pad % tm != 0 ||
      slices <= 0 || splits <= 0 || rows_per_split % kDwRows != 0 ||
      static_cast<long long>(splits) * rows_per_split < m || blocks <= 0 ||
      (vec_prev != nullptr && dg != nullptr) ||
      (vec_prev == nullptr && dy_prev != nullptr) ||
      ((dy_prev == nullptr) != (s_prev == nullptr)))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* dy_b = static_cast<const __nv_bfloat16*>(dy);
  const auto* a_b = static_cast<const __nv_bfloat16*>(a);
  const auto* ap_b = static_cast<const __nv_bfloat16*>(a_prev);
  const auto* w_b = static_cast<const __nv_bfloat16*>(w);
  auto* da_b = static_cast<__nv_bfloat16*>(da);

  cudaError_t err = papc_launch(
      da_kernel, dim3(grid_for(static_cast<long long>(slices) * cout_p, 256)),
      dim3(256), 0, s, dy_b, a_b, m, m_pad, cout, cout_p, vec, s_in, slices,
      da_b, db_part);
  if (err != cudaSuccess) return err;
  const int tiles = (cin_pp / kDwTile) * (cout_pp / kDwTile);
  err = papc_launch(dw_kernel, dim3(tiles, splits),
                    dim3(samlp_train::kWarps * 32), 0, s, ap_b, m, cin,
                    vec_prev, static_cast<const __nv_bfloat16*>(da_b), cout_p,
                    rows_per_split, cout_pp, cin_pp, dw_part);
  if (err != cudaSuccess) return err;
  err = samlp_train::reduce_partials(dw_part, splits, cin, cout, cin_pp,
                                     cout_pp, dw, s);
  if (err != cudaSuccess) return err;
  err = samlp_train::reduce_partials(db_part, slices, 1, cout, 1, cout_p, db,
                                     s);
  if (err != cudaSuccess) return err;
  if (dy_prev == nullptr && dg == nullptr) return cudaSuccess;
  const bool gate = vec_prev != nullptr;
  const size_t smem =
      samlp_train::kWarps * 256 * sizeof(float) +
      (gate ? static_cast<size_t>(tm / samlp_train::kUnitRows) * 2 * cin_p *
                  sizeof(float)
            : 0);
  err = papc_launch(dh_kernel, dim3(blocks), dim3(samlp_train::kWarps * 32),
                    smem, s, static_cast<const __nv_bfloat16*>(da_b), m,
                    cout_p, w_b, cin, cin_p, ap_b, vec_prev, tm,
                    static_cast<__nv_bfloat16*>(dy_prev), dg, s_part);
  if (err != cudaSuccess || !gate) return err;
  return samlp_train::reduce_partials(s_part, blocks, 2, cin, 2, cin_p,
                                      s_prev, s);
}
