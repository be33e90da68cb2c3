// Eval-mode set-abstraction MLP + max over each K-row group, fused:
//   h_0 = x;  h_l = max((bf16(h_{l-1}) . bf16(W_l) + b_l) * scale_l + shift_l, 0)
//   out[g, :] = max over the k rows of group g of h_L
// BatchNorm with running statistics is folded into (scale, shift).
//
// Replaces: papc_tpu/ops/pallas/samlp.py::eval_mlp_max (_eval_kernel),
// which runs the whole stack for a tile of rows in VMEM and writes only
// the pooled output. Numeric contract kept from it: the input and every
// hidden activation are rounded to bf16 as the next layer's operand,
// products accumulate in f32, bias, affine and ReLU are f32, and the max
// is over each group of k consecutive rows.
//
// What bounds it on the H100: the matrix products (SSG at B = 32: SA1
// 13 GFLOP, SA2 35 GFLOP, SA3 6 GFLOP). Device-memory traffic is only
// the input and the pooled output, because no activation leaves the SM.
//
// Design: one block of 8 warps takes a tile of TM rows (a multiple of 64
// and of k, so groups never straddle tiles). Activations stay in shared
// memory as bf16 (exact: they are rounded to bf16 for the next product
// anyway), in two ping-pong buffers. Each warp computes 64 x 16 output
// tiles with tensor-core bf16 MMAs (nvcuda::wmma, m16n16k16, f32
// accumulators), loading each weight fragment once for four row
// fragments; the weights are small and stay in L1/L2. The epilogue adds
// the bias, applies the affine and ReLU and either stores bf16 for the
// next layer or, for the last layer, folds the value into the group max
// with a shared-memory atomicMax on its bit pattern (ReLU output is >= +0,
// and non-negative floats order like their bits). Widest case, SSG SA3 at
// k = 128: buffers of 128 x 520 and 128 x 264 bf16 plus 12 KB, 213 KB of
// the 227 KB a block may opt into.
#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kMaxLayers = 4;
constexpr int kWarps = 8;
constexpr int kRowFrags = 4;  // 16-row fragments per warp work unit

struct MlpParams {
  int n_layers;
  int cin[kMaxLayers];   // padded to a multiple of 16
  int cout[kMaxLayers];  // padded to a multiple of 16
  const __nv_bfloat16* w[kMaxLayers];  // [cin, cout] row-major, zero-padded
  const float* bias[kMaxLayers];       // [cout], zero-padded
  const float* scale[kMaxLayers];
  const float* shift[kMaxLayers];
};

__global__ void __launch_bounds__(kWarps * 32)
    samlp_eval_kernel(const float* __restrict__ x, int m, int c0, int k,
                      int tm, int ld_x, int ld_y, int c_last,
                      MlpParams prm, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* buf_x = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* buf_y = buf_x + static_cast<size_t>(tm) * ld_x;
  float* scratch =
      reinterpret_cast<float*>(buf_y + static_cast<size_t>(tm) * ld_y);
  unsigned* pooled = reinterpret_cast<unsigned*>(scratch + kWarps * 256);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * tm;
  const int groups = tm / k;
  const int c_last_pad = prm.cout[prm.n_layers - 1];

  // input tile -> bf16, zero in the channel padding and past the last row
  const int cin0 = prm.cin[0];
  for (int e = tid; e < tm * cin0; e += blockDim.x) {
    const int r = e / cin0, c = e - r * cin0;
    const int row = row0 + r;
    const float v =
        (row < m && c < c0) ? x[static_cast<size_t>(row) * c0 + c] : 0.f;
    buf_x[r * ld_x + c] = __float2bfloat16_rn(v);
  }
  for (int e = tid; e < groups * c_last_pad; e += blockDim.x) pooled[e] = 0u;
  __syncthreads();

  float* my_scratch = scratch + warp * 256;
  for (int l = 0; l < prm.n_layers; ++l) {
    const bool last = l == prm.n_layers - 1;
    const __nv_bfloat16* in = (l & 1) ? buf_y : buf_x;
    const int ld_in = (l & 1) ? ld_y : ld_x;
    __nv_bfloat16* dst = (l & 1) ? buf_x : buf_y;
    const int ld_dst = (l & 1) ? ld_x : ld_y;
    const int cin = prm.cin[l], cout = prm.cout[l];
    const __nv_bfloat16* w = prm.w[l];
    const float* bias = prm.bias[l];
    const float* scale = prm.scale[l];
    const float* shift = prm.shift[l];
    const int col_tiles = cout / 16;
    const int units = col_tiles * (tm / (16 * kRowFrags));

    for (int u = warp; u < units; u += kWarps) {
      const int ct = u % col_tiles;
      const int rb = u / col_tiles;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowFrags];
#pragma unroll
      for (int f = 0; f < kRowFrags; ++f) wmma::fill_fragment(acc[f], 0.f);
      for (int kk = 0; kk < cin; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(bf, w + static_cast<size_t>(kk) * cout + ct * 16,
                               cout);
#pragma unroll
        for (int f = 0; f < kRowFrags; ++f) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              af;
          wmma::load_matrix_sync(
              af, in + (rb * 16 * kRowFrags + f * 16) * ld_in + kk, ld_in);
          wmma::mma_sync(acc[f], af, bf, acc[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < kRowFrags; ++f) {
        wmma::store_matrix_sync(my_scratch, acc[f], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e >> 4, c = e & 15;
          const int col = ct * 16 + c;
          const int rl = rb * 16 * kRowFrags + f * 16 + r;
          const float a = __fadd_rn(my_scratch[e], bias[col]);
          float h = __fadd_rn(__fmul_rn(a, scale[col]), shift[col]);
          h = h > 0.f ? h : 0.f;  // +0 for -0 too: pooled compares bits
          if (!last) {
            dst[rl * ld_dst + col] = __float2bfloat16_rn(h);
          } else if (row0 + rl < m) {
            atomicMax(&pooled[(rl / k) * c_last_pad + col],
                      __float_as_uint(h));
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }

  const int g0 = row0 / k;
  const int n_groups = m / k;
  for (int e = tid; e < groups * c_last; e += blockDim.x) {
    const int g = e / c_last, c = e - g * c_last;
    if (g0 + g < n_groups)
      out[static_cast<size_t>(g0 + g) * c_last + c] =
          __uint_as_float(pooled[g * c_last_pad + c]);
  }
}

}  // namespace

// x [M, C0] f32 row-major; per layer l < n_layers: w[l] bf16 [cin[l], cout[l]]
// (both padded to multiples of 16, zero-filled), bias/scale/shift f32
// [cout[l]] (zero in the padding). tm: rows per block, a multiple of 64
// and of k; ld_x / ld_y: shared-memory row strides in bf16 elements.
// -> out [M / k, c_last] f32.
PAPC_EXPORT int papc_samlp_eval(const float* x, int m, int c0, int k,
                                int n_layers, const int* cin,
                                const int* cout, const void* const* w,
                                const float* const* bias,
                                const float* const* scale,
                                const float* const* shift, int c_last,
                                int tm, int ld_x, int ld_y, float* out,
                                void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || m <= 0 || k <= 0 ||
      m % k != 0 || tm <= 0 || tm % 64 != 0 || tm % k != 0)
    return cudaErrorInvalidValue;
  MlpParams prm{};
  prm.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    if (cin[l] % 16 != 0 || cout[l] % 16 != 0) return cudaErrorInvalidValue;
    prm.cin[l] = cin[l];
    prm.cout[l] = cout[l];
    prm.w[l] = static_cast<const __nv_bfloat16*>(w[l]);
    prm.bias[l] = bias[l];
    prm.scale[l] = scale[l];
    prm.shift[l] = shift[l];
  }
  const size_t smem = static_cast<size_t>(tm) * (ld_x + ld_y) * 2 +
                      kWarps * 256 * sizeof(float) +
                      static_cast<size_t>(tm / k) * cout[n_layers - 1] *
                          sizeof(unsigned);
  const int blocks = (m + tm - 1) / tm;
  return papc_launch(samlp_eval_kernel, dim3(blocks), dim3(kWarps * 32), smem,
                     static_cast<cudaStream_t>(stream), x, m, c0, k, tm, ld_x,
                     ld_y, c_last, prm, out);
}
