// The two per-column passes at the top of a training set-abstraction MLP.
//
// finalize_max: the last BN + ReLU and the max over each group of k rows,
//   h = max(a * scale + shift, 0);  out[g, c] = max_r h[g*k + r, c]
//   amax[g, c] = the first r that attains it
// bwd_seed: the gradient of out routed back through that argmax only and
// the last ReLU gate, plus the last BN's gradient sums,
//   dy[g*k + r, c] = (r == amax[g, c] and a*scale + shift > 0) ? dout[g, c] : 0
//   s = (sum dy, sum dy * xhat) per column, xhat = (a - mean) * inv_std
//
// Replaces: papc_tpu/ops/pallas/samlp.py::finalize_max (_finalize_kernel)
// and ::bwd_seed (_bwd_seed_kernel). Numeric contract kept: a is bf16, the
// affine, max, dy and sums are f32, dy is stored bf16 after the sums.
//
// What bounds them on the H100: bytes, reading a once (SA1 524288 x 128,
// SA2 262144 x 256, SA3 4096 x 1024 bf16) and, for bwd_seed, writing dy.
//
// Design: one thread per (group, channel) column of k rows, neighbouring
// threads on neighbouring channels so every row is read coalesced. The
// affine and x-hat use __fmul_rn / __fadd_rn / __fsub_rn: contracted into
// an FMA, o would move by an ulp, flip the o > 0 gate or a tie of the max,
// and switch a whole dy element on or off against the plain version. The
// scan keeps the first maximum (strict >), as the TPU kernel's
// min-index-of-equals does. bwd_seed's threads each take the groups
// p, p + slices, ... of one channel and write their two sums to
// partials[p]; a second kernel adds the slices in order.
#include "samlp_train.cuh"

namespace {

using samlp_train::affine;
using samlp_train::bf2f;

__global__ void finalize_max_kernel(const __nv_bfloat16* __restrict__ a,
                                    int c, int k, long long total,
                                    const float* __restrict__ vec,
                                    float* __restrict__ out,
                                    int* __restrict__ amax) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += stride) {
    const long long g = e / c;
    const int ch = static_cast<int>(e - g * c);
    const float scale = vec[ch], shift = vec[c + ch];
    const __nv_bfloat16* col = a + g * k * c + ch;
    float best = 0.f;
    int arg = 0;
    for (int r = 0; r < k; ++r) {
      const float o = affine(bf2f(col[static_cast<size_t>(r) * c]), scale,
                             shift);
      const float h = o > 0.f ? o : 0.f;
      if (r == 0 || h > best) {
        best = h;
        arg = r;
      }
    }
    out[e] = best;
    amax[e] = arg;
  }
}

__global__ void bwd_seed_kernel(const __nv_bfloat16* __restrict__ a, int c,
                                int k, int groups,
                                const float* __restrict__ vec,
                                const float* __restrict__ dout,
                                const int* __restrict__ amax, int slices,
                                __nv_bfloat16* __restrict__ dy,
                                float* __restrict__ partials) {
  const long long total = static_cast<long long>(slices) * c;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += stride) {
    const int p = static_cast<int>(t / c);
    const int ch = static_cast<int>(t - static_cast<long long>(p) * c);
    const float scale = vec[ch], shift = vec[c + ch];
    const float mean = vec[2 * c + ch], inv_std = vec[3 * c + ch];
    float s1 = 0.f, s2 = 0.f;
    for (int g = p; g < groups; g += slices) {
      const size_t gc = static_cast<size_t>(g) * c + ch;
      const int am = amax[gc];
      const float d = dout[gc];
      for (int r = 0; r < k; ++r) {
        const size_t i = (static_cast<size_t>(g) * k + r) * c + ch;
        const float av = bf2f(a[i]);
        const float v = (r == am && affine(av, scale, shift) > 0.f) ? d : 0.f;
        dy[i] = __float2bfloat16_rn(v);
        s1 += v;
        s2 += __fmul_rn(v, __fmul_rn(__fsub_rn(av, mean), inv_std));
      }
    }
    partials[static_cast<size_t>(p) * 2 * c + ch] = s1;
    partials[(static_cast<size_t>(p) * 2 + 1) * c + ch] = s2;
  }
}

int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  return static_cast<int>(blocks > 132 * 64 ? 132 * 64 : blocks);
}

}  // namespace

// a [M, C] bf16, M a multiple of k; vec f32 rows (scale, shift, ...) of
// width C, of which rows 0 and 1 are read -> out [M/k, C] f32, amax
// [M/k, C] i32.
PAPC_EXPORT int papc_samlp_finalize_max(const void* a, int m, int c, int k,
                                        const float* vec, float* out,
                                        int* amax, void* stream) {
  if (m <= 0 || c <= 0 || k <= 0 || m % k != 0) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(m / k) * c;
  return papc_launch(finalize_max_kernel, dim3(grid_for(total, 256)),
                     dim3(256), 0, static_cast<cudaStream_t>(stream),
                     static_cast<const __nv_bfloat16*>(a), c, k, total, vec,
                     out, amax);
}

// a [M, C] bf16; vec f32 [4, C] (scale, shift, mean, inv_std); dout, amax
// [M/k, C] f32 / i32; slices: groups are split over slices x C threads.
// -> dy [M, C] bf16, partials [slices, 2, C] (scratch), sums [2, C] f32.
PAPC_EXPORT int papc_samlp_bwd_seed(const void* a, int m, int c, int k,
                                    const float* vec, const float* dout,
                                    const int* amax, int slices, void* dy,
                                    float* partials, float* sums,
                                    void* stream) {
  if (m <= 0 || c <= 0 || k <= 0 || m % k != 0 || slices <= 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(slices) * c;
  cudaError_t err = papc_launch(
      bwd_seed_kernel, dim3(grid_for(total, 256)), dim3(256), 0, s,
      static_cast<const __nv_bfloat16*>(a), c, k, m / k, vec, dout, amax,
      slices, static_cast<__nv_bfloat16*>(dy), partials);
  if (err != cudaSuccess) return err;
  return samlp_train::reduce_partials(partials, slices, 2, c, 2, c, sums, s);
}
