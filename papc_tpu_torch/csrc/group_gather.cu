// Grouping gather of a set-abstraction stage, in row layout:
//   out[b, s, k, :] = concat(xyz, feats)[b, clip(idx[b, s, k]), :]
// with new_xyz[b, s] subtracted from the three xyz channels.
//
// Replaces: papc_tpu/ops/pallas/gather_t.py::gather_cols_pallas
// (_gather_t_kernel), the forward of gather_cols. On the TPU the gather
// is a one-hot product on the MXU in a channel-major [B, C, M] layout,
// exact through a hi/mid/lo bf16 split; the centring is the elementwise
// step that follows it (papc_tpu/ops/grouping.py:214-220). Fusing the
// centring here computes the same function.
//
// What bounds it on the H100: bytes. It reads each gathered source row
// (3 + D floats, from L2: a batch row's source is at most 512 x 131 x 4 B)
// and writes the grouped tensor once (SA2: 32 x 128 x 64 x 131 x 4 B =
// 137 MB); there is no arithmetic beyond one subtraction.
//
// Design: one thread per output element, consecutive threads on
// consecutive channels, so the writes and the reads of each source row
// are coalesced. A copy and one correctly rounded subtraction: the
// result equals the plain PyTorch version exactly.
#include "common.cuh"

namespace {

__global__ void group_gather_kernel(const float* __restrict__ xyz,
                                    const float* __restrict__ feats,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ new_xyz,
                                    int n, int d, int s, int k,
                                    long long total,
                                    float* __restrict__ out) {
  const int c_all = 3 + d;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += stride) {
    const long long row = e / c_all;  // flat (b, s, k)
    const int c = static_cast<int>(e - row * c_all);
    const long long query = row / k;  // flat (b, s)
    const long long b = query / s;
    int j = idx[row];
    j = j < 0 ? 0 : (j >= n ? n - 1 : j);
    const long long src = b * n + j;
    out[e] = c < 3 ? __fsub_rn(xyz[src * 3 + c], new_xyz[query * 3 + c])
                   : feats[src * d + (c - 3)];
  }
}

}  // namespace

// xyz [B, N, 3], feats [B, N, D] or null when D = 0, idx [B, S, K] i32,
// new_xyz [B, S, 3] -> out [B, S, K, 3 + D] f32.
PAPC_EXPORT int papc_group_gather(const float* xyz, const float* feats,
                                  const int* idx, const float* new_xyz,
                                  int b, int n, int d, int s, int k,
                                  float* out, void* stream) {
  if (b <= 0 || n <= 0 || d < 0 || s <= 0 || k <= 0 ||
      (d > 0 && feats == nullptr))
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * s * k * (3 + d);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  return papc_launch(group_gather_kernel, dim3(static_cast<int>(blocks)),
                     dim3(threads), 0, static_cast<cudaStream_t>(stream),
                     xyz, feats, idx, new_xyz, n, d, s, k, total, out);
}
