// Farthest point sampling, one thread block per cloud.
//
// Replaces: papc_tpu/ops/pallas/fps.py::farthest_point_sample_pallas
// (_fps_kernel), which keeps the coordinates and the running
// min-distance resident in VMEM for the whole selection loop.
//
// What bounds it on the H100: the loop is sequential. Each of npoint
// rounds reads the whole cloud once and ends in a block-wide argmax,
// so the time is rounds x (one pass over N points + two barriers); the
// bytes are tiny (16 B a point) and the FLOPs negligible.
//
// Design: the cloud (x, y, z planes) and the running min-distance live
// in shared memory (16 B a point: 16 KB at N = 1024), so the loop never
// touches device memory after the first load. Each thread owns the
// points j = tid, tid + blockDim, ... in ascending order, keeps its own
// best (value, index), and the block combines them with warp shuffles
// and one shared-memory step. Ties go to the smaller index, which is
// torch.argmax's and jnp.argmax's first-occurrence rule.
//
// Rounding: the distance is ((dx*dx + dy*dy) + dz*dz), each operation
// rounded on its own (__fmul_rn / __fadd_rn). nvcc would otherwise
// contract a*b+c into one FMA, move distances by an ulp and flip argmax
// ties against the plain PyTorch loop, which this kernel equals bit for
// bit.
#include <math_constants.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ void keep_better(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(1024)
    fps_kernel(const float* __restrict__ xyz,
                           const int* __restrict__ start, int n,
                           int npoint, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = px + n;
  float* pz = py + n;
  float* dist = pz + n;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int far_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  for (int j = tid; j < n; j += blockDim.x) {
    px[j] = p[3 * j];
    py[j] = p[3 * j + 1];
    pz[j] = p[3 * j + 2];
    dist[j] = CUDART_INF_F;
  }
  int far = start[b];
  __syncthreads();

  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) out[static_cast<size_t>(b) * npoint + i] = far;
    const float cx = px[far], cy = py[far], cz = pz[far];
    float bv = -CUDART_INF_F;
    int bi = n;
    for (int j = tid; j < n; j += blockDim.x) {
      const float dx = __fsub_rn(px[j], cx);
      const float dy = __fsub_rn(py[j], cy);
      const float dz = __fsub_rn(pz[j], cz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
          __fmul_rn(dz, dz));
      const float nd = fminf(dist[j], d);
      dist[j] = nd;
      if (nd > bv) {  // ascending j: strict > keeps the first maximum
        bv = nd;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, bv, off);
      const int i2 = __shfl_down_sync(0xffffffffu, bi, off);
      keep_better(bv, bi, v2, i2);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? red_i[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_down_sync(0xffffffffu, bv, off);
        const int i2 = __shfl_down_sync(0xffffffffu, bi, off);
        keep_better(bv, bi, v2, i2);
      }
      if (lane == 0) far_s = bi < n ? bi : n - 1;
    }
    __syncthreads();
    far = far_s;
  }
}

}  // namespace

// xyz [B, N, 3] f32 contiguous, start [B] i32 in [0, N) -> out [B, npoint] i32.
PAPC_EXPORT int papc_fps(const float* xyz, const int* start, int b, int n,
                         int npoint, int* out, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0) return cudaErrorInvalidValue;
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(n) * 4 * sizeof(float);
  return papc_launch(fps_kernel, dim3(b), dim3(threads), smem,
                     static_cast<cudaStream_t>(stream), xyz, start, n,
                     npoint, out);
}
