// Fused rotated-box greedy NMS, one thread block per frame, no K x K
// IoU matrix:
//   keep = valid; for i in 0..K-1: if keep[i]: for every kept j > i,
//   clip box j by box i's four halfplanes (Sutherland-Hodgman), and
//   clear keep[j] when inter / (area_i + area_j - inter) > threshold.
//
// Replaces: papc_tpu/ops/pallas/nms.py::rotate_nms_pallas
// (_rot_sweep_kernel), which keeps the corners lane-major in VMEM and
// clips all K boxes against each still-kept row.
//
// What bounds it on the H100: the chain of K dependent iterations, not
// operations or bytes. Kept rows x K clips is at most about 5e5 clips of
// about 200 flops a frame at K = 1000, about 1.5 us at the card's
// 67 TFLOP/s f32 rate, and the input is 36 KB a frame. Each iteration ends at a block barrier,
// and a block runs on one SM: B = 2 frames use 2 of the 132 SMs.
//
// Design: every box's corners (32 B), its area w*l (4 B) and its keep
// flag (1 B) live in shared memory, 37 KB at K = 1000 (more than 48 KB
// through the dynamic opt-in, up to the 227 KB a block may have). The
// wrapper computes corners and areas with the plain box5_to_corners, so
// the sines and cosines are the plain version's. Thread t owns boxes
// t, t + blockDim, ...; at iteration i (after a barrier, a uniform
// branch on keep[i]) it clips each of its own kept j > i in registers
// and local memory. Skipping a j that is already suppressed changes
// nothing: the sweep only ever clears flags.
//
// The clip is the plain version's arithmetic, each operation rounded on
// its own (__fmul_rn / __fsub_rn / __fadd_rn / __fdiv_rn): the sign of
// the cross product dx*(vy-ay) - dy*(vx-ax) decides whether a vertex is
// inside, and a contracted FMA would flip it against the plain version.
// The output ring of a clip is at most twice its input (4 -> 8 -> 16 ->
// 32 -> 64 slots, as the plain version's doubling ring; a convex quad
// needs at most 8). The shoelace sums run over the polygon in order
// where the plain version sums its ring as a tree, so the areas agree to
// a few ulps and the keep masks agree except for a pair whose IoU lies
// that close to the threshold.
#include "common.cuh"

namespace {

constexpr int kMaxVerts = 64;

__device__ __forceinline__ float cross(float vx, float vy, float ax,
                                       float ay, float dx, float dy,
                                       float orient) {
  return __fmul_rn(__fsub_rn(__fmul_rn(dx, __fsub_rn(vy, ay)),
                             __fmul_rn(dy, __fsub_rn(vx, ax))),
                   orient);
}

// Intersection area of quad q (corners qx, qy) clipped by the quad with
// corners bx, by (winding orient).
__device__ float clipped_area(const float* qx, const float* qy,
                              const float* bx, const float* by,
                              float orient) {
  float px[2][kMaxVerts], py[2][kMaxVerts];
  int n = 4;
  for (int v = 0; v < 4; ++v) {
    px[0][v] = qx[v];
    py[0][v] = qy[v];
  }
  int cur = 0;
  for (int e = 0; e < 4 && n > 0; ++e) {
    const float ax = bx[e], ay = by[e];
    const float dx = __fsub_rn(bx[(e + 1) & 3], ax);
    const float dy = __fsub_rn(by[(e + 1) & 3], ay);
    const float* ix = px[cur];
    const float* iy = py[cur];
    float* ox = px[cur ^ 1];
    float* oy = py[cur ^ 1];
    int m = 0;
    const float c0 = cross(ix[0], iy[0], ax, ay, dx, dy, orient);
    float c = c0;
    for (int v = 0; v < n; ++v) {
      const int nv = v + 1 == n ? 0 : v + 1;
      const float nc =
          nv == 0 ? c0 : cross(ix[nv], iy[nv], ax, ay, dx, dy, orient);
      const bool in = c >= 0.0f, nin = nc >= 0.0f;
      if (in) {
        ox[m] = ix[v];
        oy[m] = iy[v];
        ++m;
      }
      const float den = __fsub_rn(c, nc);
      if (in != nin && den != 0.0f) {
        const float t = __fdiv_rn(c, den);
        ox[m] = __fadd_rn(ix[v], __fmul_rn(t, __fsub_rn(ix[nv], ix[v])));
        oy[m] = __fadd_rn(iy[v], __fmul_rn(t, __fsub_rn(iy[nv], iy[v])));
        ++m;
      }
      c = nc;
    }
    n = m;
    cur ^= 1;
  }
  float area2 = 0.0f;
  for (int v = 0; v < n; ++v) {
    const int nv = v + 1 == n ? 0 : v + 1;
    area2 = __fadd_rn(area2, __fsub_rn(__fmul_rn(px[cur][v], py[cur][nv]),
                                       __fmul_rn(px[cur][nv], py[cur][v])));
  }
  return __fmul_rn(0.5f, fabsf(area2));
}

__global__ void __launch_bounds__(1024)
    nms_rotate_kernel(const float* __restrict__ corners,
                      const float* __restrict__ areas,
                      const bool* __restrict__ valid, int k, float thr,
                      bool* __restrict__ keep_out) {
  extern __shared__ float smem[];
  float* cs = smem;             // [K][4][2] corners
  float* area = cs + 8 * k;     // [K]
  unsigned char* keep = reinterpret_cast<unsigned char*>(area + k);  // [K]
  const int b = blockIdx.x;
  const size_t base = static_cast<size_t>(b) * k;
  for (int j = threadIdx.x; j < 8 * k; j += blockDim.x)
    cs[j] = corners[base * 8 + j];
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    area[j] = areas[base + j];
    keep[j] = valid[base + j] ? 1 : 0;
  }
  for (int i = 0; i < k; ++i) {
    __syncthreads();
    if (!keep[i]) continue;  // uniform: every thread reads the same flag
    float bx[4], by[4];
    for (int e = 0; e < 4; ++e) {
      bx[e] = cs[8 * i + 2 * e];
      by[e] = cs[8 * i + 2 * e + 1];
    }
    float shoelace = 0.0f;
    for (int e = 0; e < 4; ++e)
      shoelace = __fadd_rn(shoelace,
                           __fsub_rn(__fmul_rn(bx[e], by[(e + 1) & 3]),
                                     __fmul_rn(bx[(e + 1) & 3], by[e])));
    // torch.sign: -1, 0 or 1, and NaN stays NaN
    const float orient =
        shoelace > 0.0f ? 1.0f : (shoelace < 0.0f ? -1.0f : shoelace);
    const float area_i = area[i];
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
      if (!keep[j]) continue;
      float qx[4], qy[4];
      for (int v = 0; v < 4; ++v) {
        qx[v] = cs[8 * j + 2 * v];
        qy[v] = cs[8 * j + 2 * v + 1];
      }
      const float inter = clipped_area(qx, qy, bx, by, orient);
      const float denom = __fsub_rn(__fadd_rn(area_i, area[j]), inter);
      const float iou = denom > 0.0f ? __fdiv_rn(inter, denom) : 0.0f;
      if (iou > thr) keep[j] = 0;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    keep_out[base + j] = keep[j] != 0;
}

}  // namespace

// corners [B, K, 4, 2] f32, areas [B, K] f32, valid [B, K] bool, boxes
// score-sorted -> keep [B, K] bool.
PAPC_EXPORT int papc_nms_rotate(const float* corners, const float* areas,
                                const bool* valid, int b, int k, float thr,
                                bool* keep, void* stream) {
  if (b <= 0 || k <= 0) return cudaErrorInvalidValue;
  const int threads = k >= 1024 ? 1024 : ((k + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(k) * (9 * sizeof(float) + 1);
  return papc_launch(nms_rotate_kernel, dim3(b), dim3(threads), smem,
                     static_cast<cudaStream_t>(stream), corners, areas,
                     valid, k, thr, keep);
}
