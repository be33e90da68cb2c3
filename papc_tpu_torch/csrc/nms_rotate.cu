// Fused rotated-box greedy NMS in two launches, no K x K IoU matrix:
//   keep = valid; for i in 0..K-1: if keep[i]: for every j > i, clip box
//   j by box i's four halfplanes (Sutherland-Hodgman), and clear keep[j]
//   when inter / (area_i + area_j - inter) > threshold.
//
// Replaces: papc_tpu/ops/pallas/nms.py::rotate_nms_pallas
// (_rot_sweep_kernel), which keeps the corners lane-major in VMEM and
// clips all K boxes against each still-kept row.
//
// What bounds it on the H100: the clips' instruction issue. A clip is
// about 200 f32 operations, some 3 us over the 1.0 M valid pairs i < j of
// B = 2 frames at K = 1000 at the card's 67 TFLOP/s, but the register
// ring's selects make it some 1500-2000 instructions a lane: about
// 0.065 ms on the H100 (chip_smoke.py's phase 7), where the sweep's K
// dependent decisions (nms_mask.cuh) take 0.015. The input is 36 KB a
// frame.
//
// Design: the decision of each pair does not depend on the sweep, so
// rotate_mask_kernel decides all of them at once across the card, into
// nms_mask.cuh's bitmask, and the shared sweep resolves the greedy
// order over the bits. A warp takes one row i and 32 columns: each lane
// clips its box j > i by box i, and a ballot writes the 32 bits. Rows
// and columns that are not valid take no clip. The wrapper computes
// corners and areas with the plain box5_to_corners, so the sines and
// cosines are the plain version's.
//
// The clip is the plain version's arithmetic, each operation rounded on
// its own (__fmul_rn / __fsub_rn / __fadd_rn / __fdiv_rn): the sign of
// the cross product dx*(vy-ay) - dy*(vx-ax) decides whether a vertex is
// inside, and a contracted FMA would flip it against the plain version.
// Two convex quads meet in at most 8 vertices, so each clip's polygon
// lives in a fixed, fully unrolled ring of 8 vertices in registers (a
// write at the running count m is a select on each slot). Rounding can
// make a clip emit more (now and then a box and its copy turned by pi);
// such a pair is clipped again in the 64-slot ring of the plain
// version's doubling bound (4 -> 8 -> 16 -> 32 -> 64), the same
// arithmetic in a larger buffer, and counted. The shoelace sums run
// over the polygon in order where the plain version sums its ring as a
// tree, so the areas agree to a few ulps and the keep masks agree except
// for a pair whose IoU lies that close to the threshold.
#include <cstdint>

#include "nms_mask.cuh"

namespace {

constexpr int kRing = 8;       // vertices of the register ring
constexpr int kMaxVerts = 64;  // the overflow ring
constexpr int kWarps = 8;      // rows a block of the mask kernel

__device__ __forceinline__ float cross(float vx, float vy, float ax,
                                       float ay, float dx, float dy,
                                       float orient) {
  return __fmul_rn(__fsub_rn(__fmul_rn(dx, __fsub_rn(vy, ay)),
                             __fmul_rn(dy, __fsub_rn(vx, ax))),
                   orient);
}

struct Quad {
  float x[4], y[4];
};

// Intersection area of quad q clipped by quad b (winding orient) in the
// 64-slot ring: the pairs whose clip overflows the register ring. Out
// of line, its quads by value, so that the ring's local memory stays off
// the common path.
__device__ __noinline__ float clipped_area_wide(Quad q, Quad b,
                                                float orient) {
  const float* bx = b.x;
  const float* by = b.y;
  float px[2][kMaxVerts], py[2][kMaxVerts];
  int n = 4;
  for (int v = 0; v < 4; ++v) {
    px[0][v] = q.x[v];
    py[0][v] = q.y[v];
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

// Vertex (x, y) into slot m of the register ring: a select on every slot
// below `limit`, the most vertices this write can follow. Past the ring,
// `fits` goes false.
__device__ __forceinline__ void put(float (&ox)[kRing], float (&oy)[kRing],
                                    int& m, int limit, float x, float y,
                                    bool& fits) {
#pragma unroll
  for (int s = 0; s < kRing; ++s)
    if (s < limit && m == s) {
      ox[s] = x;
      oy[s] = y;
    }
  if (m >= kRing) fits = false;
  ++m;
}

// One clip of the ring (x, y, n), n <= NIN, against the halfplane on side
// orient of the edge (ax, ay) + t (dx, dy), into (ox, oy, m): the
// 64-slot ring's loop with each index fixed at compile time.
template <int NIN>
__device__ __forceinline__ void clip_ring(const float (&x)[kRing],
                                          const float (&y)[kRing], int n,
                                          float ax, float ay, float dx,
                                          float dy, float orient,
                                          float (&ox)[kRing],
                                          float (&oy)[kRing], int& m,
                                          bool& fits) {
  float cr[NIN];
#pragma unroll
  for (int v = 0; v < NIN; ++v)
    cr[v] = cross(x[v], y[v], ax, ay, dx, dy, orient);
  m = 0;
#pragma unroll
  for (int v = 0; v < NIN; ++v) {
    if (v < n) {
      const int up = v + 1 < NIN ? v + 1 : 0;  // v + 1 within the ring
      const bool wrap = v + 1 == n;
      const float nx = wrap ? x[0] : x[up];
      const float ny = wrap ? y[0] : y[up];
      const float c = cr[v], nc = wrap ? cr[0] : cr[up];
      const bool in = c >= 0.0f, nin = nc >= 0.0f;
      if (in) put(ox, oy, m, 2 * v + 1, x[v], y[v], fits);
      const float den = __fsub_rn(c, nc);
      if (in != nin && den != 0.0f) {
        const float t = __fdiv_rn(c, den);
        put(ox, oy, m, 2 * v + 2,
            __fadd_rn(x[v], __fmul_rn(t, __fsub_rn(nx, x[v]))),
            __fadd_rn(y[v], __fmul_rn(t, __fsub_rn(ny, y[v]))), fits);
      }
    }
  }
}

// Intersection area of quad q clipped by quad b in the register ring;
// `fits` goes false when a clip needs more than kRing vertices (the
// area is then not computed).
__device__ __forceinline__ float clipped_area(const Quad& q, const Quad& b,
                                              float orient, bool& fits) {
  const float(&bx)[4] = b.x;
  const float(&by)[4] = b.y;
  float x0[kRing], y0[kRing], x1[kRing], y1[kRing];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    x0[v] = q.x[v];
    y0[v] = q.y[v];
  }
  int n0 = 4, n1;
  fits = true;
  const float dx0 = __fsub_rn(bx[1], bx[0]), dy0 = __fsub_rn(by[1], by[0]);
  const float dx1 = __fsub_rn(bx[2], bx[1]), dy1 = __fsub_rn(by[2], by[1]);
  const float dx2 = __fsub_rn(bx[3], bx[2]), dy2 = __fsub_rn(by[3], by[2]);
  const float dx3 = __fsub_rn(bx[0], bx[3]), dy3 = __fsub_rn(by[0], by[3]);
  clip_ring<4>(x0, y0, n0, bx[0], by[0], dx0, dy0, orient, x1, y1, n1, fits);
  clip_ring<kRing>(x1, y1, n1, bx[1], by[1], dx1, dy1, orient, x0, y0, n0,
                   fits);
  clip_ring<kRing>(x0, y0, n0, bx[2], by[2], dx2, dy2, orient, x1, y1, n1,
                   fits);
  clip_ring<kRing>(x1, y1, n1, bx[3], by[3], dx3, dy3, orient, x0, y0, n0,
                   fits);
  float area2 = 0.0f;
#pragma unroll
  for (int v = 0; v < kRing; ++v) {
    if (v < n0) {
      const int up = v + 1 < kRing ? v + 1 : 0;
      const bool wrap = v + 1 == n0;
      const float nx = wrap ? x0[0] : x0[up];
      const float ny = wrap ? y0[0] : y0[up];
      area2 = __fadd_rn(area2, __fsub_rn(__fmul_rn(x0[v], ny),
                                         __fmul_rn(nx, y0[v])));
    }
  }
  return __fmul_rn(0.5f, fabsf(area2));
}

// box `box`'s corners: [4][2] floats, 32 bytes
__device__ __forceinline__ Quad load_box(const float* __restrict__ corners,
                                         size_t box) {
  const float4* p = reinterpret_cast<const float4*>(corners + 8 * box);
  const float4 a = p[0], c = p[1];
  Quad q;
  q.x[0] = a.x, q.y[0] = a.y, q.x[1] = a.z, q.y[1] = a.w;
  q.x[2] = c.x, q.y[2] = c.y, q.x[3] = c.z, q.y[3] = c.w;
  return q;
}

// Grid (ceil(K / kWarps), 2 * words, B): warp w of block (x, h, b) takes
// row i = kWarps x + w and columns 32 h .. 32 h + 31 of frame b, and
// writes their 32 bits (half a word, the low half first). Every row
// i < K writes all its words, zeros below the diagonal. Each block
// writes its count of ring-overflow pairs into overflow[b][h][x].
__global__ void __launch_bounds__(kWarps * 32)
    rotate_mask_kernel(const float* __restrict__ corners,
                       const float* __restrict__ areas,
                       const bool* __restrict__ valid, int k, float thr,
                       uint64_t* __restrict__ mask,
                       int* __restrict__ overflow) {
  __shared__ int over[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nw = nms::words(k);
  const size_t frame = static_cast<size_t>(b) * k;
  bool wide = false;
  if (i < k) {  // uniform across the warp
    unsigned bits = 0;
    if (valid[frame + i] && 32 * h + 31 > i) {
      const Quad bq = load_box(corners, frame + i);
      float shoelace = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        shoelace = __fadd_rn(
            shoelace, __fsub_rn(__fmul_rn(bq.x[e], bq.y[(e + 1) & 3]),
                                __fmul_rn(bq.x[(e + 1) & 3], bq.y[e])));
      // torch.sign: -1, 0 or 1, and NaN stays NaN
      const float orient =
          shoelace > 0.0f ? 1.0f : (shoelace < 0.0f ? -1.0f : shoelace);
      const int j = 32 * h + lane;
      bool hit = false;
      if (j > i && j < k && valid[frame + j]) {
        const Quad q = load_box(corners, frame + j);
        bool fits;
        float inter = clipped_area(q, bq, orient, fits);
        if (!fits) {
          wide = true;
          inter = clipped_area_wide(q, bq, orient);
        }
        const float denom =
            __fsub_rn(__fadd_rn(areas[frame + i], areas[frame + j]), inter);
        const float iou = denom > 0.0f ? __fdiv_rn(inter, denom) : 0.0f;
        hit = iou > thr;
      }
      bits = __ballot_sync(0xffffffffu, hit);
    }
    if (lane == 0)
      reinterpret_cast<uint32_t*>(
          mask + static_cast<size_t>(b) * nms::frame_words(k) +
          static_cast<size_t>(i) * nw)[h] = bits;
  }
  const int n_wide = __popc(__ballot_sync(0xffffffffu, wide));
  if (lane == 0) over[warp] = n_wide;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += over[w];
    overflow[(static_cast<size_t>(b) * gridDim.y + h) * gridDim.x +
             blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(1024)
    rotate_sweep_kernel(const uint64_t* __restrict__ mask,
                        const bool* __restrict__ valid, int k, bool staged,
                        bool* __restrict__ keep) {
  const size_t frame = static_cast<size_t>(blockIdx.x) * k;
  nms::sweep(mask + blockIdx.x * nms::frame_words(k), valid + frame, k,
             staged, keep + frame);
}

}  // namespace

// corners [B, K, 4, 2] f32, areas [B, K] f32, valid [B, K] bool, boxes
// score-sorted -> keep [B, K] bool. scratch: the mask, B x
// nms::frame_words(K) 64-bit words, then the overflow counts, B x 2
// words(K) x ceil(K / 8) ints (ops/kernels/nms.py::scratch_bytes).
PAPC_EXPORT int papc_nms_rotate(const float* corners, const float* areas,
                                const bool* valid, int b, int k, float thr,
                                void* scratch, bool* keep, void* stream) {
  if (b <= 0 || b > 65535 || k <= 0 || k > nms::kMaxK)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* mask = static_cast<uint64_t*>(scratch);
  int* overflow = reinterpret_cast<int*>(mask + b * nms::frame_words(k));
  const dim3 grid((k + kWarps - 1) / kWarps, 2 * nms::words(k), b);
  const cudaError_t err =
      papc_launch(rotate_mask_kernel, grid, dim3(kWarps * 32), 0, s, corners,
                  areas, valid, k, thr, mask, overflow);
  if (err != cudaSuccess) return err;
  return nms::launch_sweep(rotate_sweep_kernel, mask, valid, b, k, keep, s);
}
