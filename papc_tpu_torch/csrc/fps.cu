// Farthest point sampling: the cloud in registers, one barrier a round.
//
// Replaces: papc_tpu/ops/pallas/fps.py::farthest_point_sample_pallas
// (_fps_kernel), which keeps the coordinates and the running
// min-distance resident in VMEM for the whole selection loop.
//
// What bounds it on the H100: neither bytes (16 B a point, read once)
// nor operations (10 a point a round). The npoint rounds depend on one
// another: a round's centroid is the previous round's argmax, so the
// time is rounds x the latency of one round (distance update, argmax
// over the cloud, hand-over of the winner). The design shortens that
// chain.
//
// Ownership. A cloud is split over a cluster of C blocks of W warps
// (the plan, ops/kernels/fps.py::fps_plan; C = 1 is a plain launch).
// Thread (rank, warp, lane) owns the P consecutive points starting at
// ((rank*W + warp)*32 + lane)*P and holds their x, y, z and running
// distance in registers, so the loop never touches memory for its
// points. Ownership ascends over (rank, warp, lane, slot), and every
// tie-break below takes the lowest of these, which is the lowest point
// index: torch.argmax's and jnp.argmax's first occurrence.
//
// A round:
// 1. each thread updates its P distances and takes their argmax as a
//    tree over slots, in which a higher slot replaces a lower one only
//    when strictly larger (the first maximum), carrying its coordinates;
// 2. the warp's argmax without index shuffles: distances are >= 0, so
//    their float bits order as unsigned integers (the key); redux.sync
//    takes the largest key, and __ffs of a ballot of the lanes that hold
//    it gives the lowest such lane;
// 3. one warp a cloud: the winner's index and coordinates reach the
//    warp by shuffles, and there is no barrier at all;
// 4. W warps in one block: the winning lane writes its record (x, y, z,
//    index) and key to slot [round & 1][warp] in shared memory, one
//    __syncthreads follows, and every thread reads the W keys (two
//    broadcast 16-byte loads; absent warps' keys stay 0), takes their
//    argmax as a tree over warps and the next centroid from the winning
//    record;
// 5. a cluster: the winning lane writes its record and key into slot
//    [round & 1][rank*W + warp] of every block of the cluster with
//    st.async, which counts the bytes on that block's mbarrier for the
//    round's parity; each block waits on its own mbarrier (the round's
//    one barrier), and every warp reduces the C*W records as in step 2
//    (lane l takes records l*per .. l*per + per - 1 in order). The
//    mbarrier takes the place of barrier.cluster, whose release compiles
//    to a device-wide memory fence that costs more than the rest of the
//    round.
// The parity double-buffers the slots, so no second barrier is needed:
// round r+1 writes the other parity, and round r+2's records are sent
// only after round r+1's barrier, which no warp reaches before it has
// read round r's.
//
// Padding. Slots past N start at distance -inf, which fminf keeps and
// which never beats a real slot, so a padding slot wins only in a
// thread that has no point. Such a thread reports the key 0, the key of
// a real distance 0 (npoint = N picks such points in its last rounds);
// it still loses that tie, because padding lies past every real point
// in the ownership order and the first occurrence wins.
//
// The picks: lane l of warp 0 of rank 0 keeps the pick of every round
// r with r % 32 == l in a register, and the warp stores each 32 picks
// as one coalesced 128-byte row.
//
// Rounding: the distance is ((dx*dx + dy*dy) + dz*dz), each operation
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn). nvcc would
// otherwise contract a*b+c into one FMA, move distances by an ulp and
// flip argmax ties against the plain PyTorch loop, which this kernel
// equals bit for bit.
#include <cooperative_groups.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 16;  // 8 portable, 16 with the attribute
constexpr int kPortableCluster = 8;
constexpr int kBlockWarps = 8;   // warps of a block outside a cluster

// Warps a block may have at P points a lane: the launch bound caps the
// registers at 65536 / threads, and a lane holds 4 P of them for its
// points plus about 32 for the rest.
template <int P>
constexpr int max_warps() {
  return P >= 32 ? 8 : (P >= 8 ? 16 : 32);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The lowest lane whose key is the warp's largest.
__device__ __forceinline__ int first_max_lane(unsigned key) {
  const unsigned top = __reduce_max_sync(kFull, key);
  return __ffs(__ballot_sync(kFull, key == top)) - 1;
}

// A 4-word store into block `rank`'s shared memory at the address that
// `local` has here, counted as bytes on that block's mbarrier `bar`.
__device__ __forceinline__ void store_remote(const void* local, const void* bar,
                                             int rank, uint4 v) {
  unsigned dst, dbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(dst) : "r"(smem_addr(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(dbar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(dbar)
      : "memory");
}

__device__ __forceinline__ void expect_bytes(const void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(const void* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// A warp's record of a round: its best point (the key lies beside it).
struct Record {
  float x, y, z;
  int index;
};

template <int P, bool CLUSTER>
__global__ void __launch_bounds__(32 * max_warps<P>())
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int n, int npoint, int* __restrict__ out) {
  // one block: [2][kBlockWarps] records and keys (absent warps' keys 0);
  // a cluster: [2][C*W] records as uint4 {x, y, z, index}, [2][C*W] keys
  // as uint4 {key, 0, 0, 0} (st.async writes 4 words), two mbarriers
  __shared__ __align__(16) Record brec[2][kBlockWarps];
  __shared__ __align__(16) unsigned bkey[2][kBlockWarps];
  extern __shared__ __align__(16) uint4 crec[];

  const int nwarps = blockDim.x >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = CLUSTER ? static_cast<int>(cluster.num_blocks()) : 1;
  const int rank = CLUSTER ? static_cast<int>(cluster.block_rank()) : 0;
  const int nrec = csize * nwarps;
  uint4* ckey = crec + 2 * nrec;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ckey + 2 * nrec);
  const int b = blockIdx.x / csize;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = ((rank * nwarps + warp) * 32 + lane) * P;
  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;

  float px[P], py[P], pz[P], pd[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int j = first + s;
    const bool real = j < n;
    px[s] = real ? cloud[3 * j] : 0.f;
    py[s] = real ? cloud[3 * j + 1] : 0.f;
    pz[s] = real ? cloud[3 * j + 2] : 0.f;
    pd[s] = real ? CUDART_INF_F : -CUDART_INF_F;
  }
  int far = start[b];
  float cx = cloud[3 * far], cy = cloud[3 * far + 1], cz = cloud[3 * far + 2];
  const bool writer = rank == 0 && warp == 0;
  int* picks = out + static_cast<size_t>(b) * npoint;
  int pick = 0;
  const unsigned bytes = nrec * 2 * sizeof(uint4);
  if (CLUSTER) {
    if (threadIdx.x == 0) {
      for (int p = 0; p < 2; ++p)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(smem_addr(bar + p)));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      expect_bytes(bar, bytes);
      expect_bytes(bar + 1, bytes);
    }
    // every block runs, its mbarriers armed, before the first remote store
    cluster_barrier();
  } else {
    if (threadIdx.x < 2 * kBlockWarps)  // keys of absent warps stay 0
      (&bkey[0][0])[threadIdx.x] = 0;
    __syncthreads();
  }

  for (int i = 0;; ++i) {
    if (lane == (i & 31)) pick = far;
    if (writer && ((i & 31) == 31 || i == npoint - 1) && lane <= (i & 31))
      picks[(i & ~31) + lane] = pick;
    if (i == npoint - 1) break;

    // the thread's distances, then their argmax as a tree over slots: a
    // higher slot replaces a lower one only when strictly larger
    float v[P], bx[P], by[P], bz[P];
    int bs[P];
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const float dx = __fsub_rn(px[s], cx);
      const float dy = __fsub_rn(py[s], cy);
      const float dz = __fsub_rn(pz[s], cz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
          __fmul_rn(dz, dz));
      pd[s] = fminf(pd[s], d);
      v[s] = pd[s];
      bs[s] = s;
      bx[s] = px[s];
      by[s] = py[s];
      bz[s] = pz[s];
    }
#pragma unroll
    for (int w = 1; w < P; w *= 2) {
#pragma unroll
      for (int s = 0; s + w < P; s += 2 * w) {
        if (v[s + w] > v[s]) {
          v[s] = v[s + w];
          bs[s] = bs[s + w];
          bx[s] = bx[s + w];
          by[s] = by[s + w];
          bz[s] = bz[s + w];
        }
      }
    }
    const unsigned mine = __float_as_uint(fmaxf(v[0], 0.f));
    const int win = first_max_lane(mine);
    const int par = i & 1;
    if (!CLUSTER && nwarps == 1) {
      far = __shfl_sync(kFull, first + bs[0], win);
      cx = __shfl_sync(kFull, bx[0], win);
      cy = __shfl_sync(kFull, by[0], win);
      cz = __shfl_sync(kFull, bz[0], win);
    } else if (!CLUSTER) {
      if (lane == win) {
        brec[par][warp] = Record{bx[0], by[0], bz[0], first + bs[0]};
        bkey[par][warp] = mine;
      }
      __syncthreads();
      // every thread scans the block's keys (a broadcast read), a tree
      // over warps as over slots
      const uint4 k0 = reinterpret_cast<const uint4*>(bkey[par])[0];
      const uint4 k1 = reinterpret_cast<const uint4*>(bkey[par])[1];
      unsigned k[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      int j[8] = {0, 1, 2, 3, 4, 5, 6, 7};
#pragma unroll
      for (int w = 1; w < 8; w *= 2) {
#pragma unroll
        for (int s = 0; s < 8; s += 2 * w) {
          if (k[s + w] > k[s]) {
            k[s] = k[s + w];
            j[s] = j[s + w];
          }
        }
      }
      const Record r = brec[par][j[0]];
      cx = r.x;
      cy = r.y;
      cz = r.z;
      far = r.index;
    } else {
      const int base = par * nrec;
      if (lane == win) {
        const int slot = base + rank * nwarps + warp;
        const uint4 r = make_uint4(__float_as_uint(bx[0]),
                                   __float_as_uint(by[0]),
                                   __float_as_uint(bz[0]), first + bs[0]);
        const uint4 k = make_uint4(mine, 0, 0, 0);
        for (int dst = 0; dst < csize; ++dst) {
          store_remote(crec + slot, bar + par, dst, r);
          store_remote(ckey + slot, bar + par, dst, k);
        }
      }
      wait_phase(bar + par, (i >> 1) & 1);
      // re-arm this parity for round i + 2: its records land only after
      // every warp of the cluster has read this round's (they are sent
      // after round i + 1's wait)
      if (threadIdx.x == 0) expect_bytes(bar + par, bytes);
      // lane l takes records l*per .. l*per + per - 1 in order
      const int per = (nrec + 31) >> 5;
      unsigned best = 0;
      uint4 br = make_uint4(0, 0, 0, 0);
      for (int t = 0; t < per; ++t) {
        const int j = lane * per + t;
        if (j < nrec) {
          const unsigned k = ckey[base + j].x;
          if (t == 0 || k > best) {
            best = k;
            br = crec[base + j];
          }
        }
      }
      const int top = first_max_lane(best);
      cx = __uint_as_float(__shfl_sync(kFull, br.x, top));
      cy = __uint_as_float(__shfl_sync(kFull, br.y, top));
      cz = __uint_as_float(__shfl_sync(kFull, br.z, top));
      far = static_cast<int>(__shfl_sync(kFull, br.w, top));
    }
  }
  // no block leaves while a remote store to it may be in flight
  if (CLUSTER) cluster_barrier();
}

template <int P>
cudaError_t launch(const float* xyz, const int* start, int b, int n,
                   int npoint, int warps, int csize, int* out,
                   cudaStream_t stream) {
  if (warps > max_warps<P>() || (csize == 1 && warps > kBlockWarps))
    return cudaErrorInvalidValue;
  if (csize == 1)
    return papc_launch(fps_kernel<P, false>, dim3(b), dim3(32 * warps), 0,
                       stream, xyz, start, n, npoint, out);
  const size_t smem =
      static_cast<size_t>(4) * csize * warps * sizeof(uint4) + 16;
  return papc_launch_cluster(fps_kernel<P, true>, dim3(b * csize),
                             dim3(32 * warps), smem, csize,
                             csize > kPortableCluster, stream, xyz, start, n,
                             npoint, out);
}

}  // namespace

// xyz [B, N, 3] f32 contiguous, start [B] i32 in [0, N) -> out [B, npoint]
// i32. The plan (warps W a block, points P a lane, cluster C blocks a
// cloud) comes from ops/kernels/fps.py::fps_plan; a plan that does not
// hold N, or whose P or W the kernel has no registers for, returns
// cudaErrorInvalidValue.
PAPC_EXPORT int papc_fps(const float* xyz, const int* start, int b, int n,
                         int npoint, int warps, int points_per_lane,
                         int cluster, int* out, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || warps < 1 || cluster < 1 ||
      cluster > kMaxCluster ||
      static_cast<long long>(32) * warps * points_per_lane * cluster < n)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (points_per_lane) {
    case 1: return launch<1>(xyz, start, b, n, npoint, warps, cluster, out, s);
    case 2: return launch<2>(xyz, start, b, n, npoint, warps, cluster, out, s);
    case 4: return launch<4>(xyz, start, b, n, npoint, warps, cluster, out, s);
    case 8: return launch<8>(xyz, start, b, n, npoint, warps, cluster, out, s);
    case 16: return launch<16>(xyz, start, b, n, npoint, warps, cluster, out, s);
    case 32: return launch<32>(xyz, start, b, n, npoint, warps, cluster, out, s);
    default: return cudaErrorInvalidValue;
  }
}
