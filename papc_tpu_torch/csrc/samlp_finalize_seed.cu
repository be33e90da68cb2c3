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
// What bounds them on the H100: bytes. finalize_max reads a once (SA1
// 524288 x 128, SA2 262144 x 256, SA3 4096 x 1024 bf16) and writes out and
// amax; bwd_seed writes dy (as large as a) and reads dout, amax and, of a,
// only the one element per (group, channel) at the argmax row: every other
// element of dy is 0 whatever a holds there.
//
// Design (the plans are ops/kernels/samlp_train.py::finalize_plan and
// ::seed_plan; blocks of 256 threads):
//  - finalize_max: a thread owns a chunk of V channels (8 where C % 8 == 0,
//    4 where C % 4 == 0, else 1) of one group and walks its rows with one
//    V-wide load a row (16 bytes at V = 8), four rows' loads in flight.
//    `lanes` neighbouring threads take neighbouring chunks of one row, so a
//    warp reads 32 / lanes rows of up to 256 contiguous bytes each. Where
//    groups x chunks threads would not fill the card (SA3's 32 groups),
//    the k rows of a group are split over `slices` row ranges taken by
//    threads of one block; their (max, row) pairs meet in shared memory
//    and merge in slice order, a larger value winning and a tie keeping
//    the earlier slice, which is the first occurrence. out and amax are
//    written V at a time.
//  - bwd_seed: a block takes `tile` whole groups (or, where one group's dy
//    is larger than a block's span, as at SA3, one group's `rows` rows),
//    so the dy it writes is one contiguous span. Phase 1: threads over
//    (group, chunk) read amax and dout V at a time and a at the argmax
//    row alone, form the gate and v = gate ? dout : 0, and leave, per
//    (group, channel), v's bf16 bits beside its row in one word of shared
//    memory, and v and v * xhat for the sums. An amax outside [0, k)
//    selects no row and reads nothing. Phase 2: the block writes its span
//    with V-wide stores (16 bytes at V = 8), each element 0 unless its row
//    is the one in its word. The block that holds a group's first row adds
//    the sums of its groups, in group order, into one row of partials
//    [tiles][2][C]; split_reduce (samlp_train.cuh) adds the rows in a
//    fixed order. Two launches a call; two calls give the same bits.
//  - The affine and x-hat use __fmul_rn / __fadd_rn / __fsub_rn: contracted
//    into an FMA, o would move by an ulp, flip the o > 0 gate or a tie of
//    the max, and switch a whole dy element on or off against the plain
//    version.
#include <cstdint>
#include <cstring>

#include "samlp_train.cuh"

namespace {

using samlp_train::affine;

constexpr int kThreads = 256;
constexpr unsigned kNoRow = 0xffffu;  // a key's row field: no row selected

// V bf16 channels moved by one load or store.
template <int V>
struct Chunk;
template <>
struct Chunk<8> {
  using T = uint4;
};
template <>
struct Chunk<4> {
  using T = uint2;
};
template <>
struct Chunk<1> {
  using T = unsigned short;
};

__device__ __forceinline__ unsigned word(const uint4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}
__device__ __forceinline__ unsigned word(const uint2& x, int i) {
  return i == 0 ? x.x : x.y;
}
__device__ __forceinline__ unsigned word(unsigned short x, int) { return x; }

// Channel i of a chunk as f32 (a bf16's bits are an f32's upper half).
template <typename T>
__device__ __forceinline__ float channel(const T& x, int i) {
  const unsigned w = word(x, i >> 1);
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// The bits of a 32-bit value as another 32-bit type.
template <typename To, typename From>
__device__ __forceinline__ To bits(From x) {
  static_assert(sizeof(To) == 4 && sizeof(From) == 4, "32-bit values");
  To t;
  memcpy(&t, &x, 4);
  return t;
}

// V values of 32 bits to and from memory: one or two 16-byte accesses
// (V = 4, 8; the address on 16 bytes), or one plain access (V = 1).
template <int V, typename W>
__device__ __forceinline__ void load_words(const W* p, W (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = *p;
  } else {
    const auto* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const uint4 u = q[i];
      x[4 * i] = bits<W>(u.x);
      x[4 * i + 1] = bits<W>(u.y);
      x[4 * i + 2] = bits<W>(u.z);
      x[4 * i + 3] = bits<W>(u.w);
    }
  }
}

template <int V, typename W>
__device__ __forceinline__ void store_words(W* p, const W (&x)[V]) {
  if constexpr (V == 1) {
    *p = x[0];
  } else {
    auto* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      uint4 u;
      u.x = bits<unsigned>(x[4 * i]);
      u.y = bits<unsigned>(x[4 * i + 1]);
      u.z = bits<unsigned>(x[4 * i + 2]);
      u.w = bits<unsigned>(x[4 * i + 3]);
      q[i] = u;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p,
                                           const unsigned (&h)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                   h[6] | h[7] << 16);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(h[0] | h[1] << 16,
                                              h[2] | h[3] << 16);
  } else {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(h[0]);
  }
}

// Thread t of a block: chunk `t % lanes` of the block's chunk range, row
// slice `(t / lanes) % slices`, group `t / (lanes * slices)` of the
// block's groups; block b: chunk range `b % ranges`, groups from
// `(b / ranges) * per_block`. Slice s walks rows [s * rows, s * rows +
// rows) of k.
template <int V>
__global__ void __launch_bounds__(kThreads)
    finalize_max_kernel(const __nv_bfloat16* __restrict__ a, int c, int k,
                        int groups, const float* __restrict__ vec, int lanes,
                        int slices, int rows, float* __restrict__ out,
                        int* __restrict__ amax) {
  using T = typename Chunk<V>::T;
  __shared__ float s_best[V * kThreads];
  __shared__ int s_arg[V * kThreads];
  const int chunks = c / V;
  const int ranges = (chunks + lanes - 1) / lanes;
  const int per_block = kThreads / (lanes * slices);
  const int t = threadIdx.x;
  const int lane = t % lanes, q = t / lanes;
  const int s = q % slices, gi = q / slices;
  const int g = (blockIdx.x / ranges) * per_block + gi;
  const int j = (blockIdx.x % ranges) * lanes + lane;
  const bool live = g < groups && j < chunks;
  float best[V];
  int arg[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    best[v] = -1.f;  // below every ReLU value: the first row always wins
    arg[v] = 0;
  }
  if (live) {
    float scale[V], shift[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      scale[v] = vec[j * V + v];
      shift[v] = vec[c + j * V + v];
    }
    const int r0 = s * rows, r1 = min(k, r0 + rows);
    const T* p = reinterpret_cast<const T*>(
        a + static_cast<size_t>(g) * k * c + static_cast<size_t>(j) * V);
    const size_t stride = c / V;  // one row, in chunks
    auto take = [&](const T& x, int r) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float o = affine(channel(x, v), scale[v], shift[v]);
        const float h = o > 0.f ? o : 0.f;
        if (h > best[v]) {
          best[v] = h;
          arg[v] = r;
        }
      }
    };
    int r = r0;
    for (; r + 4 <= r1; r += 4) {
      T x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = __ldg(p + (r + u) * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u) take(x[u], r + u);
    }
    for (; r < r1; ++r) take(__ldg(p + r * stride), r);
  }
  if (slices > 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s_best[v * kThreads + t] = best[v];
      s_arg[v * kThreads + t] = arg[v];
    }
    __syncthreads();
    if (s != 0) return;
    for (int s2 = 1; s2 < slices; ++s2) {
      const int u = (gi * slices + s2) * lanes + lane;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float h = s_best[v * kThreads + u];
        if (h > best[v]) {
          best[v] = h;
          arg[v] = s_arg[v * kThreads + u];
        }
      }
    }
  }
  if (!live) return;
  const size_t o = static_cast<size_t>(g) * c + static_cast<size_t>(j) * V;
  store_words<V>(out + o, best);
  store_words<V>(amax + o, arg);
}

// Block b: tile `b / splits` of `tile` groups, rows [r0, r0 + rows) of
// each with r0 = (b % splits) * rows (splits > 1 only where tile == 1).
// Shared memory: key [tile][C] (row - r0 << 16 | bf16 bits of v, or
// kNoRow << 16), and, for the sums, v and v * xhat [tile][C] f32.
template <int V>
__global__ void __launch_bounds__(kThreads)
    bwd_seed_kernel(const __nv_bfloat16* __restrict__ a, int c, int k,
                    int groups, const float* __restrict__ vec,
                    const float* __restrict__ dout,
                    const int* __restrict__ amax, int tile, int rows,
                    __nv_bfloat16* __restrict__ dy,
                    float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* s_key = reinterpret_cast<unsigned*>(smem);
  float* s_v = reinterpret_cast<float*>(s_key + tile * c);
  float* s_vx = s_v + tile * c;
  const int splits = (k + rows - 1) / rows;
  const int tile_id = blockIdx.x / splits;
  const int g0 = tile_id * tile;
  const int ng = min(tile, groups - g0);
  const int r0 = (blockIdx.x % splits) * rows, r1 = min(k, r0 + rows);
  const bool sums = r0 == 0;
  const int chunks = c / V;

  for (int i = threadIdx.x; i < ng * chunks; i += kThreads) {
    const int gl = i / chunks, j = i - gl * chunks;
    const size_t gc = static_cast<size_t>(g0 + gl) * c + j * V;
    int am[V];
    float d[V];
    load_words<V>(amax + gc, am);
    load_words<V>(dout + gc, d);
    unsigned key[V];
    float val[V], vx[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int ch = j * V + v, r = am[v];
      const bool mine = r >= r0 && r < r1;
      key[v] = kNoRow << 16;
      val[v] = 0.f;
      vx[v] = 0.f;
      if (r >= 0 && r < k && (mine || sums)) {
        const float av = samlp_train::bf2f(
            a[(static_cast<size_t>(g0 + gl) * k + r) * c + ch]);
        if (affine(av, vec[ch], vec[c + ch]) > 0.f) {
          val[v] = d[v];
          vx[v] = __fmul_rn(d[v], __fmul_rn(__fsub_rn(av, vec[2 * c + ch]),
                                            vec[3 * c + ch]));
        }
        if (mine)
          key[v] = static_cast<unsigned>(r - r0) << 16 |
                   __bfloat16_as_ushort(__float2bfloat16_rn(val[v]));
      }
    }
    store_words<V>(s_key + gl * c + j * V, key);
    if (sums) {
      store_words<V>(s_v + gl * c + j * V, val);
      store_words<V>(s_vx + gl * c + j * V, vx);
    }
  }
  __syncthreads();
  if (sums) {
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      float s1 = 0.f, s2 = 0.f;
      for (int gl = 0; gl < ng; ++gl) {
        s1 += s_v[gl * c + ch];
        s2 += s_vx[gl * c + ch];
      }
      partials[static_cast<size_t>(tile_id) * 2 * c + ch] = s1;
      partials[(static_cast<size_t>(tile_id) * 2 + 1) * c + ch] = s2;
    }
  }

  // The span: rows r0..r1 of groups g0..g0 + ng, contiguous since a block
  // takes whole groups or rows of one group. Thread t walks its chunks
  // t, t + kThreads, ... as (span row, chunk j), the row also as (group
  // gl, row r of r1 - r0), stepped without division.
  const int nr = r1 - r0, span_rows = ng * nr;
  __nv_bfloat16* base = dy + (static_cast<size_t>(g0) * k + r0) * c;
  const int drow = kThreads / chunks, dj = kThreads % chunks;
  int row = threadIdx.x / chunks, j = threadIdx.x % chunks;
  int gl = row / nr, r = row % nr;
  while (row < span_rows) {
    unsigned key[V], h[V];
    load_words<V>(s_key + gl * c + j * V, key);
#pragma unroll
    for (int v = 0; v < V; ++v)
      h[v] = (key[v] >> 16) == static_cast<unsigned>(r) ? key[v] & 0xffffu
                                                        : 0u;
    store_bf16<V>(base + static_cast<size_t>(row) * c + j * V, h);
    row += drow;
    r += drow;
    j += dj;
    if (j >= chunks) {
      j -= chunks;
      ++row;
      ++r;
    }
    while (r >= nr) {
      r -= nr;
      ++gl;
    }
  }
}

template <int V>
cudaError_t launch_finalize(const __nv_bfloat16* a, int c, int k, int groups,
                            const float* vec, int lanes, int slices, int rows,
                            int blocks, float* out, int* amax,
                            cudaStream_t s) {
  return papc_launch(finalize_max_kernel<V>, dim3(blocks), dim3(kThreads), 0,
                     s, a, c, k, groups, vec, lanes, slices, rows, out, amax);
}

template <int V>
cudaError_t launch_seed(const __nv_bfloat16* a, int c, int k, int groups,
                        const float* vec, const float* dout, const int* amax,
                        int tile, int rows, int blocks, size_t smem,
                        __nv_bfloat16* dy, float* partials, cudaStream_t s) {
  return papc_launch(bwd_seed_kernel<V>, dim3(blocks), dim3(kThreads), smem,
                     s, a, c, k, groups, vec, dout, amax, tile, rows, dy,
                     partials);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// a [M, C] bf16, M a multiple of k; vec f32 rows (scale, shift, ...) of
// width C, of which rows 0 and 1 are read -> out [M/k, C] f32, amax
// [M/k, C] i32. The plan (finalize_plan): v channels a thread's load,
// `lanes` chunks a block row, k split into `slices` ranges of `rows`,
// `blocks` blocks of 256 threads; a plan that does not cover the tensor
// exactly is refused (cudaErrorInvalidValue), as is an a, out or amax off
// 16 bytes where v > 1.
PAPC_EXPORT int papc_samlp_finalize_max(const void* a, int m, int c, int k,
                                        const float* vec, int v, int lanes,
                                        int slices, int rows, int blocks,
                                        float* out, int* amax, void* stream) {
  if (m <= 0 || c <= 0 || k <= 0 || m % k != 0 ||
      (v != 1 && v != 4 && v != 8) || c % v != 0 || lanes <= 0 ||
      slices <= 0 || lanes * slices > kThreads ||
      kThreads % (lanes * slices) != 0 || rows <= 0 ||
      static_cast<long long>(slices) * rows < k || (slices - 1) * rows >= k)
    return cudaErrorInvalidValue;
  const int groups = m / k, chunks = c / v;
  const int per_block = kThreads / (lanes * slices);
  const long long want = static_cast<long long>((groups + per_block - 1) /
                                                per_block) *
                         ((chunks + lanes - 1) / lanes);
  if (blocks != want ||
      (v > 1 && !(aligned16(a) && aligned16(out) && aligned16(amax))))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a_b = static_cast<const __nv_bfloat16*>(a);
  if (v == 8)
    return launch_finalize<8>(a_b, c, k, groups, vec, lanes, slices, rows,
                              blocks, out, amax, s);
  if (v == 4)
    return launch_finalize<4>(a_b, c, k, groups, vec, lanes, slices, rows,
                              blocks, out, amax, s);
  return launch_finalize<1>(a_b, c, k, groups, vec, lanes, slices, rows,
                            blocks, out, amax, s);
}

// a [M, C] bf16; vec f32 [4, C] (scale, shift, mean, inv_std); dout, amax
// [M/k, C] f32 / i32 -> dy [M, C] bf16, partials [tiles, 2, C] (scratch,
// tiles = ceil((M/k) / tile)), sums [2, C] f32. The plan (seed_plan): v
// channels a thread's load and store, `tile` groups a block, each split
// into ranges of `rows` rows (rows < k only with tile 1), `blocks` = tiles
// x ceil(k / rows) blocks of 256 threads; a plan that does not cover the
// tensor exactly is refused (cudaErrorInvalidValue), as is a k above
// 65534 (a row must fit a key's 16 bits) or a dout, amax or dy off 16
// bytes where v > 1.
PAPC_EXPORT int papc_samlp_bwd_seed(const void* a, int m, int c, int k,
                                    const float* vec, const float* dout,
                                    const int* amax, int v, int tile,
                                    int rows, int blocks, void* dy,
                                    float* partials, float* sums,
                                    void* stream) {
  if (m <= 0 || c <= 0 || k <= 0 || m % k != 0 || k >= static_cast<int>(kNoRow) ||
      (v != 1 && v != 4 && v != 8) || c % v != 0 || tile <= 0 ||
      rows <= 0 || rows > k || (rows < k && tile != 1))
    return cudaErrorInvalidValue;
  const int groups = m / k, tiles = (groups + tile - 1) / tile;
  const size_t smem = static_cast<size_t>(tile) * c * 12;
  if (blocks != static_cast<long long>(tiles) * ((k + rows - 1) / rows) ||
      smem > 232448 ||
      (v > 1 && !(aligned16(dout) && aligned16(amax) && aligned16(dy))))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a_b = static_cast<const __nv_bfloat16*>(a);
  auto* dy_b = static_cast<__nv_bfloat16*>(dy);
  cudaError_t err;
  if (v == 8)
    err = launch_seed<8>(a_b, c, k, groups, vec, dout, amax, tile, rows,
                         blocks, smem, dy_b, partials, s);
  else if (v == 4)
    err = launch_seed<4>(a_b, c, k, groups, vec, dout, amax, tile, rows,
                         blocks, smem, dy_b, partials, s);
  else
    err = launch_seed<1>(a_b, c, k, groups, vec, dout, amax, tile, rows,
                         blocks, smem, dy_b, partials, s);
  if (err != cudaSuccess) return err;
  const samlp_train::SplitSum none{nullptr, 0, 0, 0, 0, 0, nullptr};
  return samlp_train::split_reduce({partials, tiles, 2, c, 2, c, sums}, none,
                                   32, s);
}
