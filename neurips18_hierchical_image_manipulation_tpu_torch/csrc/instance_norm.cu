// InstanceNorm2d(affine=False) forward on NHWC, fused with an optional
// residual add and an optional activation:  y = act(IN(x) + residual).
// eps 1e-5 inside the sqrt, biased variance, fp32 statistics, IO in the
// input dtype (fp32 or bf16). Also emits the per-(n, c) mean and rstd in
// fp32 for the backward pass.
//
// Replaces the forward TPU kernel of ops/pallas/instance_norm.py in the
// JAX package (fused_instance_norm -> _run_fwd / _fwd_kernel).
//
// Bound: bytes. x (and the residual) read once, y written once, a few
// operations an element: 0.105 ms at 3.35 TB/s over the 27 sites of a bs-1
// 512x256 fp32 forward (chip_smoke.in_bytes). The TPU kernel walks the HW
// axis SEQUENTIALLY inside one grid cell, carrying sum / sum-of-squares in
// VMEM from one step to the next, then walks it again to normalize. Blocks
// on this card run in parallel and in no order, so nothing can be carried
// between them; instead the (sample, 32-channel) plane is split over the
// blocks of a thread-block cluster that together hold it in shared memory:
//
//   cluster form (one launch; kernels/instance_norm._fwd_plan picks it where
//             a plane's rows fit 16 blocks' shared memory, <= 192 KB of x a
//             block): grid (cs, C / 32, N), cluster (cs, 1, 1), 256 threads.
//             Block `rank` copies x of its `chunk` rows x 32 channels into
//             shared memory with 16-byte cp.async, the only read of x. Exact
//             two-pass statistics from there: each thread sums its rows in
//             order, a shuffle tree and the 8 warps in order give the
//             block's sums, which the cs blocks exchange through distributed
//             shared memory, every block adding them in rank order 0..cs-1
//             (so all blocks hold the same mean bits); after a cluster
//             barrier the same for the sums of (x - mean)^2. Rank 0 writes
//             mean and rstd; every block normalizes its rows from shared
//             memory, reads the residual with 16-byte loads and writes y
//             once with 16-byte stores.
//   split form (planes too large for 16 blocks: at 512x256 the G stem, first
//             down and last two ups; channel counts off the 16-byte vectors,
//             with scalar accesses): two launches over the same (split,
//             channel tile, n) blocks. Launch 1 writes each block's Chan
//             partial (mean, M2) of its rows: each thread folds in four rows
//             at a time (their exact mean and M2, one Chan merge, one
//             division for its channels), then lanes and warps merge in a
//             fixed order. Launch 2 visits the blocks in reverse order, so
//             that its first reads find the rows launch 1 read last in L2;
//             each block merges its channels' S partials itself in a fixed
//             order (eight strided runs, then the eight in order: no
//             finalize launch, the same bits in every block), the lowest
//             split writes mean and rstd, and it normalizes its rows,
//             reading x a second time.
// Welford / Chan or exact two-pass sums throughout: no one-pass E[x^2] -
// E[x]^2 over a long run of values (it cancels when |mean| >> std).
//
// Backward (himan_instance_norm_bwd), replacing ops/pallas/instance_norm.py
// _run_bwd / _bwd_kernel of the JAX package. From the saved x, y, mean and
// rstd and the cotangent g of y:
//   gm = g * act'(y)     relu: y > 0 ? 1 : 0   lrelu: y >= 0 ? 1 : 0.2
//   dx = (gm - mean(gm) - xhat * mean(gm * xhat)) * rstd,  xhat = (x-mean)*rstd
// and, where a residual was added before the activation, dres = gm.
// Bound: bytes. x, g (and y) read once, dx (and dres) written once, a few
// operations an element: 0.24 ms at 3.35 TB/s over the 39 sites of a bs-1
// 512x256 fp32 train step (chip_smoke.in_bwd_bytes). The TPU kernel keeps
// one (sample, channel tile) plane in VMEM and walks it twice; here, as in
// the forward, the plane is split over the blocks of a cluster:
//
//   cluster form (one launch; kernels/instance_norm._bwd_plan picks it where
//             a plane's rows fit 16 blocks' shared memory): grid (cs, C /
//             32, N), cluster (cs, 1, 1), 256 threads a block. Block `rank`
//             copies x, g (and y) of its `chunk` rows x 32 channels into
//             shared memory with 16-byte cp.async (<= 192 KB), sums gm and
//             gm * xhat there (each thread over its rows in order, a shuffle
//             tree, then the 8 warps in order), exchanges the two sums
//             through distributed shared memory, where every block adds the
//             cs partials in rank order 0..cs-1 (so all blocks hold the same
//             bits), and after a cluster barrier writes dx (and dres) for its
//             rows from shared memory with 16-byte stores: x, y, g read once.
//   split form (the G stem and first down, 256x512x64 and 128x256x128, too
//             large for any cluster; odd channel counts): two launches over
//             the same (split, channel tile, n) blocks. Launch 1 writes each
//             block's two sums; launch 2 visits the blocks in reverse order,
//             so that its first reads find the rows launch 1 read last in
//             L2, sums the splits' partials of its channels in a fixed
//             order (four strided runs, then the four in order) and writes
//             dx: x, y, g are read twice, five or seven passes against the
//             bound's four or five.
// 16-byte vectors throughout: 4 fp32 or 8 bf16 channels a thread. No
// atomics, and every sum in a fixed order: the same bits on every run.
//
// Limits, checked by the wrapper: N <= 65535 (grid.z, grid.y) and
// HW * C < 2^30 (32-bit index within one sample).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;        // channels per block (one per lane)
constexpr int kSlab = 196608;    // a cluster block's shared-memory slab, at most
                                 // (kernels/instance_norm._SLAB)

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Chan et al.: merge (nb, mb, qb) into (na, ma, qa)
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& qa,
                                           float nb, float mb, float qb) {
  const float n = na + nb;
  if (nb == 0.0f) return;
  if (na == 0.0f) {
    na = nb;
    ma = mb;
    qa = qb;
    return;
  }
  const float d = mb - ma;
  const float fb = nb / n;
  ma = ma + d * fb;
  qa = qa + qb + d * d * na * fb;
  na = n;
}

// The same for NV channels that share their counts: one division for all
// (with na == 0 it gives mb and qb exactly)
template <int NV>
__device__ __forceinline__ void chan_merge_v(float& na, float (&ma)[NV], float (&qa)[NV],
                                             float nb, const float (&mb)[NV],
                                             const float (&qb)[NV]) {
  if (nb == 0.0f) return;
  const float n = na + nb, fb = nb / n, w = na * fb;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float d = mb[j] - ma[j];
    ma[j] += d * fb;
    qa[j] += qb[j] + d * d * w;
  }
  na = n;
}

// d act(v) / dv from the activation's output y = act(v)
__device__ __forceinline__ float act_grad(float g, float y, int act) {
  if (act == 1) return y > 0.0f ? g : 0.0f;
  if (act == 2) return y >= 0.0f ? g : 0.2f * g;
  return g;
}

// Vectors of VEC channels: 16 bytes, 4 fp32 or 8 bf16. Without `vec` (C
// not a multiple of VEC: rows not 16-byte aligned) or with `n` < VEC (the
// channel tail) the access is scalar.
template <typename T>
struct V {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[V<T>::N]);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ void load_v(const T* p, int n, bool vec, float (&v)[V<T>::N]) {
  if (vec && n >= V<T>::N) {
    unpack<T>(*reinterpret_cast<const uint4*>(p), v);
    return;
  }
#pragma unroll
  for (int j = 0; j < V<T>::N; ++j) v[j] = j < n ? to_f<T>(p[j]) : 0.0f;
}

template <typename T>
__device__ __forceinline__ void store_v(T* p, int n, bool vec, const float (&v)[V<T>::N]) {
  if (vec && n >= V<T>::N) {
    __align__(16) T t[V<T>::N];
#pragma unroll
    for (int j = 0; j < V<T>::N; ++j) t[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(t);
    return;
  }
#pragma unroll
  for (int j = 0; j < V<T>::N; ++j)
    if (j < n) p[j] = from_f<T>(v[j]);
}

// The thread layout of both directions: a block owns 32 channels (kTile)
// of one sample and a run of rows. Thread t takes the VEC channels (t % G)
// * VEC.. of rows t / G, t / G + RP, ...: G = 32 / VEC vectors a row, RP =
// 256 / G row lanes (fp32 8 x 32, bf16 4 x 64). A warp covers 4 (8) whole
// rows.
template <typename T>
struct Layout {
  static constexpr int VEC = V<T>::N;
  static constexpr int G = kTile / VEC;
  static constexpr int RP = 256 / G;
};

// One thread's gm and gm * xhat sums over its rows of [r0, r1), then the
// block's per-channel sums: lanes of a warp by a shuffle tree, then the 8
// warps in order, into out[0][32] (gm) and out[1][32] (gm * xhat). Every
// order is fixed. `rows` reads row r's three vectors into xv, yv, gv.
template <typename T, typename Rows>
__device__ __forceinline__ void bwd_block_sums(int nrows, float mu[], float rs[],
                                               int act, Rows rows,
                                               float (*out)[kTile]) {
  using L = Layout<T>;
  __shared__ float red[2][8][kTile];
  const int tid = threadIdx.x, grp = tid % L::G;
  float sg[L::VEC], sgx[L::VEC];
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) sg[j] = sgx[j] = 0.0f;
  for (int r = tid / L::G; r < nrows; r += L::RP) {
    float xv[L::VEC], yv[L::VEC], gv[L::VEC];
    rows(r, xv, yv, gv);
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) {
      const float gm = act_grad(gv[j], yv[j], act);
      sg[j] += gm;
      sgx[j] += gm * ((xv[j] - mu[j]) * rs[j]);
    }
  }
#pragma unroll
  for (int off = L::G; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) {
      sg[j] += __shfl_xor_sync(0xffffffffu, sg[j], off);
      sgx[j] += __shfl_xor_sync(0xffffffffu, sgx[j], off);
    }
  const int warp = tid / 32;
  if (tid % 32 < L::G)
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) {
      red[0][warp][grp * L::VEC + j] = sg[j];
      red[1][warp][grp * L::VEC + j] = sgx[j];
    }
  __syncthreads();
  if (tid < 2 * kTile) {
    const int k = tid / kTile, c = tid % kTile;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[k][w][c];
    out[k][c] = s;
  }
}

// dx (and dres) for this thread's rows of the block, from the two means.
template <typename T, typename Rows>
__device__ __forceinline__ void bwd_block_dx(int nrows, const float mu[],
                                             const float rs[], const float a[],
                                             const float b[], int act, Rows rows,
                                             T* dx, T* dres, int64_t row0, int C,
                                             int nvalid, bool vec) {
  using L = Layout<T>;
  for (int r = threadIdx.x / L::G; r < nrows; r += L::RP) {
    float xv[L::VEC], yv[L::VEC], gv[L::VEC], d[L::VEC], gmv[L::VEC];
    rows(r, xv, yv, gv);
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) {
      gmv[j] = act_grad(gv[j], yv[j], act);
      d[j] = (gmv[j] - a[j] - ((xv[j] - mu[j]) * rs[j]) * b[j]) * rs[j];
    }
    const int64_t o = (row0 + r) * C;
    store_v<T>(dx + o, nvalid, vec, d);
    if (dres != nullptr) store_v<T>(dres + o, nvalid, vec, gmv);
  }
}

// Reads the three vectors of one row from device memory.
template <typename T>
struct GlobalRows {
  const T *x, *y, *g;  // at (row0, this thread's first channel)
  int C, n;
  bool vec;
  __device__ void operator()(int r, float (&xv)[V<T>::N], float (&yv)[V<T>::N],
                             float (&gv)[V<T>::N]) const {
    const int64_t o = (int64_t)r * C;
    load_v<T>(x + o, n, vec, xv);
    load_v<T>(g + o, n, vec, gv);
    if (y != nullptr) load_v<T>(y + o, n, vec, yv);
  }
};

// Reads the three vectors of one row from the block's shared-memory slab.
template <typename T>
struct SharedRows {
  const T *x, *y, *g;  // at (row 0, this thread's first channel)
  __device__ void operator()(int r, float (&xv)[V<T>::N], float (&yv)[V<T>::N],
                             float (&gv)[V<T>::N]) const {
    const int o = r * kTile;
    unpack<T>(*reinterpret_cast<const uint4*>(x + o), xv);
    unpack<T>(*reinterpret_cast<const uint4*>(g + o), gv);
    if (y != nullptr) unpack<T>(*reinterpret_cast<const uint4*>(y + o), yv);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ float act_fwd(float v, int act) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return v >= 0.0f ? v : v * 0.2f;
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive();
  cluster_wait();
}

// The block's per-channel sums of each thread's VEC partial sums s: lanes
// that share channels by a shuffle tree, then the 8 warps in order, into
// out[32] (written by the first 32 threads). red: [8][kTile] scratch.
template <typename T>
__device__ __forceinline__ void fwd_block_sum(float (&s)[V<T>::N], float (*red)[kTile],
                                              float* out) {
  using L = Layout<T>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = L::G; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
  if (tid % 32 < L::G)
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) red[tid / 32][(tid % L::G) * L::VEC + j] = s[j];
  __syncthreads();
  if (tid < kTile) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += red[w][tid];
    out[tid] = t;
  }
}

// act((v - mu) * rs + res) of one row's vector, stored at yp
template <typename T>
__device__ __forceinline__ void fwd_store(T* yp, const T* rp, float (&v)[V<T>::N],
                                          const float (&mu)[V<T>::N], const float (&rs)[V<T>::N],
                                          int act, int nvalid, bool vec) {
  float rv[V<T>::N];
  if (rp != nullptr) load_v<T>(rp, nvalid, vec, rv);
#pragma unroll
  for (int j = 0; j < V<T>::N; ++j) {
    float o = (v[j] - mu[j]) * rs[j];
    if (rp != nullptr) o += rv[j];
    v[j] = act_fwd(o, act);
  }
  store_v<T>(yp, nvalid, vec, v);
}

// Cluster form: one launch, grid (cluster size, channel tiles, N), cluster
// (cs, 1, 1), 256 threads. Block `rank` owns rows [rank * chunk, ...) of
// its (sample, 32 channels) and holds x of those rows in shared memory.
// C % VEC == 0.
template <typename T>
__global__ void __launch_bounds__(256)
in_fwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd, int HW, int C,
                      int chunk, int act, float eps) {
  using L = Layout<T>;
  extern __shared__ uint4 slab[];
  __shared__ float part[2][kTile];  // this block's sums of x, then of (x - mean)^2
  __shared__ float stat[2][kTile];  // the plane's mean and rstd
  __shared__ float red[8][kTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int n = blockIdx.z, c0 = blockIdx.y * kTile, tid = threadIdx.x;
  const int r0 = rank * chunk, nrows = min(chunk, HW - r0);
  T* sx = reinterpret_cast<T*>(slab);
  const int64_t base = ((int64_t)n * HW + r0) * C + c0;
  for (int i = tid; i < nrows * L::G; i += 256) {
    const int r = i / L::G, v = (i % L::G) * L::VEC;
    if (c0 + v < C) cp_async16(sx + r * kTile + v, x + base + (int64_t)r * C + v);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int v0 = (tid % L::G) * L::VEC;
  const int rows = c0 + v0 < C ? nrows : 0;  // a live vector is whole
  float s[L::VEC], v[L::VEC], mu[L::VEC], rs[L::VEC];
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) s[j] = 0.0f;
  for (int r = tid / L::G; r < rows; r += L::RP) {
    unpack<T>(*reinterpret_cast<const uint4*>(sx + r * kTile + v0), v);
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) s[j] += v[j];
  }
  fwd_block_sum<T>(s, red, part[0]);
  cluster_sync_all();
  if (tid < kTile) {
    float t = 0.0f;
    for (int q = 0; q < cs; ++q) t += cluster.map_shared_rank(&part[0][0], q)[tid];
    stat[0][tid] = t / (float)HW;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) {
    mu[j] = stat[0][v0 + j];
    s[j] = 0.0f;
  }
  for (int r = tid / L::G; r < rows; r += L::RP) {
    unpack<T>(*reinterpret_cast<const uint4*>(sx + r * kTile + v0), v);
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) s[j] += (v[j] - mu[j]) * (v[j] - mu[j]);
  }
  fwd_block_sum<T>(s, red, part[1]);
  cluster_sync_all();
  if (tid < kTile) {
    float t = 0.0f;
    for (int q = 0; q < cs; ++q) t += cluster.map_shared_rank(&part[1][0], q)[tid];
    stat[1][tid] = 1.0f / sqrtf(t / (float)HW + eps);
  }
  cluster_arrive();  // no other block's shared memory is read from here on
  __syncthreads();
  if (rank == 0 && tid < kTile && c0 + tid < C) {
    mean[n * C + c0 + tid] = stat[0][tid];
    rstd[n * C + c0 + tid] = stat[1][tid];
  }
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) rs[j] = stat[1][v0 + j];
  const int64_t o0 = base + v0;
#pragma unroll 4
  for (int r = tid / L::G; r < rows; r += L::RP) {
    unpack<T>(*reinterpret_cast<const uint4*>(sx + r * kTile + v0), v);
    const int64_t o = o0 + (int64_t)r * C;
    fwd_store<T>(y + o, res != nullptr ? res + o : nullptr, v, mu, rs, act, L::VEC, true);
  }
  cluster_wait();  // no block leaves while another may still read its sums
}

// Split form, launch 1: grid (S, channel tiles, N), 256 threads; the
// block's Chan partial (mean, M2) of its `chunk` rows to part (2 planes of
// N * S * C), read from device memory (16-byte loads where C allows).
template <typename T>
__global__ void __launch_bounds__(256)
in_fwd_split_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int HW, int C,
                          int S, int chunk) {
  using L = Layout<T>;
  constexpr int NV = L::VEC;
  __shared__ float wc[8], wm[8][kTile], wq[8][kTile];
  const int s = blockIdx.x, n = blockIdx.z, c0 = blockIdx.y * kTile, tid = threadIdx.x;
  const int r0 = s * chunk, nrows = min(chunk, HW - r0);
  const int v0 = (tid % L::G) * NV, c = c0 + v0;
  const int nvalid = min(NV, C - c);
  const bool vec = C % NV == 0;
  const T* xp = x + ((int64_t)n * HW + r0) * C + c;
  float cnt = 0.0f, m[NV], q[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) m[j] = q[j] = 0.0f;
  // four rows a group (eight took 108-120 registers a thread and two
  // resident blocks an SM on H100)
  constexpr int GR = 4;
  for (int r = tid / L::G; r < nrows; r += GR * L::RP) {
    // rows r, r + RP, r + 2 RP, r + 3 RP (those below nrows): their exact
    // mean and M2 join the running ones by one Chan merge
    int k = 0;
    float v[GR][NV], mb[NV], qb[NV];
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      if (r + i * L::RP < nrows) {
        load_v<T>(xp + (int64_t)(r + i * L::RP) * C, nvalid, vec, v[i]);
        ++k;
      } else {
#pragma unroll
        for (int j = 0; j < NV; ++j) v[i][j] = 0.0f;
      }
    }
    const float inv = 1.0f / (float)k;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float t = 0.0f;
#pragma unroll
      for (int i = 0; i < GR; ++i) t += v[i][j];
      mb[j] = t * inv;
      qb[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < GR; ++i)
        if (i < k) qb[j] += (v[i][j] - mb[j]) * (v[i][j] - mb[j]);
    }
    chan_merge_v<NV>(cnt, m, q, (float)k, mb, qb);
  }
  // lanes that share channels: lane l takes lane l + off, down to the G
  // lanes of the first row lane (only lanes whose result is taken next are
  // read)
#pragma unroll
  for (int off = 16; off >= L::G; off >>= 1) {
    float mb[NV], qb[NV];
    const float nb = __shfl_down_sync(0xffffffffu, cnt, off);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      mb[j] = __shfl_down_sync(0xffffffffu, m[j], off);
      qb[j] = __shfl_down_sync(0xffffffffu, q[j], off);
    }
    chan_merge_v<NV>(cnt, m, q, nb, mb, qb);
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < L::G) {
    if (lane == 0) wc[warp] = cnt;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      wm[warp][v0 + j] = m[j];
      wq[warp][v0 + j] = q[j];
    }
  }
  __syncthreads();
  if (tid < kTile && c0 + tid < C) {
    float nt = 0.0f, mt = 0.0f, qt = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) chan_merge(nt, mt, qt, wc[w], wm[w][tid], wq[w][tid]);
    const int64_t o = ((int64_t)n * S + s) * C + c0 + tid;
    part[o] = mt;
    part[(int64_t)gridDim.z * S * C + o] = qt;
  }
}

// Split form, launch 2: the same blocks in reverse order (the last blocks
// of launch 1 ran last, so their rows are the likeliest still in L2). Each
// block merges the S partials of its channels in a fixed order, then
// normalizes its rows, reading x a second time.
template <typename T>
__global__ void __launch_bounds__(256)
in_fwd_split_norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         const float* __restrict__ part, T* __restrict__ y,
                         float* __restrict__ mean, float* __restrict__ rstd, int HW, int C,
                         int S, int chunk, int act, float eps) {
  using L = Layout<T>;
  constexpr int NV = L::VEC;
  __shared__ float pc[8][kTile], pm[8][kTile], pq[8][kTile];
  __shared__ float stat[2][kTile];
  const int s = gridDim.x - 1 - blockIdx.x, n = gridDim.z - 1 - blockIdx.z;
  const int c0 = (gridDim.y - 1 - blockIdx.y) * kTile, tid = threadIdx.x;
  {
    // 8 threads a channel take every 8th split in order (their loads 8 at a
    // time in flight), then the 8 are merged in order
    const int cc = tid % kTile, q0 = tid / kTile;
    float nt = 0.0f, mt = 0.0f, qt = 0.0f;
    if (c0 + cc < C) {
      const int64_t plane = (int64_t)gridDim.z * S * C;
      const float* p = part + (int64_t)n * S * C + c0 + cc;
      for (int q = q0; q < S; q += 64) {
        float pm[8], pq[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (q + 8 * i < S) {
            pm[i] = p[(int64_t)(q + 8 * i) * C];
            pq[i] = p[plane + (int64_t)(q + 8 * i) * C];
          }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (q + 8 * i < S)
            chan_merge(nt, mt, qt, (float)min(chunk, HW - (q + 8 * i) * chunk), pm[i], pq[i]);
      }
    }
    pc[q0][cc] = nt;
    pm[q0][cc] = mt;
    pq[q0][cc] = qt;
  }
  __syncthreads();
  if (tid < kTile) {
    float nt = 0.0f, mt = 0.0f, qt = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) chan_merge(nt, mt, qt, pc[w][tid], pm[w][tid], pq[w][tid]);
    stat[0][tid] = mt;
    stat[1][tid] = 1.0f / sqrtf(qt / (float)HW + eps);
    if (s == 0 && c0 + tid < C) {
      mean[n * C + c0 + tid] = mt;
      rstd[n * C + c0 + tid] = stat[1][tid];
    }
  }
  __syncthreads();
  const int v0 = (tid % L::G) * NV, c = c0 + v0;
  const int nvalid = min(NV, C - c);
  if (nvalid <= 0) return;
  const bool vec = C % NV == 0;
  float mu[NV], rs[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    mu[j] = stat[0][v0 + j];
    rs[j] = stat[1][v0 + j];
  }
  const int r0 = s * chunk, nrows = min(chunk, HW - r0);
  const int64_t o0 = ((int64_t)n * HW + r0) * C + c;
  constexpr int GR = 4;
  for (int r = tid / L::G; r < nrows; r += GR * L::RP) {
    float v[GR][NV];  // four rows' loads in flight
#pragma unroll
    for (int i = 0; i < GR; ++i)
      if (r + i * L::RP < nrows) load_v<T>(x + o0 + (int64_t)(r + i * L::RP) * C, nvalid, vec, v[i]);
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      if (r + i * L::RP >= nrows) break;
      const int64_t o = o0 + (int64_t)(r + i * L::RP) * C;
      fwd_store<T>(y + o, res != nullptr ? res + o : nullptr, v[i], mu, rs, act, nvalid, vec);
    }
  }
}

// This thread's channels: valid count, mean and rstd (zeros past C).
template <typename T>
__device__ __forceinline__ int bwd_stats(const float* mean, const float* rstd,
                                         int nc0, int c, int C,
                                         float (&mu)[V<T>::N], float (&rs)[V<T>::N]) {
  const int nvalid = min(V<T>::N, C - c);
#pragma unroll
  for (int j = 0; j < V<T>::N; ++j) {
    mu[j] = j < nvalid ? mean[nc0 + c + j] : 0.0f;
    rs[j] = j < nvalid ? rstd[nc0 + c + j] : 0.0f;
  }
  return nvalid;
}

// One launch: grid (cluster size, channel tiles, N), cluster (cs, 1, 1),
// 256 threads. Block `rank` of the cluster owns rows [rank * chunk, ...) of
// its (sample, 32 channels): it copies x, g (and y) of those rows into
// shared memory once (cp.async, 16 bytes), sums from there, exchanges the
// sums with the other blocks of the cluster through distributed shared
// memory (summed in rank order 0..cs-1 by every block, so all blocks hold
// the same bits), and writes dx from shared memory. C % VEC == 0.
template <typename T>
__global__ void __launch_bounds__(256)
in_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ y,
                      const T* __restrict__ g, const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      T* __restrict__ dres, int HW, int C, int chunk, int act) {
  using L = Layout<T>;
  extern __shared__ uint4 slab[];
  __shared__ float sums[2][kTile];
  __shared__ float means[2][kTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int n = blockIdx.z, c0 = blockIdx.y * kTile, tid = threadIdx.x;
  const int r0 = rank * chunk, nrows = min(chunk, HW - r0);
  T* sx = reinterpret_cast<T*>(slab);
  T* sg = sx + chunk * kTile;
  T* sy = y != nullptr ? sg + chunk * kTile : nullptr;
  const int64_t base = ((int64_t)n * HW + r0) * C + c0;
  for (int i = tid; i < nrows * L::G; i += 256) {
    const int r = i / L::G, v = (i % L::G) * L::VEC;
    if (c0 + v >= C) continue;
    const int64_t o = base + (int64_t)r * C + v;
    cp_async16(sx + r * kTile + v, x + o);
    cp_async16(sg + r * kTile + v, g + o);
    if (sy != nullptr) cp_async16(sy + r * kTile + v, y + o);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int v0 = (tid % L::G) * L::VEC, c = c0 + v0;
  float mu[L::VEC], rs[L::VEC];
  const int nvalid = bwd_stats<T>(mean, rstd, n * C, c, C, mu, rs);
  const bool live = nvalid > 0;
  SharedRows<T> rows{sx + v0, sy != nullptr ? sy + v0 : nullptr, sg + v0};
  bwd_block_sums<T>(live ? nrows : 0, mu, rs, act, rows, sums);
  cluster.sync();
  if (tid < 2 * kTile) {
    const int k = tid / kTile, cc = tid % kTile;
    float s = 0.0f;
    for (int q = 0; q < cs; ++q) s += cluster.map_shared_rank(&sums[0][0], q)[k * kTile + cc];
    means[k][cc] = s / (float)HW;
  }
  cluster.sync();  // the means are visible; no block leaves while read
  if (!live) return;
  float a[L::VEC], b[L::VEC];
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) {
    a[j] = means[0][v0 + j];
    b[j] = means[1][v0 + j];
  }
  bwd_block_dx<T>(nrows, mu, rs, a, b, act, rows, dx + v0 + c0, dres ? dres + v0 + c0 : nullptr,
                  (int64_t)n * HW + r0, C, nvalid, true);
}

// Split form, launch 1: grid (S, channel tiles, N), 256 threads; the
// block's per-channel sums of its `chunk` rows to part (2 planes of
// N * S * C), read from device memory with 16-byte loads.
template <typename T>
__global__ void __launch_bounds__(256)
in_bwd_split_sums_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ g, const float* __restrict__ mean,
                         const float* __restrict__ rstd, float* __restrict__ part,
                         int HW, int C, int S, int chunk, int act) {
  using L = Layout<T>;
  __shared__ float sums[2][kTile];
  const int s = blockIdx.x, n = blockIdx.z, c0 = blockIdx.y * kTile;
  const int r0 = s * chunk, nrows = min(chunk, HW - r0);
  const int v0 = (threadIdx.x % L::G) * L::VEC, c = c0 + v0;
  float mu[L::VEC], rs[L::VEC];
  const int nvalid = bwd_stats<T>(mean, rstd, n * C, c, C, mu, rs);
  const int64_t o = ((int64_t)n * HW + r0) * C + c;
  GlobalRows<T> rows{x + o, y != nullptr ? y + o : nullptr, g + o, C, nvalid,
                     C % L::VEC == 0};
  bwd_block_sums<T>(nvalid > 0 ? nrows : 0, mu, rs, act, rows, sums);
  const int tid = threadIdx.x;
  if (tid < 2 * kTile && c0 + tid % kTile < C) {
    const int64_t plane = (int64_t)gridDim.z * S * C;
    part[(tid / kTile) * plane + ((int64_t)n * S + s) * C + c0 + tid % kTile] =
        sums[tid / kTile][tid % kTile];
  }
}

// Split form, launch 2: the same blocks in reverse order (the last blocks
// of launch 1 ran last, so their rows are the likeliest still in L2). Each
// block sums the S partials of its channels in a fixed order, then writes
// dx for its rows, reading x, y and g a second time.
template <typename T>
__global__ void __launch_bounds__(256)
in_bwd_split_dx_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const T* __restrict__ g, const float* __restrict__ mean,
                       const float* __restrict__ rstd, const float* __restrict__ part,
                       T* __restrict__ dx, T* __restrict__ dres, int HW, int C, int S,
                       int chunk, int act) {
  using L = Layout<T>;
  __shared__ float means[2][kTile];
  __shared__ float quarter[4][2 * kTile];
  const int s = gridDim.x - 1 - blockIdx.x, n = gridDim.z - 1 - blockIdx.z;
  const int c0 = (gridDim.y - 1 - blockIdx.y) * kTile, tid = threadIdx.x;
  {
    // the S partials of each (sum, channel): 4 threads take every 4th
    // split in order, then the 4 are added in order
    const int o = tid % (2 * kTile), q0 = tid / (2 * kTile);
    const int k = o / kTile, cc = c0 + o % kTile;
    float sum = 0.0f;
    if (cc < C) {
      const float* p = part + k * (int64_t)gridDim.z * S * C + (int64_t)n * S * C + cc;
      for (int q = q0; q < S; q += 4) sum += p[(int64_t)q * C];
    }
    quarter[q0][o] = sum;
  }
  __syncthreads();
  if (tid < 2 * kTile)
    means[tid / kTile][tid % kTile] =
        (((quarter[0][tid] + quarter[1][tid]) + quarter[2][tid]) + quarter[3][tid]) / (float)HW;
  __syncthreads();
  const int r0 = s * chunk, nrows = min(chunk, HW - r0);
  const int v0 = (tid % L::G) * L::VEC, c = c0 + v0;
  float mu[L::VEC], rs[L::VEC], a[L::VEC], b[L::VEC];
  const int nvalid = bwd_stats<T>(mean, rstd, n * C, c, C, mu, rs);
  if (nvalid <= 0) return;
#pragma unroll
  for (int j = 0; j < L::VEC; ++j) {
    a[j] = means[0][v0 + j];
    b[j] = means[1][v0 + j];
  }
  const int64_t o = ((int64_t)n * HW + r0) * C + c;
  const bool vec = C % L::VEC == 0;
  GlobalRows<T> rows{x + o, y != nullptr ? y + o : nullptr, g + o, C, nvalid, vec};
  bwd_block_dx<T>(nrows, mu, rs, a, b, act, rows, dx + c, dres ? dres + c : nullptr,
                  (int64_t)n * HW + r0, C, nvalid, vec);
}

// Launches a cluster-form kernel on grid (cs, channel tiles, N) in clusters
// of (cs, 1, 1) with `smem` bytes of dynamic shared memory. The first call
// for each kernel allows it kSlab bytes and non-portable cluster sizes (up
// to 16 on Hopper).
template <typename... P, typename... A>
int launch_cluster(void (*kern)(P...), dim3 grid, int smem, cudaStream_t s, A... args) {
  static int attrs = -1;  // one per kernel
  if (attrs < 0) {
    attrs = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSlab);
    if (!attrs)
      attrs = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (attrs) return attrs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, kern, args...);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* res, void* y, float* mean, float* rstd, float* ws,
               int N, int HW, int C, int S, int chunk, int act, float eps, int cluster,
               cudaStream_t s) {
  const dim3 grid(S, (C + kTile - 1) / kTile, N);
  if (cluster)
    return launch_cluster(in_fwd_cluster_kernel<T>, grid, chunk * kTile * (int)sizeof(T), s,
                          (const T*)x, (const T*)res, (T*)y, mean, rstd, HW, C, chunk, act, eps);
  in_fwd_split_stats_kernel<T><<<grid, 256, 0, s>>>((const T*)x, ws, HW, C, S, chunk);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  in_fwd_split_norm_kernel<T><<<grid, 256, 0, s>>>((const T*)x, (const T*)res, ws, (T*)y, mean,
                                                   rstd, HW, C, S, chunk, act, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* g, const float* mean,
               const float* rstd, void* dx, void* dres, float* ws, int N, int HW,
               int C, int S, int chunk, int act, int cluster, cudaStream_t s) {
  const dim3 grid(S, (C + kTile - 1) / kTile, N);
  if (cluster)
    return launch_cluster(in_bwd_cluster_kernel<T>, grid,
                          chunk * kTile * (int)sizeof(T) * (y != nullptr ? 3 : 2), s,
                          (const T*)x, (const T*)y, (const T*)g, mean, rstd, (T*)dx, (T*)dres,
                          HW, C, chunk, act);
  in_bwd_split_sums_kernel<T><<<grid, 256, 0, s>>>((const T*)x, (const T*)y, (const T*)g,
                                                   mean, rstd, ws, HW, C, S, chunk, act);
  int err = (int)cudaGetLastError();
  if (err) return err;
  in_bwd_split_dx_kernel<T><<<grid, 256, 0, s>>>((const T*)x, (const T*)y, (const T*)g,
                                                 mean, rstd, ws, (T*)dx, (T*)dres, HW, C, S,
                                                 chunk, act);
  return (int)cudaGetLastError();
}

}  // namespace

// Backward. x, y (nullable when act is 0), g, dx, dres (nullable): NHWC
// contiguous (N, HW, C) in fp32 or bf16, 16-byte aligned; mean, rstd: the
// forward's fp32 (N, C). cluster 1: one launch, S = the cluster size
// (<= 16) and C % (16 / sizeof(dtype)) == 0; cluster 0: the split form, S
// splits, ws fp32 of 2 * N * S * C. Rows: `chunk` a block (S * chunk >= HW).
extern "C" int himan_instance_norm_bwd(const void* x, const void* y, const void* g,
                                       const void* mean, const void* rstd, void* dx,
                                       void* dres, void* ws, int N, int HW, int C, int S,
                                       int chunk, int act, int cluster, int is_bf16,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(x, y, g, (const float*)mean, (const float*)rstd, dx,
                                     dres, (float*)ws, N, HW, C, S, chunk, act, cluster, s);
  return launch_bwd<float>(x, y, g, (const float*)mean, (const float*)rstd, dx, dres,
                           (float*)ws, N, HW, C, S, chunk, act, cluster, s);
}

// Forward. x, res (nullable), y: NHWC contiguous (N, HW, C) in fp32 or
// bf16, 16-byte aligned; mean, rstd: fp32 (N, C). act: 0 none, 1 relu, 2
// lrelu 0.2. cluster 1: one launch, S = the cluster size (<= 16) and C %
// (16 / sizeof(dtype)) == 0, ws unused; cluster 0: the split form, S splits,
// ws fp32 of 2 * N * S * C. Rows: `chunk` a block (S * chunk >= HW).
extern "C" int himan_instance_norm_fwd(const void* x, const void* res, void* y, void* mean,
                                       void* rstd, void* ws, int N, int HW, int C, int S,
                                       int chunk, int act, float eps, int cluster,
                                       int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_fwd<__nv_bfloat16>(x, res, y, (float*)mean, (float*)rstd, (float*)ws, N, HW,
                                     C, S, chunk, act, eps, cluster, s);
  return launch_fwd<float>(x, res, y, (float*)mean, (float*)rstd, (float*)ws, N, HW, C, S,
                           chunk, act, eps, cluster, s);
}
