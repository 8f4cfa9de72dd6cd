// InstanceNorm2d(affine=False) forward on NHWC, fused with an optional
// residual add and an optional activation:  y = act(IN(x) + residual).
// eps 1e-5 inside the sqrt, biased variance, fp32 statistics, IO in the
// input dtype (fp32 or bf16). Also emits the per-(n, c) mean and rstd in
// fp32 for the backward pass.
//
// Replaces the forward TPU kernel of ops/pallas/instance_norm.py in the
// JAX package (fused_instance_norm -> _run_fwd / _fwd_kernel).
//
// Bound: bytes. The statistics read x once and the normalize reads x (and
// the residual) once and writes y once; the arithmetic is a few operations
// per byte. The TPU kernel walks the HW axis SEQUENTIALLY inside one grid
// cell, carrying sum / sum-of-squares in VMEM from one step to the next.
// Blocks on this card run in parallel and in no order, so nothing can be
// carried between them; and at the generator stem (HW = 131072, C = 64) a
// block per (n, channel tile) would give 2 blocks for 132 SMs. So the HW
// axis is split across blocks and the statistics are merged in a second
// launch:
//
//   launch 1  grid (split, channel tile of 32, n), block 32 x 8. Each warp
//             reads 32 consecutive channels of one pixel (coalesced); each
//             thread folds its rows in, four at a time (the four values'
//             exact mean and M2, merged into the running ones with Chan's
//             formula), the 8 row lanes are merged with Chan's formula,
//             and one (count, mean, M2) partial per (n, split, c) goes to
//             the workspace.
//   launch 2  one warp per (n, c): merges the split partials with Chan's
//             formula (lanes, then a shuffle tree) and writes mean and
//             rstd = 1 / sqrt(M2 / HW + eps).
//   launch 3  elementwise: y = (x - mean) * rstd [+ residual], then the
//             activation, stored in x's dtype.
//
// Form used: Welford / Chan throughout. No one-pass E[x^2] - E[x]^2 is
// taken over a long run of values in fp32 (it cancels catastrophically
// when |mean| >> std).
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
// one (sample, channel tile) plane in VMEM and walks it twice; here the
// plane is split over the blocks of a thread-block cluster that together
// hold it in shared memory:
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

constexpr int kTile = 32;  // channels per block (one per lane)
constexpr int kRows = 8;   // row lanes per block
constexpr int kBwdSlab = 196608;  // the backward's shared-memory slab, at most
                                  // (kernels/instance_norm._BWD_SLAB)

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

template <typename T>
__global__ void in_partial_kernel(const T* __restrict__ x,
                                  float* __restrict__ part, int HW, int C,
                                  int S, int chunk) {
  const int s = blockIdx.x, n = blockIdx.z;
  const int c = blockIdx.y * kTile + threadIdx.x;
  const int hw0 = s * chunk;
  const int hw1 = min(hw0 + chunk, HW);
  float cnt = 0.0f, mean = 0.0f, m2 = 0.0f;
  if (c < C) {
    const T* xp = x + (int64_t)n * HW * C + c;
    int hw = hw0 + threadIdx.y;
    // four independent loads in flight per thread; their exact two-pass
    // (mean, M2) joins the running one by one Chan merge, so there is one
    // division per four values instead of Welford's one per value
    for (; hw + 3 * kRows < hw1; hw += 4 * kRows) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = to_f<T>(xp[(int64_t)(hw + j * kRows) * C]);
      const float mb = (v[0] + v[1] + v[2] + v[3]) * 0.25f;
      float qb = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) qb += (v[j] - mb) * (v[j] - mb);
      chan_merge(cnt, mean, m2, 4.0f, mb, qb);
    }
    for (; hw < hw1; hw += kRows) {
      const float v = to_f<T>(xp[(int64_t)hw * C]);
      cnt += 1.0f;
      const float d = v - mean;
      mean += d / cnt;
      m2 += d * (v - mean);
    }
  }
  __shared__ float sc[kRows][kTile], sm[kRows][kTile], sq[kRows][kTile];
  sc[threadIdx.y][threadIdx.x] = cnt;
  sm[threadIdx.y][threadIdx.x] = mean;
  sq[threadIdx.y][threadIdx.x] = m2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
#pragma unroll
    for (int j = 1; j < kRows; ++j)
      chan_merge(cnt, mean, m2, sc[j][threadIdx.x], sm[j][threadIdx.x],
                 sq[j][threadIdx.x]);
    const int64_t o = ((int64_t)n * S + s) * C + c;
    const int64_t plane = (int64_t)gridDim.z * S * C;
    part[o] = cnt;
    part[plane + o] = mean;
    part[2 * plane + o] = m2;
  }
}

__global__ void in_finalize_kernel(const float* __restrict__ part,
                                   float* __restrict__ mean_out,
                                   float* __restrict__ rstd_out, int N, int HW,
                                   int C, int S, float eps) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= N * C) return;  // whole warps exit together
  const int n = warp / C, c = warp % C;
  const int64_t plane = (int64_t)N * S * C;
  float cnt = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int s = lane; s < S; s += 32) {
    const int64_t o = ((int64_t)n * S + s) * C + c;
    chan_merge(cnt, mean, m2, part[o], part[plane + o], part[2 * plane + o]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, cnt, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float qb = __shfl_down_sync(0xffffffffu, m2, off);
    chan_merge(cnt, mean, m2, nb, mb, qb);
  }
  if (lane == 0) {
    const float var = m2 / (float)HW;
    mean_out[warp] = mean;
    rstd_out[warp] = 1.0f / sqrtf(var + eps);
  }
}

// grid (tiles, n). The launch makes the stride gridDim.x * blockDim.x a
// multiple of C, so each thread meets one channel only: its mean and rstd
// sit in registers and the loop does no index division.
template <typename T>
__global__ void in_normalize_kernel(const T* __restrict__ x,
                                    const T* __restrict__ res,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ rstd,
                                    T* __restrict__ y, int hwc, int C,
                                    int act) {
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int nc = blockIdx.y * C + i0 % C;
  const float mu = mean[nc], rs = rstd[nc];
  const int64_t base = (int64_t)blockIdx.y * hwc;
  for (int i = i0; i < hwc; i += stride) {
    float v = (to_f<T>(x[base + i]) - mu) * rs;
    if (res != nullptr) v += to_f<T>(res[base + i]);
    if (act == 1) {
      v = fmaxf(v, 0.0f);
    } else if (act == 2) {
      v = v >= 0.0f ? v : v * 0.2f;
    }
    y[base + i] = from_f<T>(v);
  }
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <typename T>
int launch(const void* x, const void* res, void* y, float* mean, float* rstd,
           float* part, int N, int HW, int C, int S, int chunk, int act,
           float eps, cudaStream_t s) {
  const dim3 block(kTile, kRows);
  const dim3 grid1(S, (C + kTile - 1) / kTile, N);
  in_partial_kernel<T><<<grid1, block, 0, s>>>((const T*)x, part, HW, C, S,
                                               chunk);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int warps = N * C;
  in_finalize_kernel<<<(warps + 7) / 8, 256, 0, s>>>(part, mean, rstd, N, HW,
                                                     C, S, eps);
  err = (int)cudaGetLastError();
  if (err) return err;
  // about 132 * 16 blocks in all, no more than the elements need, rounded
  // up so that the stride is a multiple of C
  const int hwc = HW * C;
  const int g = C / gcd(C, 256);
  int tiles = (132 * 16 + N - 1) / N;
  if (tiles > (hwc + 255) / 256) tiles = (hwc + 255) / 256;
  tiles = (tiles + g - 1) / g * g;
  in_normalize_kernel<T><<<dim3(tiles, N), 256, 0, s>>>(
      (const T*)x, (const T*)res, mean, rstd, (T*)y, hwc, C, act);
  return (int)cudaGetLastError();
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

// The backward's thread layout: a block owns 32 channels (kTile) of one
// sample and a run of rows. Thread t takes the VEC channels (t % G) * VEC..
// of rows t / G, t / G + RP, ...: G = 32 / VEC vectors a row, RP = 256 / G
// row lanes (fp32 8 x 32, bf16 4 x 64). A warp covers 4 (8) whole rows.
template <typename T>
struct BwdLayout {
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
  using L = BwdLayout<T>;
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
  using L = BwdLayout<T>;
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
  using L = BwdLayout<T>;
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
  using L = BwdLayout<T>;
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
  using L = BwdLayout<T>;
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

template <typename T>
int launch_bwd(const void* x, const void* y, const void* g, const float* mean,
               const float* rstd, void* dx, void* dres, float* ws, int N, int HW,
               int C, int S, int chunk, int act, int cluster, cudaStream_t s) {
  const int ctiles = (C + kTile - 1) / kTile;
  if (cluster) {
    auto kern = in_bwd_cluster_kernel<T>;
    const int smem = chunk * kTile * (int)sizeof(T) * (y != nullptr ? 3 : 2);
    static int attrs = -1;  // set once per dtype: the largest slab, clusters of 16
    if (attrs < 0) {
      attrs = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        kBwdSlab);
      if (!attrs)
        attrs = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (attrs) return attrs;
    int err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S, ctiles, N);
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = (int)cudaLaunchKernelEx(&cfg, kern, (const T*)x, (const T*)y, (const T*)g, mean,
                                  rstd, (T*)dx, (T*)dres, HW, C, chunk, act);
    if (err) return err;
    return (int)cudaGetLastError();
  }
  const dim3 grid(S, ctiles, N);
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

// x, res (nullable), y: NHWC contiguous (N, HW, C) in fp32 or bf16.
// mean, rstd: fp32 (N, C). part: fp32 workspace of 3 * N * S * C.
// S splits of `chunk` rows each cover HW. act: 0 none, 1 relu, 2 lrelu 0.2.
extern "C" int himan_instance_norm_fwd(const void* x, const void* res,
                                       void* y, void* mean, void* rstd,
                                       void* part, int N, int HW, int C,
                                       int S, int chunk, int act, float eps,
                                       int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, res, y, (float*)mean, (float*)rstd,
                                 (float*)part, N, HW, C, S, chunk, act, eps, s);
  return launch<float>(x, res, y, (float*)mean, (float*)rstd, (float*)part, N,
                       HW, C, S, chunk, act, eps, s);
}
