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
// _run_bwd / _bwd_kernel. From the saved x, y, mean and rstd and the
// cotangent g of y:
//   gm = g * act'(y)     relu: y > 0 ? 1 : 0   lrelu: y >= 0 ? 1 : 0.2
//   dx = (gm - mean(gm) - xhat * mean(gm * xhat)) * rstd,  xhat = (x-mean)*rstd
// and, where a residual was added before the activation, dres = gm.
// Bound: bytes (x, y, g read once, dx written once; the statistics pass
// reads x, y, g a second time, which the bound does not count). Same
// three-launch structure as the forward, with plain fp32 sums in place of
// Welford (these are means of products, not a variance):
//   launch 1  grid (split, channel tile, n): per (n, split, c) partial
//             sums of gm and gm * xhat, each thread over its rows in a
//             fixed order, the 8 row lanes summed in a fixed order;
//   launch 2  one warp per (n, c): the S partials, lanes then a shuffle
//             tree (fixed order), over HW -> mean(gm), mean(gm * xhat);
//   launch 3  elementwise dx (and dres).
// No atomics anywhere, so the result is the same bits on every run. Any
// HW is taken: the D sites are odd (65x129, 33x65, 17x33, ...).
//
// Limits, checked by the wrapper: N <= 65535 (grid.z, grid.y) and
// HW * C < 2^30 (32-bit index within one sample).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // channels per block (one per lane)
constexpr int kRows = 8;   // row lanes per block

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
template <typename T>
__device__ __forceinline__ float masked_grad(float g, const T* y, int64_t o,
                                             int act) {
  if (act == 1) return to_f<T>(y[o]) > 0.0f ? g : 0.0f;
  if (act == 2) return to_f<T>(y[o]) >= 0.0f ? g : 0.2f * g;
  return g;
}

template <typename T>
__global__ void in_bwd_partial_kernel(const T* __restrict__ x,
                                      const T* __restrict__ y,
                                      const T* __restrict__ g,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ rstd,
                                      float* __restrict__ part, int HW, int C,
                                      int S, int chunk, int act) {
  const int s = blockIdx.x, n = blockIdx.z;
  const int c = blockIdx.y * kTile + threadIdx.x;
  const int hw0 = s * chunk;
  const int hw1 = min(hw0 + chunk, HW);
  float sg = 0.0f, sgx = 0.0f;
  if (c < C) {
    const float mu = mean[n * C + c], rs = rstd[n * C + c];
    const int64_t base = (int64_t)n * HW * C + c;
    for (int hw = hw0 + threadIdx.y; hw < hw1; hw += kRows) {
      const int64_t o = base + (int64_t)hw * C;
      const float gm = masked_grad<T>(to_f<T>(g[o]), y, o, act);
      sg += gm;
      sgx += gm * ((to_f<T>(x[o]) - mu) * rs);
    }
  }
  __shared__ float ss[kRows][kTile], sx[kRows][kTile];
  ss[threadIdx.y][threadIdx.x] = sg;
  sx[threadIdx.y][threadIdx.x] = sgx;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
#pragma unroll
    for (int j = 1; j < kRows; ++j) {
      sg += ss[j][threadIdx.x];
      sgx += sx[j][threadIdx.x];
    }
    const int64_t o = ((int64_t)n * S + s) * C + c;
    const int64_t plane = (int64_t)gridDim.z * S * C;
    part[o] = sg;
    part[plane + o] = sgx;
  }
}

__global__ void in_bwd_finalize_kernel(const float* __restrict__ part,
                                       float* __restrict__ mg_out,
                                       float* __restrict__ mgx_out, int N,
                                       int HW, int C, int S) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= N * C) return;  // whole warps exit together
  const int n = warp / C, c = warp % C;
  const int64_t plane = (int64_t)N * S * C;
  float sg = 0.0f, sgx = 0.0f;
  for (int s = lane; s < S; s += 32) {
    const int64_t o = ((int64_t)n * S + s) * C + c;
    sg += part[o];
    sgx += part[plane + o];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sg += __shfl_down_sync(0xffffffffu, sg, off);
    sgx += __shfl_down_sync(0xffffffffu, sgx, off);
  }
  if (lane == 0) {
    mg_out[warp] = sg / (float)HW;
    mgx_out[warp] = sgx / (float)HW;
  }
}

// grid (tiles, n), one channel per thread as in in_normalize_kernel
template <typename T>
__global__ void in_bwd_dx_kernel(const T* __restrict__ x,
                                 const T* __restrict__ y,
                                 const T* __restrict__ g,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ rstd,
                                 const float* __restrict__ mg,
                                 const float* __restrict__ mgx,
                                 T* __restrict__ dx, T* __restrict__ dres,
                                 int hwc, int C, int act) {
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int nc = blockIdx.y * C + i0 % C;
  const float mu = mean[nc], rs = rstd[nc], a = mg[nc], b = mgx[nc];
  const int64_t base = (int64_t)blockIdx.y * hwc;
  for (int i = i0; i < hwc; i += stride) {
    const int64_t o = base + i;
    const float gm = masked_grad<T>(to_f<T>(g[o]), y, o, act);
    const float xh = (to_f<T>(x[o]) - mu) * rs;
    dx[o] = from_f<T>((gm - a - xh * b) * rs);
    if (dres != nullptr) dres[o] = from_f<T>(gm);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* g, const float* mean,
               const float* rstd, void* dx, void* dres, float* ws, int N,
               int HW, int C, int S, int chunk, int act, cudaStream_t s) {
  float* mg = ws;
  float* mgx = ws + N * C;
  float* part = ws + 2 * N * C;
  const dim3 block(kTile, kRows);
  const dim3 grid1(S, (C + kTile - 1) / kTile, N);
  in_bwd_partial_kernel<T><<<grid1, block, 0, s>>>(
      (const T*)x, (const T*)y, (const T*)g, mean, rstd, part, HW, C, S,
      chunk, act);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int warps = N * C;
  in_bwd_finalize_kernel<<<(warps + 7) / 8, 256, 0, s>>>(part, mg, mgx, N, HW,
                                                         C, S);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int hwc = HW * C;
  const int gq = C / gcd(C, 256);
  int tiles = (132 * 16 + N - 1) / N;
  if (tiles > (hwc + 255) / 256) tiles = (hwc + 255) / 256;
  tiles = (tiles + gq - 1) / gq * gq;
  in_bwd_dx_kernel<T><<<dim3(tiles, N), 256, 0, s>>>(
      (const T*)x, (const T*)y, (const T*)g, mean, rstd, mg, mgx, (T*)dx,
      (T*)dres, hwc, C, act);
  return (int)cudaGetLastError();
}

}  // namespace

// Backward. x, y (nullable when act is 0), g, dx, dres (nullable): NHWC
// contiguous (N, HW, C) in fp32 or bf16; mean, rstd: the forward's fp32
// (N, C); ws: fp32 workspace of 2 * N * C + 2 * N * S * C.
extern "C" int himan_instance_norm_bwd(const void* x, const void* y,
                                       const void* g, const void* mean,
                                       const void* rstd, void* dx, void* dres,
                                       void* ws, int N, int HW, int C, int S,
                                       int chunk, int act, int is_bf16,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(x, y, g, (const float*)mean,
                                     (const float*)rstd, dx, dres, (float*)ws,
                                     N, HW, C, S, chunk, act, s);
  return launch_bwd<float>(x, y, g, (const float*)mean, (const float*)rstd, dx,
                           dres, (float*)ws, N, HW, C, S, chunk, act, s);
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
