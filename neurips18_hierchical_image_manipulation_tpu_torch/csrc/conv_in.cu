// Fused reflect-pad-1 3x3 stride-1 convolution + InstanceNorm(affine=False)
// (+ residual) (+ ReLU) on NHWC: the generator's resblock body as one op,
//   y = relu?( IN(conv3x3(reflect_pad(x, 1), w) + b) + residual? ).
// x NHWC (N, H, W, Cin), w HWIO (3, 3, Cin, Cout) = a (9 Cin, Cout) matrix,
// b fp32 (Cout), y NHWC (N, H, W, Cout) in x's dtype (fp32 or bf16).
// eps inside the sqrt, biased variance, statistics from the fp32 sums.
//
// Replaces the TPU kernel of ops/pallas/conv_in.py in the JAX package
// (conv3x3_in_act -> _fused -> _run / _kernel), which the JAX package times
// in tools/roofline_resblock.py and never wires into its networks.
//
// Bound: operations. At the generator bottleneck (bs 1, 16x32, 1024 -> 1024
// channels) one call is 2 * 512 * 9216 * 1024 = 9.66 GFLOP against 6 MB of
// x, y, residual and weights: chip_smoke.conv_in_bound puts it at 0.144 ms
// of fp32 arithmetic at 67 TFLOP/s, 2.596 ms over the 18 resblock convs of
// one 512x256 forward, and at 0.0098 ms (0.176 ms for the 18) in bf16 at
// 989 TFLOP/s.
//
// The TPU kernel gives one grid cell a whole (H, W) plane of one sample and
// 128 output channels, runs the conv as 9 tap matmuls into a VMEM
// accumulator and takes the IN statistics from it before the one write.
// Here a block owns a 64-pixel x 64-channel tile, too small for a plane,
// and blocks run in parallel in no order, so the statistics are reduced
// across blocks in a second launch:
//
//   launch 1  implicit GEMM, M = the H*W pixels of one sample (grid.z = n),
//             N = Cout, K = 9 * Cin taken tap by tap. Each K step loads an
//             (pixels x channels) slice of x for one tap into shared memory,
//             reflecting the row and column indices in the load (row -1
//             reads row 1, row H reads row H-2), so no padded copy exists.
//               fp32: K slices of 16 channels, 4 x 4 outputs a thread,
//                     fp32 FMA (no TF32: the fp32 tier is the parity tier);
//               bf16: K slices of 32 channels, the next slice's 16-byte
//                     loads (when the channel counts are multiples of 8) in
//                     flight over the current slice's products, ldmatrix
//                     fragments, mma.sync m16n8k16 with fp32 accumulators,
//                     a warp a 32 x 16 sub-tile.
//             The epilogue adds b to the fp32 sums (before the statistics,
//             as the TPU kernel does), stores the pre-norm tile in fp32 and
//             one (count, mean, M2) per channel of the tile: the tile's
//             exact two-pass mean and sum of squared deviations, in a fixed
//             order.
//   launch 2  grid (row split, 32 channels, n): each block merges the
//             tiles' partials of its channels with Chan's formula in tile
//             order, then normalizes its rows, adds the residual, applies
//             ReLU and casts, one write.
// No atomics: the same inputs give the same bits on every run.
//
// Limits, checked by the wrapper: H, W > 1 (reflect pad 1), N <= 65535,
// Cout / 64 <= 65535.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output pixels of one sample per tile
constexpr int BN = 64;        // output channels per tile
constexpr int kThreads = 256;
constexpr int kFmaK = 16;     // K slice of the fp32 kernel
constexpr int kMmaK = 32;     // K slice of the bf16 kernel
constexpr int kMmaPad = 8;    // bf16 row padding: conflict-free fragments

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

__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// Chan et al.: merge (nb, mb, qb) into (na, ma, qa)
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& qa,
                                           float nb, float mb, float qb) {
  if (nb == 0.0f) return;
  if (na == 0.0f) {
    na = nb;
    ma = mb;
    qa = qb;
    return;
  }
  const float n = na + nb;
  const float d = mb - ma;
  const float fb = nb / n;
  ma = ma + d * fb;
  qa = qa + qb + d * d * na * fb;
  na = n;
}

// The tile's sums (bias added) sit in Cs. Store them to ypre and write the
// tile's per-channel (count, mean, M2): 4 threads a channel over 16 rows
// each, combined in a fixed order.
__device__ void tile_epilogue(float (*Cs)[BN + 1], float* __restrict__ ypre,
                              float* __restrict__ part, int n, int HW, int Cout,
                              int S) {
  __shared__ float red[4][BN];
  __shared__ float mean_s[BN];
  const int tid = threadIdx.x;
  const int col = tid % BN, quarter = tid / BN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int rows = min(BM, HW - m0);
  const bool cv = n0 + col < Cout;
  float s = 0.0f;
  for (int r = quarter * 16; r < quarter * 16 + 16 && r < rows; ++r) {
    const float v = Cs[r][col];
    s += v;
    if (cv) ypre[((int64_t)n * HW + m0 + r) * Cout + n0 + col] = v;
  }
  red[quarter][col] = s;
  __syncthreads();
  if (tid < BN)
    mean_s[tid] = (((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid]) / (float)rows;
  __syncthreads();
  const float mu = mean_s[col];
  float q = 0.0f;
  for (int r = quarter * 16; r < quarter * 16 + 16 && r < rows; ++r) {
    const float d = Cs[r][col] - mu;
    q += d * d;
  }
  red[quarter][col] = q;
  __syncthreads();
  if (tid < BN && n0 + tid < Cout) {
    const int64_t o = ((int64_t)n * S + blockIdx.x) * Cout + n0 + tid;
    const int64_t plane = (int64_t)gridDim.z * S * Cout;
    part[o] = (float)rows;
    part[plane + o] = mean_s[tid];
    part[2 * plane + o] = ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
  }
}

// fp32: grid (ceil(HW / 64), ceil(Cout / 64), N), 256 threads, 4 x 4 outputs
// a thread (rows ty*4.., channels tx*4..).
__global__ void __launch_bounds__(kThreads)
conv_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ ypre,
                float* __restrict__ part, int H, int W, int Cin, int Cout,
                int S) {
  __shared__ __align__(16) float As[kFmaK][BM + 4];
  __shared__ __align__(16) float Bs[kFmaK][BN];
  __shared__ float Cs[BM][BN + 1];
  const int tid = threadIdx.x, n = blockIdx.z;
  const int HW = H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // A loads: channel a_k of rows a_r + 16 i (16 threads read 16 channels of
  // one pixel); B loads: column b_c of K rows b_k + 4 i
  const int a_k = tid % kFmaK, a_r = tid / kFmaK;
  const int b_c = tid % BN, b_k = tid / BN;
  int ah[4], aw[4];
  bool av[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_r + 16 * i;
    av[i] = m < HW;
    ah[i] = av[i] ? m / W : 0;
    aw[i] = av[i] ? m % W : 0;
  }
  const bool bv = n0 + b_c < Cout;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const float* xn = x + (int64_t)n * HW * Cin;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    int64_t aoff[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      aoff[i] = ((int64_t)reflect1(ah[i] + dy, H) * W + reflect1(aw[i] + dx, W)) * Cin;
    const float* wt = w + (int64_t)tap * Cin * Cout + n0 + b_c;
    for (int c0 = 0; c0 < Cin; c0 += kFmaK) {
      const int ci = c0 + a_k;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        As[a_k][a_r + 16 * i] = (av[i] && ci < Cin) ? xn[aoff[i] + ci] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = c0 + b_k + 4 * i;
        Bs[b_k + 4 * i][b_c] = (bv && k < Cin) ? wt[(int64_t)k * Cout] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFmaK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float ar[4] = {a.x, a.y, a.z, a.w};
        const float br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + tx * 4 + j;
    const float bj = c < Cout ? bias[c] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) Cs[ty * 4 + i][tx * 4 + j] = acc[i][j] + bj;
  }
  __syncthreads();
  tile_epilogue(Cs, ypre, part, n, HW, Cout, S);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 address the
// rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 8 consecutive bf16 (as raw 16-bit words) from src, those at or past
// `valid` zero; one 16-byte load when `vec` (all 8 valid and aligned)
__device__ __forceinline__ uint4 load8(const uint16_t* src, int valid, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(src);
  uint16_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < valid ? src[j] : (uint16_t)0;
  uint4 u;
  u.x = v[0] | ((uint32_t)v[1] << 16);
  u.y = v[2] | ((uint32_t)v[3] << 16);
  u.z = v[4] | ((uint32_t)v[5] << 16);
  u.w = v[6] | ((uint32_t)v[7] << 16);
  return u;
}

// bf16: grid as the fp32 kernel, 8 warps as 2 (rows) x 4 (channels), each
// a 32 x 16 sub-tile of 2 x 2 m16n8 fragments. A K step is 32 input
// channels of one tap: As (pixel, k) and Bs (k, channel) in shared memory,
// read into fragments with ldmatrix (Bs transposed). Each thread loads 8
// channels of one pixel and 8 output channels of one weight row, 16 bytes
// at a time when Cin (Cout) is a multiple of 8, and the next K step's loads
// are in flight while the current one multiplies.
__global__ void __launch_bounds__(kThreads)
conv_mma_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ ypre,
                float* __restrict__ part, int H, int W, int Cin, int Cout,
                int S) {
  __shared__ __align__(16) uint16_t As[BM][kMmaK + kMmaPad];
  __shared__ __align__(16) uint16_t Bs[kMmaK][BN + kMmaPad];
  __shared__ float Cs[BM][BN + 1];
  const int tid = threadIdx.x, n = blockIdx.z;
  const int HW = H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool vec_a = Cin % 8 == 0, vec_b = Cout % 8 == 0;
  // A: row a_r, channels 8 a_v..; B: K row b_k, output channels 8 b_v..
  const int a_r = tid / 4, a_v = tid % 4;
  const int b_k = tid / 8, b_v = tid % 8;
  const int m = m0 + a_r;
  const bool av = m < HW;
  const int ah = av ? m / W : 0, aw = av ? m % W : 0;
  const int nb = n0 + 8 * b_v;
  const int cpt = (Cin + kMmaK - 1) / kMmaK;  // K steps per tap
  const int steps = 9 * cpt;
  const uint16_t* xn = x + (int64_t)n * HW * Cin;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  uint4 ra, rb;
  auto load = [&](int step) {
    const int tap = step / cpt, c0 = (step % cpt) * kMmaK;
    const int ci = c0 + 8 * a_v;
    ra = make_uint4(0, 0, 0, 0);
    if (av && ci < Cin) {
      const int sh = reflect1(ah + tap / 3 - 1, H), sw = reflect1(aw + tap % 3 - 1, W);
      ra = load8(xn + ((int64_t)sh * W + sw) * Cin + ci, Cin - ci, vec_a);
    }
    const int k = c0 + b_k;
    rb = make_uint4(0, 0, 0, 0);
    if (k < Cin && nb < Cout)
      rb = load8(w + ((int64_t)tap * Cin + k) * Cout + nb, Cout - nb, vec_b);
  };
  load(0);
  for (int step = 0; step < steps; ++step) {
    *reinterpret_cast<uint4*>(&As[a_r][8 * a_v]) = ra;
    *reinterpret_cast<uint4*>(&Bs[b_k][8 * b_v]) = rb;
    __syncthreads();
    if (step + 1 < steps) load(step + 1);
#pragma unroll
    for (int ks = 0; ks < kMmaK; ks += 16) {
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], &As[wm + i * 16 + lane % 16][ks + (lane / 16) * 8]);
      ldsm_x4_trans(b, &Bs[ks + lane % 16][wn + (lane / 16) * 8]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b[2 * j], b[2 * j + 1]);
    }
    __syncthreads();
  }
  // fragment (i, j): rows wm + 16 i + g (+8), channels wn + 8 j + 2 t4 (+1)
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int cl = wn + j * 8 + 2 * t4;
    const float b0 = n0 + cl < Cout ? bias[n0 + cl] : 0.0f;
    const float b1 = n0 + cl + 1 < Cout ? bias[n0 + cl + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + i * 16 + g;
      Cs[r][cl] = acc[i][j][0] + b0;
      Cs[r][cl + 1] = acc[i][j][1] + b1;
      Cs[r + 8][cl] = acc[i][j][2] + b0;
      Cs[r + 8][cl + 1] = acc[i][j][3] + b1;
    }
  }
  __syncthreads();
  tile_epilogue(Cs, ypre, part, n, HW, Cout, S);
}

// grid (splits, ceil(Cout / 32), N), block 32 x 8: merge the S tile
// partials of this block's channels, then normalize `chunk` rows.
template <typename T>
__global__ void conv_in_normalize_kernel(const float* __restrict__ ypre,
                                         const float* __restrict__ part,
                                         const T* __restrict__ res,
                                         T* __restrict__ y, int HW, int Cout,
                                         int S, int chunk, int relu,
                                         float eps) {
  __shared__ float mu_s[32], rs_s[32];
  const int n = blockIdx.z;
  const int c = blockIdx.y * 32 + threadIdx.x;
  if (threadIdx.y == 0) {
    float cnt = 0.0f, mean = 0.0f, m2 = 0.0f;
    if (c < Cout) {
      const int64_t plane = (int64_t)gridDim.z * S * Cout;
      for (int s = 0; s < S; ++s) {
        const int64_t o = ((int64_t)n * S + s) * Cout + c;
        chan_merge(cnt, mean, m2, part[o], part[plane + o], part[2 * plane + o]);
      }
    }
    mu_s[threadIdx.x] = mean;
    rs_s[threadIdx.x] = 1.0f / sqrtf(m2 / (float)HW + eps);
  }
  __syncthreads();
  if (c >= Cout) return;
  const float mu = mu_s[threadIdx.x], rs = rs_s[threadIdx.x];
  const int hw0 = blockIdx.x * chunk;
  const int hw1 = min(hw0 + chunk, HW);
  for (int hw = hw0 + threadIdx.y; hw < hw1; hw += 8) {
    const int64_t o = ((int64_t)n * HW + hw) * Cout + c;
    float v = (ypre[o] - mu) * rs;
    if (res != nullptr) v += to_f<T>(res[o]);
    if (relu) v = fmaxf(v, 0.0f);
    y[o] = from_f<T>(v);
  }
}

int tiles_m(int HW) { return (HW + BM - 1) / BM; }

template <typename T>
int launch_normalize(const float* ypre, const float* part, const void* res,
                     void* y, int N, int HW, int Cout, int S, int relu,
                     float eps, cudaStream_t s) {
  // about 132 * 8 blocks in all, each at least 8 rows
  const int ctiles = (Cout + 31) / 32;
  int splits = (132 * 8 + N * ctiles - 1) / (N * ctiles);
  const int max_splits = (HW + 7) / 8;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  int chunk = (HW + splits - 1) / splits;
  chunk = (chunk + 7) / 8 * 8;
  splits = (HW + chunk - 1) / chunk;
  conv_in_normalize_kernel<T><<<dim3(splits, ctiles, N), dim3(32, 8), 0, s>>>(
      ypre, part, (const T*)res, (T*)y, HW, Cout, S, chunk, relu, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 workspace the call needs: the pre-norm output, then (count, mean, M2)
// planes of N * S * Cout, S = ceil(H * W / 64).
extern "C" int64_t himan_conv_in_workspace(int N, int H, int W, int Cout) {
  const int64_t HW = (int64_t)H * W;
  return N * HW * Cout + 3 * (int64_t)N * tiles_m((int)HW) * Cout;
}

// x NHWC (N, H, W, Cin), w (9 * Cin, Cout) row-major (HWIO), both fp32 or
// both bf16; bias fp32 (Cout); res (nullable) and y NHWC (N, H, W, Cout) in
// x's dtype; ws fp32 of himan_conv_in_workspace(N, H, W, Cout) floats.
extern "C" int himan_conv3x3_in_act(const void* x, const void* w,
                                    const void* bias, const void* res,
                                    void* y, void* ws, int N, int H, int W,
                                    int Cin, int Cout, int relu, float eps,
                                    int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int HW = H * W;
  const int S = tiles_m(HW);
  float* ypre = (float*)ws;
  float* part = ypre + (int64_t)N * HW * Cout;
  const dim3 grid(S, (Cout + BN - 1) / BN, N);
  if (is_bf16) {
    conv_mma_kernel<<<grid, kThreads, 0, s>>>(
        (const uint16_t*)x, (const uint16_t*)w, (const float*)bias, ypre, part,
        H, W, Cin, Cout, S);
  } else {
    conv_fma_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)bias, ypre, part, H,
        W, Cin, Cout, S);
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if (is_bf16)
    return launch_normalize<__nv_bfloat16>(ypre, part, res, y, N, HW, Cout, S,
                                           relu, eps, s);
  return launch_normalize<float>(ypre, part, res, y, N, HW, Cout, S, relu,
                                 eps, s);
}
