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
// All three kernels here run an implicit GEMM, M = the H*W pixels of one
// sample (grid.z = n), N = Cout, K = 9 * Cin taken tap by tap. The mma and
// fma kernels reflect the row and column indices in their loads of x (row
// -1 reads row 1, row H reads row H-2), so no padded copy exists for them;
// the wgmma kernel reads a padded copy. kernels/conv_in._plan picks:
//
//   conv_wgmma_kernel (bf16, Cin and Cout multiples of 8, a grid of at
//             least half the SMs; the resblock roofline path at bs 32).
//             Bound there: operations, 0.31 ms at 989 TFLOP/s. Two small
//             launches first lay the operands out for TMA: transpose_kernel
//             writes the weights K-major (Cout, 9, Cin), reflect_pad1_kernel
//             a reflect-padded copy of x (N, H + 2, W + 2, Cin). (TMA
//             zero-fills out-of-bounds rows and cannot reflect; loading A
//             with 16-byte cp.async from the reflected addresses instead
//             made that stream, not the tensor cores, the kernel's limit.)
//             A tile is 128 pixels (whole image rows: 128 / W rows of W, or
//             128 columns of one row) x 256 output channels; K steps of 64
//             channels of one tap (128-byte rows, the 128-byte swizzle).
//             384 threads: one thread of the producer warpgroup
//             (setmaxnreg 40) keeps a ring of 4 stages full, each with a
//             full and an empty mbarrier: A by one TMA 4-D box of the padded
//             copy at the tap's offset (rows x columns x 64 channels), B by
//             a TMA 3-D box (64 channels x 1 tap x 256 output channels), both
//             zero past Cin and Cout. Two consumer warpgroups (setmaxnreg
//             232) issue wgmma m64n256k16 from shared memory into fp32
//             registers, one group in flight, and release a stage when its
//             group is done. Epilogue: the bias joins the registers; each
//             tile's exact two-pass (count, mean, M2) per channel (a shuffle
//             tree over a warp's 16 pixels, then the 8 warps in order).
//             Where the plane has <= 8 tiles (H*W <= 1024 at W <= 128) the
//             plane's tiles are one thread-block cluster: B is multicast by
//             TMA to all its blocks (each loads 1/cs of the tile, for 2, 4
//             or 8 blocks), and after the main loop each block reads the
//             others' partials through distributed shared memory and merges
//             them with Chan's formula in rank order 0..cs-1 (every block
//             the same bits), then normalizes its registers, adds the
//             residual, applies ReLU and writes y once in bf16: no fp32
//             pre-norm round trip. Larger planes keep the two-launch
//             epilogue below (conv_in_normalize_kernel). A barrier wait of
//             more than 2 s traps instead of holding the card.
//   conv_mma_kernel (bf16 otherwise: bs 1 at the bottleneck, channel
//             counts that 16-byte copies cannot take): a block owns a
//             64-pixel x 64-channel tile; K steps of 32 channels, the next
//             step's 16-byte loads (when the channel counts are multiples
//             of 8) in flight over the current step's products, ldmatrix
//             fragments, mma.sync m16n8k16 with fp32 accumulators, a warp
//             a 32 x 16 sub-tile. The epilogue adds b to the fp32 sums
//             (before the statistics, as the TPU kernel does), stores the
//             pre-norm tile in fp32 and one (count, mean, M2) per channel
//             of the tile: the tile's exact two-pass mean and sum of
//             squared deviations, in a fixed order. A second launch
//             (conv_in_normalize_kernel), grid (row split, 32 channels, n),
//             merges the partials of its channels with Chan's formula in
//             tile order, then normalizes its rows, adds the residual,
//             applies ReLU and casts, one write.
//   conv_fma_kernel (fp32, the parity tier: full fp32 on the FMA pipes, no
//             TF32). Bound: operations, 0.144 ms at the bs-1 bottleneck
//             (67 TFLOP/s of fp32 FMA), where a 64 x 64 tile of 4 x 4
//             outputs a thread (scalar global loads, no stage in flight,
//             128 blocks walking all of K alone) took 0.703 ms on an H100
//             80GB HBM3 at 700 W. A tile is 128 pixels x 256 output
//             channels, 8 x 16 outputs a thread (6 16-byte shared loads for
//             128 FFMAs), K steps of 32 channels of one tap through a
//             4-stage ring of cp.async copies (16 bytes: A as NHWC pixel
//             rows of 32 channels, the reflect-1 addresses computed in the
//             load; B as HWIO weight rows of 256 output channels; 4-byte
//             copies where Cin or Cout is not a multiple of 4), one
//             __syncthreads a K step. 255 registers and 200 KB
//             of shared memory: one block an SM. Where the tiles alone give
//             fewer than 128 blocks, K is split 2, 4 or 8 ways into whole
//             K steps (kernels/conv_in._plan): each split writes its
//             partial sums, which conv_splitk_reduce_kernel adds in split
//             order with the bias while it takes each row slice's exact
//             two-pass statistics. An unsplit tile writes its pre-norm
//             values and statistics. conv_in_normalize_kernel then merges
//             and normalizes, as for the mma kernel. A plane of one tile,
//             unsplit, is normalized and written by its block: 1, 2 or 3
//             launches. No thread-block cluster: at one block an SM an
//             H100 80GB HBM3 (700 W) holds 30 clusters of 4 or 15 of 8 at
//             once (120 blocks), so a 128-block grid of them runs in two
//             waves.
// No atomics and every merge in a fixed order: the same inputs give the
// same bits on every run.
//
// Limits, checked by the wrapper: H, W > 1 (reflect pad 1), N <= 65535,
// Cout / 64 <= 65535.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;        // output pixels of one sample per tile
constexpr int BN = 64;        // output channels per tile
constexpr int kThreads = 256;
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

// rows of a block of the row-split kernels: about 132 * 8 blocks of 32
// channels in all, each at least 8 rows, a multiple of 8 -> chunk; *splits
int row_chunk(int N, int HW, int Cout, int* splits_out) {
  const int ctiles = (Cout + 31) / 32;
  int splits = (132 * 8 + N * ctiles - 1) / (N * ctiles);
  const int max_splits = (HW + 7) / 8;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  int chunk = (HW + splits - 1) / splits;
  chunk = (chunk + 7) / 8 * 8;
  *splits_out = (HW + chunk - 1) / chunk;
  return chunk;
}

template <typename T>
int launch_normalize(const float* ypre, const float* part, const void* res,
                     void* y, int N, int HW, int Cout, int S, int relu,
                     float eps, cudaStream_t s) {
  const int ctiles = (Cout + 31) / 32;
  int splits;
  const int chunk = row_chunk(N, HW, Cout, &splits);
  conv_in_normalize_kernel<T><<<dim3(splits, ctiles, N), dim3(32, 8), 0, s>>>(
      ypre, part, (const T*)res, (T*)y, HW, Cout, S, chunk, relu, eps);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ wgmma
// The Hopper bf16 kernel: see the head of this file.

constexpr int WM = 128;          // output pixels of one sample per tile
constexpr int WN = 256;          // output channels per tile
constexpr int WK = 64;           // input channels of one tap per K step: 128 B
constexpr int kStages = 4;       // ring depth (48 KB a stage)
constexpr int kWgThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kStageBytes = (WM + WN) * WK * 2;
constexpr int kWgSmem = kStages * kStageBytes + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ bool mbar_try(uint32_t addr, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P;\nmbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P;\n}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// waits for the phase of `bar` with this parity; a wait of more than 2 s
// (an arrival that never comes) traps, so a fault fails the launch instead
// of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(a, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

// arrival on the barrier at `bar`'s offset in the shared memory of block
// `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the same box into the shared memory (and onto the barrier) at the same
// offsets of every block of the cluster in `mask`
__device__ __forceinline__ void tma_load_3d_mc(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                               int c0, int c1, int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// wgmma descriptor of a K-major bf16 tile of 128-byte rows, 128-byte
// swizzle, 8-row groups 1024 bytes apart (the tile starts 1024-aligned)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[WN / 2]) {
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 256 fp32, this warpgroup's registers) += A (64 x 16) * B (256 x
// 16)^T, both bf16 K-major in shared memory behind 128-byte-swizzle
// descriptors.
__device__ __forceinline__ void wgmma_tile(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// grid (tiles of the plane, ceil(Cout / 256), N), 384 threads. A tile is
// `rb` image rows x `wt` columns (rb * wt <= 128 pixels) of one sample; tile
// t is row group t / tiles_w, column group t % tiles_w. With `clustered`
// all of a plane's tiles (<= 8) form one cluster.
__global__ void __launch_bounds__(kWgThreads, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                  const uint16_t* __restrict__ res, uint16_t* __restrict__ y,
                  float* __restrict__ ypre, float* __restrict__ part, int H, int W, int Cin,
                  int Cout, int wt, int rb, int tiles_w, int relu, float eps, int clustered,
                  int mc) {
  extern __shared__ uint8_t wg_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ float red[8][WN];
  __shared__ float tstat[3][WN];  // this tile's count, mean, M2 per channel
  __shared__ float gstat[2][WN];  // the plane's mean, rstd per channel
  const uint32_t base = (smem_u32(wg_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, n = blockIdx.z, n0 = blockIdx.y * WN;
  const int h0 = (blockIdx.x / tiles_w) * rb, w0 = (blockIdx.x % tiles_w) * wt;
  const int cpt = (Cin + WK - 1) / WK, steps = 9 * cpt;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);        // the producer's expect_tx; the TMA bytes
      mbar_init(&empty[s], 8 * mc);  // each consumer warp of the mc blocks
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (clustered) cluster_sync_all();  // every block's barriers exist
  const int rank = clustered ? (int)blockIdx.x : 0;

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues both TMA loads a stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      const uint32_t abytes = rb * wt * WK * 2;
      for (int it = 0; it < steps; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int tap = it / cpt, c0 = (it % cpt) * WK;
        const uint32_t sa = base + s * kStageBytes, sb = sa + WM * WK * 2;
        mbar_expect_tx(&full[s], abytes + WN * WK * 2);
        // A: the padded input at row h0 + dy + 1, column w0 + dx + 1
        tma_load_4d(sa, &xmap, &full[s], c0, w0 + tap % 3, h0 + tap / 3, n);
        if (mc > 1) {
          // this block's 1/mc of the B tile, into all mc blocks at once
          const int rows = WN / mc;
          tma_load_3d_mc(sb + rank * rows * 128, &wmap, &full[s], c0, tap, n0 + rank * rows,
                         (uint16_t)((1u << mc) - 1));
        } else {
          tma_load_3d(sb, &wmap, &full[s], c0, tap, n0);
        }
      }
    }
    if (clustered) {
      cluster_sync_all();
      cluster_sync_all();
    }
    return;
  }

  // ---- consumer warpgroups: pixels 64 cw .. of the tile, all 256 channels
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = tid - 128, cw = ct / 128, w8 = ct / 32, l = ct % 32;
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;
  for (int it = 0; it < steps; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t sa = base + s * kStageBytes + cw * 64 * 128, sb = base + s * kStageBytes + WM * WK * 2;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      wgmma_tile(acc, wg_desc(sa + kk * 32), wg_desc(sb + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    // the group before this one is done: release its stage
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (it > 0) {
      // lane q of each warp releases the stage in block q of the multicast
      if (mc > 1 && l < mc) mbar_arrive_cluster(&empty[(it - 1) % kStages], l);
      if (mc == 1 && l == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // ---- epilogue. acc[4q + e]: tile pixel p_lo (e < 2) or p_lo + 8,
  // channel 8q + 2 (l % 4) + e % 2 of the tile
  const int p_lo = cw * 64 + (w8 % 4) * 16 + l / 4;
  int64_t orow[2];  // output pixel index of p_lo, p_lo + 8 (-1: none)
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int p = p_lo + 8 * h2, r = p / wt, wc = p % wt;
    const bool ok = p < rb * wt && h0 + r < H && w0 + wc < W;
    orow[h2] = ok ? ((int64_t)n * H + h0 + r) * W + w0 + wc : -1;
  }
  const bool vlo = orow[0] >= 0, vhi = orow[1] >= 0;
  const int rows = min(rb, H - h0) * min(wt, W - w0);
#pragma unroll
  for (int q = 0; q < WN / 8; ++q) {
    const int c = n0 + q * 8 + (l % 4) * 2;
    const float b0 = c < Cout ? bias[c] : 0.0f, b1 = c + 1 < Cout ? bias[c + 1] : 0.0f;
    acc[4 * q] += b0;
    acc[4 * q + 1] += b1;
    acc[4 * q + 2] += b0;
    acc[4 * q + 3] += b1;
  }
  // the tile's exact two-pass statistics per channel: the 16 pixels of a
  // warp by a shuffle tree, then the 8 warps in order
  auto col_reduce = [&](float (&v)[WN / 4], float* outp) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < WN / 4; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    if (l < 4)
#pragma unroll
      for (int k = 0; k < WN / 4; ++k) red[w8][(k / 2) * 8 + l * 2 + k % 2] = v[k];
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (ct < WN) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) t += red[w][ct];
      outp[ct] = t;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  };
  float v[WN / 4];
#pragma unroll
  for (int k = 0; k < WN / 4; ++k) {
    const int q = k / 2, e = k % 2;
    v[k] = (vlo ? acc[4 * q + e] : 0.0f) + (vhi ? acc[4 * q + 2 + e] : 0.0f);
  }
  col_reduce(v, tstat[1]);
  if (ct < WN) tstat[1][ct] /= (float)rows;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < WN / 4; ++k) {
    const int q = k / 2, e = k % 2;
    const float mu = tstat[1][q * 8 + (l % 4) * 2 + e];
    const float a = acc[4 * q + e] - mu, b = acc[4 * q + 2 + e] - mu;
    v[k] = (vlo ? a * a : 0.0f) + (vhi ? b * b : 0.0f);
  }
  col_reduce(v, tstat[2]);
  if (!clustered) {
    // two-launch epilogue: the pre-norm tile and its partials
    if (ct < WN && n0 + ct < Cout) {
      const int64_t o = ((int64_t)n * gridDim.x + blockIdx.x) * Cout + n0 + ct;
      const int64_t plane = (int64_t)gridDim.z * gridDim.x * Cout;
      part[o] = (float)rows;
      part[plane + o] = tstat[1][ct];
      part[2 * plane + o] = tstat[2][ct];
    }
#pragma unroll
    for (int q = 0; q < WN / 8; ++q) {
      const int c = n0 + q * 8 + (l % 4) * 2;
      if (c >= Cout) continue;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        if (orow[h2] >= 0)
          *reinterpret_cast<float2*>(ypre + orow[h2] * Cout + c) =
              make_float2(acc[4 * q + 2 * h2], acc[4 * q + 2 * h2 + 1]);
    }
    return;
  }
  if (ct < WN) tstat[0][ct] = (float)rows;
  cluster_sync_all();
  if (ct < WN) {
    // Chan's merge of the cluster's tiles in rank order: every block of the
    // cluster computes the same bits
    cg::cluster_group cluster = cg::this_cluster();
    float cnt = 0.0f, mean = 0.0f, m2 = 0.0f;
    for (int q = 0; q < (int)cluster.num_blocks(); ++q) {
      const float* t = cluster.map_shared_rank(&tstat[0][0], q);
      chan_merge(cnt, mean, m2, t[ct], t[WN + ct], t[2 * WN + ct]);
    }
    gstat[0][ct] = mean;
    gstat[1][ct] = 1.0f / sqrtf(m2 / (float)(H * W) + eps);
  }
  cluster_sync_all();  // gstat visible; no block leaves while it is read
#pragma unroll
  for (int q = 0; q < WN / 8; ++q) {
    const int cl = q * 8 + (l % 4) * 2, c = n0 + cl;
    if (c >= Cout) continue;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (orow[h2] < 0) continue;
      const int64_t o = orow[h2] * Cout + c;
      float a = (acc[4 * q + 2 * h2] - gstat[0][cl]) * gstat[1][cl];
      float b = (acc[4 * q + 2 * h2 + 1] - gstat[0][cl + 1]) * gstat[1][cl + 1];
      if (res != nullptr) {
        const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + o);
        a += __low2float(r2);
        b += __high2float(r2);
      }
      if (relu) {
        a = fmaxf(a, 0.0f);
        b = fmaxf(b, 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(y + o) = __floats2bfloat162_rn(a, b);
    }
  }
}

// The wgmma kernel's two operand layouts, 16-byte vectors of 8 bf16 (C a
// multiple of 8). xp (N, H + 2, W + 2, C) = reflect_pad(x, 1): row -1
// reads row 1, row H reads row H - 2, the same for columns.
__global__ void reflect_pad1_kernel(const uint4* __restrict__ x, uint4* __restrict__ xp, int N,
                                    int H, int W, int C8) {
  const int64_t total = (int64_t)N * (H + 2) * (W + 2) * C8;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int cv = (int)(i % C8);
    int64_t t = i / C8;
    const int wp = (int)(t % (W + 2));
    t /= W + 2;
    const int hp = (int)(t % (H + 2));
    const int64_t n = t / (H + 2);
    xp[i] = x[((n * H + reflect1(hp - 1, H)) * W + reflect1(wp - 1, W)) * C8 + cv];
  }
}

// w (9 Cin, Cout) -> wt (Cout, 9 Cin), 32 x 32 tiles through shared memory
__global__ void transpose_kernel(const uint16_t* __restrict__ w, uint16_t* __restrict__ wt,
                                 int K, int Cout) {
  __shared__ uint16_t tile[32][33];
  const int k0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int k = k0 + r, c = c0 + threadIdx.x;
    if (k < K && c < Cout) tile[r][threadIdx.x] = w[(int64_t)k * Cout + c];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r, k = k0 + threadIdx.x;
    if (k < K && c < Cout) wt[(int64_t)c * K + k] = tile[threadIdx.x][r];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    fn = (EncodeTiled)p;
  }
  return fn;
}

int64_t align256(int64_t b) { return (b + 255) / 256 * 256; }

// Bytes of ws the wgmma variant needs: wt, xp, then (two-launch epilogue)
// the fp32 pre-norm output and the tiles' (count, mean, M2) planes.
int64_t wgmma_workspace(int N, int H, int W, int Cin, int Cout, int tiles, int clustered) {
  int64_t b = align256((int64_t)9 * Cin * Cout * 2) + align256((int64_t)N * (H + 2) * (W + 2) * Cin * 2);
  if (!clustered) b += align256((int64_t)N * H * W * Cout * 4) + (int64_t)3 * N * tiles * Cout * 4;
  return b;
}

int launch_wgmma(const void* x, const void* w, const float* bias, const void* res, void* y,
                 uint8_t* ws, int N, int H, int W, int Cin, int Cout, int relu, float eps,
                 int wt, int rb, int clustered, cudaStream_t s) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int tiles_w = (W + wt - 1) / wt, tiles = (H + rb - 1) / rb * tiles_w;
  uint16_t* wtp = (uint16_t*)ws;
  uint16_t* xp = (uint16_t*)(ws + align256((int64_t)9 * Cin * Cout * 2));
  float* ypre = (float*)((uint8_t*)xp + align256((int64_t)N * (H + 2) * (W + 2) * Cin * 2));
  float* part = ypre + align256((int64_t)N * H * W * Cout * 4) / 4;
  transpose_kernel<<<dim3((Cout + 31) / 32, (9 * Cin + 31) / 32), dim3(32, 8), 0, s>>>(
      (const uint16_t*)w, wtp, 9 * Cin, Cout);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reflect_pad1_kernel<<<132 * 8, 256, 0, s>>>((const uint4*)x, (uint4*)xp, N, H, W, Cin / 8);
  err = (int)cudaGetLastError();
  if (err) return err;
  // B multicast over the cluster where its blocks split the tile evenly
  const int mc = clustered && (tiles == 2 || tiles == 4 || tiles == 8) ? tiles : 1;
  CUtensorMap xmap, wmap;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W + 2, (cuuint64_t)H + 2,
                                (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)Cin * 2 * (W + 2),
                                   (cuuint64_t)Cin * 2 * (W + 2) * (H + 2)};
    const cuuint32_t box[4] = {WK, (cuuint32_t)wt, (cuuint32_t)rb, 1}, estr[4] = {1, 1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, xp, dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Cin, 9, (cuuint64_t)Cout};
    const cuuint64_t strides[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)Cin * 18};
    const cuuint32_t box[3] = {WK, 1, (cuuint32_t)(WN / mc)}, estr[3] = {1, 1, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wtp, dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  err = (int)cudaFuncSetAttribute(conv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kWgSmem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, (Cout + WN - 1) / WN, N);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kWgSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clustered ? tiles : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, conv_wgmma_kernel, xmap, wmap, bias, (const uint16_t*)res,
                                (uint16_t*)y, ypre, part, H, W, Cin, Cout, wt, rb, tiles_w, relu,
                                eps, clustered, mc);
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err || clustered) return err;
  return launch_normalize<__nv_bfloat16>(ypre, part, res, y, N, H * W, Cout, tiles, relu, eps, s);
}


// ------------------------------------------------------------------ fp32
// The FMA kernel: see the head of this file.

constexpr int FM = 128;            // output pixels of one sample per tile
constexpr int FN = 256;            // output channels per tile
constexpr int FK = 32;             // input channels of one tap per K step
constexpr int kFStages = 4;        // cp.async ring depth
constexpr int kFAStride = FK + 4;  // an A row: 32 channels + 4 floats (144 B)
constexpr int kFSStride = FN + 4;  // a row of the epilogue's tiles
constexpr int kFStageFloats = FM * kFAStride + FK * FN;
constexpr int kFSmem = kFStages * kFStageFloats * 4;  // 200 KB
static_assert(FM * kFSStride <= kFStages * kFStageFloats, "the epilogue's tile fits the ring");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// grid (mt * ks, ceil(Cout / 256), N), 256 threads. Block x = m * ks + q:
// pixels 128 m .. of sample z, output channels 256 y .., K steps
// [q S / ks, (q + 1) S / ks) of the S = 9 * ceil(Cin / 32). Thread (ty, tx)
// accumulates rows ty + 16 i (i < 8), channels 64 h + 4 tx + j (h, j < 4).
// A K split (ks > 1) writes its partial sums to splitp for
// conv_splitk_reduce_kernel. Else the tile's pre-norm values and its
// (count, mean, M2) per channel go to ypre / part for
// conv_in_normalize_kernel, or, where the tile is the whole plane
// (`plane`: one tile, no split), y is written here.
__global__ void __launch_bounds__(kThreads, 1)
conv_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ y, float* __restrict__ ypre, float* __restrict__ part,
                float* __restrict__ splitp, int H, int W, int Cin, int Cout, int ks,
                int plane, int vec_a, int vec_b, int relu, float eps) {
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, n = blockIdx.z, HW = H * W;
  const int mtile = blockIdx.x / ks, q = blockIdx.x % ks;
  const int m0 = mtile * FM, n0 = blockIdx.y * FN;
  const int cpt = (Cin + FK - 1) / FK, nk = 9 * cpt / ks, kbeg = q * nk;
  const float* xn = x + (int64_t)n * HW * Cin;
  const uint32_t sbase = smem_u32(fsm);

  // A by 16-byte copies: channels 4 (tid % 8) .. of pixels tid / 8 + 32 r
  constexpr int kAC = FK / 4, kAV = FM * kAC / kThreads;
  int ph[kAV], pw[kAV];
  bool pv[kAV];
#pragma unroll
  for (int r = 0; r < kAV; ++r) {
    const int m = m0 + tid / kAC + (kThreads / kAC) * r;
    pv[r] = m < HW;
    ph[r] = pv[r] ? m / W : 0;
    pw[r] = pv[r] ? m % W : 0;
  }
  auto load = [&](int slot, int step) {
    const int tap = step / cpt, c0 = (step % cpt) * FK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const uint32_t sa = sbase + slot * kFStageFloats * 4;
    const uint32_t sb = sa + FM * kFAStride * 4;
    if (vec_a) {
#pragma unroll
      for (int r = 0; r < kAV; ++r) {
        const int p = tid / kAC + (kThreads / kAC) * r, c = c0 + 4 * (tid % kAC);
        const bool ok = pv[r] && c < Cin;
        const float* src =
            ok ? xn + ((int64_t)reflect1(ph[r] + dy, H) * W + reflect1(pw[r] + dx, W)) * Cin + c
               : x;
        cp_async16(sa + (p * kFAStride + 4 * (tid % kAC)) * 4, src, ok);
      }
    } else {
      // element by element: channel c0 + tid % 32 of pixels tid / 32 + 8 r
#pragma unroll 4
      for (int r = 0; r < FM * FK / kThreads; ++r) {
        const int p = tid / FK + (kThreads / FK) * r, c = c0 + tid % FK, m = m0 + p;
        const bool ok = m < HW && c < Cin;
        const float* src =
            ok ? xn + ((int64_t)reflect1(m / W + dy, H) * W + reflect1(m % W + dx, W)) * Cin + c
               : x;
        cp_async4(sa + (p * kFAStride + tid % FK) * 4, src, ok);
      }
    }
    const float* wt = w + ((int64_t)tap * Cin + c0) * Cout + n0;
    if (vec_b) {
      // output channels 4 (tid % 32) .. of K rows tid / 32 + 8 r
#pragma unroll
      for (int r = 0; r < FK * FN / 4 / kThreads; ++r) {
        const int k = tid / (FN / 4) + (kThreads * 4 / FN) * r, c = 4 * (tid % (FN / 4));
        const bool ok = c0 + k < Cin && n0 + c < Cout;
        cp_async16(sb + (k * FN + c) * 4, ok ? wt + (int64_t)k * Cout + c : w, ok);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < FK * FN / kThreads; ++r) {
        const int k = tid / FN + (kThreads / FN) * r, c = tid % FN;
        const bool ok = c0 + k < Cin && n0 + c < Cout;
        cp_async4(sb + (k * FN + c) * 4, ok ? wt + (int64_t)k * Cout + c : w, ok);
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < nk) load(s, kbeg + s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // stage it landed for all; stage it - 1 is free
    if (it + kFStages - 1 < nk) load((it + kFStages - 1) % kFStages, kbeg + it + kFStages - 1);
    cp_async_commit();
    const float* As = fsm + (it % kFStages) * kFStageFloats + ty * kFAStride;
    const float* Bs = fsm + (it % kFStages) * kFStageFloats + FM * kFAStride + tx * 4;
#pragma unroll
    for (int k4 = 0; k4 < FK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + 16 * i * kFAStride + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[4];
#pragma unroll
        for (int h = 0; h < 4; ++h)
          b[h] = *reinterpret_cast<const float4*>(Bs + (k4 + kk) * FN + 64 * h);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = f4(a[i], kk);
#pragma unroll
          for (int h = 0; h < 4; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][4 * h + j] = fmaf(av, f4(b[h], j), acc[i][4 * h + j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every product read the ring: it becomes the tile
  if (ks > 1) {
    // this K split's partial sums, for conv_splitk_reduce_kernel
    float* pq = splitp + ((int64_t)q * gridDim.z + n) * HW * Cout;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= HW) continue;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int c = n0 + 64 * h + 4 * tx;
        const float* v = acc[i] + 4 * h;
        float* dst = pq + (int64_t)m * Cout + c;
        if (Cout % 4 == 0 && c + 3 < Cout) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < Cout) dst[j] = v[j];
        }
      }
    }
    return;
  }

  float* Cs = fsm;  // the tile
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = Cs + (ty + 16 * i) * kFSStride + tx * 4;
#pragma unroll
    for (int h = 0; h < 4; ++h)
      *reinterpret_cast<float4*>(row + 64 * h) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
  __syncthreads();

  // thread: channel tid of the tile, plus the bias; its exact two-pass
  // statistics in row order
  const int col = tid, c = n0 + col;
  if (c >= Cout) return;
  const float bc = bias[c];
  const int cnt = max(0, min(FM, HW - m0));
  float sum = 0.0f;
  for (int r = 0; r < cnt; ++r) sum += Cs[r * kFSStride + col] + bc;
  const float mu = cnt > 0 ? sum / (float)cnt : 0.0f;
  float m2 = 0.0f;
  for (int r = 0; r < cnt; ++r) {
    const float d = Cs[r * kFSStride + col] + bc - mu;
    m2 += d * d;
  }
  if (!plane) {
    // two-launch epilogue: the pre-norm tile and its statistics
    const int64_t o = ((int64_t)n * gridDim.x + blockIdx.x) * Cout + c;
    const int64_t pl = (int64_t)gridDim.z * gridDim.x * Cout;
    part[o] = (float)cnt;
    part[pl + o] = mu;
    part[2 * pl + o] = m2;
    for (int r = 0; r < cnt; ++r)
      ypre[((int64_t)n * HW + m0 + r) * Cout + c] = Cs[r * kFSStride + col] + bc;
    return;
  }
  // the tile is the plane (m0 = 0, cnt = HW)
  const float rs = 1.0f / sqrtf(m2 / (float)HW + eps);
  for (int r = 0; r < cnt; ++r) {
    const int64_t o = ((int64_t)n * HW + r) * Cout + c;
    float u = (Cs[r * kFSStride + col] + bc - mu) * rs;
    if (res != nullptr) u += res[o];
    if (relu) u = fmaxf(u, 0.0f);
    y[o] = u;
  }
}

// grid (splits, ceil(Cout / 32), N), block 32 x 8: rows [chunk x, ..) of
// sample z, channels 32 y ..: the ks partial sums of the fp32 kernel added in
// split order, then the bias -> ypre; the rows' exact two-pass (count, mean,
// M2) per channel -> part, as slice x of gridDim.x.
__global__ void conv_splitk_reduce_kernel(const float* __restrict__ splitp,
                                          const float* __restrict__ bias,
                                          float* __restrict__ ypre, float* __restrict__ part,
                                          int HW, int Cout, int ks, int chunk) {
  __shared__ float red[8][32];
  __shared__ float mean_s[32];
  const int tx = threadIdx.x, ty = threadIdx.y, n = blockIdx.z, N = gridDim.z;
  const int c = blockIdx.y * 32 + tx;
  const int r0 = blockIdx.x * chunk, r1 = min(r0 + chunk, HW);
  const int64_t plane = (int64_t)N * HW * Cout;
  float s = 0.0f;
  if (c < Cout) {
    const float bc = bias[c];
    for (int r = r0 + ty; r < r1; r += 8) {
      const int64_t o = ((int64_t)n * HW + r) * Cout + c;
      float v = 0.0f;
      for (int q = 0; q < ks; ++q) v += splitp[q * plane + o];
      v += bc;
      ypre[o] = v;
      s += v;
    }
  }
  red[ty][tx] = s;
  __syncthreads();
  const float cnt = (float)max(0, r1 - r0);
  if (ty == 0) {
    float t = 0.0f;
    for (int k = 0; k < 8; ++k) t += red[k][tx];
    mean_s[tx] = cnt > 0.0f ? t / cnt : 0.0f;
  }
  __syncthreads();
  const float mu = mean_s[tx];
  float m2 = 0.0f;
  if (c < Cout)
    for (int r = r0 + ty; r < r1; r += 8) {
      const float d = ypre[((int64_t)n * HW + r) * Cout + c] - mu;
      m2 += d * d;
    }
  __syncthreads();
  red[ty][tx] = m2;
  __syncthreads();
  if (ty == 0 && c < Cout) {
    float t = 0.0f;
    for (int k = 0; k < 8; ++k) t += red[k][tx];
    const int64_t o = ((int64_t)n * gridDim.x + blockIdx.x) * Cout + c;
    const int64_t pl = (int64_t)N * gridDim.x * Cout;
    part[o] = cnt;
    part[pl + o] = mu;
    part[2 * pl + o] = t;
  }
}

// The fp32 kernel's workspace (floats): none when one unsplit tile is the
// plane; else ypre, the slices' (count, mean, M2) planes and, for a K split,
// the splits' partial sums.
int64_t fma_workspace(int N, int HW, int Cout, int ks, int64_t* part_off, int64_t* split_off) {
  const int mt = (HW + FM - 1) / FM;
  if (mt == 1 && ks == 1) return 0;
  int S = mt;
  if (ks > 1) row_chunk(N, HW, Cout, &S);
  *part_off = (int64_t)N * HW * Cout;
  *split_off = *part_off + 3 * (int64_t)N * S * Cout;
  return *split_off + (ks > 1 ? (int64_t)ks * N * HW * Cout : 0);
}

int launch_fma(const float* x, const float* w, const float* bias, const float* res, float* y,
               uint8_t* ws, int N, int H, int W, int Cin, int Cout, int relu, float eps, int ks,
               cudaStream_t s) {
  const int HW = H * W, mt = (HW + FM - 1) / FM, steps = 9 * ((Cin + FK - 1) / FK);
  if ((ks != 1 && ks != 2 && ks != 4 && ks != 8) || steps % ks != 0)
    return (int)cudaErrorInvalidValue;
  const int plane = mt == 1 && ks == 1;
  int64_t part_off = 0, split_off = 0;
  fma_workspace(N, HW, Cout, ks, &part_off, &split_off);
  float* ypre = (float*)ws;
  float* part = ypre + part_off;
  float* splitp = ypre + split_off;
  const int vec_a = Cin % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const int vec_b = Cout % 4 == 0 && ((uintptr_t)w & 15) == 0;
  int err = (int)cudaFuncSetAttribute(conv_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kFSmem);
  if (err) return err;
  conv_fma_kernel<<<dim3(mt * ks, (Cout + FN - 1) / FN, N), kThreads, kFSmem, s>>>(
      x, w, bias, res, y, ypre, part, splitp, H, W, Cin, Cout, ks, plane, vec_a, vec_b, relu,
      eps);
  err = (int)cudaGetLastError();
  if (err || plane) return err;
  int S = mt;
  if (ks > 1) {
    const int chunk = row_chunk(N, HW, Cout, &S);
    conv_splitk_reduce_kernel<<<dim3(S, (Cout + 31) / 32, N), dim3(32, 8), 0, s>>>(
        splitp, bias, ypre, part, HW, Cout, ks, chunk);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_normalize<float>(ypre, part, res, y, N, HW, Cout, S, relu, eps, s);
}

}  // namespace

// Bytes of workspace a call needs. variant 0: fp32 FMA, with a K split of
// ks (no workspace when one unsplit tile is the plane; else the fp32
// pre-norm output, the slices' (count, mean, M2) planes and the splits'
// partial sums); 1: bf16 mma.sync (the pre-norm output and the 64-pixel
// tiles' planes); 2: bf16 wgmma with tiles of rb x wt pixels, clustered
// when cl > 1 (see wgmma_workspace).
extern "C" int64_t himan_conv_in_workspace(int N, int H, int W, int Cin, int Cout, int variant,
                                           int wt, int rb, int ks, int cl) {
  const int64_t HW = (int64_t)H * W;
  if (variant == 2)
    return wgmma_workspace(N, H, W, Cin, Cout, (H + rb - 1) / rb * ((W + wt - 1) / wt), cl > 1);
  if (variant == 0) {
    int64_t part_off, split_off;
    return 4 * fma_workspace(N, (int)HW, Cout, ks, &part_off, &split_off);
  }
  return 4 * (N * HW * Cout + 3 * (int64_t)N * tiles_m((int)HW) * Cout);
}

// x NHWC (N, H, W, Cin), w (9 * Cin, Cout) row-major (HWIO), both fp32 or
// both bf16; bias fp32 (Cout); res (nullable) and y NHWC (N, H, W, Cout) in
// x's dtype; ws: himan_conv_in_workspace bytes. variant, ks and cl as
// there; the wgmma variant's tiles are rb image rows x wt columns.
// kernels/conv_in._plan picks the variant, the tile, the split and the
// cluster.
extern "C" int himan_conv3x3_in_act(const void* x, const void* w, const void* bias,
                                    const void* res, void* y, void* ws, int N, int H, int W,
                                    int Cin, int Cout, int relu, float eps, int variant, int wt,
                                    int rb, int ks, int cl, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 2)
    return launch_wgmma(x, w, (const float*)bias, res, y, (uint8_t*)ws, N, H, W, Cin, Cout, relu,
                        eps, wt, rb, cl > 1, s);
  if (variant == 0)
    return launch_fma((const float*)x, (const float*)w, (const float*)bias, (const float*)res,
                      (float*)y, (uint8_t*)ws, N, H, W, Cin, Cout, relu, eps, ks, s);
  const int HW = H * W;
  const int S = tiles_m(HW);
  float* ypre = (float*)ws;
  float* part = ypre + (int64_t)N * HW * Cout;
  conv_mma_kernel<<<dim3(S, (Cout + BN - 1) / BN, N), kThreads, 0, s>>>(
      (const uint16_t*)x, (const uint16_t*)w, (const float*)bias, ypre, part, H, W, Cin, Cout,
      S);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_normalize<__nv_bfloat16>(ypre, part, res, y, N, HW, Cout, S, relu, eps, s);
}
