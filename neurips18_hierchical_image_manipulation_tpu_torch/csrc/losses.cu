// Loss reductions to fp32 means, a group of up to 16 terms in one launch,
// and their backward, one launch a group. Term k of a group is
//   mode 0  mean((a - t)^2)   t = b[i], or the scalar t when b is null
//   mode 1  mean(|a - t|)
// the mean taken over the term's true element count n.
//
// Replaces the TPU kernel of ops/pallas/losses.py in the JAX package:
// mse_to_scalar / l1_to_scalar -> _reduce_call (_sq_kernel, _abs_kernel).
// The TPU kernel reads a materialized diff tensor, padded to its 256K-element
// tile, and carries one accumulator across a sequential grid, one call a
// term. Here the two operands are read directly (no diff tensor is
// written), and one launch reduces every term of a loss: the 6 MSE terms of
// a 512x256 train step are two groups (G's GAN term, D's real and fake),
// the 13 L1 terms two more (feature matching, VGG).
//
// Bound: bytes, each operand element read once (3 operations an element
// pair). The step's 13 L1 terms read 177 MB in fp32, 0.0529 ms at 3.35 TB/s;
// its 6 MSE terms read 28 KB, so they cost what a launch costs.
//
// The design:
//   * the term table goes to the kernel by value (a __grid_constant__
//     struct): no host-to-device copy, so a CUDA graph can capture the
//     launch;
//   * blocks map to terms by a prefix sum of per-term block counts; a term's
//     block count and its split into 16-byte chunks depend only on its n and
//     dtype, so its partials, and the order they are summed in, do not
//     depend on the group it is in;
//   * a chunk is 16 bytes of each operand (4 fp32 or 8 bf16, counted from
//     the term's first element), one vector load when both operands are
//     16-byte aligned; otherwise the same chunks are read element by element
//     (the same registers, the same sums: a misaligned view gives the bits
//     of an aligned copy). Only the last chunk can be ragged, and is masked;
//     four chunks of each operand are in flight per thread;
//   * the finish runs in the same launch (a term of one block divides its
//     sum at once): each block writes its partial,
//     fences, and takes a ticket from the term's counter; the block that
//     draws the last ticket sums the term's partials in index order, divides
//     by n, writes the mean and resets the counter to 0. The counters live
//     in a workspace zeroed once when it is allocated (no memset a call). Which block finishes varies from run to run; the order of
//     every sum does not, so the bits are the same on every run.
// Two launches that share the workspace must not run at once:
// kernels/losses.py keeps one for each (device, stream), whose launches run
// one after another.
//
// Indices are 64-bit: any n that fits in memory is taken.
//
// The backward (loss_group_kernel_bwd) replaces no TPU kernel: the JAX
// package leaves the closed form to XLA. With g the (T,) upstream gradient,
// it writes each term's input gradient in the operand's dtype:
//   mode 0  da = ((2 g[k]) / n) (a - t)
//   mode 1  da = (g[k] / n) sign(a - t)     (0 where a == t)
// and db = -da where a tensor target takes a gradient. The arithmetic is
// PyTorch's closed form to the bit: the scale is g[k] (2 g[k] for mode 0)
// times the fp32 reciprocal of n rounded to fp32, as PyTorch's CUDA
// division by a host scalar computes it; the product with (a - t) or its
// sign is in fp32, rounded once to the operand's dtype.
//
// Bound: bytes, a and b read and da written once: 6 B an element in bf16,
// 12 in fp32 (the closed form in plain PyTorch moves ~46 B an element in
// bf16 through its fp32 temporaries). The flagship step's 13 L1 terms at
// bs 32 and 512x512 are 1.41 G elements a side, 8.5 GB in bf16: 2.53 ms at
// 3.35 TB/s.
//
// The design, the forward's where it can be:
//   * the table of the terms that take a gradient goes by value; a term's
//     g[k] is read from device memory in the kernel (no host sync, so a CUDA
//     graph can capture the launch), and no workspace is needed: nothing is
//     reduced;
//   * blocks map to terms by a prefix sum of block counts; each thread
//     keeps kUnroll 16-byte chunks of a and b in flight, then stores the
//     chunks of da (and db); a term whose operands or outputs are off the
//     16-byte grid takes the same chunks element by element, and only the
//     last chunk can be ragged (masked).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // chunks of each operand in flight a thread
constexpr int kMaxTerms = 16;
constexpr int kMaxTermBlocks = 1024;

struct LossTerm {
  const void* a;
  const void* b;  // null: the scalar target t
  int64_t n;
  float t;
  int mode;
  int vec;        // both operands 16-byte aligned
  int blocks;
  int block0;     // the term's first block in the grid
};

struct LossGroup {
  LossTerm term[kMaxTerms];
  int count;
};

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kPerChunk = 4;
  __device__ static float get(const uint4& r, int j) {
    const uint32_t w = j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
    return __uint_as_float(w);
  }
  // the bits of x in this dtype
  __device__ static uint32_t bits(float x) { return __float_as_uint(x); }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;
  __device__ static float get(const uint4& r, int j) {
    const uint32_t w = (j >> 1) == 0 ? r.x : (j >> 1) == 1 ? r.y : (j >> 1) == 2 ? r.z : r.w;
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  // x rounded to nearest even, as PyTorch's cast to bf16 rounds it
  __device__ static uint32_t bits(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }
};

// chunk j of one operand as raw bits; elements at or past n read as 0
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int64_t j, int64_t n, bool vec) {
  constexpr int V = Elem<T>::kPerChunk;
  const int64_t e0 = j * V;
  if (vec && e0 + V <= n) return __ldg(reinterpret_cast<const uint4*>(p + e0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
  const uint32_t* f = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (e0 + v >= n) break;
    if constexpr (sizeof(T) == 4)
      w[v] = __ldg(f + e0 + v);
    else
      w[v >> 1] |= (uint32_t)__ldg(h + e0 + v) << (16 * (v & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// sum over the chunk's elements below n of (a - t)^2 or |a - t|, in order
template <typename T>
__device__ __forceinline__ float chunk_sum(const uint4& ra, const uint4& rb, bool has_b,
                                           float t, int mode, int64_t valid) {
  constexpr int V = Elem<T>::kPerChunk;
  float s = 0.0f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float d = Elem<T>::get(ra, v) - (has_b ? Elem<T>::get(rb, v) : t);
    const float e = mode == 0 ? d * d : fabsf(d);
    s += v < valid ? e : 0.0f;
  }
  return s;
}

// sum of v over the block, in a fixed order; valid in thread 0
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
loss_group_kernel(const __grid_constant__ LossGroup g, float* __restrict__ part,
                  unsigned* __restrict__ ticket, float* __restrict__ out) {
  constexpr int V = Elem<T>::kPerChunk;
  int k = 0;
  while (k + 1 < g.count && (int)blockIdx.x >= g.term[k + 1].block0) ++k;
  const LossTerm& tm = g.term[k];
  const T* a = static_cast<const T*>(tm.a);
  const T* b = static_cast<const T*>(tm.b);
  const bool has_b = b != nullptr, vec = tm.vec != 0;
  const int bid = blockIdx.x - tm.block0;
  const int64_t n = tm.n, nch = (n + V - 1) / V;
  const int64_t stride = (int64_t)tm.blocks * kThreads;
  int64_t j = (int64_t)bid * kThreads + threadIdx.x;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float acc = 0.0f;
  for (; j + (kUnroll - 1) * stride < nch; j += kUnroll * stride) {
    uint4 ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ra[u] = load_chunk<T>(a, j + u * stride, n, vec);
      rb[u] = has_b ? load_chunk<T>(b, j + u * stride, n, vec) : zero;
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      s[u] = chunk_sum<T>(ra[u], rb[u], has_b, tm.t, tm.mode, n - (j + u * stride) * V);
    acc += (s[0] + s[1]) + (s[2] + s[3]);
  }
  for (; j < nch; j += stride) {
    const uint4 ra = load_chunk<T>(a, j, n, vec);
    const uint4 rb = has_b ? load_chunk<T>(b, j, n, vec) : zero;
    acc += chunk_sum<T>(ra, rb, has_b, tm.t, tm.mode, n - j * V);
  }
  acc = block_sum(acc);
  if (tm.blocks == 1) {
    // the term's only partial is its sum (the bits the finish would give)
    if (threadIdx.x == 0) out[k] = acc / (float)n;
    return;
  }
  float* tpart = part + (int64_t)k * kMaxTermBlocks;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    tpart[bid] = acc;
    __threadfence();
    last = atomicAdd(&ticket[k], 1u) == (unsigned)tm.blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float v = 0.0f;
  for (int i = threadIdx.x; i < tm.blocks; i += kThreads) v += __ldcg(tpart + i);
  v = block_sum(v);
  if (threadIdx.x == 0) {
    out[k] = v / (float)n;
    ticket[k] = 0u;
  }
}

constexpr int kMaxGradBlocks = 8192;  // blocks of one term in the backward

struct GradTerm {
  const void* a;
  const void* b;  // null: the scalar target t
  void* da;       // null: a takes no gradient
  void* db;       // null: b takes none, or there is no b
  int64_t n;
  float t;
  float inv_n;    // 1 / n, n rounded to fp32 and the quotient too (on the host)
  int mode;
  int k;          // the term's index in the upstream gradient
  int vec;        // a, b, da and db all 16-byte aligned
  int blocks;
  int block0;
};

struct GradGroup {
  GradTerm term[kMaxTerms];
  int count;
};

// chunk j of one output from its elements' bits (the low 16 of each word
// pair in bf16); elements at or past n are not written
template <typename T>
__device__ __forceinline__ void store_chunk(T* p, int64_t j, int64_t n, bool vec, const uint4& r) {
  constexpr int V = Elem<T>::kPerChunk;
  const int64_t e0 = j * V;
  if (vec && e0 + V <= n) {
    *reinterpret_cast<uint4*>(p + e0) = r;
    return;
  }
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  uint16_t* h = reinterpret_cast<uint16_t*>(p);
  uint32_t* f = reinterpret_cast<uint32_t*>(p);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (e0 + v >= n) break;
    if constexpr (sizeof(T) == 4)
      f[e0 + v] = w[v];
    else
      h[e0 + v] = (uint16_t)(w[v >> 1] >> (16 * (v & 1)));
  }
}

// a chunk's gradient s = scale (a - t) (mode 0) or scale sign(a - t), and
// -s, each rounded once to T, as raw chunks
template <typename T>
__device__ __forceinline__ void grad_chunk(const uint4& ra, const uint4& rb, bool has_b, float t,
                                           int mode, float scale, uint4& ga, uint4& gb) {
  constexpr int V = Elem<T>::kPerChunk;
  uint32_t wa[4] = {0u, 0u, 0u, 0u}, wb[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float d = Elem<T>::get(ra, v) - (has_b ? Elem<T>::get(rb, v) : t);
    const float sign = (float)((0.0f < d) - (d < 0.0f));  // torch.sign: 0 at a tie
    const float s = scale * (mode == 0 ? d : sign);
    if constexpr (sizeof(T) == 4) {
      wa[v] = Elem<T>::bits(s);
      wb[v] = Elem<T>::bits(-s);
    } else {
      wa[v >> 1] |= Elem<T>::bits(s) << (16 * (v & 1));
      wb[v >> 1] |= Elem<T>::bits(-s) << (16 * (v & 1));
    }
  }
  ga = make_uint4(wa[0], wa[1], wa[2], wa[3]);
  gb = make_uint4(wb[0], wb[1], wb[2], wb[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
loss_group_kernel_bwd(const __grid_constant__ GradGroup g, const float* __restrict__ up,
                      int64_t up_stride) {
  constexpr int V = Elem<T>::kPerChunk;
  int k = 0;
  while (k + 1 < g.count && (int)blockIdx.x >= g.term[k + 1].block0) ++k;
  const GradTerm& tm = g.term[k];
  const T* a = static_cast<const T*>(tm.a);
  const T* b = static_cast<const T*>(tm.b);
  T* da = static_cast<T*>(tm.da);
  T* db = static_cast<T*>(tm.db);
  const bool has_b = b != nullptr, vec = tm.vec != 0;
  const float gk = __ldg(up + (int64_t)tm.k * up_stride);
  const float scale = (tm.mode == 0 ? 2.0f * gk : gk) * tm.inv_n;
  const int64_t n = tm.n, nch = (n + V - 1) / V;
  const int64_t stride = (int64_t)tm.blocks * kThreads;
  int64_t j = (int64_t)(blockIdx.x - tm.block0) * kThreads + threadIdx.x;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (; j + (kUnroll - 1) * stride < nch; j += kUnroll * stride) {
    uint4 ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ra[u] = load_chunk<T>(a, j + u * stride, n, vec);
      rb[u] = has_b ? load_chunk<T>(b, j + u * stride, n, vec) : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint4 ga, gb;
      grad_chunk<T>(ra[u], rb[u], has_b, tm.t, tm.mode, scale, ga, gb);
      if (da) store_chunk<T>(da, j + u * stride, n, vec, ga);
      if (db) store_chunk<T>(db, j + u * stride, n, vec, gb);
    }
  }
  for (; j < nch; j += stride) {
    const uint4 ra = load_chunk<T>(a, j, n, vec);
    const uint4 rb = has_b ? load_chunk<T>(b, j, n, vec) : zero;
    uint4 ga, gb;
    grad_chunk<T>(ra, rb, has_b, tm.t, tm.mode, scale, ga, gb);
    if (da) store_chunk<T>(da, j, n, vec, ga);
    if (db) store_chunk<T>(db, j, n, vec, gb);
  }
}

// blocks of one term: one pass of kUnroll chunks a thread, at most
// kMaxTermBlocks (a larger term loops)
int term_blocks(int64_t n, int itemsize, int64_t max_blocks = kMaxTermBlocks) {
  const int64_t per = 16 / itemsize;
  const int64_t chunks = (n + per - 1) / per;
  int64_t blocks = (chunks + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks > max_blocks) blocks = max_blocks;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// Bytes of a workspace: the terms' counters, then their
// partials. The caller zeroes it once, when it is allocated.
extern "C" int64_t himan_loss_workspace_bytes() {
  return 256 + (int64_t)kMaxTerms * kMaxTermBlocks * 4;
}

// count terms (1..16), all fp32 or all bf16 (is_bf16); a[k], b[k] (b[k]
// null: the scalar target t[k]) contiguous, n[k] > 0 elements each; mode[k]
// 0 (squares) or 1 (absolute values). ws: himan_loss_workspace_bytes of
// the stream's workspace; out: count fp32 means.
extern "C" int himan_loss_group(const void* const* a, const void* const* b, const float* t,
                                const int64_t* n, const int* mode, int count, int is_bf16,
                                void* ws, void* out, void* stream) {
  if (count < 1 || count > kMaxTerms) return (int)cudaErrorInvalidValue;
  LossGroup g = {};
  g.count = count;
  int blocks = 0;
  for (int k = 0; k < count; ++k) {
    if (n[k] < 1) return (int)cudaErrorInvalidValue;
    LossTerm& tm = g.term[k];
    tm.a = a[k];
    tm.b = b[k];
    tm.n = n[k];
    tm.t = t[k];
    tm.mode = mode[k];
    tm.vec = (((uintptr_t)a[k] | (uintptr_t)b[k]) & 15) == 0;
    tm.blocks = term_blocks(n[k], is_bf16 ? 2 : 4);
    tm.block0 = blocks;
    blocks += tm.blocks;
  }
  unsigned* ticket = (unsigned*)ws;
  float* part = (float*)((uint8_t*)ws + 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    loss_group_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(g, part, ticket, (float*)out);
  else
    loss_group_kernel<float><<<blocks, kThreads, 0, s>>>(g, part, ticket, (float*)out);
  return (int)cudaGetLastError();
}

// The backward of a group: count terms (1..16) that take a gradient, all
// fp32 or all bf16 (is_bf16); a[k], b[k] (null: the scalar target t[k]),
// da[k] and db[k] (null: no gradient) contiguous, n[k] > 0 elements each,
// at least one of da[k], db[k] given; mode[k] as the forward's; k_up[k]
// the term's index in the fp32 upstream gradient g (stride g_stride
// elements).
extern "C" int himan_loss_group_bwd(const void* const* a, const void* const* b,
                                    void* const* da, void* const* db, const float* t,
                                    const int64_t* n, const int* mode, const int* k_up,
                                    int count, int is_bf16, const void* g, int64_t g_stride,
                                    void* stream) {
  if (count < 1 || count > kMaxTerms) return (int)cudaErrorInvalidValue;
  GradGroup grp = {};
  grp.count = count;
  int blocks = 0;
  for (int k = 0; k < count; ++k) {
    if (n[k] < 1 || (da[k] == nullptr && db[k] == nullptr) ||
        (db[k] != nullptr && b[k] == nullptr))
      return (int)cudaErrorInvalidValue;
    GradTerm& tm = grp.term[k];
    tm.a = a[k];
    tm.b = b[k];
    tm.da = da[k];
    tm.db = db[k];
    tm.n = n[k];
    tm.t = t[k];
    tm.inv_n = 1.0f / (float)n[k];
    tm.mode = mode[k];
    tm.k = k_up[k];
    tm.vec = (((uintptr_t)a[k] | (uintptr_t)b[k] | (uintptr_t)da[k] | (uintptr_t)db[k]) & 15) == 0;
    tm.blocks = term_blocks(n[k], is_bf16 ? 2 : 4, kMaxGradBlocks);
    tm.block0 = blocks;
    blocks += tm.blocks;
  }
  const float* up = (const float*)g;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    loss_group_kernel_bwd<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(grp, up, g_stride);
  else
    loss_group_kernel_bwd<float><<<blocks, kThreads, 0, s>>>(grp, up, g_stride);
  return (int)cudaGetLastError();
}
