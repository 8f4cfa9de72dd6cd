// Loss reductions to one fp32 scalar:
//   mode 0  mean((a - t)^2)   t = b[i], or the scalar t when b is null
//   mode 1  mean(|a - t|)
// the mean taken over the true element count n.
//
// Replaces the TPU kernel of ops/pallas/losses.py in the JAX package:
// mse_to_scalar / l1_to_scalar -> _reduce_call (_sq_kernel, _abs_kernel).
// The TPU kernel reads a materialized diff tensor, padded to its 256K-element
// tile, and carries one accumulator across a sequential grid. Here the two
// operands are read directly (no diff tensor is written), the ragged end is
// masked, and the sum runs in two launches:
//   launch 1  a grid-stride loop, four independent loads in flight per
//             thread, fp32 per-thread sums, a warp shuffle tree and a
//             shared-memory tree per block -> one partial per block;
//   launch 2  one block sums the partials in a fixed tree and divides by n.
// The grid depends only on n, and every sum has a fixed order, so the
// result is the same bits on every run (no atomics).
//
// Bound: bytes. Each operand element is read once and the arithmetic is 3
// operations per element pair; e.g. the relu1_1 VGG tap at 512x256 fp32,
// two operands of 8.4M elements, 67 MB, is ~20 us at 3.35 TB/s.
//
// Indices are 64-bit: any n that fits in memory is taken.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // the finish launch takes them in one block

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float term(const T* a, const T* b, float t,
                                      int64_t i, int mode) {
  const float d = to_f<T>(a[i]) - (b != nullptr ? to_f<T>(b[i]) : t);
  return mode == 0 ? d * d : fabsf(d);
}

// sum of v over the block, in a fixed order; valid in thread 0
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = threadIdx.x < nwarps ? warp_sums[threadIdx.x] : 0.0f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void reduce_partial_kernel(const T* __restrict__ a,
                                      const T* __restrict__ b, float t,
                                      int64_t n, int mode,
                                      float* __restrict__ part) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  for (; i + 3 * stride < n; i += 4 * stride) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = term<T>(a, b, t, i + j * stride, mode);
    acc += (v[0] + v[1]) + (v[2] + v[3]);
  }
  for (; i < n; i += stride) acc += term<T>(a, b, t, i, mode);
  acc = block_sum(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

__global__ void reduce_finish_kernel(const float* __restrict__ part,
                                     int nparts, float n_true,
                                     float* __restrict__ out) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) v += part[i];
  v = block_sum(v);
  if (threadIdx.x == 0) out[0] = v / n_true;
}

template <typename T>
int launch(const void* a, const void* b, float t, int64_t n, int mode,
           float* part, float* out, cudaStream_t s) {
  int64_t blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  reduce_partial_kernel<T><<<(int)blocks, kThreads, 0, s>>>(
      (const T*)a, (const T*)b, t, n, mode, part);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_finish_kernel<<<1, kMaxBlocks, 0, s>>>(part, (int)blocks, (float)n,
                                                out);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of per-block partials a launch for n elements writes (the
// wrapper sizes the workspace with it).
extern "C" int himan_loss_blocks(int64_t n) {
  int64_t blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

// a, b (nullable): contiguous, n elements each, fp32 or bf16; t: the scalar
// target when b is null. part: fp32 workspace of himan_loss_blocks(n);
// out: one fp32.
extern "C" int himan_loss_reduce(const void* a, const void* b, float t,
                                 int64_t n, int mode, void* part, void* out,
                                 int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(a, b, t, n, mode, (float*)part, (float*)out,
                                 s);
  return launch<float>(a, b, t, n, mode, (float*)part, (float*)out, s);
}
