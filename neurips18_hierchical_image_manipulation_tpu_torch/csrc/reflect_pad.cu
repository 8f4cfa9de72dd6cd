// Backward of ReflectionPad2d(p) on NHWC: folds the cotangent of the padded
// tensor, dy (N, H+2p, W+2p, C), back onto the input, dx (N, H, W, C).
//
// Replaces the TPU kernel of ops/pallas/reflect_pad.py in the JAX package
// (reflect_pad_bwd / _bwd_kernel): a read-modify-write fold of the mirrored
// strips into a VMEM block, one padded sample per grid step.
//
// Here it is a GATHER: one thread per dx element sums the dy entries that
// map onto it. Padded row i maps to input row reflect(i - p); the rows that
// map onto input row y are
//   core    i = y + p                          always
//   top     i = p - y                          when 1 <= y <= p
//   bottom  i = 2h - 2 - y + p                 when h-1-p <= y <= h-2
// and the same for columns, so a dx element sums 1 to 9 entries (9 only
// when a mirror strip overlaps both borders: h <= 2p; the TPU kernel refused
// those sizes, this one takes any h, w > p). Each thread writes its own
// element: no atomics, and the sum order is fixed (rows, then columns).
//
// Bound: bytes. dy is read once and dx written once (the border strips are
// a few rows of a tensor hundreds of rows tall, and their second read hits
// the cache); at the head pad of the 512x256 generator (1, 262, 518, 64)
// fp32 that is 34.7 MB read + 33.6 MB written, ~20 us at 3.35 TB/s.
// Design: grid.x = one block row per (n, y) output row, grid.y = tiles of
// the row's W*C elements; consecutive threads take consecutive channels of
// a pixel, so every load and store of a warp is coalesced. A row index is
// decoded once per block, the column by one 32-bit division per element.
//
// Limits, checked by the wrapper: N*H < 2^31, (W+2p)*C < 2^31.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// the padded indices (at most 3) whose reflection is input index y of n
__device__ __forceinline__ int sources(int y, int n, int p, int* idx) {
  int k = 0;
  idx[k++] = y + p;
  if (y >= 1 && y <= p) idx[k++] = p - y;
  if (y >= n - 1 - p && y <= n - 2) idx[k++] = 2 * n - 2 - y + p;
  return k;
}

template <typename T>
__global__ void reflect_pad_bwd_kernel(const T* __restrict__ dy,
                                       T* __restrict__ dx, int H, int W,
                                       int C, int p) {
  const int row = blockIdx.x;  // n * H + y
  const int n = row / H, y = row - n * H;
  const int Wp = W + 2 * p, Hp = H + 2 * p;
  int rows[3];
  const int nr = sources(y, H, p, rows);
  const T* src = dy + (int64_t)n * Hp * Wp * C;
  T* dst = dx + (int64_t)row * W * C;
  const int wc = W * C;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < wc;
       i += gridDim.y * blockDim.x) {
    const int x = i / C, c = i - x * C;
    int cols[3];
    const int nc = sources(x, W, p, cols);
    float acc = 0.0f;
    for (int a = 0; a < nr; ++a) {
      const T* r = src + (int64_t)rows[a] * Wp * C + c;
      for (int b = 0; b < nc; ++b) acc += to_f<T>(r[cols[b] * C]);
    }
    dst[i] = from_f<T>(acc);
  }
}

}  // namespace

// dy: (N, H+2p, W+2p, C), dx: (N, H, W, C), both contiguous NHWC in fp32
// or bf16; H, W > p.
extern "C" int himan_reflect_pad_bwd(const void* dy, void* dx, int N, int H,
                                     int W, int C, int p, int is_bf16,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int wc = W * C;
  int tiles = (wc + 255) / 256;
  // enough blocks in all to fill the card a few times, at least one a row
  const int per_row = (132 * 16 + N * H - 1) / (N * H);
  if (tiles > per_row) tiles = per_row;
  if (tiles > 65535) tiles = 65535;
  const dim3 grid(N * H, tiles);
  if (is_bf16)
    reflect_pad_bwd_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        (const __nv_bfloat16*)dy, (__nv_bfloat16*)dx, H, W, C, p);
  else
    reflect_pad_bwd_kernel<float><<<grid, 256, 0, s>>>(
        (const float*)dy, (float*)dx, H, W, C, p);
  return (int)cudaGetLastError();
}
