// Generator-input build: one-hot label ⊕ instance-edge plane ⊕ box-masked
// RGB, optionally reflect-padded, written NHWC in one pass.
//
// Replaces the TPU kernels of ops/pallas/encode.py in the JAX package:
//   * encode_full   (_expand_rgb_kernel)    -> pad 0, n_rgb 3
//   * encode_packed (_expand_packed_kernel) -> pad 3, n_rgb 3, emitted
//     UNPACKED: the port's stem conv reads the padded NHWC tensor as is,
//     so the TPU's space-to-depth packing has no counterpart here
//   * encode_cond   (_expand_kernel)        -> pad 0, n_rgb 0
//
// out[b, y, x, c] with (sy, sx) = (reflect(y - pad), reflect(x - pad)):
//   c <  nc             label[b, sy, sx] == c          (ids outside [0, nc)
//                                                       give an all-zero row)
//   c == nc  (has_edge) edge(b, sy, sx): inst differs from any 4-neighbour,
//                       borders zero-extended (pix2pixHD get_edges). In pad
//                       mode this is the reflect OF THE EDGE PLANE.
//   above               image[b, sy, sx, k] * (1 - m) + 0 * m, m = inside-box
//                       test in fp32 exactly as boxcomposite._box_mask_one;
//                       bit-identical to the JAX mask_box, -0.0 included.
//
// Bound: bytes. Nothing is reused across outputs except the few ids a pixel
// shares with its neighbours; at 512x256 bs 1 fp32 the pad-3 output is
// 262*518*39*4 B = 21.2 MB written against ~2.5 MB read, i.e. ~7 us at
// 3.35 TB/s. The output is C times wider than the per-pixel inputs, so
// the kernel must keep many stores in flight without waiting on loads.
// Design: a block takes kPix consecutive output pixels of one row
// (grid.x = row b*Hp + y, grid.y = pixel tile). Phase 1: one thread per
// pixel loads its id, edge and masked RGB into shared memory (all loads
// of the block in flight at once). Phase 2: the block writes the tile's
// kPix * C outputs, consecutive threads at consecutive addresses (fully
// coalesced), each thread a run of stores with no global load between
// them. (One output element per thread, each with its own load, is
// latency-bound: every store waits on a load, and bf16 takes as long as
// fp32.)

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int reflect_index(int i, int n) {
  // torch ReflectionPad2d / jnp.pad(mode="reflect"): no edge repeat; pad < n
  if (i < 0) return -i;
  if (i >= n) return 2 * n - 2 - i;
  return i;
}

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T store_f(float v);
template <>
__device__ __forceinline__ float store_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: every value written is a bf16 value
}

constexpr int kPix = 128;      // output pixels per block
constexpr int kThreads = 256;  // threads per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const int32_t* __restrict__ label,
                  const int32_t* __restrict__ inst, const T* __restrict__ image,
                  const float* __restrict__ boxes, T* __restrict__ out, int H,
                  int W, int nc, int has_edge, int n_rgb, int pad) {
  __shared__ int32_t s_id[kPix];
  __shared__ float s_extra[kPix][4];  // [edge] then the masked RGB
  const int C = nc + has_edge + n_rgb;
  const int Hp = H + 2 * pad, Wp = W + 2 * pad;
  const int row = blockIdx.x;  // b * Hp + y
  const int b = row / Hp, y = row - b * Hp;
  const int x0 = blockIdx.y * kPix;
  const int npix = min(kPix, Wp - x0);
  const int p = threadIdx.x;
  if (p < npix) {
    const int sy = reflect_index(y - pad, H);
    const int sx = reflect_index(x0 + p - pad, W);
    const int64_t src = ((int64_t)b * H + sy) * W + sx;
    s_id[p] = label[src];
    if (has_edge) {
      const int32_t id = inst[src];
      const bool e = (sx > 0 && inst[src - 1] != id) ||
                     (sx < W - 1 && inst[src + 1] != id) ||
                     (sy > 0 && inst[src - W] != id) ||
                     (sy < H - 1 && inst[src + W] != id);
      s_extra[p][0] = e ? 1.0f : 0.0f;
    }
    if (n_rgb) {
      const float* bx = boxes + 4 * b;
      const float by0 = bx[0], bx0 = bx[1], bh = bx[2], bw = bx[3];
      const float fy = (float)sy, fx = (float)sx;
      const bool inside = (fy >= by0) && (fy < by0 + bh) && (fx >= bx0) &&
                          (fx < bx0 + bw);
      const float m = inside ? 1.0f : 0.0f;
      for (int k = 0; k < 3; ++k) {
        const float v = load_f<T>(image + src * 3 + k);
        s_extra[p][has_edge + k] = v * (1.0f - m) + 0.0f * m;
      }
    }
  }
  __syncthreads();
  T* o = out + ((int64_t)row * Wp + x0) * C;
  const int n = npix * C;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int q = e / C, c = e - q * C;
    const float v = c < nc ? (s_id[q] == c ? 1.0f : 0.0f) : s_extra[q][c - nc];
    o[e] = store_f<T>(v);
  }
}

}  // namespace

// The wrapper guarantees B * Hp < 2^31 (grid.x), Wp <= 65535 * kPix
// (grid.y) and has_edge + n_rgb <= 4, and launches nothing for an empty
// output.
extern "C" int himan_encode(const void* label, const void* inst,
                            const void* image, const void* boxes, void* out,
                            int B, int H, int W, int nc, int has_edge,
                            int n_rgb, int pad, int is_bf16, void* stream) {
  const dim3 grid((unsigned)B * (H + 2 * pad),
                  (unsigned)((W + 2 * pad + kPix - 1) / kPix));
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* lab = (const int32_t*)label;
  const int32_t* ins = (const int32_t*)inst;
  const float* bxs = (const float*)boxes;
  if (is_bf16) {
    encode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        lab, ins, (const __nv_bfloat16*)image, bxs, (__nv_bfloat16*)out, H, W,
        nc, has_edge, n_rgb, pad);
  } else {
    encode_kernel<float><<<grid, kThreads, 0, s>>>(
        lab, ins, (const float*)image, bxs, (float*)out, H, W, nc, has_edge,
        n_rgb, pad);
  }
  return (int)cudaGetLastError();
}
