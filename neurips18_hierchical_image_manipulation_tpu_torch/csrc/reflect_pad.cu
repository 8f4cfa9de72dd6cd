// ReflectionPad2d(p) on NHWC, forward and backward.
//
// ------------------------------------------------------------- forward
// y (N, H+2p, W+2p, C) from x (N, H, W, C): output row yo of image n copies
// source row reflect(yo - p), output column xo source pixel reflect(xo - p),
// where reflect(i) = |i| below 0 and 2(n-1) - i from n on (H, W > p, so one
// bounce; the mirrors may overlap).
//
// Replaces no TPU kernel: the JAX package pads with jnp.pad, which XLA
// fuses into its neighbours. On the card the plain version
// (kernels/reflect_pad.reflect_pad_plain) takes three passes: aten's
// reflection pad makes the channels_last view of x contiguous NCHW (a
// transposing copy), pads in NCHW, and the result is copied back to NHWC
// (a second transposing copy). This kernel is one NHWC pass.
//
// Bound: bytes. x is read once and y written once: at the flagship's
// resblock pad (32, 32, 32, 1024) bf16 that is 67.1 MB + 75.8 MB, 42.7 us at
// 3.35 TB/s; its head pad (32, 512, 512, 64) 1.07 GB + 1.10 GB, 0.65 ms.
//
// Global memory moves in 16-byte vectors on both sides. Items are output
// rows times tiles of a row (kernels/reflect_pad._fwd_plan: at most 16 KB
// of output an item, at least 264 items where the rows allow), one block of
// 256 threads an item; each thread issues its (up to) 4 loads before its
// stores. Two forms, by the pixel's byte width:
// wide (C * itemsize a multiple of 16, x 16-byte aligned: every resblock
// and head pad): an item is `tile` output pixels; each output vector copies
// the vector of its source pixel.
// narrow (the 39- and 36-channel stems, 78 / 72 bytes a pixel in bf16; also
// a misaligned x): output pixels do not start on 16-byte boundaries. Each
// item is `tile` 16-byte chunks of the flat output, those whose first byte
// lies in its row. A chunk whose bytes come from one contiguous source run
// (one output row, and one source pixel or only interior pixels) loads the
// one or two aligned 16-byte vectors that hold the run and shifts it into
// place; the chunks at the mirrors and across rows (about 1 % of a stem's)
// gather element by element. Every chunk is stored as one aligned vector
// but the flat output's last, partial one, which is written element by
// element. The aligned vector that holds a byte of x lies inside x's
// allocation (the allocators align and size allocations in multiples of
// 256 bytes), so x needs no alignment here: _fwd_plan sends a misaligned x
// to this form and the wrapper does not raise for it.
//
// Limits, checked by the wrapper: N*(H+2p)*tiles < 2^31, (W+2p)*C*itemsize
// < 2^30.
//
// ------------------------------------------------------------- backward
// Folds the cotangent of the padded tensor, dy (N, H+2p, W+2p, C), back
// onto the input, dx (N, H, W, C).
//
// Replaces the TPU kernel of ops/pallas/reflect_pad.py in the JAX package
// (reflect_pad_bwd / _bwd_kernel): a read-modify-write fold of the mirrored
// strips into a VMEM block, one padded sample per grid step.
//
// Padded row i maps to input row reflect(i - p); the rows that map onto
// input row y, in increasing order, are
//   top     i = p - y                          when 1 <= y <= p
//   core    i = y + p                          always
//   bottom  i = 2h - 2 - y + p                 when h-1-p <= y <= h-2
// and the same for columns, so a dx element sums 1 to 9 entries (9 only
// when a mirror strip overlaps both borders: h <= 2p; the TPU kernel refused
// those sizes, this one takes any h, w > p). Every sum is in fp32 in a fixed
// order, rows first, then columns, each in increasing padded index (the
// order of kernels/reflect_pad.reflect_pad_bwd_plain), rounded once.
//
// Bound: bytes. dy is read once and dx written once; at the head pad of the
// 512x256 generator (1, 262, 518, 64) fp32 that is 34.7 MB read + 33.6 MB
// written, ~20 us at 3.35 TB/s; the 18 resblock pads (1, 18, 34, 1024) are
// 4.6 MB each, 1.4 us, and launch-bound.
//
// bulk form (C * itemsize a multiple of 16; every pad of the networks): a
// persistent grid of ~132 blocks walks the work items, an item being one
// dx row's tile of `tp` pixels (kernels/reflect_pad._plan picks tp so that
// the left mirror targets, columns 1..p, fall in a row's first tile and the
// right ones, W-1-p..W-2, in its last). In NHWC everything an item needs of
// one source row is one contiguous segment of dy: the tile's core pixels,
// extended to the row's edge on the first and last tiles. One thread moves
// the 1-3 segments into shared memory with 1-D TMA bulk copies
// (cp.async.bulk, completion on the stage's mbarrier; no tensor map, so no
// host-side encode per call) into a ring of 3 stages, so that one item's
// fold overlaps the next items' loads. The block folds the rows, then the
// columns, from shared memory into the stage's output tile, and the thread
// writes it back with a cp.async.bulk store; an interior tile of a row with
// one source is stored straight from its loaded segment. Pixels and vectors
// are walked by a thread layout fixed once per block: no per-element
// division.
// gather form (C * itemsize not a multiple of 16, where bulk copies cannot
// be aligned): one thread per dx element sums the dy entries that map onto
// it, coalesced across the channels of a pixel.
//
// Limits, checked by the wrapper: N*H < 2^31, (W+2p)*C < 2^31.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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

// the padded indices (at most 3) whose reflection is input index y of n,
// in increasing order
__device__ __forceinline__ int sources(int y, int n, int p, int* idx) {
  int k = 0;
  if (y >= 1 && y <= p) idx[k++] = p - y;
  idx[k++] = y + p;
  if (y >= n - 1 - p && y <= n - 2) idx[k++] = 2 * n - 2 - y + p;
  return k;
}

// gather form: one thread per dx element; grid.x = one block row per (n,
// y) output row, grid.y = tiles of the row's W*C elements; consecutive
// threads take consecutive channels of a pixel. The row is decoded once per
// block, the column by one 32-bit division per element.
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
    for (int b = 0; b < nc; ++b) {
      float r = 0.0f;
      for (int a = 0; a < nr; ++a) r += to_f<T>(src[((int64_t)rows[a] * Wp + cols[b]) * C + c]);
      acc += r;
    }
    dst[i] = from_f<T>(acc);
  }
}

// ---------------------------------------------------------------- bulk form

constexpr int kStages = 3;      // the ring's stages (kernels/reflect_pad._STAGES)
constexpr int kSmem = 204800;   // a block's shared memory, at most (_SMEM)
constexpr int kBars = 128;      // the stages' mbarriers, before the stages (_BARS)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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
// (a copy that never lands) traps, so a fault fails the launch instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(a, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device to shared memory; completes on `bar` as transaction bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 1-D bulk copy from shared to device memory, one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               "cp.async.bulk.commit_group;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[16 / sizeof(T)]);
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

// One work item: dx row (n, y), pixels [x0, x1); its source rows in
// increasing order; the padded columns [lo, hi) of each source row it needs
// (one contiguous segment of dy).
struct Item {
  int n, y, x0, x1, lo, hi, nr;
  int rows[3];
};

__device__ __forceinline__ Item decode(int it, int H, int W, int p, int tp, int tiles) {
  Item t;
  const int row = it / tiles, k = it - row * tiles;
  t.n = row / H;
  t.y = row - t.n * H;
  t.x0 = k * tp;
  t.x1 = min(t.x0 + tp, W);
  t.lo = t.x0 == 0 ? 0 : t.x0 + p;
  t.hi = t.x1 == W ? W + 2 * p : t.x1 + p;
  t.nr = sources(t.y, H, p, t.rows);
  return t;
}

// Persistent: block b takes items b, b + gridDim.x, ... Thread 0 keeps the
// loads of the next kStages - 1 items in flight and stores each finished
// tile; all 256 threads fold.
template <typename T>
__global__ void __launch_bounds__(256)
reflect_pad_bwd_bulk_kernel(const T* __restrict__ dy, T* __restrict__ dx, int H, int W, int C,
                            int p, int tp, int tiles, int items) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  T* const stage0 = reinterpret_cast<T*>(smem + kBars);
  const int Wp = W + 2 * p, Hp = H + 2 * p, tid = threadIdx.x;
  const int cap = (tp + 2 * p) * C;            // one source segment's room
  const int stage = 3 * cap + tp * C;          // three segments, then the output tile
  const int mine = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // the fold's thread layout, fixed for the block: CV vectors a pixel,
  // `par` pixels at once
  const int CV = C / VEC;
  const int par = CV >= 256 ? 1 : 256 / CV;
  const int tx = CV >= 256 ? 0 : tid / CV, tc = tid - tx * CV;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_item = [&](int k) {  // thread 0: item k's loads into stage k % kStages
    const Item t = decode(blockIdx.x + k * gridDim.x, H, W, p, tp, tiles);
    const int st = k % kStages;
    const uint32_t bytes = (uint32_t)((t.hi - t.lo) * C * (int)sizeof(T));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(&full[st])), "r"(bytes * t.nr) : "memory");
    for (int a = 0; a < t.nr; ++a)
      bulk_load(stage0 + st * stage + a * cap,
                dy + (((int64_t)t.n * Hp + t.rows[a]) * Wp + t.lo) * C, bytes, &full[st]);
  };
  if (tid == 0)
    for (int k = 0; k < kStages - 1 && k < mine; ++k) load_item(k);
  for (int k = 0; k < mine; ++k) {
    const int st = k % kStages;
    if (tid == 0) {
      // item k + kStages - 1 loads into the stage of item k - 1, whose
      // store may be reading it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      if (k + kStages - 1 < mine) load_item(k + kStages - 1);
    }
    mbar_wait(&full[st], (k / kStages) & 1);
    const Item t = decode(blockIdx.x + k * gridDim.x, H, W, p, tp, tiles);
    const T* in = stage0 + st * stage;
    const T* out = in;  // an interior tile with one source row is its segment
    if (t.nr > 1 || t.x0 == 0 || t.x1 == W) {
      T* o = stage0 + st * stage + 3 * cap;
      for (int xl = tx; tx < par && xl < t.x1 - t.x0; xl += par) {
        const int x = t.x0 + xl;
        int js[3], nj = 0;  // its padded columns, in increasing order, in the segment
        if (x >= 1 && x <= p) js[nj++] = p - x - t.lo;
        js[nj++] = x + p - t.lo;
        if (x >= W - 1 - p && x <= W - 2) js[nj++] = 2 * W - 2 - x + p - t.lo;
        for (int cv = tc; cv < CV; cv += 256) {
          float acc[VEC], v[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
          for (int b = 0; b < nj; ++b) {
            float r[VEC];
#pragma unroll
            for (int j = 0; j < VEC; ++j) r[j] = 0.0f;
            for (int a = 0; a < t.nr; ++a) {
              unpack<T>(*reinterpret_cast<const uint4*>(in + a * cap + js[b] * C + cv * VEC), v);
#pragma unroll
              for (int j = 0; j < VEC; ++j) r[j] += v[j];
            }
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] += r[j];
          }
          __align__(16) T packed[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) packed[j] = from_f<T>(acc[j]);
          *reinterpret_cast<uint4*>(o + xl * C + cv * VEC) = *reinterpret_cast<const uint4*>(packed);
        }
      }
      // the tile's generic-proxy writes, before the bulk store reads them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      out = o;
    }
    __syncthreads();
    if (tid == 0)
      bulk_store(dx + (((int64_t)t.n * H + t.y) * W + t.x0) * C, out,
                 (uint32_t)((t.x1 - t.x0) * C * (int)sizeof(T)));
  }
  // the shared memory stays until the last store has read it
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <typename T>
int launch_bulk(const void* dy, void* dx, int N, int H, int W, int C, int p, int tp, int blocks,
                cudaStream_t s) {
  auto kern = reflect_pad_bwd_bulk_kernel<T>;
  static int attr = -1;  // once per dtype: the largest ring
  if (attr < 0)
    attr = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr) return attr;
  const int tiles = (W + tp - 1) / tp;
  const int smem = kBars + kStages * (4 * tp + 6 * p) * C * (int)sizeof(T);
  kern<<<blocks, 256, smem, s>>>((const T*)dy, (T*)dx, H, W, C, p, tp, tiles, N * H * tiles);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ forward form

// the source index of padded index i - p of an axis of n (one bounce)
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

constexpr int kFwdThreads = 256;
constexpr int kFwdUnroll = 4;   // vectors a thread has in flight (kernels/reflect_pad._FWD_ITEM)

// wide form: block = one item, output row `row` = blockIdx.x / tiles, its
// pixels [x0, x0 + tile); CV 16-byte vectors a pixel
__global__ void __launch_bounds__(kFwdThreads)
reflect_pad_fwd_wide_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int H, int W,
                            int CV, int p, int tile, int tiles) {
  const int row = blockIdx.x / tiles, k = blockIdx.x - row * tiles;
  const int Hp = H + 2 * p, Wp = W + 2 * p;
  const int n = row / Hp, ys = reflect(row - n * Hp - p, H);
  const int x0 = k * tile, nv = min(tile, Wp - x0) * CV;
  const uint4* src = x + ((int64_t)n * H + ys) * W * CV;
  uint4* dst = y + ((int64_t)row * Wp + x0) * CV;
  for (int base = threadIdx.x; base < nv; base += kFwdThreads * kFwdUnroll) {
    uint4 v[kFwdUnroll];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      const int i = base + u * kFwdThreads;
      if (i < nv) {
        const int j = i / CV;
        v[u] = __ldg(src + reflect(x0 + j - p, W) * CV + (i - j * CV));
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      const int i = base + u * kFwdThreads;
      if (i < nv) dst[i] = v[u];
    }
  }
}

// 16 bytes of x from byte address a: the one or two aligned vectors that
// hold them, shifted into place
__device__ __forceinline__ uint4 load16(const unsigned char* a) {
  const uintptr_t u = (uintptr_t)a;
  const uint4* v = reinterpret_cast<const uint4*>(u & ~(uintptr_t)15);
  const int s = (int)(u & 15);
  const uint4 v0 = __ldg(v);
  if (s == 0) return v0;
  const uint4 v1 = __ldg(v + 1);
  const uint64_t q0 = v0.x | (uint64_t)v0.y << 32, q1 = v0.z | (uint64_t)v0.w << 32;
  const uint64_t q2 = v1.x | (uint64_t)v1.y << 32, q3 = v1.z | (uint64_t)v1.w << 32;
  const bool hi = s >= 8;
  const uint64_t a0 = hi ? q1 : q0, a1 = hi ? q2 : q1, a2 = hi ? q3 : q2;
  const int sh = (s & 7) * 8;
  const uint64_t r0 = sh ? (a0 >> sh) | (a1 << (64 - sh)) : a0;
  const uint64_t r1 = sh ? (a1 >> sh) | (a2 << (64 - sh)) : a1;
  return make_uint4((uint32_t)r0, (uint32_t)(r0 >> 32), (uint32_t)r1, (uint32_t)(r1 >> 32));
}

// narrow form: block = one item, output row `row` = blockIdx.x / tiles and
// `tile` of the 16-byte chunks of the flat output whose first byte lies in
// that row; px bytes a pixel, RB = (W+2p) px bytes an output row, E
// elements of ES bytes a chunk
template <int ES>
__global__ void __launch_bounds__(kFwdThreads)
reflect_pad_fwd_narrow_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ y,
                              int H, int W, int px, int p, int tile, int tiles, int rows) {
  using E_t = typename std::conditional<ES == 2, uint16_t, uint32_t>::type;
  constexpr int E = 16 / ES;
  const int row = blockIdx.x / tiles, k = blockIdx.x - row * tiles;
  const int Hp = H + 2 * p, Wp = W + 2 * p, RB = Wp * px;
  const int n = row / Hp, ys = reflect(row - n * Hp - p, H);
  const unsigned char* src = x + ((int64_t)n * H + ys) * W * px;
  const int64_t rb0 = (int64_t)row * RB;
  const int64_t total = (int64_t)rows * RB;
  const int64_t qa = (rb0 + 15) >> 4, qb = (rb0 + RB + 15) >> 4;
  const int64_t q0 = qa + (int64_t)k * tile;
  const int nq = q0 >= qb ? 0 : (int)(qb - q0 < tile ? qb - q0 : tile);   // chunks of the item
  for (int base = threadIdx.x; base < nq; base += kFwdThreads * kFwdUnroll) {
    uint4 v[kFwdUnroll];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      const int i = base + u * kFwdThreads;
      if (i >= nq) continue;
      const int o = (int)(((q0 + i) << 4) - rb0);   // the chunk's first byte in the row
      const int j = o / px, j1 = (o + 15) / px;
      if (o + 16 <= RB && (j == j1 || (j >= p && j1 < W + p))) {
        v[u] = load16(src + (int64_t)reflect(j - p, W) * px + (o - j * px));
      } else {   // at a mirror or across rows: element by element
        union { uint4 u4; E_t e[E]; } c;
        c.u4 = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          int r = row, oe = o + e * ES;
          while (oe >= RB) oe -= RB, ++r;
          if (r >= rows) break;
          const int ne = r / Hp, ye = reflect(r - ne * Hp - p, H), je = oe / px;
          c.e[e] = *reinterpret_cast<const E_t*>(
              x + (((int64_t)ne * H + ye) * W + reflect(je - p, W)) * px + (oe - je * px));
        }
        v[u] = c.u4;
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      const int i = base + u * kFwdThreads;
      if (i >= nq) continue;
      const int64_t b = (q0 + i) << 4;
      if (b + 16 <= total) {
        *reinterpret_cast<uint4*>(y + b) = v[u];
      } else {   // the flat output's last, partial chunk
        union { uint4 u4; E_t e[E]; } c;
        c.u4 = v[u];
        for (int e = 0; e < E && b + e * ES < total; ++e)
          *reinterpret_cast<E_t*>(y + b + e * ES) = c.e[e];
      }
    }
  }
}

}  // namespace

// dy: (N, H+2p, W+2p, C), dx: (N, H, W, C), both contiguous NHWC in fp32
// or bf16; H, W > p. tile > 0: the bulk form with tiles of `tile` pixels on
// `blocks` blocks (kernels/reflect_pad._plan; C * itemsize a multiple of
// 16, dy and dx 16-byte aligned); tile 0: the gather form.
extern "C" int himan_reflect_pad_bwd(const void* dy, void* dx, int N, int H,
                                     int W, int C, int p, int tile, int blocks,
                                     int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tile > 0)
    return is_bf16 ? launch_bulk<__nv_bfloat16>(dy, dx, N, H, W, C, p, tile, blocks, s)
                   : launch_bulk<float>(dy, dx, N, H, W, C, p, tile, blocks, s);
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

// x: (N, H, W, C), y: (N, H+2p, W+2p, C), both contiguous NHWC in fp32 or
// bf16; H, W > p; y 16-byte aligned. wide 1: the wide form (C * itemsize a
// multiple of 16, x 16-byte aligned), `tile` pixels an item; wide 0: the
// narrow form, `tile` 16-byte chunks an item; `tiles` items an output row
// (kernels/reflect_pad._fwd_plan).
extern "C" int himan_reflect_pad_fwd(const void* x, void* y, int N, int H, int W, int C, int p,
                                     int wide, int tile, int tiles, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int es = is_bf16 ? 2 : 4, rows = N * (H + 2 * p);
  const int grid = rows * tiles;
  if (wide)
    reflect_pad_fwd_wide_kernel<<<grid, kFwdThreads, 0, s>>>(
        (const uint4*)x, (uint4*)y, H, W, C * es / 16, p, tile, tiles);
  else if (is_bf16)
    reflect_pad_fwd_narrow_kernel<2><<<grid, kFwdThreads, 0, s>>>(
        (const unsigned char*)x, (unsigned char*)y, H, W, C * es, p, tile, tiles, rows);
  else
    reflect_pad_fwd_narrow_kernel<4><<<grid, kFwdThreads, 0, s>>>(
        (const unsigned char*)x, (unsigned char*)y, H, W, C * es, p, tile, tiles, rows);
  return (int)cudaGetLastError();
}
