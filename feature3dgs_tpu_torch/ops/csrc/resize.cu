// The feature loss's align_corners bilinear resize, read from and written
// back to the rasterizer's tile layout, for NVIDIA Hopper (sm_90a), plain C
// interface: one forward kernel and its backward.
//
// Replaces no TPU kernel: the JAX package folds the tile permutation into
// its interpolation operators (feature3dgs_tpu/train/losses.py:
// resize_bilinear_from_tiles, _stride_resize_from_tiles) and leaves them to
// XLA. In PyTorch the step assembled the [H, W, F] image from the [T, P, F]
// tiles (ops/rasterize.py:tiles_to_image, a full copy), ran F.interpolate on
// a permuted view of it (one thread an output pixel walking the channels,
// neighbouring lanes 2F floats apart) and, backward, upsample_bilinear2d's
// atomic scatter into a zero-filled image gradient, copied back into tile
// layout for the compositing backward. The wrapper is ops/cuda_resize.py;
// the plain version it is held to is train/losses.py's tiles_to_image +
// F.interpolate path.
//
// Same taps as F.interpolate(mode="bilinear", align_corners=True) in
// float32 (ATen's upsample_bilinear2d): scale = float(in - 1) / (out - 1)
// (0 for out == 1), taken on the host as ATen takes it; src = scale * dst;
// lo = (int)src, lambda = src - lo, hi = lo + (lo < in - 1). The coordinate
// arithmetic is written with __fmul_rn / __fsub_rn (ATen's product has a
// second use, so nvcc contracts nothing there either); the blend
// h0 * (w0 * v00 + w1 * v01) + h1 * (w0 * v10 + w1 * v11) is written as
// ATen writes it, so nvcc's default contraction treats both alike. The
// backward sums the same terms as ATen's four atomics an output pixel,
// (h * w) * g, but gathers them a source pixel at a time in a fixed order
// (output rows ascending, the lo term before the hi term, then output
// columns likewise): no atomics, no zero fill, the same bits every run.
//
// What bounds it on the card: bytes. The forward reads each source pixel a
// tap touches once and writes the output once: at 1216 x 800 -> 608 x 400
// that is every source pixel (scale ~2), 1.99 GB + 0.50 GB at F = 512 and
// 0.50 + 0.12 GB at F = 128, 0.74 / 0.19 ms at 3.35 TB/s. The backward
// moves the same bytes the other way (the output gradient read, each
// element about four times, mostly from L2; the tile gradient written once,
// every element). The arithmetic is a few flops a float. On an H100 (700 W)
// at that shape: forward 0.20 / 0.81 ms (F = 128 / 512), backward 0.26 /
// 0.98 ms, against 0.19 / 0.74 ms each way; there the forward and the
// backward are both bit-equal to ATen's. Design:
//   * channels go across the threads of a pixel, 16 bytes a thread
//     (float4) when F % 4 == 0 and both arrays are 16-byte aligned, else 4;
//     a thread loops over its share of the channels;
//   * the forward gives a pixel a group of threads (a power of two up to
//     32: a warp a pixel at F >= 128). Its pixels are output pixels in
//     row-major order; each reads its four taps straight from the tile
//     layout (tile = (y / tile_h) * grid_x + x / tile_w, pixel (y % tile_h)
//     * tile_w + x % tile_w), so the image is never assembled and no
//     permuted view is read;
//   * the backward's pixels are the padded grid's pixels in tile-layout
//     order, so its stores are contiguous. A pixel's output rows are those
//     whose taps touch its row, found from the same float32 formula (lo is
//     monotone in dst: the first row with lo >= y - 1 up to the first with
//     lo >= y + 1, from an estimate corrected by exact tests), and its
//     columns likewise. That search and the pixel's place in the grid (five
//     integer divisions) would cost more instructions than the pixel's
//     bytes take to move if every warp made it for its own pixel, so a warp
//     takes 32 pixels: lane i makes pixel i's search, and the warp then
//     sums the pixels in turn from shuffled ranges, its lanes across the
//     channels. Pixels outside the crop get empty ranges and are written 0.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

struct Geometry {
  int in_h, in_w;     // the crop
  int out_h, out_w;
  int grid_x, tile_w, tile_h;
  float scale_h, scale_w;
  float inv_scale_h, inv_scale_w;  // 1 / scale (0 for a scale of 0)
  int lanes_log2;     // the forward's threads a pixel: 1 << lanes_log2
  int nvec;           // vectors a pixel: F / 4 or F
};

struct Tap {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ int lo_of(int dst, float scale) {
  return static_cast<int>(__fmul_rn(scale, static_cast<float>(dst)));
}

__device__ __forceinline__ Tap tap(int dst, float scale, int n_in) {
  const float src = __fmul_rn(scale, static_cast<float>(dst));
  const int lo = static_cast<int>(src);
  const float l1 = __fsub_rn(src, static_cast<float>(lo));
  return Tap{lo, lo + (lo < n_in - 1 ? 1 : 0), __fsub_rn(1.0f, l1), l1};
}

// The first dst in [0, n_out] with lo_of(dst) >= t (n_out if none), from
// the estimate t / scale (t * inv_scale) corrected by exact tests.
__device__ __forceinline__ int first_at_least(int t, float scale,
                                              float inv_scale, int n_out) {
  if (t <= 0) return 0;
  if (!(scale > 0.0f)) return n_out;  // one output, or one input: lo = 0
  const float est = ceilf(static_cast<float>(t) * inv_scale);
  int e = est < static_cast<float>(n_out) ? static_cast<int>(est) : n_out;
  while (e > 0 && lo_of(e - 1, scale) >= t) --e;
  while (e < n_out && lo_of(e, scale) < t) ++e;
  return e;
}

// The source pixel (y, x) of the crop: its offset in pixels in the tile
// layout [T, P, F].
__device__ __forceinline__ long long tile_pixel(int y, int x,
                                                const Geometry& g) {
  const int tile = (y / g.tile_h) * g.grid_x + x / g.tile_w;
  const int p = (y % g.tile_h) * g.tile_w + x % g.tile_w;
  return static_cast<long long>(tile) * (g.tile_w * g.tile_h) + p;
}

__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, float h0, float h1,
                                       float w0, float w1) {
  return h0 * (w0 * v00 + w1 * v01) + h1 * (w0 * v10 + w1 * v11);
}

__device__ __forceinline__ float4 blend(float4 v00, float4 v01, float4 v10,
                                        float4 v11, float h0, float h1,
                                        float w0, float w1) {
  return make_float4(blend(v00.x, v01.x, v10.x, v11.x, h0, h1, w0, w1),
                     blend(v00.y, v01.y, v10.y, v11.y, h0, h1, w0, w1),
                     blend(v00.z, v01.z, v10.z, v11.z, h0, h1, w0, w1),
                     blend(v00.w, v01.w, v10.w, v11.w, h0, h1, w0, w1));
}

__device__ __forceinline__ float zero_of(float) { return 0.0f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// acc + (w * g), the product rounded, then the sum (ATen's atomic term)
__device__ __forceinline__ float add_term(float acc, float w, float g) {
  return __fadd_rn(acc, __fmul_rn(w, g));
}

__device__ __forceinline__ float4 add_term(float4 acc, float w, float4 g) {
  return make_float4(add_term(acc.x, w, g.x), add_term(acc.y, w, g.y),
                     add_term(acc.z, w, g.z), add_term(acc.w, w, g.w));
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
    resize_forward_kernel(const V* __restrict__ tiles, V* __restrict__ out,
                          const Geometry g) {
  const int lanes = 1 << g.lanes_log2;
  const long long pix =
      static_cast<long long>(blockIdx.x) * (THREADS >> g.lanes_log2) +
      (threadIdx.x >> g.lanes_log2);
  if (pix >= static_cast<long long>(g.out_h) * g.out_w) return;
  const int oy = static_cast<int>(pix / g.out_w);
  const int ox = static_cast<int>(pix - static_cast<long long>(oy) * g.out_w);
  const Tap ty = tap(oy, g.scale_h, g.in_h);
  const Tap tx = tap(ox, g.scale_w, g.in_w);
  const V* p00 = tiles + tile_pixel(ty.lo, tx.lo, g) * g.nvec;
  const V* p01 = tiles + tile_pixel(ty.lo, tx.hi, g) * g.nvec;
  const V* p10 = tiles + tile_pixel(ty.hi, tx.lo, g) * g.nvec;
  const V* p11 = tiles + tile_pixel(ty.hi, tx.hi, g) * g.nvec;
  V* o = out + pix * g.nvec;
#pragma unroll 4
  for (int v = threadIdx.x & (lanes - 1); v < g.nvec; v += lanes) {
    o[v] = blend(p00[v], p01[v], p10[v], p11[v], ty.w_lo, ty.w_hi, tx.w_lo,
                 tx.w_hi);
  }
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
    resize_backward_kernel(const V* __restrict__ g_out,
                           V* __restrict__ g_tiles, const Geometry g,
                           long long n_pixels) {
  // a warp takes 32 pixels: lane i finds pixel i's output rows and columns,
  // then the warp sums each pixel in turn, its lanes across the channels
  const int lane = threadIdx.x & 31;
  const long long base =
      (static_cast<long long>(blockIdx.x) * (THREADS / 32) +
       (threadIdx.x >> 5)) * 32;
  if (base >= n_pixels) return;
  int y = 0, x = 0, r0 = 0, r1 = 0, c0 = 0, c1 = 0;  // empty: written 0
  if (base + lane < n_pixels) {
    const int ppt = g.tile_w * g.tile_h;
    const int tile = static_cast<int>((base + lane) / ppt);
    const int p = static_cast<int>(base + lane - static_cast<long long>(tile) *
                                                     ppt);
    y = (tile / g.grid_x) * g.tile_h + p / g.tile_w;
    x = (tile % g.grid_x) * g.tile_w + p % g.tile_w;
    if (y < g.in_h && x < g.in_w) {
      // output rows / columns whose lo or hi tap is this row / column
      r0 = first_at_least(y - 1, g.scale_h, g.inv_scale_h, g.out_h);
      r1 = first_at_least(y + 1, g.scale_h, g.inv_scale_h, g.out_h);
      c0 = first_at_least(x - 1, g.scale_w, g.inv_scale_w, g.out_w);
      c1 = first_at_least(x + 1, g.scale_w, g.inv_scale_w, g.out_w);
    }
  }
  const int count = static_cast<int>(min(32LL, n_pixels - base));
  for (int j = 0; j < count; ++j) {
    const int py = __shfl_sync(0xffffffffu, y, j);
    const int px = __shfl_sync(0xffffffffu, x, j);
    const int pr0 = __shfl_sync(0xffffffffu, r0, j);
    const int pr1 = __shfl_sync(0xffffffffu, r1, j);
    const int pc0 = __shfl_sync(0xffffffffu, c0, j);
    const int pc1 = __shfl_sync(0xffffffffu, c1, j);
    V* o = g_tiles + (base + j) * g.nvec;
    for (int v = lane; v < g.nvec; v += 32) {
      V acc = zero_of(V{});
      for (int oy = pr0; oy < pr1; ++oy) {
        const Tap ty = tap(oy, g.scale_h, g.in_h);
        const V* row = g_out + static_cast<long long>(oy) * g.out_w * g.nvec;
        for (int k = 0; k < 2; ++k) {
          if ((k ? ty.hi : ty.lo) != py) continue;
          const float hw = k ? ty.w_hi : ty.w_lo;
          for (int ox = pc0; ox < pc1; ++ox) {
            const Tap tx = tap(ox, g.scale_w, g.in_w);
            const V gv = row[static_cast<long long>(ox) * g.nvec + v];
            if (tx.lo == px) acc = add_term(acc, __fmul_rn(hw, tx.w_lo), gv);
            if (tx.hi == px) acc = add_term(acc, __fmul_rn(hw, tx.w_hi), gv);
          }
        }
      }
      o[v] = acc;
    }
  }
}

int lanes_log2_for(int nvec) {
  int l = 0;
  while (l < 5 && (1 << l) < nvec) ++l;
  return l;
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// ATen's area_pixel_compute_scale for align_corners: float(in - 1) / (out -
// 1), the divisor converted to float, 0 for a single output.
float align_corners_scale(int n_in, int n_out) {
  return n_out > 1 ? static_cast<float>(n_in - 1) / static_cast<float>(n_out - 1)
                   : 0.0f;
}

// The geometry of a call, or false for sizes the kernels do not take.
bool geometry(int channels, int in_h, int in_w, int out_h, int out_w,
              int grid_x, int grid_y, int tile_w, int tile_h, bool vec4,
              Geometry* g) {
  if (channels <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 ||
      tile_w <= 0 || tile_h <= 0 || grid_x * tile_w < in_w ||
      grid_y * tile_h < in_h)
    return false;
  const int nvec = vec4 ? channels / 4 : channels;
  const float sh = align_corners_scale(in_h, out_h);
  const float sw = align_corners_scale(in_w, out_w);
  *g = Geometry{in_h, in_w, out_h, out_w, grid_x, tile_w, tile_h,
                sh, sw, sh > 0.0f ? 1.0f / sh : 0.0f,
                sw > 0.0f ? 1.0f / sw : 0.0f, lanes_log2_for(nvec), nvec};
  return true;
}

unsigned int forward_blocks(long long pixels, const Geometry& g) {
  const long long per_block = THREADS >> g.lanes_log2;
  return static_cast<unsigned int>((pixels + per_block - 1) / per_block);
}

template <typename K>
int attributes_of(K kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], kernel, THREADS, 0));
}

}  // namespace

extern "C" {

const char* f3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[0..2] = registers a thread, local (spill) bytes a thread, resident
// blocks an SM, of the forward (backward = 0) or backward (backward = 1)
// kernel on float4 (vec4 = 1) or float (vec4 = 0) channels.
int f3dgs_resize_attributes(int backward, int vec4, int* out) {
  switch ((backward ? 2 : 0) + (vec4 ? 1 : 0)) {
    case 0: return attributes_of(resize_forward_kernel<float>, out);
    case 1: return attributes_of(resize_forward_kernel<float4>, out);
    case 2: return attributes_of(resize_backward_kernel<float>, out);
    case 3: return attributes_of(resize_backward_kernel<float4>, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// tiles [grid_y * grid_x, tile_h * tile_w, channels] (the crop in_h x in_w
// at its top left) -> out [out_h, out_w, channels], on `stream`; returns
// cudaGetLastError() (0 = launched).
int f3dgs_resize_forward(const float* tiles, float* out, int channels,
                         int in_h, int in_w, int out_h, int out_w, int grid_x,
                         int grid_y, int tile_w, int tile_h,
                         cudaStream_t stream) {
  const bool vec4 = channels % 4 == 0 && aligned16(tiles) && aligned16(out);
  Geometry g;
  if (!geometry(channels, in_h, in_w, out_h, out_w, grid_x, grid_y, tile_w,
                tile_h, vec4, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = forward_blocks(static_cast<long long>(out_h) * out_w, g);
  if (vec4) {
    resize_forward_kernel<float4><<<blocks, THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(tiles), reinterpret_cast<float4*>(out),
        g);
  } else {
    resize_forward_kernel<float><<<blocks, THREADS, 0, stream>>>(tiles, out,
                                                                  g);
  }
  return static_cast<int>(cudaGetLastError());
}

// g_out [out_h, out_w, channels] -> g_tiles [grid_y * grid_x, tile_h *
// tile_w, channels], every element written (0 outside the crop), on
// `stream`; returns cudaGetLastError() (0 = launched).
int f3dgs_resize_backward(const float* g_out, float* g_tiles, int channels,
                          int in_h, int in_w, int out_h, int out_w,
                          int grid_x, int grid_y, int tile_w, int tile_h,
                          cudaStream_t stream) {
  const bool vec4 =
      channels % 4 == 0 && aligned16(g_out) && aligned16(g_tiles);
  Geometry g;
  if (!geometry(channels, in_h, in_w, out_h, out_w, grid_x, grid_y, tile_w,
                tile_h, vec4, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels =
      static_cast<long long>(grid_x) * grid_y * tile_w * tile_h;
  const unsigned int blocks =
      static_cast<unsigned int>((pixels + THREADS - 1) / THREADS);
  if (vec4) {
    resize_backward_kernel<float4><<<blocks, THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(g_out),
        reinterpret_cast<float4*>(g_tiles), g, pixels);
  } else {
    resize_backward_kernel<float><<<blocks, THREADS, 0, stream>>>(
        g_out, g_tiles, g, pixels);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
