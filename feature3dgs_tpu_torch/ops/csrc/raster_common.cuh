// Splat arithmetic shared by the forward and backward compositing kernels
// (raster_forward.cu, raster_backward.cu).
//
// The backward re-decides which (splat, pixel) pairs counted in the forward
// (power <= 0 and alpha >= 1/255, then position < n_contrib), so both
// kernels must evaluate power and alpha with the same bits. One function
// does it for both. __fmul_rn/__fadd_rn/__fsub_rn keep nvcc from
// contracting the products into FMAs, so the thresholds see the rounding
// of the plain PyTorch version's separate multiplies and adds.
//
// The alpha_matmul mode (RasterConfig.alpha_matmul; the alpha_mm mode of the
// TPU kernels, pallas_raster.py:167-189, 302-304, 671-674) evaluates the
// same power as a six-term dot product: alpha_coeff turns one splat and its
// tile's origin into the coefficients of (1, X, Y, X^2, XY, Y^2) over the
// tile-local pixel coordinates, once per list entry, and splat_alpha_mm
// evaluates the dot per pixel. Rounding: every product and sum is rounded
// separately (__fmul_rn/__fadd_rn, no FMA contraction), in the fixed order
// ((((c0 + c1 X) + c2 Y) + c3 X^2) + c4 XY) + c5 Y^2, which is the order
// and rounding of ops/composite.py:_alpha_power. Coordinates stay
// tile-local so every term is of the order of (distance / sigma)^2; global
// pixel coordinates squared would lose the low bits to cancellation.
//
// The feature products of both kernels run on the tensor cores as 3xTF32
// (tf32_split, mma_3xtf32 below): each f32 operand is split into
// hi = tf32(x) and lo = x - hi, and lo.hi + hi.lo + hi.hi is summed
// by three mma.sync.m16n8k8 TF32 instructions from a zero accumulator
// (small terms first); the caller then adds the result to its f32
// accumulator on the CUDA cores, because the tensor core's own accumulate
// truncates and a chain of hundreds of them drifts past the kernels' bars.
// The dropped lo.lo term is below 2^-22 of each product. cp.async helpers
// (16- and 4-byte copies with zero fill) serve both kernels' staging rings.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f3dgs {

constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.99;
constexpr float T_EPS = (float)1e-4;

__host__ __device__ inline int pad4(int x) { return (x + 3) & ~3; }

// One splat at pixel (px, py): dx = x - px, dy = y - py,
// power = -0.5 (a dx^2 + c dy^2) - b dx dy, gexp = exp(power),
// alpha = min(0.99, op * gexp). Returns whether the splat counts there
// (power <= 0 and alpha >= 1/255).
__device__ __forceinline__ bool splat_alpha(float x, float y, float ca,
                                            float cb, float cc, float op,
                                            float px, float py, float& dx,
                                            float& dy, float& gexp,
                                            float& alpha) {
  dx = __fsub_rn(x, px);
  dy = __fsub_rn(y, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(cb, dx), dy));
  gexp = expf(power);
  alpha = fminf(__fmul_rn(op, gexp), ALPHA_MAX);
  return power <= 0.f && alpha >= ALPHA_MIN;
}

// Coefficients of one splat's power over the tile-local monomials, with
// (ox, oy) the tile's first pixel: xl = x - ox, yl = y - oy,
// c0 = -0.5 (a xl^2 + c yl^2) - b xl yl, c1 = a xl + b yl,
// c2 = c yl + b xl, c3 = -0.5 a, c4 = -b, c5 = -0.5 c.
__device__ __forceinline__ void alpha_coeff(float x, float y, float ca,
                                            float cb, float cc, float ox,
                                            float oy, float& xl, float& yl,
                                            float c[6]) {
  xl = __fsub_rn(x, ox);
  yl = __fsub_rn(y, oy);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, xl), xl),
                               __fmul_rn(__fmul_rn(cc, yl), yl));
  c[0] = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, xl), yl));
  c[1] = __fadd_rn(__fmul_rn(ca, xl), __fmul_rn(cb, yl));
  c[2] = __fadd_rn(__fmul_rn(cc, yl), __fmul_rn(cb, xl));
  c[3] = __fmul_rn(-0.5f, ca);
  c[4] = -cb;
  c[5] = __fmul_rn(-0.5f, cc);
}

// The pixel's five non-constant monomials of its tile-local coordinates.
struct PixelMonomials {
  float x, y, xx, xy, yy;
  __device__ __forceinline__ PixelMonomials(float lx, float ly)
      : x(lx), y(ly), xx(lx * lx), xy(lx * ly), yy(ly * ly) {}
};

// splat_alpha in the alpha_matmul mode: power = c . (1, X, Y, X^2, XY, Y^2)
// from the coefficients of entry k, stored as coeff[j * stride + k].
__device__ __forceinline__ bool splat_alpha_mm(const float* coeff, int stride,
                                               int k, float op,
                                               const PixelMonomials& m,
                                               float& gexp, float& alpha) {
  float power = __fadd_rn(coeff[k], __fmul_rn(coeff[stride + k], m.x));
  power = __fadd_rn(power, __fmul_rn(coeff[2 * stride + k], m.y));
  power = __fadd_rn(power, __fmul_rn(coeff[3 * stride + k], m.xx));
  power = __fadd_rn(power, __fmul_rn(coeff[4 * stride + k], m.xy));
  power = __fadd_rn(power, __fmul_rn(coeff[5 * stride + k], m.yy));
  gexp = expf(power);
  alpha = fminf(__fmul_rn(op, gexp), ALPHA_MAX);
  return power <= 0.f && alpha >= ALPHA_MIN;
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// x = hi + lo exactly, hi = x rounded to nearest at TF32's 11 significant
// bits (Veltkamp's split with 2^13 + 1: three full-rate f32 operations, no
// cvt.rna.tf32, which runs at half rate). The tensor core reads the upper
// 19 bits of an operand, so hi enters exactly and lo loses less than
// 2^-10 |lo| <= 2^-22 |x|.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float p = __fmul_rn(x, 8193.f);
  const float h = __fadd_rn(__fsub_rn(x, p), p);
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// d += a [16 x 8, row-major fragment] . b [8 x 8, column-major fragment],
// TF32 operands, f32 accumulate. With g = lane / 4 and t = lane % 4 a thread
// holds a = {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)},
// b = {(t, g), (t + 4, g)} (row = the product's inner index) and
// d = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a . b, the same product from a zero accumulator (no registers are
// cleared for it).
__device__ __forceinline__ void mma_tf32_zero(float d[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// acc[j] += a . b[j] to f32 grade for N column tiles at once: the three
// TF32 products of each tile from zero on the tensor core, term by term
// across the tiles so that N independent chains are in flight, then one f32
// add per element on the CUDA cores.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*acc)[4],
                                           const uint32_t a_hi[4],
                                           const uint32_t a_lo[4],
                                           const uint32_t (*b_hi)[2],
                                           const uint32_t (*b_lo)[2]) {
  float c[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32_zero(c[j], a_lo, b_hi[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a_hi, b_lo[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a_hi, b_hi[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] += c[j][q];
}

// Asynchronous copies global -> shared; `valid` false writes zeros instead
// (the source is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace f3dgs
