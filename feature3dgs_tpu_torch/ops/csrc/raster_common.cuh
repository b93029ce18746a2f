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
#pragma once

#include <cuda_runtime.h>

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

}  // namespace f3dgs
