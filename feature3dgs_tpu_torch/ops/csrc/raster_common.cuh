// Splat arithmetic shared by the forward and backward compositing kernels
// (raster_forward.cu, raster_backward.cu).
//
// The backward re-decides which (splat, pixel) pairs counted in the forward
// (power <= 0 and alpha >= 1/255, then position < n_contrib), so both
// kernels must evaluate power and alpha with the same bits. One function
// does it for both. __fmul_rn/__fadd_rn/__fsub_rn keep nvcc from
// contracting the products into FMAs, so the thresholds see the rounding
// of the plain PyTorch version's separate multiplies and adds.
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

}  // namespace f3dgs
