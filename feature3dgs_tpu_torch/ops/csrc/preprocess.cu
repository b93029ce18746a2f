// Per-Gaussian preprocess for NVIDIA Hopper (sm_90a), plain C interface:
// one forward pass and its closed-form backward, one thread a Gaussian.
//
// Replaces no TPU kernel: the JAX package leaves this stage
// (feature3dgs_tpu/core/projection.py:preprocess, core/sh.py and the tile
// rectangles of ops/rasterize.py) to XLA, which fuses it. Run op by op in
// PyTorch it was ~410 elementwise launches a view at SH degree 3 and ~790
// more in autograd's backward, each with its own temporaries. The forward
// here is core/projection.py:preprocess, core/sh.py:sh_to_rgb, the
// ndc_offset add, ops/rasterize.py:rect_radius, core/projection.py:
// tile_rect and the cull (area, active mask) in one pass; the backward is
// core/projection.py:preprocess_backward (with core/sh.py:sh_backward),
// which recomputes the forward from the inputs and saves nothing. The
// wrapper is ops/cuda_preprocess.py.
//
// Same bits as the plain versions on the card: every op is written with
// __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn and __fsqrt_rn in the plain
// code's op order, so nvcc's default -fmad=true contracts nothing; Python
// scalars enter as (float) of their double, as PyTorch rounds them; 1.0 / x
// is a correctly rounded reciprocal (torch's reciprocal), x / python_scalar
// is x times the float32 rounding of the scalar's double reciprocal, which
// the wrapper passes (PyTorch's CUDA division by a CPU scalar); torch.maximum / minimum / clamp_min keep NaN;
// log is libdevice's logf, as torch.log's. The sum of three squares of the
// view direction follows PyTorch's CUDA reduction over a last dimension of
// 3 (two lanes: elements 0 and 2 in one, then 1): (d0^2 + d2^2) + d1^2.
//
// What bounds it on the card: bytes. The forward reads ~237 B a Gaussian
// at degree 3 (means, scales, rotation, opacity, 48 SH floats, alive) and
// writes ~57 B; the backward reads ~277 B and writes ~240 B. At 1 M
// Gaussians and 3.35 TB/s that is ~0.09 ms and ~0.15 ms. The arithmetic
// (a few hundred flops, two IEEE divisions and square roots a Gaussian) is
// far below the card's rate. Design:
//   * one thread a Gaussian, 128 a block; the camera is staged once a block
//     in shared memory;
//   * the SH rows of the block's Gaussians are staged through shared memory
//     by all threads at consecutive addresses (a warp's rows are 32 x 192 B
//     apart, read in place they would be 192 B strided loads), at an odd
//     row stride so that the threads' own rows hit distinct banks;
//     templated on the degree, only the first (degree+1)^2 rows are read;
//   * the backward writes g_shs, all M rows (zeros above the degree),
//     through the same shared rows, as contiguous stores;
//   * the cotangents are read at their row and column strides: the
//     compositing backward hands xy, conic, rgb and depth as column slices
//     of one [N, 10] array, read in place. A null cotangent is zero.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;

// PyTorch's float32 rounding of a Python float
#define F(x) (static_cast<float>(x))

constexpr double C0 = 0.28209479177387814;
constexpr double C1 = 0.4886025119029199;
constexpr double C20 = 1.0925484305920792, C21 = -1.0925484305920792,
                 C22 = 0.31539156525252005, C23 = -1.0925484305920792,
                 C24 = 0.5462742152960396;
constexpr double C30 = -0.5900435899266435, C31 = 2.890611442640554,
                 C32 = -0.4570457994644658, C33 = 0.3731763325901154,
                 C34 = -0.4570457994644658, C35 = 1.445305721320277,
                 C36 = -0.5900435899266435;
constexpr double C40 = 2.5033429417967046, C41 = -1.7701307697799304,
                 C42 = 0.9461746957575601, C43 = -0.6690465435572892,
                 C44 = 0.10578554691520431, C45 = -0.6690465435572892,
                 C46 = 0.47308734787878004, C47 = -1.7701307697799304,
                 C48 = 0.6258357354491761;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }

// torch.maximum / torch.minimum / clamp_min on float: NaN wins
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// shared-memory row stride of a Gaussian's K*3 SH floats: odd, so that
// thread t's row starts in bank (t * stride) % 32, distinct over a warp
template <int DEG>
struct Rows {
  static constexpr int K = (DEG + 1) * (DEG + 1);
  static constexpr int K3 = 3 * K;
  static constexpr int STRIDE = K3 | 1;
};

// the camera, staged in shared memory: view 0-15, proj 16-31 (row-major),
// campos 32-34, tan_fovx 35, tan_fovy 36
constexpr int CAM = 37;

struct Camera {
  const float* view;
  const float* proj;
  const float* campos;
  const float* tan_fovx;
  const float* tan_fovy;
};

__device__ __forceinline__ void stage_camera(const Camera& c, float* s) {
  const int t = threadIdx.x;
  if (t < 16) s[t] = c.view[t];
  else if (t < 32) s[t] = c.proj[t - 16];
  else if (t < 35) s[t] = c.campos[t - 32];
  else if (t == 35) s[t] = *c.tan_fovx;
  else if (t == 36) s[t] = *c.tan_fovy;
}

// p @ m[row, :3] + m[row, 3], as core/projection.py:_affine_row
__device__ __forceinline__ float affine(const float* m, int row, float x,
                                        float y, float z) {
  const float* r = m + 4 * row;
  return add(add(add(mul(x, r[0]), mul(y, r[1])), mul(z, r[2])), r[3]);
}

// stage the first K rows of the block's Gaussians' SH [n, m_rows, 3]
template <int DEG>
__device__ __forceinline__ void stage_sh(const float* __restrict__ shs,
                                         int m_rows, int first, int count,
                                         float* rows) {
  using R = Rows<DEG>;
  const long long m3 = 3LL * m_rows;
  for (int e = threadIdx.x; e < count * R::K3; e += THREADS) {
    const int g = e / R::K3, j = e - g * R::K3;
    rows[g * R::STRIDE + j] = shs[(first + g) * m3 + j];
  }
}

// The quantities of core/projection.py:preprocess that both passes need,
// each rounded as the plain version rounds it.
struct Geometry {
  float t[3];                 // view-space point; depth = t[2]
  float hx, hy, inv_w;        // homogeneous projection, 1 / (w + 1e-7)
  float q[4];                 // rotation (r, x, y, z)
  float R[3][3];              // its matrix
  float s[3], sq[3];          // scale_modifier * scales, and squared
  float cov[6];               // xx, xy, xz, yy, yz, zz
  float ux, uy, cx, cy;       // t / tz, and clamped to 1.3 tan_fov
  float fx, fy, inv_z, inv_z2;
  float j00, j02, j11, j12;
  float t0[3], t1[3];         // rows of J W
  float s0[3], s1[3];         // cov @ t0, cov @ t1
  float a, b, c, det;         // cov2d (+0.3 low-pass) and its determinant
};

__device__ __forceinline__ float sig(const float* cov, int i, int j) {
  // packed symmetric index of (min(i,j), max(i,j))
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  const int idx = lo == 0 ? hi : (lo == 1 ? 2 + hi : 5);
  return cov[idx];
}

__device__ __forceinline__ void geometry(const float* cam, float mx, float my,
                                         float mz, const float4 q,
                                         float sx, float sy, float sz,
                                         float scale_mod, int width,
                                         int height, Geometry& g) {
  const float* v = cam;
  const float* p = cam + 16;
  #pragma unroll
  for (int r = 0; r < 3; ++r) g.t[r] = affine(v, r, mx, my, mz);
  g.hx = affine(p, 0, mx, my, mz);
  g.hy = affine(p, 1, mx, my, mz);
  g.inv_w = rcp(add(affine(p, 3, mx, my, mz), F(1e-7)));

  // build_cov3d
  const float qr = q.x, qx = q.y, qy = q.z, qz = q.w;
  g.q[0] = qr; g.q[1] = qx; g.q[2] = qy; g.q[3] = qz;
  g.R[0][0] = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  g.R[0][1] = mul(2.0f, sub(mul(qx, qy), mul(qr, qz)));
  g.R[0][2] = mul(2.0f, add(mul(qx, qz), mul(qr, qy)));
  g.R[1][0] = mul(2.0f, add(mul(qx, qy), mul(qr, qz)));
  g.R[1][1] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  g.R[1][2] = mul(2.0f, sub(mul(qy, qz), mul(qr, qx)));
  g.R[2][0] = mul(2.0f, sub(mul(qx, qz), mul(qr, qy)));
  g.R[2][1] = mul(2.0f, add(mul(qy, qz), mul(qr, qx)));
  g.R[2][2] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
  g.s[0] = mul(scale_mod, sx);
  g.s[1] = mul(scale_mod, sy);
  g.s[2] = mul(scale_mod, sz);
  #pragma unroll
  for (int k = 0; k < 3; ++k) g.sq[k] = mul(g.s[k], g.s[k]);
  const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int i = pi[e], j = pj[e];
    g.cov[e] = add(add(mul(mul(g.sq[0], g.R[i][0]), g.R[j][0]),
                       mul(mul(g.sq[1], g.R[i][1]), g.R[j][1])),
                   mul(mul(g.sq[2], g.R[i][2]), g.R[j][2]));
  }

  // compute_cov2d
  const float tx = g.t[0], ty = g.t[1], tz = g.t[2];
  const float limx = mul(F(1.3), cam[35]), limy = mul(F(1.3), cam[36]);
  g.ux = dvd(tx, tz);
  g.uy = dvd(ty, tz);
  g.cx = tmin(tmax(g.ux, -limx), limx);
  g.cy = tmin(tmax(g.uy, -limy), limy);
  const float txc = mul(g.cx, tz), tyc = mul(g.cy, tz);
  g.fx = dvd(static_cast<float>(width), mul(2.0f, cam[35]));
  g.fy = dvd(static_cast<float>(height), mul(2.0f, cam[36]));
  g.inv_z = rcp(tz);
  g.inv_z2 = mul(g.inv_z, g.inv_z);
  g.j00 = mul(g.fx, g.inv_z);
  g.j02 = mul(mul(-g.fx, txc), g.inv_z2);
  g.j11 = mul(g.fy, g.inv_z);
  g.j12 = mul(mul(-g.fy, tyc), g.inv_z2);
  #pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.t0[k] = add(mul(g.j00, v[k]), mul(g.j02, v[8 + k]));
    g.t1[k] = add(mul(g.j11, v[4 + k]), mul(g.j12, v[8 + k]));
  }
  for (int i = 0; i < 3; ++i) {
    g.s0[i] = add(add(mul(sig(g.cov, i, 0), g.t0[0]),
                      mul(sig(g.cov, i, 1), g.t0[1])),
                  mul(sig(g.cov, i, 2), g.t0[2]));
    g.s1[i] = add(add(mul(sig(g.cov, i, 0), g.t1[0]),
                      mul(sig(g.cov, i, 1), g.t1[1])),
                  mul(sig(g.cov, i, 2), g.t1[2]));
  }
  g.a = add(add(add(mul(g.t0[0], g.s0[0]), mul(g.t0[1], g.s0[1])),
                mul(g.t0[2], g.s0[2])),
            F(0.3));
  g.b = add(add(mul(g.t1[0], g.s0[0]), mul(g.t1[1], g.s0[1])),
            mul(g.t1[2], g.s0[2]));
  g.c = add(add(add(mul(g.t1[0], g.s1[0]), mul(g.t1[1], g.s1[1])),
                mul(g.t1[2], g.s1[2])),
            F(0.3));
  g.det = sub(mul(g.a, g.c), mul(g.b, g.b));
}

// The basis values of core/sh.py:eval_sh, as its left factors (rows 1 and
// 3 are subtracted there): B[k] for k < (DEG+1)^2.
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* B) {
  B[0] = F(C0);
  if constexpr (DEG > 0) {
    B[1] = mul(F(C1), y);
    B[2] = mul(F(C1), z);
    B[3] = mul(F(C1), x);
  }
  if constexpr (DEG > 1) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    B[4] = mul(F(C20), xy);
    B[5] = mul(F(C21), yz);
    B[6] = mul(F(C22), sub(sub(mul(2.0f, zz), xx), yy));
    B[7] = mul(F(C23), xz);
    B[8] = mul(F(C24), sub(xx, yy));
    if constexpr (DEG > 2) {
      B[9] = mul(mul(F(C30), y), sub(mul(3.0f, xx), yy));
      B[10] = mul(mul(F(C31), xy), z);
      B[11] = mul(mul(F(C32), y), sub(sub(mul(4.0f, zz), xx), yy));
      B[12] = mul(mul(F(C33), z),
                  sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      B[13] = mul(mul(F(C34), x), sub(sub(mul(4.0f, zz), xx), yy));
      B[14] = mul(mul(F(C35), z), sub(xx, yy));
      B[15] = mul(mul(F(C36), x), sub(xx, mul(3.0f, yy)));
    }
    if constexpr (DEG > 3) {
      const float xx_yy = sub(xx, yy);
      const float xx3_yy = sub(mul(3.0f, xx), yy);
      const float xx_3yy = sub(xx, mul(3.0f, yy));
      const float zz7_1 = sub(mul(7.0f, zz), 1.0f);
      const float zz7_3 = sub(mul(7.0f, zz), 3.0f);
      B[16] = mul(mul(F(C40), xy), xx_yy);
      B[17] = mul(mul(F(C41), yz), xx3_yy);
      B[18] = mul(mul(F(C42), xy), zz7_1);
      B[19] = mul(mul(F(C43), yz), zz7_3);
      B[20] = mul(F(C44), add(mul(zz, sub(mul(35.0f, zz), 30.0f)), 3.0f));
      B[21] = mul(mul(F(C45), xz), zz7_3);
      B[22] = mul(mul(F(C46), xx_yy), zz7_1);
      B[23] = mul(mul(F(C47), xz), xx_3yy);
      B[24] = mul(F(C48), sub(mul(xx, xx_3yy), mul(yy, xx3_yy)));
    }
  }
}

// eval_sh for channel `c` of one Gaussian's staged rows (stride 3)
template <int DEG>
__device__ __forceinline__ float sh_eval(const float* B, const float* row,
                                         int c) {
  float r = mul(F(C0), row[c]);
  if constexpr (DEG > 0) {
    r = sub(r, mul(B[1], row[3 + c]));
    r = add(r, mul(B[2], row[6 + c]));
    r = sub(r, mul(B[3], row[9 + c]));
  }
#pragma unroll
  for (int k = 4; k < Rows<DEG>::K; ++k) r = add(r, mul(B[k], row[3 * k + c]));
  return r;
}

// the unit view direction of core/sh.py:sh_to_rgb
__device__ __forceinline__ void direction(const float* cam, float mx,
                                          float my, float mz, float* dir,
                                          float& length) {
  const float d0 = sub(mx, cam[32]), d1 = sub(my, cam[33]),
              d2 = sub(mz, cam[34]);
  length = __fsqrt_rn(add(add(mul(d0, d0), mul(d2, d2)), mul(d1, d1)));
  dir[0] = dvd(d0, length);
  dir[1] = dvd(d1, length);
  dir[2] = dvd(d2, length);
}

struct FwdArgs {
  int n, m_rows, width, height, grid_x, grid_y, tile_w, tile_h;
  float scale_mod, inv_three, inv_alpha_min;
  const float* means;
  const float* scales;
  const float4* rots;
  const float* shs;
  const float* opacity;
  const float* offset;          // [n, 2] or null
  const unsigned char* mask;    // [n] or null
  Camera cam;
  float* xy;
  float* depth;
  float* conic;
  float* radius;
  float* rgb;
  int* rect_min;
  int* rect_max;
  unsigned char* pre_valid;
  unsigned char* valid;
};

template <int DEG>
__global__ void __launch_bounds__(THREADS)
    preprocess_fwd_kernel(const FwdArgs a) {
  using R = Rows<DEG>;
  __shared__ float cam[CAM];
  __shared__ float rows[THREADS * R::STRIDE];
  const int first = blockIdx.x * THREADS;
  const int count = min(THREADS, a.n - first);
  stage_camera(a.cam, cam);
  stage_sh<DEG>(a.shs, a.m_rows, first, count, rows);
  __syncthreads();
  const int i = first + threadIdx.x;
  if (i >= a.n) return;

  const float mx = a.means[3 * i], my = a.means[3 * i + 1],
              mz = a.means[3 * i + 2];
  Geometry g;
  geometry(cam, mx, my, mz, a.rots[i], a.scales[3 * i], a.scales[3 * i + 1],
           a.scales[3 * i + 2], a.scale_mod, a.width, a.height, g);
  const bool in_front = g.t[2] > F(0.2);

  // invert_cov2d
  const bool invertible = g.det != 0.0f;
  const float inv_det = rcp(invertible ? g.det : 1.0f);
  const float mid = mul(0.5f, add(g.a, g.c));
  const float disc = __fsqrt_rn(tmax(sub(mul(mid, mid), g.det), F(0.1)));
  const float lam = add(mid, disc);
  float radius = ceilf(mul(3.0f, __fsqrt_rn(tmax(lam, 0.0f))));

  // ndc_to_pixel, then the ndc_offset add
  const float w = static_cast<float>(a.width), h = static_cast<float>(a.height);
  float px = mul(sub(mul(add(mul(g.hx, g.inv_w), 1.0f), w), 1.0f), 0.5f);
  float py = mul(sub(mul(add(mul(g.hy, g.inv_w), 1.0f), h), 1.0f), 0.5f);
  if (a.offset != nullptr) {
    px = add(px, mul(mul(a.offset[2 * i], w), 0.5f));
    py = add(py, mul(mul(a.offset[2 * i + 1], h), 0.5f));
  }

  // sh_to_rgb
  float dir[3], length;
  direction(cam, mx, my, mz, dir, length);
  float B[R::K];
  sh_basis<DEG>(dir[0], dir[1], dir[2], B);
  const float* row = rows + threadIdx.x * R::STRIDE;
  float rgb[3];
  #pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = add(sh_eval<DEG>(B, row, c), 0.5f);
    rgb[c] = v != v ? v : fmaxf(v, 0.0f);
  }

  const bool pre_valid = in_front && invertible && radius > 0.0f;
  if (!pre_valid) radius = 0.0f;

  // rect_radius, tile_rect and the cull of ops/rasterize.py:_prep_view
  const float op = a.opacity[i];
  const float lg = logf(mul(tmax(op, F(1e-12)), a.inv_alpha_min));
  const float spread = __fsqrt_rn(mul(2.0f, tmax(lg, 0.0f)));
  const float rr = tmin(
      radius, add(ceilf(mul(mul(radius, a.inv_three), spread)), 1.0f));
  const float tw = static_cast<float>(a.tile_w),
              th = static_cast<float>(a.tile_h);
  const float lox = floorf(dvd(sub(px, rr), tw));
  const float loy = floorf(dvd(sub(py, rr), th));
  const float hix = floorf(dvd(add(add(px, rr), static_cast<float>(a.tile_w - 1)), tw));
  const float hiy = floorf(dvd(add(add(py, rr), static_cast<float>(a.tile_h - 1)), th));
  const float gx = static_cast<float>(a.grid_x),
              gy = static_cast<float>(a.grid_y);
  const int rminx = static_cast<int>(tmin(tmax(lox, 0.0f), gx));
  const int rminy = static_cast<int>(tmin(tmax(loy, 0.0f), gy));
  const int rmaxx = static_cast<int>(tmin(tmax(hix, 0.0f), gx));
  const int rmaxy = static_cast<int>(tmin(tmax(hiy, 0.0f), gy));
  const bool valid = pre_valid && (rmaxx - rminx) * (rmaxy - rminy) > 0 &&
                     (a.mask == nullptr || a.mask[i] != 0);

  a.xy[2 * i] = px;
  a.xy[2 * i + 1] = py;
  a.depth[i] = g.t[2];
  a.conic[3 * i] = mul(g.c, inv_det);
  a.conic[3 * i + 1] = mul(-g.b, inv_det);
  a.conic[3 * i + 2] = mul(g.a, inv_det);
  a.radius[i] = radius;
  #pragma unroll
  for (int c = 0; c < 3; ++c) a.rgb[3 * i + c] = rgb[c];
  a.rect_min[2 * i] = rminx;
  a.rect_min[2 * i + 1] = rminy;
  a.rect_max[2 * i] = rmaxx;
  a.rect_max[2 * i + 1] = rmaxy;
  a.pre_valid[i] = pre_valid;
  a.valid[i] = valid;
}

// a cotangent read at its strides (elements); null reads zero
struct Cot {
  const float* p;
  long long rs, cs;
  __device__ __forceinline__ float at(long long i, int c) const {
    return p == nullptr ? 0.0f : p[i * rs + c * cs];
  }
};

struct BwdArgs {
  int n, m_rows, width, height;
  float scale_mod;
  const float* means;
  const float* scales;
  const float4* rots;
  const float* shs;
  const unsigned char* valid;
  Camera cam;
  Cot g_xy, g_depth, g_conic, g_rgb;
  float* g_means;
  float* g_scales;
  float* g_rots;
  float* g_shs;    // [n, m_rows, 3], every row written
  float* g_ndc;    // [n, 2] or null
};

// d min(max(u, lo), hi) / du as autograd takes it: half at each tie
__device__ __forceinline__ float clamp_factor(float u, float lo, float hi) {
  const float up = u > lo ? 1.0f : (u == lo ? 0.5f : 0.0f);
  const float m = tmax(u, lo);
  return mul(up, m < hi ? 1.0f : (m == hi ? 0.5f : 0.0f));
}

// The closed-form backward, core/projection.py:preprocess_backward op for op
template <int DEG>
__device__ __forceinline__ void backward_one(const BwdArgs& a, const float* cam,
                                             int i, float* row) {
  using R = Rows<DEG>;
  const float mx = a.means[3 * i], my = a.means[3 * i + 1],
              mz = a.means[3 * i + 2];
  Geometry g;
  geometry(cam, mx, my, mz, a.rots[i], a.scales[3 * i], a.scales[3 * i + 1],
           a.scales[3 * i + 2], a.scale_mod, a.width, a.height, g);
  const float* v = cam;
  const float* p = cam + 16;
  const float inv_det = rcp(g.det);

  // conic = (c, -b, a) / det
  const float gc0 = a.g_conic.at(i, 0), gc1 = a.g_conic.at(i, 1),
              gc2 = a.g_conic.at(i, 2);
  const float g_inv = add(sub(mul(gc0, g.c), mul(gc1, g.b)), mul(gc2, g.a));
  const float g_det = -mul(mul(g_inv, inv_det), inv_det);
  const float g_a = add(mul(gc2, inv_det), mul(g_det, g.c));
  const float g_b = sub(-mul(gc1, inv_det), mul(g_det, mul(2.0f, g.b)));
  const float g_c = add(mul(gc0, inv_det), mul(g_det, g.a));

  // a = t0' S t0, b = t1' S t0, c = t1' S t1
  const float g_a2 = mul(2.0f, g_a), g_c2 = mul(2.0f, g_c);
  float g_t0[3], g_t1[3];
  #pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_t0[k] = add(mul(g_a2, g.s0[k]), mul(g_b, g.s1[k]));
    g_t1[k] = add(mul(g_b, g.s0[k]), mul(g_c2, g.s1[k]));
  }
  float g_cov[6];
  {
    const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int ii = pi[e], jj = pj[e];
      if (ii == jj) {
        g_cov[e] = add(add(mul(g_a, mul(g.t0[ii], g.t0[ii])),
                           mul(g_b, mul(g.t1[ii], g.t0[ii]))),
                       mul(g_c, mul(g.t1[ii], g.t1[ii])));
      } else {
        g_cov[e] = add(add(mul(g_a2, mul(g.t0[ii], g.t0[jj])),
                           mul(g_b, add(mul(g.t1[ii], g.t0[jj]),
                                        mul(g.t1[jj], g.t0[ii])))),
                       mul(g_c2, mul(g.t1[ii], g.t1[jj])));
      }
    }
  }

  // the Jacobian rows, 1/tz, the clamp and t = V m
  const float tz = g.t[2];
  const float g_j00 = add(add(mul(g_t0[0], v[0]), mul(g_t0[1], v[1])),
                          mul(g_t0[2], v[2]));
  const float g_j02 = add(add(mul(g_t0[0], v[8]), mul(g_t0[1], v[9])),
                          mul(g_t0[2], v[10]));
  const float g_j11 = add(add(mul(g_t1[0], v[4]), mul(g_t1[1], v[5])),
                          mul(g_t1[2], v[6]));
  const float g_j12 = add(add(mul(g_t1[0], v[8]), mul(g_t1[1], v[9])),
                          mul(g_t1[2], v[10]));
  const float nfx = -g.fx, nfy = -g.fy;
  const float txc = mul(g.cx, tz), tyc = mul(g.cy, tz);
  const float g_txc = mul(mul(g_j02, g.inv_z2), nfx);
  const float g_tyc = mul(mul(g_j12, g.inv_z2), nfy);
  const float g_inv_z2 = add(mul(g_j02, mul(nfx, txc)),
                             mul(g_j12, mul(nfy, tyc)));
  const float g_inv_z = add(add(mul(g_j00, g.fx), mul(g_j11, g.fy)),
                            mul(g_inv_z2, mul(2.0f, g.inv_z)));
  const float limx = mul(F(1.3), cam[35]), limy = mul(F(1.3), cam[36]);
  const float g_ux = mul(mul(g_txc, tz), clamp_factor(g.ux, -limx, limx));
  const float g_uy = mul(mul(g_tyc, tz), clamp_factor(g.uy, -limy, limy));
  const float g_tx = dvd(g_ux, tz);
  const float g_ty = dvd(g_uy, tz);
  float g_tz = add(a.g_depth.at(i, 0), mul(g_txc, g.cx));
  g_tz = add(g_tz, mul(g_tyc, g.cy));
  g_tz = sub(g_tz, mul(mul(g_inv_z, g.inv_z), g.inv_z));
  g_tz = sub(g_tz, dvd(mul(g_ux, g.ux), tz));
  g_tz = sub(g_tz, dvd(mul(g_uy, g.uy), tz));

  // xy = ((ndc + 1) * wh - 1) * 0.5, ndc = h / w
  const float gx = a.g_xy.at(i, 0), gy = a.g_xy.at(i, 1);
  const float w = static_cast<float>(a.width), h = static_cast<float>(a.height);
  const float g_nx = mul(mul(gx, 0.5f), w);
  const float g_ny = mul(mul(gy, 0.5f), h);
  const float g_hx = mul(g_nx, g.inv_w), g_hy = mul(g_ny, g.inv_w);
  const float g_hw = -mul(mul(add(mul(g_nx, g.hx), mul(g_ny, g.hy)), g.inv_w),
                         g.inv_w);

  // the colour: its clamp, the SH rows and the view direction
  float dir[3], length;
  direction(cam, mx, my, mz, dir, length);
  const float x = dir[0], y = dir[1], z = dir[2];
  float B[R::K];
  sh_basis<DEG>(x, y, z, B);
  float g_v[3];
  #pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float pre = add(sh_eval<DEG>(B, row, c), 0.5f);
    g_v[c] = pre >= 0.0f ? a.g_rgb.at(i, c) : 0.0f;
  }
  // w_k = g_v . sh_k, then g_sh_k = g_v * (signed basis), in place
  float wk[R::K];
#pragma unroll
  for (int k = 0; k < R::K; ++k) {
    float* r = row + 3 * k;
    wk[k] = add(add(mul(g_v[0], r[0]), mul(g_v[1], r[1])), mul(g_v[2], r[2]));
    const float bk = (k == 1 || k == 3) ? -B[k] : B[k];
    #pragma unroll
    for (int c = 0; c < 3; ++c) r[c] = mul(g_v[c], bk);
  }
  float gd[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (DEG > 0) {
    gd[1] = mul(wk[1], F(-C1));
    gd[2] = mul(wk[2], F(C1));
    gd[0] = mul(wk[3], F(-C1));
  }
  if constexpr (DEG > 1) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    float* W = wk;
    gd[0] = add(gd[0], mul(W[4], mul(F(C20), y)));
    gd[1] = add(gd[1], mul(W[4], mul(F(C20), x)));
    gd[1] = add(gd[1], mul(W[5], mul(F(C21), z)));
    gd[2] = add(gd[2], mul(W[5], mul(F(C21), y)));
    gd[0] = add(gd[0], mul(W[6], mul(F(-2.0 * C22), x)));
    gd[1] = add(gd[1], mul(W[6], mul(F(-2.0 * C22), y)));
    gd[2] = add(gd[2], mul(W[6], mul(F(4.0 * C22), z)));
    gd[0] = add(gd[0], mul(W[7], mul(F(C23), z)));
    gd[2] = add(gd[2], mul(W[7], mul(F(C23), x)));
    gd[0] = add(gd[0], mul(W[8], mul(F(2.0 * C24), x)));
    gd[1] = add(gd[1], mul(W[8], mul(F(-2.0 * C24), y)));
    if constexpr (DEG > 2) {
      const float xx_yy = sub(xx, yy);
      gd[0] = add(gd[0], mul(W[9], mul(F(6.0 * C30), xy)));
      gd[1] = add(gd[1], mul(W[9], mul(F(3.0 * C30), xx_yy)));
      gd[0] = add(gd[0], mul(W[10], mul(F(C31), yz)));
      gd[1] = add(gd[1], mul(W[10], mul(F(C31), xz)));
      gd[2] = add(gd[2], mul(W[10], mul(F(C31), xy)));
      gd[0] = add(gd[0], mul(W[11], mul(F(-2.0 * C32), xy)));
      gd[1] = add(gd[1], mul(W[11], mul(F(C32), sub(sub(mul(4.0f, zz), xx),
                                                     mul(3.0f, yy)))));
      gd[2] = add(gd[2], mul(W[11], mul(F(8.0 * C32), yz)));
      gd[0] = add(gd[0], mul(W[12], mul(F(-6.0 * C33), xz)));
      gd[1] = add(gd[1], mul(W[12], mul(F(-6.0 * C33), yz)));
      gd[2] = add(gd[2], mul(W[12], mul(F(C33),
                                        sub(sub(mul(6.0f, zz), mul(3.0f, xx)),
                                            mul(3.0f, yy)))));
      gd[0] = add(gd[0], mul(W[13], mul(F(C34), sub(sub(mul(4.0f, zz),
                                                         mul(3.0f, xx)), yy))));
      gd[1] = add(gd[1], mul(W[13], mul(F(-2.0 * C34), xy)));
      gd[2] = add(gd[2], mul(W[13], mul(F(8.0 * C34), xz)));
      gd[0] = add(gd[0], mul(W[14], mul(F(2.0 * C35), xz)));
      gd[1] = add(gd[1], mul(W[14], mul(F(-2.0 * C35), yz)));
      gd[2] = add(gd[2], mul(W[14], mul(F(C35), xx_yy)));
      gd[0] = add(gd[0], mul(W[15], mul(F(3.0 * C36), xx_yy)));
      gd[1] = add(gd[1], mul(W[15], mul(F(-6.0 * C36), xy)));
    }
    if constexpr (DEG > 3) {
      const float xx_yy = sub(xx, yy);
      const float xyz = mul(xy, z);
      const float zz7_1 = sub(mul(7.0f, zz), 1.0f);
      const float zz7_3 = sub(mul(7.0f, zz), 3.0f);
      const float xx3_yy = sub(mul(3.0f, xx), yy);
      const float xx_3yy = sub(xx, mul(3.0f, yy));
      gd[0] = add(gd[0], mul(W[16], mul(F(C40), mul(y, xx3_yy))));
      gd[1] = add(gd[1], mul(W[16], mul(F(C40), mul(x, xx_3yy))));
      gd[0] = add(gd[0], mul(W[17], mul(F(6.0 * C41), xyz)));
      gd[1] = add(gd[1], mul(W[17], mul(F(3.0 * C41), mul(z, xx_yy))));
      gd[2] = add(gd[2], mul(W[17], mul(F(C41), mul(y, xx3_yy))));
      gd[0] = add(gd[0], mul(W[18], mul(F(C42), mul(y, zz7_1))));
      gd[1] = add(gd[1], mul(W[18], mul(F(C42), mul(x, zz7_1))));
      gd[2] = add(gd[2], mul(W[18], mul(F(14.0 * C42), xyz)));
      gd[1] = add(gd[1], mul(W[19], mul(F(C43), mul(z, zz7_3))));
      gd[2] = add(gd[2], mul(W[19], mul(F(C43),
                                        mul(y, sub(mul(21.0f, zz), 3.0f)))));
      gd[2] = add(gd[2], mul(W[20], mul(F(C44),
                                        mul(z, sub(mul(140.0f, zz), 60.0f)))));
      gd[0] = add(gd[0], mul(W[21], mul(F(C45), mul(z, zz7_3))));
      gd[2] = add(gd[2], mul(W[21], mul(F(C45),
                                        mul(x, sub(mul(21.0f, zz), 3.0f)))));
      gd[0] = add(gd[0], mul(W[22], mul(F(2.0 * C46), mul(x, zz7_1))));
      gd[1] = add(gd[1], mul(W[22], mul(F(-2.0 * C46), mul(y, zz7_1))));
      gd[2] = add(gd[2], mul(W[22], mul(F(14.0 * C46), mul(z, xx_yy))));
      gd[0] = add(gd[0], mul(W[23], mul(F(3.0 * C47), mul(z, xx_yy))));
      gd[1] = add(gd[1], mul(W[23], mul(F(-6.0 * C47), xyz)));
      gd[2] = add(gd[2], mul(W[23], mul(F(C47), mul(x, xx_3yy))));
      gd[0] = add(gd[0], mul(W[24], mul(F(4.0 * C48), mul(x, xx_3yy))));
      gd[1] = add(gd[1], mul(W[24], mul(F(4.0 * C48),
                                        mul(y, sub(yy, mul(3.0f, xx))))));
    }
  }
  const float dg = add(add(mul(x, gd[0]), mul(y, gd[1])), mul(z, gd[2]));
  float g_d[3];
  #pragma unroll
  for (int k = 0; k < 3; ++k) g_d[k] = dvd(sub(gd[k], mul(dir[k], dg)), length);

  // means: t, h, w and the direction, per coordinate
  #pragma unroll
  for (int k = 0; k < 3; ++k) {
    float acc = add(mul(g_tx, v[k]), mul(g_ty, v[4 + k]));
    acc = add(acc, mul(g_tz, v[8 + k]));
    acc = add(acc, mul(g_hx, p[k]));
    acc = add(acc, mul(g_hy, p[4 + k]));
    acc = add(acc, mul(g_hw, p[12 + k]));
    a.g_means[3 * i + k] = add(acc, g_d[k]);
  }

  // the covariance's R and S^2, then the scales and q
  const int diag[3] = {0, 3, 5};
  #pragma unroll
  for (int k = 0; k < 3; ++k) {
    float gs = mul(g_cov[0], mul(g.R[0][k], g.R[0][k]));
    gs = add(gs, mul(g_cov[1], mul(g.R[0][k], g.R[1][k])));
    gs = add(gs, mul(g_cov[2], mul(g.R[0][k], g.R[2][k])));
    gs = add(gs, mul(g_cov[3], mul(g.R[1][k], g.R[1][k])));
    gs = add(gs, mul(g_cov[4], mul(g.R[1][k], g.R[2][k])));
    gs = add(gs, mul(g_cov[5], mul(g.R[2][k], g.R[2][k])));
    a.g_scales[3 * i + k] = mul(mul(gs, mul(2.0f, g.s[k])), a.scale_mod);
  }
  float gR[3][3];
  #pragma unroll
  for (int ii = 0; ii < 3; ++ii) {
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = mul(mul(2.0f, g_cov[diag[ii]]), g.R[ii][k]);
      #pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        if (jj == ii) continue;
        const int lo = ii < jj ? ii : jj, hi = ii < jj ? jj : ii;
        const int e = lo == 0 ? hi : (lo == 1 ? 2 + hi : 5);
        acc = add(acc, mul(g_cov[e], g.R[jj][k]));
      }
      gR[ii][k] = mul(g.sq[k], acc);
    }
  }
  const float qr = g.q[0], qx = g.q[1], qy = g.q[2], qz = g.q[3];
  float t;
  t = -mul(qz, gR[0][1]);
  t = add(t, mul(qy, gR[0][2]));
  t = add(t, mul(qz, gR[1][0]));
  t = sub(t, mul(qx, gR[1][2]));
  t = sub(t, mul(qy, gR[2][0]));
  t = add(t, mul(qx, gR[2][1]));
  a.g_rots[4 * i] = mul(2.0f, t);
  t = mul(qy, gR[0][1]);
  t = add(t, mul(qz, gR[0][2]));
  t = add(t, mul(qy, gR[1][0]));
  t = sub(t, mul(qr, gR[1][2]));
  t = add(t, mul(qz, gR[2][0]));
  t = add(t, mul(qr, gR[2][1]));
  a.g_rots[4 * i + 1] =
      sub(mul(2.0f, t), mul(mul(4.0f, qx), add(gR[1][1], gR[2][2])));
  t = mul(qx, gR[0][1]);
  t = add(t, mul(qr, gR[0][2]));
  t = add(t, mul(qx, gR[1][0]));
  t = add(t, mul(qz, gR[1][2]));
  t = sub(t, mul(qr, gR[2][0]));
  t = add(t, mul(qz, gR[2][1]));
  a.g_rots[4 * i + 2] =
      sub(mul(2.0f, t), mul(mul(4.0f, qy), add(gR[0][0], gR[2][2])));
  t = -mul(qr, gR[0][1]);
  t = add(t, mul(qx, gR[0][2]));
  t = add(t, mul(qr, gR[1][0]));
  t = add(t, mul(qy, gR[1][2]));
  t = add(t, mul(qx, gR[2][0]));
  t = add(t, mul(qy, gR[2][1]));
  a.g_rots[4 * i + 3] =
      sub(mul(2.0f, t), mul(mul(4.0f, qz), add(gR[0][0], gR[1][1])));

  if (a.g_ndc != nullptr) {
    a.g_ndc[2 * i] = mul(mul(gx, w), 0.5f);
    a.g_ndc[2 * i + 1] = mul(mul(gy, h), 0.5f);
  }
}

template <int DEG>
__global__ void __launch_bounds__(THREADS)
    preprocess_bwd_kernel(const BwdArgs a) {
  using R = Rows<DEG>;
  __shared__ float cam[CAM];
  __shared__ float rows[THREADS * R::STRIDE];
  const int first = blockIdx.x * THREADS;
  const int count = min(THREADS, a.n - first);
  stage_camera(a.cam, cam);
  stage_sh<DEG>(a.shs, a.m_rows, first, count, rows);
  __syncthreads();
  const int i = first + threadIdx.x;
  float* row = rows + threadIdx.x * R::STRIDE;
  if (i < a.n) {
    if (a.valid[i]) {
      backward_one<DEG>(a, cam, i, row);
    } else {
      // no pixel saw it: exact zeros
      #pragma unroll
      for (int k = 0; k < 3; ++k) a.g_means[3 * i + k] = 0.0f;
      #pragma unroll
      for (int k = 0; k < 3; ++k) a.g_scales[3 * i + k] = 0.0f;
      #pragma unroll
      for (int k = 0; k < 4; ++k) a.g_rots[4 * i + k] = 0.0f;
      if (a.g_ndc != nullptr) {
        a.g_ndc[2 * i] = 0.0f;
        a.g_ndc[2 * i + 1] = 0.0f;
      }
      for (int j = 0; j < R::K3; ++j) row[j] = 0.0f;
    }
  }
  __syncthreads();
  // g_shs: the block's rows, all m_rows of each, as contiguous stores
  const int m3 = 3 * a.m_rows;
  float* out = a.g_shs + static_cast<long long>(first) * m3;
  for (int e = threadIdx.x; e < count * m3; e += THREADS) {
    const int gg = e / m3, j = e - gg * m3;
    out[e] = j < R::K3 ? rows[gg * R::STRIDE + j] : 0.0f;
  }
}

template <int DEG>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const int blocks = (a.n + THREADS - 1) / THREADS;
  preprocess_fwd_kernel<DEG><<<blocks, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DEG>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int blocks = (a.n + THREADS - 1) / THREADS;
  preprocess_bwd_kernel<DEG><<<blocks, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int attributes_of(K kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, THREADS, 0));
}

}  // namespace

extern "C" {

int f3dgs_preprocess_threads() { return THREADS; }

const char* f3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[0..3] = registers a thread, local (spill) bytes a thread, resident
// blocks an SM, static shared bytes a block, of the forward (backward = 0)
// or backward (backward = 1) kernel at SH degree `degree`.
int f3dgs_preprocess_attributes(int backward, int degree, int* out) {
  switch (degree * 2 + (backward ? 1 : 0)) {
    case 0: return attributes_of(preprocess_fwd_kernel<0>, out);
    case 1: return attributes_of(preprocess_bwd_kernel<0>, out);
    case 2: return attributes_of(preprocess_fwd_kernel<1>, out);
    case 3: return attributes_of(preprocess_bwd_kernel<1>, out);
    case 4: return attributes_of(preprocess_fwd_kernel<2>, out);
    case 5: return attributes_of(preprocess_bwd_kernel<2>, out);
    case 6: return attributes_of(preprocess_fwd_kernel<3>, out);
    case 7: return attributes_of(preprocess_bwd_kernel<3>, out);
    case 8: return attributes_of(preprocess_fwd_kernel<4>, out);
    case 9: return attributes_of(preprocess_bwd_kernel<4>, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward of n Gaussians on `stream`; returns cudaGetLastError() (0 =
// launched). offset and mask may be null. Bools are one byte each.
int f3dgs_preprocess_forward(
    int n, int degree, int m_rows, const float* means, const float* scales,
    const float* rots, const float* shs, const float* opacity,
    const float* offset, const unsigned char* mask, const float* view,
    const float* proj, const float* campos, const float* tan_fovx,
    const float* tan_fovy, int width, int height, int grid_x, int grid_y,
    int tile_w, int tile_h, float scale_mod, float inv_three,
    float inv_alpha_min, float* xy, float* depth, float* conic,
    float* radius, float* rgb, int* rect_min, int* rect_max,
    unsigned char* pre_valid, unsigned char* valid, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{n, m_rows, width, height, grid_x, grid_y, tile_w, tile_h,
            scale_mod, inv_three, inv_alpha_min, means, scales,
            reinterpret_cast<const float4*>(rots), shs, opacity, offset, mask,
            Camera{view, proj, campos, tan_fovx, tan_fovy}, xy, depth, conic,
            radius, rgb, rect_min, rect_max, pre_valid, valid};
  switch (degree) {
    case 0: return launch_fwd<0>(a, stream);
    case 1: return launch_fwd<1>(a, stream);
    case 2: return launch_fwd<2>(a, stream);
    case 3: return launch_fwd<3>(a, stream);
    case 4: return launch_fwd<4>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of n Gaussians on `stream`. Each cotangent is read at
// (row stride, column stride) in elements, and may be null (zero). g_ndc may
// be null (not written).
int f3dgs_preprocess_backward(
    int n, int degree, int m_rows, const float* means, const float* scales,
    const float* rots, const float* shs, const unsigned char* valid,
    const float* view, const float* proj, const float* campos,
    const float* tan_fovx, const float* tan_fovy, int width, int height,
    float scale_mod, const float* g_xy, long long g_xy_rs, long long g_xy_cs,
    const float* g_depth, long long g_depth_rs, const float* g_conic,
    long long g_conic_rs, long long g_conic_cs, const float* g_rgb,
    long long g_rgb_rs, long long g_rgb_cs, float* g_means, float* g_scales,
    float* g_rots, float* g_shs, float* g_ndc, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{n, m_rows, width, height, scale_mod, means, scales,
            reinterpret_cast<const float4*>(rots), shs, valid,
            Camera{view, proj, campos, tan_fovx, tan_fovy},
            Cot{g_xy, g_xy_rs, g_xy_cs}, Cot{g_depth, g_depth_rs, 0},
            Cot{g_conic, g_conic_rs, g_conic_cs},
            Cot{g_rgb, g_rgb_rs, g_rgb_cs}, g_means, g_scales, g_rots, g_shs,
            g_ndc};
  switch (degree) {
    case 0: return launch_bwd<0>(a, stream);
    case 1: return launch_bwd<1>(a, stream);
    case 2: return launch_bwd<2>(a, stream);
    case 3: return launch_bwd<3>(a, stream);
    case 4: return launch_bwd<4>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
