// Forward compositing kernel for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel feature3dgs_tpu/ops/pallas_raster.py:_fwd_kernel
// (driven by `forward`, the pl.pallas_call at pallas_raster.py:474): front-
// to-back alpha compositing of each tile's depth-sorted Gaussian list into
// RGB, depth, F feature channels, final transmittance and n_contrib. The
// plain PyTorch version it is held against is ops/composite.py:
// composite_plain; the wrapper is ops/cuda_raster.py.
//
// Semantics (kept from the TPU kernel):
//   * pixel (px, py) = (tile_x*tile_w + lane % tile_w, tile_y*tile_h +
//     lane / tile_w), no +0.5; tile_y wraps per image,
//     ((tile_base + t) / grid_x) % grid_y, for stacked same-size grids;
//   * power = -0.5(a dx^2 + c dy^2) - b dx dy with dx = x - px;
//     alpha = min(0.99, op * exp(power)); a splat counts iff power <= 0 and
//     alpha >= 1/255;
//   * transmittance in the log domain per chunk of CHUNK list entries:
//     T before = T_in * exp(strict prefix sum of log1p(-alpha)), T after =
//     T before * (1 - alpha); a counting splat of a live pixel contributes
//     iff T after >= 1e-4, with weight alpha * T before; at the chunk's end
//     T_in *= exp(sum of contributing log1p(-alpha)); a counting live splat
//     with T after < 1e-4 ends the pixel; n_contrib is the largest 1-based
//     list position that contributed;
//   * the whole tile stops once no pixel is live (block-wide vote).
// The per-splat power/alpha arithmetic is raster_common.cuh:splat_alpha,
// shared with the backward kernel, which must re-decide bit for bit which
// splats counted. It and the T update use __fmul_rn/__fadd_rn so the
// compiler cannot contract them into FMAs: the alpha and T thresholds then
// see the same rounding as the plain version's separate multiplies and adds.
//
// What bounds it on the card: CUDA-core f32 work. Each (splat, pixel) pair
// costs ~25 operations for alpha and T plus 2F for the feature sum, against
// instances*(10+F)*4 bytes read and H*W*(F+6)*4 bytes written; at the LSeg
// speed-up scene (F=128) the operations take longer than the bytes.
// Design:
//   * one block per tile, one thread per pixel (tile_w*tile_h <= 1024);
//     per-pixel T, live latch, n_contrib, RGB and depth stay in registers;
//   * each chunk's splat scalars are gathered through gid_sorted into
//     shared memory (no pre-packed instance slab), each thread walks the
//     chunk and stages its weights w[k][p] in shared memory;
//   * splats no pixel took are dropped from the chunk, and only the feature
//     rows of the rest are gathered;
//   * features are a [P x k] x [k x F] product from shared memory in 4x4
//     register micro-tiles (one broadcast float4 of weights and one float4
//     of features per 16 FMAs), added into the tile's output rows, which
//     hold the running sum between chunks: one thread per pixel cannot hold
//     F accumulators in registers.
// No atomics, no fast-math: the same inputs give the same output bits.
//
// The alpha_matmul mode (template parameter MM; the TPU kernel's
// alpha_mm=True path, pallas_raster.py:246, 302-304) differs only in how
// power is evaluated: the thread that stages entry k also turns it into six
// coefficients over the tile-local monomials (raster_common.cuh:
// alpha_coeff), kept in six more rows of the staged scalars, and each pixel
// thread holds its five monomials in registers and takes the six-term dot
// (splat_alpha_mm: 6 broadcast shared-memory reads, 5 products, 5 sums a
// pair, against 2 differences, 7 products and 2 sums of the exact path).
// CUDA-core f32: the dot's inner dimension is 6, and a tensor-core product
// (TF32) would move power by far more than the mode's ~3e-6 contract.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

using f3dgs::pad4;
using f3dgs::T_EPS;

constexpr int CHUNK = 32;
constexpr int N_GEOM = 10;  // x, y, conic a/b/c, opacity, r, g, b, depth
constexpr int N_COEFF = 6;  // alpha_matmul mode: c0..c5 after the N_GEOM rows
constexpr int MAX_THREADS = 1024;

__host__ __device__ inline int geom_rows(bool mm) {
  return mm ? N_GEOM + N_COEFF : N_GEOM;
}

// Shared memory: int gid[CHUNK], idx[CHUNK], flag[CHUNK], nact (+3 pad);
// float geom[geom_rows][CHUNK]; float w[CHUNK][P]; float feat[CHUNK][pad4(F)].
constexpr int INT_WORDS = 3 * CHUNK + 4;
__host__ __device__ inline size_t smem_bytes(int p, int f, bool mm) {
  return sizeof(int) * INT_WORDS
         + sizeof(float) * ((size_t)geom_rows(mm) * CHUNK + (size_t)CHUNK * p
                            + (size_t)CHUNK * pad4(f));
}

// out[p][f] (+)= sum_j w[idx[j]][p] * feat[j][f] over the tile's P pixels.
__device__ void accumulate_features(float* __restrict__ out,
                                    const float* __restrict__ s_w,
                                    const float* __restrict__ s_feat,
                                    const int* __restrict__ s_idx, int nact,
                                    int p_pix, int f_dim, bool first) {
  const int p4 = p_pix / 4;
  const int q = pad4(f_dim) / 4;
  const float4* w4 = reinterpret_cast<const float4*>(s_w);
  const float4* f4 = reinterpret_cast<const float4*>(s_feat);
  for (int u = threadIdx.x; u < p4 * q; u += blockDim.x) {
    const int pq = u / q;
    const int cq = u - pq * q;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int j = 0; j < nact; ++j) {
      const float4 wv = w4[s_idx[j] * p4 + pq];
      const float4 fv = f4[j * q + cq];
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
      const float fr[4] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wr[r], fr[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* dst = out + (size_t)(pq * 4 + r) * f_dim + cq * 4;
      if ((f_dim & 3) == 0) {
        float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        if (!first) {
          const float4 o = *reinterpret_cast<const float4*>(dst);
          v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
        }
        *reinterpret_cast<float4*>(dst) = v;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cq * 4 + c < f_dim) dst[c] = first ? acc[r][c] : dst[c] + acc[r][c];
        }
      }
    }
  }
}

template <bool MM>
__global__ void __launch_bounds__(MAX_THREADS)
raster_forward_kernel(const float* __restrict__ xy,
                      const float* __restrict__ conic,
                      const float* __restrict__ opacity,
                      const float* __restrict__ rgb,
                      const float* __restrict__ depth,
                      const float* __restrict__ feat,
                      const int* __restrict__ gid_sorted,
                      const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_counts,
                      int tile_base, int grid_x, int grid_y, int tile_w,
                      int tile_h, int f_dim,
                      float* __restrict__ out_color,
                      float* __restrict__ out_feat,
                      float* __restrict__ out_depth,
                      float* __restrict__ out_final_t,
                      int* __restrict__ out_ncontrib) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_gid = reinterpret_cast<int*>(smem_raw);
  int* s_idx = s_gid + CHUNK;
  int* s_flag = s_idx + CHUNK;
  int* s_nact = s_flag + CHUNK;
  float* s_geom = reinterpret_cast<float*>(s_gid + INT_WORDS);
  float* s_w = s_geom + geom_rows(MM) * CHUNK;
  const int p_pix = tile_w * tile_h;
  float* s_feat = s_w + (size_t)CHUNK * p_pix;
  const int f_pad = pad4(f_dim);

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tg = tile_base + t;
  const int tile_x = tg % grid_x;
  const int tile_y = (tg / grid_x) % grid_y;
  const float px = (float)(tile_x * tile_w + lane % tile_w);
  const float py = (float)(tile_y * tile_h + lane / tile_w);
  // alpha_matmul mode: the tile's first pixel and this pixel's monomials
  const float ox = (float)(tile_x * tile_w);
  const float oy = (float)(tile_y * tile_h);
  const f3dgs::PixelMonomials mono((float)(lane % tile_w),
                                   (float)(lane / tile_w));

  // the wrapper has checked that [start, start + count) lies in gid_sorted
  // and that every id in it names a Gaussian
  const int start = tile_starts[t];
  const int count = tile_counts[t];

  float trans = 1.f;
  bool live = true;
  int ncon = 0;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f;
  float* out_f_tile = out_feat + (size_t)t * p_pix * f_dim;
  const int n_chunks = (count + CHUNK - 1) / CHUNK;

  for (int i = 0; i < n_chunks; ++i) {
    // the vote also fences the previous chunk's shared-memory readers
    if (!__syncthreads_or(live)) break;
    const int base = i * CHUNK;
    const int kn = min(CHUNK, count - base);
    for (int k = lane; k < CHUNK; k += blockDim.x) {
      int g = -1;
      if (k < kn) g = gid_sorted[start + base + k];
      s_gid[k] = g;
      s_flag[k] = 0;
      // slots past the list's end (g = -1) are loaded as empty entries
      const int gg = g < 0 ? 0 : g;
      const bool ok = g >= 0;
      s_geom[0 * CHUNK + k] = ok ? xy[2 * gg] : 0.f;
      s_geom[1 * CHUNK + k] = ok ? xy[2 * gg + 1] : 0.f;
      s_geom[2 * CHUNK + k] = ok ? conic[3 * gg] : 0.f;
      s_geom[3 * CHUNK + k] = ok ? conic[3 * gg + 1] : 0.f;
      s_geom[4 * CHUNK + k] = ok ? conic[3 * gg + 2] : 0.f;
      // opacity 0 never reaches ALPHA_MIN: empty entries never count
      s_geom[5 * CHUNK + k] = ok ? opacity[gg] : 0.f;
      s_geom[6 * CHUNK + k] = ok ? rgb[3 * gg] : 0.f;
      s_geom[7 * CHUNK + k] = ok ? rgb[3 * gg + 1] : 0.f;
      s_geom[8 * CHUNK + k] = ok ? rgb[3 * gg + 2] : 0.f;
      s_geom[9 * CHUNK + k] = ok ? depth[gg] : 0.f;
      if constexpr (MM) {
        float xl, yl, c[N_COEFF];
        f3dgs::alpha_coeff(s_geom[0 * CHUNK + k], s_geom[1 * CHUNK + k],
                           s_geom[2 * CHUNK + k], s_geom[3 * CHUNK + k],
                           s_geom[4 * CHUNK + k], ox, oy, xl, yl, c);
#pragma unroll
        for (int j = 0; j < N_COEFF; ++j)
          s_geom[(N_GEOM + j) * CHUNK + k] = c[j];
      }
    }
    __syncthreads();

    float cum = 0.f;          // strict prefix of log1p(-alpha) in the chunk
    float cum_contrib = 0.f;  // sum over contributing splats
    bool ended = false;
    for (int k = 0; k < kn; ++k) {
      float w = 0.f;
      float dx, dy, gexp, alpha;
      bool counts = false;
      if (live) {
        if constexpr (MM) {
          counts = f3dgs::splat_alpha_mm(s_geom + N_GEOM * CHUNK, CHUNK, k,
                                         s_geom[5 * CHUNK + k], mono, gexp,
                                         alpha);
        } else {
          counts = f3dgs::splat_alpha(
              s_geom[0 * CHUNK + k], s_geom[1 * CHUNK + k],
              s_geom[2 * CHUNK + k], s_geom[3 * CHUNK + k],
              s_geom[4 * CHUNK + k], s_geom[5 * CHUNK + k], px, py, dx, dy,
              gexp, alpha);
        }
      }
      if (counts) {
        const float l = log1pf(-alpha);
        const float t_before = __fmul_rn(trans, expf(cum));
        const float t_after = __fmul_rn(t_before, __fsub_rn(1.f, alpha));
        cum = __fadd_rn(cum, l);
        if (t_after >= T_EPS) {
          w = __fmul_rn(alpha, t_before);
          cum_contrib = __fadd_rn(cum_contrib, l);
          ncon = base + k + 1;
          acc_r = fmaf(w, s_geom[6 * CHUNK + k], acc_r);
          acc_g = fmaf(w, s_geom[7 * CHUNK + k], acc_g);
          acc_b = fmaf(w, s_geom[8 * CHUNK + k], acc_b);
          acc_d = fmaf(w, s_geom[9 * CHUNK + k], acc_d);
          s_flag[k] = 1;
        } else {
          ended = true;
        }
      }
      s_w[(size_t)k * p_pix + lane] = w;
    }
    trans = __fmul_rn(trans, expf(cum_contrib));
    if (ended) live = false;
    __syncthreads();

    if (lane == 0) {
      int n = 0;
      for (int k = 0; k < kn; ++k)
        if (s_flag[k]) s_idx[n++] = k;
      *s_nact = n;
    }
    __syncthreads();
    const int nact = *s_nact;
    for (int e = lane; e < nact * f_pad; e += blockDim.x) {
      const int j = e / f_pad;
      const int c = e - j * f_pad;
      const int g = s_gid[s_idx[j]];
      s_feat[e] = c < f_dim ? feat[(size_t)g * f_dim + c] : 0.f;
    }
    __syncthreads();
    accumulate_features(out_f_tile, s_w, s_feat, s_idx, nact, p_pix, f_dim,
                        i == 0);
  }
  if (n_chunks == 0) {
    for (int e = lane; e < p_pix * f_dim; e += blockDim.x) out_f_tile[e] = 0.f;
  }

  const size_t o = (size_t)t * p_pix + lane;
  out_color[3 * o] = acc_r;
  out_color[3 * o + 1] = acc_g;
  out_color[3 * o + 2] = acc_b;
  out_depth[o] = acc_d;
  out_final_t[o] = trans;
  out_ncontrib[o] = ncon;
}

}  // namespace

extern "C" {

int f3dgs_raster_forward_chunk() { return CHUNK; }

size_t f3dgs_raster_forward_smem_bytes(int p_pix, int f_dim, int alpha_mm) {
  return smem_bytes(p_pix, f_dim, alpha_mm != 0);
}

const char* f3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller guarantees that every tile's list lies in gid_sorted and holds
// valid Gaussian ids (ops/cuda_raster.py:check_tile_lists). alpha_mm != 0
// selects the alpha_matmul mode.
int f3dgs_raster_forward(const float* xy, const float* conic,
                         const float* opacity, const float* rgb,
                         const float* depth, const float* feat,
                         const int* gid_sorted, const int* tile_starts,
                         const int* tile_counts,
                         int n_tiles, int tile_base, int grid_x, int grid_y,
                         int tile_w, int tile_h, int f_dim, int alpha_mm,
                         float* out_color,
                         float* out_feat, float* out_depth, float* out_final_t,
                         int* out_ncontrib, void* stream) {
  const int p_pix = tile_w * tile_h;
  if (p_pix <= 0 || p_pix > MAX_THREADS || (p_pix & 3) != 0 || f_dim < 0 ||
      grid_x <= 0 || grid_y <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const bool mm = alpha_mm != 0;
  const size_t smem = smem_bytes(p_pix, f_dim, mm);
  auto kernel = mm ? raster_forward_kernel<true> : raster_forward_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_tiles, p_pix, smem, static_cast<cudaStream_t>(stream)>>>(
      xy, conic, opacity, rgb, depth, feat, gid_sorted, tile_starts,
      tile_counts, tile_base, grid_x, grid_y, tile_w, tile_h, f_dim,
      out_color, out_feat, out_depth, out_final_t, out_ncontrib);
  return (int)cudaGetLastError();
}

}  // extern "C"
