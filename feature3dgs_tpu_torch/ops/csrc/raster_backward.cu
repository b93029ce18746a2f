// Backward compositing kernel for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel feature3dgs_tpu/ops/pallas_raster.py:_bwd_kernel
// (driven by `backward`, the pl.pallas_call at pallas_raster.py:982, under
// the custom VJP _cp_bwd): the gradient of the forward compositing
// (raster_forward.cu) with respect to each list entry's splat, as one row
// per entry of gid_sorted. The plain PyTorch version it is held against is
// ops/composite.py:composite_plain_backward; the wrapper is
// ops/cuda_raster.py:raster_backward_cuda, and ops/segment.py sums the rows
// into per-Gaussian gradients.
//
// Semantics (kept from the TPU kernel and ops/composite.py:_composite_bwd):
//   * a (entry k, pixel) pair counts iff splat_alpha says so (the forward's
//     own bits, raster_common.cuh) and k < n_contrib(pixel);
//   * T before entry k is rebuilt back to front from the saved final_T in
//     the log domain per chunk: T_end of the chunk times
//     exp(-sum_{j >= k in the chunk} log1p(-alpha_j));
//   * with u_k = rgb_k . g_color + depth_k * g_depth (+ feat_k . g_feat
//     under feature_alpha_grad; the reference leaves that coupling out) and
//     S_k = g_finalT * final_T + sum_{j > k} w_j u_j,
//     dL/dalpha_k = T_k u_k - S_k / (1 - alpha_k);
//   * the 0.99 clamp is not gated: d opacity = exp(power) dL/dalpha, and
//     dL/dpower = opacity exp(power) dL/dalpha feeds the true gradients of
//     power = -0.5 (a dx^2 + c dy^2) - b dx dy in x, y, a, b and c;
//   * d rgb = w g_color, d depth = w g_depth, d feat = w g_feat, summed over
//     the tile's pixels.
// Output: d_geom [L, 10] = (x, y, conic a, b, c, opacity, r, g, b, depth)
// and d_feat [L, F], one row per list entry. Every row of every tile's
// list is written, zeros past the tile's deepest contributor.
//
// What bounds it on the card: bytes. It must read the pixel cotangents and
// the saved state, (F + 7) * 4 bytes a pixel, and write (10 + F) * 4 bytes
// per list entry; the work is ~15 operations per walked (entry, pixel) pair
// plus ~50 + 2F per counting pair (~0.5 GB against ~9e9 operations at the
// training scene, F = 128).
// Design:
//   * one block per tile, one thread per pixel; the tile is walked back to
//     front from its deepest contributor in chunks of CHUNK entries whose
//     splat scalars are gathered through gid_sorted into shared memory;
//   * S is a scalar per pixel, because S . g = sum w_j u_j: each thread
//     carries T_end, S and its pixel's cotangents in registers;
//   * the ten per-entry sums over pixels go through warp shuffles, then
//     across warps in a fixed order (deterministic, no atomics);
//   * the weights w[k][p] are staged in shared memory and the feature
//     gradient of the entries some pixel took is the product
//     w [k x P] . g_feat [P x F], in 4x4 register micro-tiles, with g_feat
//     staged through shared memory PB pixel rows at a time.
// No atomics, no fast-math: the same inputs give the same output bits.
//
// The alpha_matmul mode (template parameter MM; the TPU kernel's
// alpha_mm=True path, pallas_raster.py:583, 671-674, 726-741): power comes
// from the forward's own coefficient dot (raster_common.cuh:alpha_coeff and
// splat_alpha_mm, so the backward re-decides each pair with the forward's
// bits in this mode too), and the five geometric sums become six sums of
// dL/dpower * (1, X, Y, X^2, XY, Y^2) over the tile's pixels (eleven
// reduced columns instead of ten, same shuffles and warp order), followed
// by the chain rule from the coefficients back to x, y and the conic, once
// per entry:
//   d x = dc0 (-(a xl + b yl)) + dc1 a + dc2 b
//   d y = dc0 (-(c yl + b xl)) + dc1 b + dc2 c
//   d a = dc0 (-0.5 xl^2) + dc1 xl - 0.5 dc3
//   d b = dc0 (-xl yl) + dc1 yl + dc2 xl - dc4
//   d c = dc0 (-0.5 yl^2) + dc2 yl - 0.5 dc5

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

using f3dgs::pad4;

constexpr int CHUNK = 32;
constexpr int N_GEOM = 10;  // x, y, conic a/b/c, opacity, r, g, b, depth
constexpr int N_ROW = 10;   // d x, y, conic a/b/c, opacity, r, g, b, depth
constexpr int N_COEFF = 6;  // alpha_matmul mode: c0..c5 after the N_GEOM rows
// alpha_matmul mode: xl, yl after the coefficients; reduced columns are
// dc0..dc5, d opacity, d r, g, b, depth
constexpr int N_GEOM_MM = N_GEOM + N_COEFF + 2;
constexpr int N_PART_MM = N_ROW + 1;
constexpr int WARP = 32;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / WARP;
constexpr int PB = 16;  // g_feat pixel rows staged per step of the product
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int geom_rows(bool mm) {
  return mm ? N_GEOM_MM : N_GEOM;
}
__host__ __device__ inline int part_cols(bool mm) {
  return mm ? N_PART_MM : N_ROW;
}

// Shared memory: int gid[CHUNK], idx[CHUNK], flag[CHUNK], nact (+3 pad),
// red[MAX_WARPS]; float geom[geom_rows][CHUNK];
// float part[warps][CHUNK][part_cols]; float w[CHUNK][P];
// float g[PB][pad4(F)].
constexpr int INT_WORDS = 3 * CHUNK + 4 + MAX_WARPS;
__host__ __device__ inline size_t smem_bytes(int p, int f, bool mm) {
  return sizeof(int) * INT_WORDS
         + sizeof(float) * ((size_t)geom_rows(mm) * CHUNK
                            + (size_t)(p / WARP) * CHUNK * part_cols(mm)
                            + (size_t)CHUNK * p + (size_t)PB * pad4(f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// out[row(j)][f] = sum_p w[idx[j]][p] * g[p][f] for the nact entries some
// pixel took; g rows are staged PB at a time. Called by the whole block.
__device__ void feature_rows(float* __restrict__ d_feat_chunk,
                             const float* __restrict__ g_tile,
                             const float* __restrict__ s_w,
                             float* __restrict__ s_g,
                             const int* __restrict__ s_idx, int nact,
                             int p_pix, int f_dim) {
  const int f_pad = pad4(f_dim);
  const int q = f_pad / 4;
  const int n_items = ((nact + 3) / 4) * q;
  for (int ub = 0; ub < n_items; ub += blockDim.x) {
    const int u = ub + threadIdx.x;
    const bool has = u < n_items;
    const int jq = has ? u / q : 0;
    const int cq = has ? u - jq * q : 0;
    int row[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = jq * 4 + r;
      row[r] = j < nact ? s_idx[j] : -1;
    }
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int p0 = 0; p0 < p_pix; p0 += PB) {
      __syncthreads();  // the previous step's readers of s_g are done
      const int rows = min(PB, p_pix - p0);
      for (int e = threadIdx.x; e < rows * f_pad; e += blockDim.x) {
        const int pp = e / f_pad;
        const int c = e - pp * f_pad;
        s_g[e] = c < f_dim ? g_tile[(size_t)(p0 + pp) * f_dim + c] : 0.f;
      }
      __syncthreads();
      if (has) {
        for (int pp = 0; pp < rows; ++pp) {
          const float4 gv =
              reinterpret_cast<const float4*>(s_g + (size_t)pp * f_pad)[cq];
          const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float wv =
                row[r] >= 0 ? s_w[(size_t)row[r] * p_pix + p0 + pp] : 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wv, gr[c], acc[r][c]);
          }
        }
      }
    }
    if (has) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (row[r] < 0) continue;
        float* dst = d_feat_chunk + (size_t)row[r] * f_dim;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (cq * 4 + c < f_dim) dst[cq * 4 + c] = acc[r][c];
      }
    }
  }
}

template <bool MM>
__global__ void __launch_bounds__(MAX_THREADS)
raster_backward_kernel(const float* __restrict__ xy,
                       const float* __restrict__ conic,
                       const float* __restrict__ opacity,
                       const float* __restrict__ rgb,
                       const float* __restrict__ depth,
                       const float* __restrict__ feat,
                       const int* __restrict__ gid_sorted,
                       const int* __restrict__ tile_starts,
                       const int* __restrict__ tile_counts,
                       const float* __restrict__ g_color,
                       const float* __restrict__ g_feat,
                       const float* __restrict__ g_depth,
                       const float* __restrict__ g_final_t,
                       const float* __restrict__ final_t,
                       const int* __restrict__ n_contrib, int grid_x,
                       int tile_w, int tile_h, int f_dim, int fag,
                       float* __restrict__ d_geom,
                       float* __restrict__ d_feat) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_gid = reinterpret_cast<int*>(smem_raw);
  int* s_idx = s_gid + CHUNK;
  int* s_flag = s_idx + CHUNK;
  int* s_nact = s_flag + CHUNK;
  int* s_red = s_nact + 4;
  float* s_geom = reinterpret_cast<float*>(s_gid + INT_WORDS);
  const int p_pix = tile_w * tile_h;
  const int n_warps = p_pix / WARP;
  constexpr int N_PART = MM ? N_PART_MM : N_ROW;
  float* s_part = s_geom + geom_rows(MM) * CHUNK;
  float* s_w = s_part + (size_t)n_warps * CHUNK * N_PART;
  float* s_g = s_w + (size_t)CHUNK * p_pix;

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane / WARP;
  const int tile_x = t % grid_x;
  const int tile_y = t / grid_x;
  const float px = (float)(tile_x * tile_w + lane % tile_w);
  const float py = (float)(tile_y * tile_h + lane / tile_w);
  // alpha_matmul mode: the tile's first pixel and this pixel's monomials
  const float ox = (float)(tile_x * tile_w);
  const float oy = (float)(tile_y * tile_h);
  const f3dgs::PixelMonomials mono((float)(lane % tile_w),
                                   (float)(lane / tile_w));

  // the caller guarantees that [start, start + count) lies in gid_sorted
  // and holds valid Gaussian ids (the forward's wrapper checked them)
  const int start = tile_starts[t];
  const int count = tile_counts[t];
  const size_t o = (size_t)t * p_pix + lane;
  const int ncon = n_contrib[o];
  const float gr = g_color[3 * o], gg = g_color[3 * o + 1],
              gb = g_color[3 * o + 2], gd = g_depth[o];
  const float* g_feat_px = g_feat + o * f_dim;
  float t_end = final_t[o];
  float suffix = g_final_t[o] * t_end;  // S: g_finalT * final_T + sum w u

  // the tile's deepest contributor bounds the walk
  const int wmax = __reduce_max_sync(FULL, ncon);
  if (lane % WARP == 0) s_red[warp] = wmax;
  __syncthreads();
  int nmax = 0;
  for (int i = 0; i < n_warps; ++i) nmax = max(nmax, s_red[i]);
  nmax = min(nmax, count);

  // rows past the deepest contributor carry no gradient
  for (size_t e = lane; e < (size_t)(count - nmax) * N_ROW; e += blockDim.x)
    d_geom[(size_t)(start + nmax) * N_ROW + e] = 0.f;
  for (size_t e = lane; e < (size_t)(count - nmax) * f_dim; e += blockDim.x)
    d_feat[(size_t)(start + nmax) * f_dim + e] = 0.f;

  const int n_chunks = (nmax + CHUNK - 1) / CHUNK;
  for (int i = n_chunks - 1; i >= 0; --i) {
    const int base = i * CHUNK;
    const int kn = min(CHUNK, nmax - base);
    __syncthreads();  // the previous chunk's readers of shared memory are done
    for (int k = lane; k < CHUNK; k += blockDim.x) {
      const bool ok = k < kn;
      const int g = ok ? gid_sorted[start + base + k] : 0;
      s_gid[k] = g;
      s_flag[k] = 0;
      s_geom[0 * CHUNK + k] = ok ? xy[2 * g] : 0.f;
      s_geom[1 * CHUNK + k] = ok ? xy[2 * g + 1] : 0.f;
      s_geom[2 * CHUNK + k] = ok ? conic[3 * g] : 0.f;
      s_geom[3 * CHUNK + k] = ok ? conic[3 * g + 1] : 0.f;
      s_geom[4 * CHUNK + k] = ok ? conic[3 * g + 2] : 0.f;
      s_geom[5 * CHUNK + k] = ok ? opacity[g] : 0.f;
      s_geom[6 * CHUNK + k] = ok ? rgb[3 * g] : 0.f;
      s_geom[7 * CHUNK + k] = ok ? rgb[3 * g + 1] : 0.f;
      s_geom[8 * CHUNK + k] = ok ? rgb[3 * g + 2] : 0.f;
      s_geom[9 * CHUNK + k] = ok ? depth[g] : 0.f;
      if constexpr (MM) {
        float xl, yl, c[N_COEFF];
        f3dgs::alpha_coeff(s_geom[0 * CHUNK + k], s_geom[1 * CHUNK + k],
                           s_geom[2 * CHUNK + k], s_geom[3 * CHUNK + k],
                           s_geom[4 * CHUNK + k], ox, oy, xl, yl, c);
#pragma unroll
        for (int j = 0; j < N_COEFF; ++j)
          s_geom[(N_GEOM + j) * CHUNK + k] = c[j];
        s_geom[(N_GEOM + N_COEFF) * CHUNK + k] = xl;
        s_geom[(N_GEOM + N_COEFF + 1) * CHUNK + k] = yl;
      }
    }
    __syncthreads();

    float rc = 0.f;  // sum of log1p(-alpha) over this chunk's entries >= k
    for (int k = kn - 1; k >= 0; --k) {
      const float ca = s_geom[2 * CHUNK + k];
      const float cb = s_geom[3 * CHUNK + k];
      const float cc = s_geom[4 * CHUNK + k];
      const float op = s_geom[5 * CHUNK + k];
      float dx, dy, gexp, alpha;
      bool m;
      if constexpr (MM) {
        m = f3dgs::splat_alpha_mm(s_geom + N_GEOM * CHUNK, CHUNK, k, op, mono,
                                  gexp, alpha);
      } else {
        m = f3dgs::splat_alpha(s_geom[0 * CHUNK + k], s_geom[1 * CHUNK + k],
                               ca, cb, cc, op, px, py, dx, dy, gexp, alpha);
      }
      m = m && base + k < ncon;
      float v[N_PART];
#pragma unroll
      for (int c = 0; c < N_PART; ++c) v[c] = 0.f;
      float w = 0.f;
      if (m) {
        rc += log1pf(-alpha);
        const float t_before = t_end * expf(-rc);
        w = alpha * t_before;
        float u = s_geom[6 * CHUNK + k] * gr + s_geom[7 * CHUNK + k] * gg
                  + s_geom[8 * CHUNK + k] * gb + s_geom[9 * CHUNK + k] * gd;
        if (fag) {
          const float* fk = feat + (size_t)s_gid[k] * f_dim;
          for (int f = 0; f < f_dim; ++f) u = fmaf(fk[f], g_feat_px[f], u);
        }
        const float dl_da = t_before * u - suffix / (1.f - alpha);
        suffix += w * u;
        const float d_op = gexp * dl_da;
        const float d_pow = op * d_op;
        if constexpr (MM) {
          v[0] = d_pow;
          v[1] = d_pow * mono.x;
          v[2] = d_pow * mono.y;
          v[3] = d_pow * mono.xx;
          v[4] = d_pow * mono.xy;
          v[5] = d_pow * mono.yy;
        } else {
          v[0] = -(ca * dx + cb * dy) * d_pow;
          v[1] = -(cc * dy + cb * dx) * d_pow;
          v[2] = -0.5f * dx * dx * d_pow;
          v[3] = -dx * dy * d_pow;
          v[4] = -0.5f * dy * dy * d_pow;
        }
        v[N_PART - 5] = d_op;
        v[N_PART - 4] = w * gr;
        v[N_PART - 3] = w * gg;
        v[N_PART - 2] = w * gb;
        v[N_PART - 1] = w * gd;
        s_flag[k] = 1;
      }
      s_w[(size_t)k * p_pix + lane] = w;
      float* part = s_part + ((size_t)warp * CHUNK + k) * N_PART;
      if (__any_sync(FULL, m)) {
#pragma unroll
        for (int c = 0; c < N_PART; ++c) {
          const float s = warp_sum(v[c]);
          if (lane % WARP == 0) part[c] = s;
        }
      } else if (lane % WARP < N_PART) {
        part[lane % WARP] = 0.f;
      }
    }
    t_end *= expf(-rc);
    __syncthreads();

    // per-entry sums across warps, in warp order
    float* geom_chunk = d_geom + (size_t)(start + base) * N_ROW;
    if constexpr (MM) {
      // each (entry, column) sum lands in warp 0's slot, which only the
      // thread that summed it has read
      for (int e = lane; e < kn * N_PART; e += blockDim.x) {
        const int k = e / N_PART;
        const int c = e - k * N_PART;
        float s = 0.f;
        for (int wp = 0; wp < n_warps; ++wp)
          s += s_part[((size_t)wp * CHUNK + k) * N_PART + c];
        s_part[(size_t)k * N_PART + c] = s;
      }
      __syncthreads();
      // the chain rule from the coefficients to x, y and the conic
      for (int k = lane; k < kn; k += blockDim.x) {
        const float* dc = s_part + (size_t)k * N_PART;
        const float ca = s_geom[2 * CHUNK + k];
        const float cb = s_geom[3 * CHUNK + k];
        const float cc = s_geom[4 * CHUNK + k];
        const float xl = s_geom[(N_GEOM + N_COEFF) * CHUNK + k];
        const float yl = s_geom[(N_GEOM + N_COEFF + 1) * CHUNK + k];
        float* row = geom_chunk + (size_t)k * N_ROW;
        row[0] = dc[0] * -(ca * xl + cb * yl) + dc[1] * ca + dc[2] * cb;
        row[1] = dc[0] * -(cc * yl + cb * xl) + dc[1] * cb + dc[2] * cc;
        row[2] = dc[0] * (-0.5f * xl * xl) + dc[1] * xl - 0.5f * dc[3];
        row[3] = dc[0] * -(xl * yl) + dc[1] * yl + dc[2] * xl - dc[4];
        row[4] = dc[0] * (-0.5f * yl * yl) + dc[2] * yl - 0.5f * dc[5];
#pragma unroll
        for (int c = 5; c < N_ROW; ++c) row[c] = dc[c + 1];
      }
    } else {
      for (int e = lane; e < kn * N_ROW; e += blockDim.x) {
        const int k = e / N_ROW;
        const int c = e - k * N_ROW;
        float s = 0.f;
        for (int wp = 0; wp < n_warps; ++wp)
          s += s_part[((size_t)wp * CHUNK + k) * N_ROW + c];
        geom_chunk[e] = s;
      }
    }
    if (f_dim == 0) continue;

    if (lane == 0) {
      int n = 0;
      for (int k = 0; k < kn; ++k)
        if (s_flag[k]) s_idx[n++] = k;
      *s_nact = n;
    }
    __syncthreads();
    const int nact = *s_nact;
    float* feat_chunk = d_feat + (size_t)(start + base) * f_dim;
    for (int e = lane; e < kn * f_dim; e += blockDim.x) {
      const int k = e / f_dim;
      if (!s_flag[k]) feat_chunk[e] = 0.f;
    }
    feature_rows(feat_chunk, g_feat + (size_t)t * p_pix * f_dim, s_w, s_g,
                 s_idx, nact, p_pix, f_dim);
  }
}

}  // namespace

extern "C" {

int f3dgs_raster_backward_chunk() { return CHUNK; }

size_t f3dgs_raster_backward_smem_bytes(int p_pix, int f_dim, int alpha_mm) {
  return smem_bytes(p_pix, f_dim, alpha_mm != 0);
}

const char* f3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller guarantees that every tile's list lies in gid_sorted and holds
// valid Gaussian ids; rows of gid_sorted that no tile's list covers are
// left unwritten. alpha_mm != 0 selects the alpha_matmul mode, which must
// be the mode of the forward that produced final_t and n_contrib.
int f3dgs_raster_backward(const float* xy, const float* conic,
                          const float* opacity, const float* rgb,
                          const float* depth, const float* feat,
                          const int* gid_sorted, const int* tile_starts,
                          const int* tile_counts, const float* g_color,
                          const float* g_feat, const float* g_depth,
                          const float* g_final_t, const float* final_t,
                          const int* n_contrib, int n_tiles, int grid_x,
                          int tile_w, int tile_h, int f_dim, int fag,
                          int alpha_mm, float* d_geom, float* d_feat,
                          void* stream) {
  const int p_pix = tile_w * tile_h;
  if (p_pix <= 0 || p_pix > MAX_THREADS || p_pix % WARP != 0 || f_dim < 0 ||
      grid_x <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const bool mm = alpha_mm != 0;
  const size_t smem = smem_bytes(p_pix, f_dim, mm);
  auto kernel =
      mm ? raster_backward_kernel<true> : raster_backward_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_tiles, p_pix, smem, static_cast<cudaStream_t>(stream)>>>(
      xy, conic, opacity, rgb, depth, feat, gid_sorted, tile_starts,
      tile_counts, g_color, g_feat, g_depth, g_final_t, final_t, n_contrib,
      grid_x, tile_w, tile_h, f_dim, fag, d_geom, d_feat);
  return (int)cudaGetLastError();
}

}  // extern "C"
