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
//   * a block stops once none of its pixels is live (block-wide vote).
// Batched views (n_per_camera = N > 0, ops/rasterize.py:rasterize_batch):
// the launch walks B cameras' stacked tile grids, camera-major; tile
// tile_base + t belongs to camera b = (tile_base + t) / (grid_x * grid_y),
// whose xy, conic, opacity, rgb and depth are rows b * N + id of [B*N]
// arrays, while feat [N,F] is one for all cameras and read at row id. At
// n_per_camera = 0 every address is the unbatched one.
// The per-splat power/alpha arithmetic is raster_common.cuh:splat_alpha,
// shared with the backward kernel, which must re-decide bit for bit which
// splats counted. It and the T update use __fmul_rn/__fadd_rn so the
// compiler cannot contract them into FMAs: the alpha and T thresholds then
// see the same rounding as the plain version's separate multiplies and adds.
// The walk's chunk stays 32 entries whatever is staged around it: T is
// rounded once per chunk, so another chunk length would move T by an ulp
// and with it n_contrib on marginal pixels.
//
// What bounds it on the card: by the roofline, bytes (every pixel's F + 6
// outputs written once, H*W*(F+6)*4, plus the (10 + F) floats of each list
// entry gathered once; at F = 128 the operations, ~25 a tested pair plus 2F
// a contributing pair, take less time than the bytes, except on long lists
// where the operations take over). What the kernel really spends its time
// on is instruction slots at 16 warps an SM: the per-pair alpha walk (exp,
// log1p and the thresholds on the CUDA cores) and the splitting, loading
// and adding around the tensor-core product (about six other instructions
// per mma). Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// PERF.md section 6): 1.9 ms against a 0.17 ms bound at the 303 K-instance
// training scene, 6.2 ms against 0.91 ms at the 1.8 M-instance loop scene.
// Design:
//   * feature accumulators stay in registers for the whole list and
//     out_feat is written once, at the end, and never read. A warp owns its
//     32 pixels x 8*NT channels as 2 x NT mma accumulator fragments (8*NT
//     registers a thread; NT = 1, 2, 4 or 8 by F);
//   * the grid is tiles x pixel splits x channel groups, blocks of at most
//     256 threads. Up to 64 channels a block has one thread per pixel (up
//     to 256 pixels of the tile). Above, two threads per pixel (template
//     parameter H = 2), in separate warps, own 64 channels each, so a block
//     is 128 pixels x 128 channels and a 32x16 tile at F = 128 is four
//     blocks. The two share the pixel's walk instead of repeating it: each
//     decides 16 of the chunk's 32 entries (power, exp, thresholds: the
//     decisions do not depend on one another) and parks alpha in the
//     weight's slot, then thread 0 alone walks the counting entries in list
//     order (T, the T_EPS test, colour, depth) and leaves the weights.
//     F > 128 adds channel groups, each repeating the walk; group 0 alone
//     writes colour, depth, final_T and n_contrib;
//   * the product w^T [pixels x entries] . feat [entries x channels] of a
//     chunk runs on the tensor cores as 3xTF32 (raster_common.cuh:
//     mma_3xtf32), 8 entries a step and four column tiles at once (four
//     independent mma chains); a step is skipped for a 16-pixel half none
//     of whose pixels took an entry (late in a list most are saturated);
//   * staging is asynchronous and double-buffered: while a chunk is walked
//     one warp gathers the next chunk's ids and splat scalars, and the next
//     chunk's feature rows (this block's channels) arrive by cp.async while
//     the current product runs. Block barriers a chunk: the live vote, the
//     arrival of the feature rows and, with H = 2, the hand-over between
//     the two threads of a pixel.
// Shared memory (floats): feat[2][32][FS] with FS = round_up(8 NT H, 32) + 8,
// w[32][PS] with PS = pixels + 8 (both strides are 8 mod 32, which spreads
// the fragment loads over all banks), geom[2][10 or 16][32], gid[2][32],
// and with H = 2 live[pixels] and took[16]: 55,616 bytes at 128 pixels,
// NT = 8, H = 2. At NT = 8 a thread needs up to 128 registers, so two
// 256-thread blocks run per SM: one can walk while the other multiplies.
// No atomics, no fast-math: the same inputs give the same output bits.
//
// The alpha_matmul mode (template parameter MM; the TPU kernel's
// alpha_mm=True path, pallas_raster.py:246, 302-304) differs only in how
// power is evaluated: the thread that stages entry k also turns it into six
// coefficients over the tile-local monomials (raster_common.cuh:
// alpha_coeff), kept in six more rows of the staged scalars, and each pixel
// thread holds its five monomials in registers and takes the six-term dot
// (splat_alpha_mm). CUDA-core f32: the dot's inner dimension is 6, and a
// tensor-core product would move power by more than the mode's contract.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

using f3dgs::round_up;
using f3dgs::T_EPS;

constexpr int CHUNK = 32;
constexpr int N_GEOM = 10;  // x, y, conic a/b/c, opacity, r, g, b, depth
constexpr int N_COEFF = 6;  // alpha_matmul mode: c0..c5 after the N_GEOM rows
constexpr int WARP = 32;
constexpr int MAX_PIXELS = 1024;  // a tile
constexpr int MAX_THREADS = 256;  // a block: at most this many of its pixels
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int geom_rows(bool mm) {
  return mm ? N_GEOM + N_COEFF : N_GEOM;
}
__host__ __device__ inline int weight_stride(int pixels) {
  return pixels + 8;
}
__host__ __device__ inline int feat_stride(int channels) {
  return channels ? round_up(channels, 32) + 8 : 0;
}
// threads = halves x the block's pixels; a block stages 8 nt halves channels
__host__ __device__ inline size_t smem_bytes(int threads, int nt, int halves,
                                             bool mm) {
  const int pixels = threads / halves;
  return sizeof(float) * ((size_t)2 * CHUNK * feat_stride(8 * nt * halves)
                          + (size_t)CHUNK * weight_stride(pixels)
                          + (size_t)2 * geom_rows(mm) * CHUNK)
         + sizeof(int) * (2 * CHUNK + (halves == 2 ? pixels + 16 : 0));
}

struct Args {
  const float* xy;
  const float* conic;
  const float* opacity;
  const float* rgb;
  const float* depth;
  const float* feat;
  const int* gid_sorted;
  const int* tile_starts;
  const int* tile_counts;
  int tile_base, n_per_camera, grid_x, grid_y, tile_w, tile_h, f_dim,
      n_groups, n_splits;
  float* out_color;
  float* out_feat;
  float* out_depth;
  float* out_final_t;
  int* out_ncontrib;
};

// The first row of this block's camera in xy, conic, opacity, rgb and
// depth (0 unbatched). Computed where it is used, from the launch's
// constants, so that it holds no register through the walk.
__device__ __forceinline__ size_t camera_row0(const Args& a) {
  const int t = blockIdx.x / (a.n_groups * a.n_splits);
  return (size_t)((a.tile_base + t) / (a.grid_x * a.grid_y)) * a.n_per_camera;
}

// Lane k of one warp stages list entry k of a chunk: its id and scalars,
// empty past the list's end (kn). The scalars are the camera's row of the
// entry; the id, which addresses feat, is staged as it is.
template <bool MM>
__device__ __forceinline__ void gather_entry(const Args& a, const int* list,
                                             int k, int kn, float ox,
                                             float oy, int* s_gid,
                                             float* s_geom) {
  const bool ok = k < kn;
  const int g = ok ? list[k] : 0;
  s_gid[k] = ok ? g : -1;
  const size_t r = camera_row0(a) + g;
  const float x = ok ? a.xy[2 * r] : 0.f;
  const float y = ok ? a.xy[2 * r + 1] : 0.f;
  const float ca = ok ? a.conic[3 * r] : 0.f;
  const float cb = ok ? a.conic[3 * r + 1] : 0.f;
  const float cc = ok ? a.conic[3 * r + 2] : 0.f;
  s_geom[0 * CHUNK + k] = x;
  s_geom[1 * CHUNK + k] = y;
  s_geom[2 * CHUNK + k] = ca;
  s_geom[3 * CHUNK + k] = cb;
  s_geom[4 * CHUNK + k] = cc;
  // opacity 0 never reaches ALPHA_MIN: empty entries never count
  s_geom[5 * CHUNK + k] = ok ? a.opacity[r] : 0.f;
  s_geom[6 * CHUNK + k] = ok ? a.rgb[3 * r] : 0.f;
  s_geom[7 * CHUNK + k] = ok ? a.rgb[3 * r + 1] : 0.f;
  s_geom[8 * CHUNK + k] = ok ? a.rgb[3 * r + 2] : 0.f;
  s_geom[9 * CHUNK + k] = ok ? a.depth[r] : 0.f;
  if constexpr (MM) {
    float xl, yl, c[N_COEFF];
    f3dgs::alpha_coeff(x, y, ca, cb, cc, ox, oy, xl, yl, c);
#pragma unroll
    for (int j = 0; j < N_COEFF; ++j) s_geom[(N_GEOM + j) * CHUNK + k] = c[j];
  }
}

// Start the copies of a chunk's feature rows, channels [c0, c0 + 8 NT) of
// each staged id, into dst[32][fs]; rows past the list's end and channels
// past F arrive as zeros. Called by the whole block.
__device__ __forceinline__ void stage_features(const float* feat, int f_dim,
                                               int c0, int fg, int fs,
                                               const int* s_gid, float* dst) {
  if ((f_dim & 3) == 0) {
    const int q = fg / 4;
    for (int e = threadIdx.x; e < CHUNK * q; e += blockDim.x) {
      const int k = e / q;
      const int c = (e - k * q) * 4;
      const int g = s_gid[k];
      const bool ok = g >= 0 && c0 + c < f_dim;
      f3dgs::cp_async16(dst + k * fs + c,
                        ok ? feat + (size_t)g * f_dim + c0 + c : feat, ok);
    }
  } else {
    for (int e = threadIdx.x; e < CHUNK * fg; e += blockDim.x) {
      const int k = e / fg;
      const int c = e - k * fg;
      const int g = s_gid[k];
      const bool ok = g >= 0 && c0 + c < f_dim;
      f3dgs::cp_async4(dst + k * fs + c,
                       ok ? feat + (size_t)g * f_dim + c0 + c : feat, ok);
    }
  }
}

// The per-pair decision of the walk: whether entry k counts at this pixel,
// and its alpha.
template <bool MM>
__device__ __forceinline__ bool entry_alpha(const float* s_geom, int k,
                                            float px, float py,
                                            const f3dgs::PixelMonomials& mono,
                                            float& alpha) {
  float dx, dy, gexp;
  if constexpr (MM) {
    return f3dgs::splat_alpha_mm(s_geom + N_GEOM * CHUNK, CHUNK, k,
                                 s_geom[5 * CHUNK + k], mono, gexp, alpha);
  } else {
    return f3dgs::splat_alpha(s_geom[0 * CHUNK + k], s_geom[1 * CHUNK + k],
                              s_geom[2 * CHUNK + k], s_geom[3 * CHUNK + k],
                              s_geom[4 * CHUNK + k], s_geom[5 * CHUNK + k], px,
                              py, dx, dy, gexp, alpha);
  }
}

// The pixel's running state through the walk.
struct PixelState {
  float trans = 1.f;
  bool live;
  int ncon = 0;
  float r = 0.f, g = 0.f, b = 0.f, d = 0.f;
};

// One counting entry of the walk, in list order: T before and after, the
// weight where the entry contributes, else the end of the pixel. Returns the
// weight (0 where the entry does not contribute).
__device__ __forceinline__ float take_entry(const float* s_geom, int k,
                                            int pos, float alpha,
                                            PixelState& px, float& cum,
                                            float& cum_contrib, bool& ended,
                                            unsigned& took) {
  const float l = log1pf(-alpha);
  const float t_before = __fmul_rn(px.trans, expf(cum));
  const float t_after = __fmul_rn(t_before, __fsub_rn(1.f, alpha));
  cum = __fadd_rn(cum, l);
  if (t_after < T_EPS) {
    ended = true;
    return 0.f;
  }
  const float w = __fmul_rn(alpha, t_before);
  cum_contrib = __fadd_rn(cum_contrib, l);
  px.ncon = pos + 1;
  px.r = fmaf(w, s_geom[6 * CHUNK + k], px.r);
  px.g = fmaf(w, s_geom[7 * CHUNK + k], px.g);
  px.b = fmaf(w, s_geom[8 * CHUNK + k], px.b);
  px.d = fmaf(w, s_geom[9 * CHUNK + k], px.d);
  took |= 1u << k;
  return w;
}

// H = 1: one thread per pixel of the block. H = 2: two threads per pixel,
// `half` 0 and 1 in separate warps; they share the pixel's walk and own
// 8 NT channels each.
template <bool MM, int NT, int H>
__global__ void __launch_bounds__(MAX_THREADS, 2)
raster_forward_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p_pix = a.tile_w * a.tile_h;
  constexpr int FG = 8 * NT;   // channels a warp accumulates
  constexpr int FGB = FG * H;  // channels a block stages
  constexpr int FS = NT ? ((FGB + 31) / 32) * 32 + 8 : 0;
  const int ppb = blockDim.x / H;  // pixels of this block
  const int ps = weight_stride(ppb);
  float* s_feat = reinterpret_cast<float*>(smem_raw);
  float* s_w = s_feat + 2 * CHUNK * FS;
  float* s_geom_all = s_w + (size_t)CHUNK * ps;
  int* s_gid_all =
      reinterpret_cast<int*>(s_geom_all + 2 * geom_rows(MM) * CHUNK);
  // H = 2: what half 0 learns in its pass and half 1 needs
  int* s_live = s_gid_all + 2 * CHUNK;
  unsigned* s_took = reinterpret_cast<unsigned*>(s_live + ppb);

  // blocks of one tile are neighbours: split-major, then channel group
  const int per_tile = a.n_groups * a.n_splits;
  const int t = blockIdx.x / per_tile;
  const int split = (blockIdx.x - t * per_tile) / a.n_groups;
  const int group = blockIdx.x - t * per_tile - split * a.n_groups;
  const int lane = threadIdx.x;
  const int half = H == 1 ? 0 : lane / ppb;
  const int pl = lane - half * ppb;        // this thread's pixel in the block
  const int pix = split * ppb + pl;        // and in the tile
  const int warp = lane / WARP;
  const int n_warps = blockDim.x / WARP;
  const int pw = pl / WARP;  // this warp's 32-pixel row block
  const int li = lane % WARP;
  const int fg_row = li >> 2;  // the mma fragments' g
  const int fg_col = li & 3;   // and t
  const bool valid = pix < p_pix;
  const int tg = a.tile_base + t;
  const int tile_x = tg % a.grid_x;
  const int tile_y = (tg / a.grid_x) % a.grid_y;
  const float px = (float)(tile_x * a.tile_w + pix % a.tile_w);
  const float py = (float)(tile_y * a.tile_h + pix / a.tile_w);
  // alpha_matmul mode: the tile's first pixel and this pixel's monomials
  const float ox = (float)(tile_x * a.tile_w);
  const float oy = (float)(tile_y * a.tile_h);
  const f3dgs::PixelMonomials mono((float)(pix % a.tile_w),
                                   (float)(pix / a.tile_w));

  // the wrapper has checked that [start, start + count) lies in gid_sorted
  // and that every id in it names a Gaussian
  const int start = a.tile_starts[t];
  const int count = a.tile_counts[t];
  const int* list = a.gid_sorted + start;
  const int n_chunks = (count + CHUNK - 1) / CHUNK;

  PixelState state;
  state.live = valid;
  // this warp's 32 pixels x its 8 NT channels, as mma accumulators
  float acc[2][NT > 0 ? NT : 1][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < (NT > 0 ? NT : 1); ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  if (n_chunks > 0 && warp == 0)
    gather_entry<MM>(a, list, li, min(CHUNK, count), ox, oy, s_gid_all,
                     s_geom_all);
  __syncthreads();
  if constexpr (NT > 0) {
    if (n_chunks > 0)
      stage_features(a.feat, a.f_dim, group * FGB, FGB, FS, s_gid_all, s_feat);
    f3dgs::cp_async_commit();
  }

  for (int i = 0; i < n_chunks; ++i) {
    // the vote also fences the previous chunk's readers of shared memory
    if (!__syncthreads_or(half == 0 && state.live)) break;
    const int st = i & 1;
    const int base = i * CHUNK;
    const int kn = min(CHUNK, count - base);
    const float* s_geom = s_geom_all + st * geom_rows(MM) * CHUNK;
    // one warp, another each chunk, stages the next chunk's scalars
    if (i + 1 < n_chunks && warp == (i + 1) % n_warps)
      gather_entry<MM>(a, list + base + CHUNK, li,
                       min(CHUNK, count - base - CHUNK), ox, oy,
                       s_gid_all + (st ^ 1) * CHUNK,
                       s_geom_all + (st ^ 1) * geom_rows(MM) * CHUNK);

    unsigned took = 0;  // entries of this chunk the pixel took
    float* w_col = s_w + pl;
    if constexpr (H == 1) {
      if (__any_sync(FULL, state.live)) {
        float cum = 0.f;          // strict prefix of log1p(-alpha), this chunk
        float cum_contrib = 0.f;  // sum over contributing splats
        bool ended = false;
        for (int k = 0; k < kn; ++k) {
          float alpha;
          float w = 0.f;
          if (state.live && entry_alpha<MM>(s_geom, k, px, py, mono, alpha))
            w = take_entry(s_geom, k, base + k, alpha, state, cum,
                           cum_contrib, ended, took);
          w_col[(size_t)k * ps] = w;
        }
        // the product's last step of 8 may reach past the list's end
        for (int k = kn; k < round_up(kn, 8); ++k) w_col[(size_t)k * ps] = 0.f;
        state.trans = __fmul_rn(state.trans, expf(cum_contrib));
        if (ended) state.live = false;
      }
    } else {
      // the two threads of a pixel decide 16 entries each (the decisions do
      // not depend on one another) and park alpha, or 0, in the weight's
      // slot; half 0 then walks the counting ones in list order
      if (half == 1 && i > 0) state.live = s_live[pl] != 0;
      if (__any_sync(FULL, state.live)) {
        for (int k = half * (CHUNK / 2); k < min(kn, (half + 1) * (CHUNK / 2));
             ++k) {
          float alpha;
          const bool counts = state.live &&
                              entry_alpha<MM>(s_geom, k, px, py, mono, alpha);
          w_col[(size_t)k * ps] = counts ? alpha : 0.f;
        }
      }
      __syncthreads();
      if (half == 0) {
        if (__any_sync(FULL, state.live)) {
          float cum = 0.f, cum_contrib = 0.f;
          bool ended = false;
          for (int k = 0; k < kn; ++k) {
            // a counting pair has alpha >= 1/255
            const float alpha = w_col[(size_t)k * ps];
            if (alpha > 0.f)
              w_col[(size_t)k * ps] = take_entry(s_geom, k, base + k, alpha,
                                                 state, cum, cum_contrib,
                                                 ended, took);
          }
          for (int k = kn; k < round_up(kn, 8); ++k)
            w_col[(size_t)k * ps] = 0.f;
          state.trans = __fmul_rn(state.trans, expf(cum_contrib));
          if (ended) state.live = false;
        }
        s_live[pl] = state.live;
      }
    }
    // entries some pixel of each 16-pixel half of the warp took
    unsigned took_half[2] = {__reduce_or_sync(FULL, li < 16 ? took : 0u),
                             __reduce_or_sync(FULL, li < 16 ? 0u : took)};
    if constexpr (H == 2) {
      if (half == 0 && li == 0) {
        s_took[2 * pw] = took_half[0];
        s_took[2 * pw + 1] = took_half[1];
      }
    }

    if constexpr (NT > 0) {
      // this chunk's feature rows have arrived, for every thread's copies
      f3dgs::cp_async_wait<0>();
      __syncthreads();
      if (i + 1 < n_chunks)
        stage_features(a.feat, a.f_dim, group * FGB, FGB, FS,
                       s_gid_all + (st ^ 1) * CHUNK,
                       s_feat + (st ^ 1) * CHUNK * FS);
      f3dgs::cp_async_commit();
      if constexpr (H == 2) {
        took_half[0] = s_took[2 * pw];
        took_half[1] = s_took[2 * pw + 1];
      }

      const float* fb = s_feat + st * CHUNK * FS + half * FG;
      const float* wb = s_w + pw * WARP;
      constexpr int NB = NT < 4 ? NT : 4;  // column tiles multiplied at once
#pragma unroll
      for (int s = 0; s < CHUNK / 8; ++s) {
        // a step of 8 entries adds nothing to a half none of whose pixels
        // took one of them (dead pixels, mostly)
        const bool run[2] = {((took_half[0] >> (8 * s)) & 0xffu) != 0,
                             ((took_half[1] >> (8 * s)) & 0xffu) != 0};
        if (!run[0] && !run[1]) continue;
        const int k0 = 8 * s + fg_col;
#pragma unroll
        for (int nb = 0; nb < NT; nb += NB) {
          uint32_t b_hi[NB][2], b_lo[NB][2];
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const float* fp = fb + k0 * FS + (nb + j) * 8 + fg_row;
            f3dgs::tf32_split(fp[0], b_hi[j][0], b_lo[j][0]);
            f3dgs::tf32_split(fp[4 * FS], b_hi[j][1], b_lo[j][1]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (!run[mt]) continue;
            uint32_t a_hi[4], a_lo[4];
            const float* wp = wb + (size_t)k0 * ps + mt * 16 + fg_row;
            f3dgs::tf32_split(wp[0], a_hi[0], a_lo[0]);
            f3dgs::tf32_split(wp[8], a_hi[1], a_lo[1]);
            f3dgs::tf32_split(wp[4 * ps], a_hi[2], a_lo[2]);
            f3dgs::tf32_split(wp[4 * ps + 8], a_hi[3], a_lo[3]);
            f3dgs::mma_3xtf32<NB>(&acc[mt][nb], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
    }
  }
  if constexpr (NT > 0) f3dgs::cp_async_wait<0>();

  // the feature map's only trip to device memory
  if constexpr (NT > 0) {
    float* out_f_tile = a.out_feat + (size_t)t * p_pix * a.f_dim;
    const bool pairs = (a.f_dim & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = group * FGB + half * FG + nt * 8 + 2 * fg_col;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = split * ppb + pw * WARP + mt * 16 + fg_row + 8 * h;
          if (row >= p_pix || col >= a.f_dim) continue;
          float* dst = out_f_tile + (size_t)row * a.f_dim + col;
          if (pairs) {
            *reinterpret_cast<float2*>(dst) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          } else {
            dst[0] = acc[mt][nt][2 * h];
            if (col + 1 < a.f_dim) dst[1] = acc[mt][nt][2 * h + 1];
          }
        }
      }
  }

  if (group == 0 && half == 0 && valid) {
    const size_t o = (size_t)t * p_pix + pix;
    a.out_color[3 * o] = state.r;
    a.out_color[3 * o + 1] = state.g;
    a.out_color[3 * o + 2] = state.b;
    a.out_depth[o] = state.d;
    a.out_final_t[o] = state.trans;
    a.out_ncontrib[o] = state.ncon;
  }
}

using Kernel = void (*)(const Args);

template <bool MM>
Kernel pick_kernel(int nt, int halves) {
  if (halves == 2)
    return nt == 8 ? raster_forward_kernel<MM, 8, 2> : nullptr;
  switch (nt) {
    case 0: return raster_forward_kernel<MM, 0, 1>;
    case 1: return raster_forward_kernel<MM, 1, 1>;
    case 2: return raster_forward_kernel<MM, 2, 1>;
    case 4: return raster_forward_kernel<MM, 4, 1>;
    case 8: return raster_forward_kernel<MM, 8, 1>;
    default: return nullptr;
  }
}

// The instantiation for NT channel tiles a warp, `halves` threads a pixel
// and a mode; null for shapes the kernel does not take.
Kernel pick_kernel(int threads, int nt, int halves, bool mm) {
  if (threads <= 0 || threads > MAX_THREADS || (halves != 1 && halves != 2) ||
      threads % (WARP * halves))
    return nullptr;
  return mm ? pick_kernel<true>(nt, halves) : pick_kernel<false>(nt, halves);
}

int n_groups(int f_dim, int nt, int halves) {
  return nt ? (f_dim + 8 * nt * halves - 1) / (8 * nt * halves) : 1;
}

}  // namespace

extern "C" {

int f3dgs_raster_forward_chunk() { return CHUNK; }

// Dynamic shared memory of a block of `threads` threads, `halves` a pixel,
// with nt channel tiles a warp.
size_t f3dgs_raster_forward_smem_bytes(int threads, int nt, int halves,
                                       int alpha_mm) {
  return smem_bytes(threads, nt, halves, alpha_mm != 0);
}

// out[0..2] = registers a thread, bytes of local memory a thread (spills),
// resident blocks an SM of the instantiation for these shapes.
int f3dgs_raster_forward_attributes(int threads, int nt, int halves,
                                    int alpha_mm, int* out) {
  Kernel kernel = pick_kernel(threads, nt, halves, alpha_mm != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(threads, nt, halves, alpha_mm != 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                            threads, smem);
}

const char* f3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller guarantees that every tile's list lies in gid_sorted and holds
// valid Gaussian ids (ops/cuda_raster.py:check_tile_lists), and with
// n_per_camera = N > 0 that the per-camera arrays hold N rows for every
// camera the tiles reach. nt is the number of 8-channel tiles a warp
// accumulates, halves the threads a pixel and threads the block's size
// (ops/cuda_raster.py:forward_plan); alpha_mm != 0 selects the alpha_matmul
// mode. Outputs are addressed with 64-bit offsets; n_tiles times the blocks
// a tile must fit in an int.
int f3dgs_raster_forward(const float* xy, const float* conic,
                         const float* opacity, const float* rgb,
                         const float* depth, const float* feat,
                         const int* gid_sorted, const int* tile_starts,
                         const int* tile_counts,
                         int n_tiles, int tile_base, int n_per_camera,
                         int grid_x, int grid_y,
                         int tile_w, int tile_h, int f_dim, int nt,
                         int halves, int threads, int alpha_mm,
                         float* out_color,
                         float* out_feat, float* out_depth, float* out_final_t,
                         int* out_ncontrib, void* stream) {
  const int p_pix = tile_w * tile_h;
  if (p_pix <= 0 || p_pix > MAX_PIXELS || f_dim < 0 || grid_x <= 0 ||
      grid_y <= 0 || n_per_camera < 0 || (f_dim > 0) != (nt > 0))
    return (int)cudaErrorInvalidValue;
  const bool mm = alpha_mm != 0;
  Kernel kernel = pick_kernel(threads, nt, halves, mm);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const size_t smem = smem_bytes(threads, nt, halves, mm);
  const int pixels = threads / halves;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args a = {xy, conic, opacity, rgb, depth, feat, gid_sorted,
                  tile_starts, tile_counts, tile_base, n_per_camera, grid_x,
                  grid_y, tile_w, tile_h, f_dim, n_groups(f_dim, nt, halves),
                  (p_pix + pixels - 1) / pixels, out_color, out_feat,
                  out_depth, out_final_t, out_ncontrib};
  kernel<<<n_tiles * a.n_groups * a.n_splits, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
