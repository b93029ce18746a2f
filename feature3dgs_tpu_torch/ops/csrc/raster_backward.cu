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
// Slices and batches (the forward's tile_base and n_per_camera, raster_
// forward.cu): tile t of a launch is global tile tg = tile_base + t, with
// pixels at tile_x = tg % grid_x, tile_y = (tg / grid_x) % grid_y; with
// n_per_camera = N > 0 it belongs to camera b = tg / (grid_x * grid_y),
// whose xy, conic, opacity, rgb and depth are rows b * N + id of [B*N]
// arrays (64-bit offsets), while feat [N,F] is one for all cameras and read
// at row id. Everything else (the cotangents, final_T, n_contrib, the
// lists and the rows written) is indexed by t and the list positions the
// call is given, so a slice of the grid is launched with its own sub-range
// of gid_sorted and rebased starts. The per-tile arithmetic does not depend
// on either, so a slice's rows and a batched camera's rows are bit-equal to
// the rows of that camera's own full launch.
//
// What bounds it on the card: by the roofline, bytes: the pixel cotangents
// and the saved state, (F + 7) * 4 bytes a pixel, read once, and (10 + F) *
// 4 bytes written per list entry (~0.7 GB against ~9e9 operations at the
// training scene, F = 128). What the kernel spends its time on is the
// per-pair walk on the CUDA cores at 16 warps an SM (about 55% of it: the
// alpha tests, then T, S and the shuffled sums of the pairs that count)
// and the tensor-core product, which mma.sync's TF32 rate holds (three
// products an element, ~14 cycles an m16n8k8 and SM quarter). Measured on
// an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md section 6):
// 2.6 ms against a 0.21 ms bound at the 303 K-instance training scene,
// 8.2 ms against 1.01 ms at the 1.8 M-instance loop scene.
// Design:
//   * one block per tile, one thread per pixel; the tile is walked back to
//     front from its deepest contributor in chunks of 32 entries. The
//     walk's chunk stays 32 whatever is staged around it: T is rebuilt per
//     chunk exactly as the forward rounded it;
//   * S is a scalar per pixel, because S . g = sum w_j u_j: each thread
//     carries T_end, S and its pixel's cotangents in registers;
//   * every w-weighted sum over the tile's pixels is one product,
//     w [entries x pixels] . G [pixels x (F + 4)], G = [g_feat | g_color |
//     g_depth]: d feat, d rgb and d depth fall out of it. The weights of E
//     entries (E = 64: two walks; 32 where shared memory is short) are
//     staged in shared memory, then G streams through once per E entries
//     instead of once per 32;
//   * the product runs on the tensor cores as 3xTF32 (raster_common.cuh:
//     mma_3xtf32), M = entries, N = F + 4 padded to 8, K = the tile's
//     pixels in a fixed order. A warp's work item is one chunk's 32
//     entries (two 16-row blocks, so each split of a cotangent serves two
//     products) x up to 3 column tiles: 2 x 6 = 12 items at F = 128 for the
//     16 warps of a 512-pixel tile (fewer, fuller warps take fewer
//     instruction slots than 16 items of one row block x 5 tiles); wider F
//     takes more rounds over G. The epilogue writes every staged row,
//     zeros for entries no pixel took;
//   * G rows arrive through a three-stage ring filled by cp.async (16 B a
//     thread; 4 B where F is not a multiple of 4) while the previous stage
//     is multiplied, one block barrier a stage; the first two stages are
//     requested before the walk begins. The next pass's ids are requested
//     before the walk and its splat scalars before the product, by the
//     block's last E threads, which store them to shared memory only after
//     the product: nobody waits for a gather;
//   * the remaining per-entry sums over pixels (five geometric and
//     d opacity; six coefficient sums and d opacity in the alpha_matmul
//     mode) go through warp shuffles (nine a warp and entry for all the
//     columns, warp_sum_columns), then across warps in a fixed order.
//     They stay direct sums in dx, dy: regrouped over monomials they
//     cancel.
// Shared memory (floats): G ring [3][R][GS] with GS = 8 mod 32 covering
// F + 4, w[E][P + 4] (the strides spread the fragment loads over all
// banks), part[warps][32][6 or 7], geom[E/32][10 or 18][32], gid[E],
// red[32]: 199,552 bytes at P = 512, F = 128, E = 64, R = 32, so one block
// of 16 warps an SM (the design trades occupancy for streaming G half as
// often). ops/cuda_raster.py:backward_plan picks E and R.
// No atomics, no fast-math: the same inputs give the same output bits.
//
// The alpha_matmul mode (template parameter MM; the TPU kernel's
// alpha_mm=True path, pallas_raster.py:583, 671-674, 726-741): power comes
// from the forward's own coefficient dot (raster_common.cuh:alpha_coeff and
// splat_alpha_mm, so the backward re-decides each pair with the forward's
// bits in this mode too), and the five geometric sums become six sums of
// dL/dpower * (1, X, Y, X^2, XY, Y^2) over the tile's pixels (seven
// shuffled columns instead of six), followed by the chain rule from the
// coefficients back to x, y and the conic, once per entry:
//   d x = dc0 (-(a xl + b yl)) + dc1 a + dc2 b
//   d y = dc0 (-(c yl + b xl)) + dc1 b + dc2 c
//   d a = dc0 (-0.5 xl^2) + dc1 xl - 0.5 dc3
//   d b = dc0 (-xl yl) + dc1 yl + dc2 xl - dc4
//   d c = dc0 (-0.5 yl^2) + dc2 yl - 0.5 dc5

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

using f3dgs::round_up;

constexpr int CHUNK = 32;
constexpr int N_GEOM = 10;  // x, y, conic a/b/c, opacity, r, g, b, depth
constexpr int N_ROW = 10;   // d x, y, conic a/b/c, opacity, r, g, b, depth
constexpr int N_COEFF = 6;  // alpha_matmul mode: c0..c5 after the N_GEOM rows
// alpha_matmul mode: xl, yl after the coefficients
constexpr int N_GEOM_MM = N_GEOM + N_COEFF + 2;
// columns summed by shuffles: d x, y, a, b, c (alpha_matmul: dc0..dc5), then
// d opacity
constexpr int N_PART = 6;
constexpr int N_PART_MM = 7;
constexpr int WARP = 32;
constexpr int MAX_THREADS = 1024;
constexpr int STAGES = 3;  // of the ring of G rows
constexpr int UNITS = 3;   // column tiles of a warp's work item
constexpr int ROWS = 2;    // 16-entry row blocks of a work item: one chunk
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int geom_rows(bool mm) {
  return mm ? N_GEOM_MM : N_GEOM;
}
__host__ __device__ inline int part_cols(bool mm) {
  return mm ? N_PART_MM : N_PART;
}
// column tiles of G = [g_feat | g_color | g_depth], and its row stride
__host__ __device__ inline int col_tiles(int f) { return (f + 4 + 7) / 8; }
__host__ __device__ inline int g_stride(int f) {
  const int gs = 8 * col_tiles(f);
  return gs + ((8 - gs % 32) + 32) % 32;
}
__host__ __device__ inline size_t smem_bytes(int p, int f, bool mm,
                                             int entries, int ring_rows) {
  return sizeof(float) * ((size_t)STAGES * ring_rows * g_stride(f)
                          + (size_t)entries * (p + 4)
                          + (size_t)(p / WARP) * CHUNK * part_cols(mm)
                          + (size_t)(entries / CHUNK) * geom_rows(mm) * CHUNK)
         + sizeof(int) * (entries + MAX_THREADS / WARP);
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
  const float* g_color;
  const float* g_feat;
  const float* g_depth;
  const float* g_final_t;
  const float* final_t;
  const int* n_contrib;
  int tile_base, n_per_camera, grid_x, grid_y, tile_w, tile_h, f_dim, fag,
      entries, ring_rows;
  float* d_geom;
  float* d_feat;
};

// Sums each of up to eight columns v[0..7] over the warp's 32 lanes with
// nine shuffles instead of forty: lanes swap halves of their columns with
// the lane 16, 8, then 4 away and keep the half their own lane bit names,
// then the last column is summed over the lanes 2 and 1 away. On return
// v[0] of lane l is the total of column l / 4. The order of the additions is
// fixed.
__device__ __forceinline__ void warp_sum_columns(float v[8], int li) {
  {
    const bool up = li & 16;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float got = __shfl_xor_sync(FULL, up ? v[j] : v[j + 4], 16);
      v[j] = (up ? v[j + 4] : v[j]) + got;
    }
  }
  {
    const bool up = li & 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float got = __shfl_xor_sync(FULL, up ? v[j] : v[j + 2], 8);
      v[j] = (up ? v[j + 2] : v[j]) + got;
    }
  }
  {
    const bool up = li & 4;
    const float got = __shfl_xor_sync(FULL, up ? v[0] : v[1], 4);
    v[0] = (up ? v[1] : v[0]) + got;
  }
  v[0] += __shfl_xor_sync(FULL, v[0], 2);
  v[0] += __shfl_xor_sync(FULL, v[0], 1);
}

// One list entry's id and splat scalars on their way to shared memory.
struct Entry {
  int g;
  float v[N_GEOM];
};

// The first row of this block's camera in xy, conic, opacity, rgb and
// depth (0 unbatched). Computed where it is used, from the launch's
// constants, so that it holds no register through the walk.
__device__ __forceinline__ size_t camera_row0(const Args& a) {
  return (size_t)((a.tile_base + (int)blockIdx.x) / (a.grid_x * a.grid_y)) *
         a.n_per_camera;
}

// Request the scalars of Gaussian g (an empty entry when !ok): the
// camera's row of it; the id, which addresses feat, is kept as it is. The
// loads are only waited for where store_entry uses them.
__device__ __forceinline__ void load_entry(const Args& a, int g, bool ok,
                                           Entry& e) {
  e.g = g;
  const size_t r = camera_row0(a) + g;
  e.v[0] = ok ? a.xy[2 * r] : 0.f;
  e.v[1] = ok ? a.xy[2 * r + 1] : 0.f;
  e.v[2] = ok ? a.conic[3 * r] : 0.f;
  e.v[3] = ok ? a.conic[3 * r + 1] : 0.f;
  e.v[4] = ok ? a.conic[3 * r + 2] : 0.f;
  // opacity 0 never reaches ALPHA_MIN: empty entries never count
  e.v[5] = ok ? a.opacity[r] : 0.f;
  e.v[6] = ok ? a.rgb[3 * r] : 0.f;
  e.v[7] = ok ? a.rgb[3 * r + 1] : 0.f;
  e.v[8] = ok ? a.rgb[3 * r + 2] : 0.f;
  e.v[9] = ok ? a.depth[r] : 0.f;
}

// Stage entry e as row k of its chunk's slot.
template <bool MM>
__device__ __forceinline__ void store_entry(const Entry& e, int k, float ox,
                                            float oy, int* s_gid,
                                            float* s_geom) {
  s_gid[k] = e.g;
#pragma unroll
  for (int j = 0; j < N_GEOM; ++j) s_geom[j * CHUNK + k] = e.v[j];
  if constexpr (MM) {
    float xl, yl, c[N_COEFF];
    f3dgs::alpha_coeff(e.v[0], e.v[1], e.v[2], e.v[3], e.v[4], ox, oy, xl, yl,
                       c);
#pragma unroll
    for (int j = 0; j < N_COEFF; ++j) s_geom[(N_GEOM + j) * CHUNK + k] = c[j];
    s_geom[(N_GEOM + N_COEFF) * CHUNK + k] = xl;
    s_geom[(N_GEOM + N_COEFF + 1) * CHUNK + k] = yl;
  }
}

// Start the copies of G rows [row0, row0 + rows) of the tile into one ring
// stage dst[rows][gs]: g_feat, then g_color and g_depth. Whole block.
__device__ __forceinline__ void stage_g(const Args& a, size_t tile_px,
                                        int row0, int rows, int gs,
                                        float* dst) {
  const int f = a.f_dim;
  const float* gf = a.g_feat + (tile_px + row0) * f;
  if ((f & 3) == 0) {
    const int q = f / 4;
    for (int e = threadIdx.x; e < rows * q; e += blockDim.x) {
      const int r = e / q;
      const int c = (e - r * q) * 4;
      f3dgs::cp_async16(dst + r * gs + c, gf + (size_t)r * f + c, true);
    }
  } else {
    for (int e = threadIdx.x; e < rows * f; e += blockDim.x) {
      const int r = e / f;
      const int c = e - r * f;
      f3dgs::cp_async4(dst + r * gs + c, gf + (size_t)r * f + c, true);
    }
  }
  for (int e = threadIdx.x; e < rows * 4; e += blockDim.x) {
    const int r = e / 4;
    const int c = e - r * 4;
    const size_t px = tile_px + row0 + r;
    f3dgs::cp_async4(dst + r * gs + f + c,
                     c < 3 ? a.g_color + 3 * px + c : a.g_depth + px, true);
  }
}

template <bool MM, int MAXT>
__global__ void __launch_bounds__(MAXT) raster_backward_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p_pix = a.tile_w * a.tile_h;
  const int n_warps = p_pix / WARP;
  const int f_dim = a.f_dim;
  const int gs = g_stride(f_dim);
  const int ps = p_pix + 4;
  constexpr int NP = MM ? N_PART_MM : N_PART;
  const int slots = a.entries / CHUNK;
  float* s_g = reinterpret_cast<float*>(smem_raw);
  float* s_w = s_g + (size_t)STAGES * a.ring_rows * gs;
  float* s_part = s_w + (size_t)a.entries * ps;
  float* s_geom_all = s_part + (size_t)n_warps * CHUNK * NP;
  int* s_gid_all =
      reinterpret_cast<int*>(s_geom_all + slots * geom_rows(MM) * CHUNK);
  int* s_red = s_gid_all + a.entries;

  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane / WARP;
  const int li = lane % WARP;
  const int fg_row = li >> 2;  // the mma fragments' g
  const int fg_col = li & 3;   // and t
  const int tg = a.tile_base + t;
  const int tile_x = tg % a.grid_x;
  const int tile_y = (tg / a.grid_x) % a.grid_y;
  const float px = (float)(tile_x * a.tile_w + lane % a.tile_w);
  const float py = (float)(tile_y * a.tile_h + lane / a.tile_w);
  // alpha_matmul mode: the tile's first pixel and this pixel's monomials
  const float ox = (float)(tile_x * a.tile_w);
  const float oy = (float)(tile_y * a.tile_h);
  const f3dgs::PixelMonomials mono((float)(lane % a.tile_w),
                                   (float)(lane / a.tile_w));

  // the caller guarantees that [start, start + count) lies in gid_sorted
  // and holds valid Gaussian ids (the forward's wrapper checked them)
  const int start = a.tile_starts[t];
  const int count = a.tile_counts[t];
  const int* list = a.gid_sorted + start;
  const size_t tile_px = (size_t)t * p_pix;
  const size_t o = tile_px + lane;
  const int ncon = a.n_contrib[o];
  const float gr = a.g_color[3 * o], gg = a.g_color[3 * o + 1],
              gb = a.g_color[3 * o + 2], gd = a.g_depth[o];
  const float* g_feat_px = a.g_feat + o * f_dim;
  float t_end = a.final_t[o];
  float suffix = a.g_final_t[o] * t_end;  // S: g_finalT * final_T + sum w u

  // the tile's deepest contributor bounds the walk
  const int wmax = __reduce_max_sync(FULL, ncon);
  if (li == 0) s_red[warp] = wmax;
  __syncthreads();
  int nmax = 0;
  for (int i = 0; i < n_warps; ++i) nmax = max(nmax, s_red[i]);
  nmax = min(nmax, count);

  // rows past the deepest contributor carry no gradient
  for (size_t e = lane; e < (size_t)(count - nmax) * N_ROW; e += blockDim.x)
    a.d_geom[(size_t)(start + nmax) * N_ROW + e] = 0.f;
  for (size_t e = lane; e < (size_t)(count - nmax) * f_dim; e += blockDim.x)
    a.d_feat[(size_t)(start + nmax) * f_dim + e] = 0.f;

  // the product's work items: (16-entry row block, batch of column tiles)
  const int n_ct = col_tiles(f_dim);
  const int n_batches = (n_ct + UNITS - 1) / UNITS;
  const int per_batch = (n_ct + n_batches - 1) / n_batches;
  const int n_items = slots * n_batches;
  const int n_stages = p_pix / a.ring_rows;
  // staged row e of the pass that ends at chunk hi: its list position, or
  // -1 for a row that stays empty
  auto staged_pos = [&](int hi, int e) {
    const int pos = max(hi - slots + 1, 0) * CHUNK + e;
    return (hi >= 0 && e >= 0 && e < a.entries &&
            pos < min(nmax, (hi + 1) * CHUNK)) ? pos : -1;
  };
  const int geom_slot = geom_rows(MM) * CHUNK;

  const int n_chunks = (nmax + CHUNK - 1) / CHUNK;
  int c_hi = n_chunks - 1;
  if (c_hi >= 0 && lane < a.entries) {
    const int pos = staged_pos(c_hi, lane);
    Entry e;
    load_entry(a, pos >= 0 ? list[pos] : 0, pos >= 0, e);
    store_entry<MM>(e, lane % CHUNK, ox, oy,
                    s_gid_all + lane / CHUNK * CHUNK,
                    s_geom_all + lane / CHUNK * geom_slot);
  }
  __syncthreads();
  // row of the next pass that this thread stages while the product runs
  // (the block's last `entries` threads), or negative
  const int my_row = lane - (p_pix - a.entries);

  while (c_hi >= 0) {
    const int c_lo = max(c_hi - slots + 1, 0);
    const int base_e = c_lo * CHUNK;  // list position of staged row 0
    // the next pass's ids set out now, its scalars after the walk, and both
    // land in shared memory after the product: no one waits for them
    const int next_hi = c_lo - 1;
    const int next_pos = staged_pos(next_hi, my_row);
    const int next_g = next_pos >= 0 ? list[next_pos] : 0;
    // the ring's first two stages travel while the walk runs
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_stages)
        stage_g(a, tile_px, s * a.ring_rows, a.ring_rows, gs,
                s_g + (size_t)s * a.ring_rows * gs);
      f3dgs::cp_async_commit();
    }

    for (int c = c_hi; c >= c_lo; --c) {
      const int slot = c - c_lo;
      const int base = c * CHUNK;
      const int kn = min(CHUNK, nmax - base);
      const float* s_geom = s_geom_all + slot * geom_rows(MM) * CHUNK;
      const int* s_gid = s_gid_all + slot * CHUNK;
      float* w_rows = s_w + (size_t)slot * CHUNK * ps;
      float rc = 0.f;  // sum of log1p(-alpha) over this chunk's entries >= k
      for (int k = kn - 1; k >= 0; --k) {
        const float ca = s_geom[2 * CHUNK + k];
        const float cb = s_geom[3 * CHUNK + k];
        const float cc = s_geom[4 * CHUNK + k];
        const float op = s_geom[5 * CHUNK + k];
        float dx, dy, gexp, alpha;
        bool m;
        if constexpr (MM) {
          m = f3dgs::splat_alpha_mm(s_geom + N_GEOM * CHUNK, CHUNK, k, op,
                                    mono, gexp, alpha);
        } else {
          m = f3dgs::splat_alpha(s_geom[0 * CHUNK + k], s_geom[1 * CHUNK + k],
                                 ca, cb, cc, op, px, py, dx, dy, gexp, alpha);
        }
        m = m && base + k < ncon;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
        float w = 0.f;
        if (m) {
          rc += log1pf(-alpha);
          const float t_before = t_end * expf(-rc);
          w = alpha * t_before;
          float u = s_geom[6 * CHUNK + k] * gr + s_geom[7 * CHUNK + k] * gg
                    + s_geom[8 * CHUNK + k] * gb + s_geom[9 * CHUNK + k] * gd;
          if (a.fag) {
            const float* fk = a.feat + (size_t)s_gid[k] * f_dim;
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
          v[NP - 1] = d_op;
        }
        w_rows[(size_t)k * ps + lane] = w;
        float* part = s_part + ((size_t)warp * CHUNK + k) * NP;
        if (__any_sync(FULL, m)) {
          warp_sum_columns(v, li);
          if ((li & 3) == 0 && (li >> 2) < NP) part[li >> 2] = v[0];
        } else if (li < NP) {
          part[li] = 0.f;
        }
      }
      t_end *= expf(-rc);
      __syncthreads();

      // per-entry sums across warps, in warp order: columns 0..5 of the row
      float* geom_chunk = a.d_geom + (size_t)(start + base) * N_ROW;
      if constexpr (MM) {
        // each (entry, column) sum lands in warp 0's slot, which only the
        // thread that summed it has read
        for (int e = lane; e < kn * NP; e += blockDim.x) {
          const int k = e / NP;
          const int j = e - k * NP;
          float s = 0.f;
          for (int wp = 0; wp < n_warps; ++wp)
            s += s_part[((size_t)wp * CHUNK + k) * NP + j];
          s_part[(size_t)k * NP + j] = s;
        }
        __syncthreads();
        // the chain rule from the coefficients to x, y and the conic
        for (int k = lane; k < kn; k += blockDim.x) {
          const float* dc = s_part + (size_t)k * NP;
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
          row[5] = dc[6];
        }
      } else {
        for (int e = lane; e < kn * NP; e += blockDim.x) {
          const int k = e / NP;
          const int j = e - k * NP;
          float s = 0.f;
          for (int wp = 0; wp < n_warps; ++wp)
            s += s_part[((size_t)wp * CHUNK + k) * NP + j];
          geom_chunk[(size_t)k * N_ROW + j] = s;
        }
      }
      __syncthreads();  // before the next walk overwrites the partial sums
    }

    Entry next;
    if (next_hi >= 0 && my_row >= 0)
      load_entry(a, next_g, next_pos >= 0, next);

    // d feat, d rgb, d depth of the staged entries: w . G on the tensor
    // cores, G streaming through the ring once per round of work items
    const int rows_staged = (c_hi - c_lo + 1) * CHUNK;
    for (int item0 = 0; item0 < n_items; item0 += n_warps) {
      if (item0 > 0) {
        __syncthreads();  // the previous round has left the ring
        for (int s = 0; s < STAGES - 1; ++s) {
          if (s < n_stages)
            stage_g(a, tile_px, s * a.ring_rows, a.ring_rows, gs,
                    s_g + (size_t)s * a.ring_rows * gs);
          f3dgs::cp_async_commit();
        }
      }
      const int item = item0 + warp;
      const int slot = item % slots;  // the chunk whose 32 entries it owns
      const int ct0 = (item / slots) * per_batch;
      // column tiles of this warp's item; none if it has no item this round
      // or its chunk is not staged in this pass
      const int n_mine = (item < n_items && slot * CHUNK < rows_staged)
                             ? max(min(per_batch, n_ct - ct0), 0) : 0;
      float acc[ROWS][UNITS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < UNITS; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][j][q] = 0.f;

      for (int s = 0; s < n_stages; ++s) {
        f3dgs::cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage s has arrived; stage s - 1 is consumed
        const int ahead = s + STAGES - 1;
        if (ahead < n_stages)
          stage_g(a, tile_px, ahead * a.ring_rows, a.ring_rows, gs,
                  s_g + (size_t)(ahead % STAGES) * a.ring_rows * gs);
        f3dgs::cp_async_commit();
        if (n_mine == 0) continue;
        const float* gbuf = s_g + (size_t)(s % STAGES) * a.ring_rows * gs;
        const float* wrow =
            s_w + (size_t)(slot * CHUNK + fg_row) * ps + s * a.ring_rows
            + fg_col;
        for (int ks = 0; ks < a.ring_rows / 8; ++ks) {
          uint32_t a_hi[ROWS][4], a_lo[ROWS][4];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float* wp = wrow + (size_t)r * 16 * ps + ks * 8;
            f3dgs::tf32_split(wp[0], a_hi[r][0], a_lo[r][0]);
            f3dgs::tf32_split(wp[8 * ps], a_hi[r][1], a_lo[r][1]);
            f3dgs::tf32_split(wp[4], a_hi[r][2], a_lo[r][2]);
            f3dgs::tf32_split(wp[8 * ps + 4], a_hi[r][3], a_lo[r][3]);
          }
          const float* gp = gbuf + (size_t)(ks * 8 + fg_col) * gs + ct0 * 8
                            + fg_row;
          uint32_t b_hi[UNITS][2], b_lo[UNITS][2];
#pragma unroll
          for (int j = 0; j < UNITS; ++j) {
            // tiles past this warp's batch read a neighbour's finite columns
            // and are never stored
            const int jj = j < n_mine ? j : 0;
            f3dgs::tf32_split(gp[jj * 8], b_hi[j][0], b_lo[j][0]);
            f3dgs::tf32_split(gp[jj * 8 + 4 * gs], b_hi[j][1], b_lo[j][1]);
          }
          // each split of a cotangent serves both row blocks
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            f3dgs::mma_3xtf32<UNITS>(acc[r], a_hi[r], a_lo[r], b_hi, b_lo);
        }
      }

      // every staged row up to the deepest contributor is written here
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < UNITS; ++j) {
          if (j >= n_mine) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int entry =
                base_e + slot * CHUNK + r * 16 + fg_row + 8 * (q >> 1);
            const int col = (ct0 + j) * 8 + 2 * fg_col + (q & 1);
            if (entry >= nmax) continue;
            if (col < f_dim)
              a.d_feat[(size_t)(start + entry) * f_dim + col] = acc[r][j][q];
            else if (col < f_dim + 4)
              a.d_geom[(size_t)(start + entry) * N_ROW + 6 + col - f_dim] =
                  acc[r][j][q];
          }
        }
    }
    // the walks and the chain rule are done with the staged scalars
    if (next_hi >= 0 && my_row >= 0)
      store_entry<MM>(next, my_row % CHUNK, ox, oy,
                      s_gid_all + my_row / CHUNK * CHUNK,
                      s_geom_all + my_row / CHUNK * geom_slot);
    __syncthreads();  // the ring and the weights are free, the scalars staged
    c_hi = next_hi;
  }
  f3dgs::cp_async_wait<0>();
}

using Kernel = void (*)(const Args);

Kernel pick_kernel(int p_pix, bool mm) {
  if (p_pix > 512)
    return mm ? raster_backward_kernel<true, 1024>
              : raster_backward_kernel<false, 1024>;
  return mm ? raster_backward_kernel<true, 512>
            : raster_backward_kernel<false, 512>;
}

bool plan_ok(int p_pix, int entries, int ring_rows) {
  return (entries == 32 || entries == 64) &&
         (ring_rows == 8 || ring_rows == 16 || ring_rows == 32) &&
         p_pix % ring_rows == 0 && entries <= p_pix;
}

}  // namespace

extern "C" {

int f3dgs_raster_backward_chunk() { return CHUNK; }

// Dynamic shared memory of a block that stages `entries` list entries and
// `ring_rows` cotangent rows a ring stage.
size_t f3dgs_raster_backward_smem_bytes(int p_pix, int f_dim, int alpha_mm,
                                        int entries, int ring_rows) {
  return smem_bytes(p_pix, f_dim, alpha_mm != 0, entries, ring_rows);
}

// out[0..2] = registers a thread, bytes of local memory a thread (spills),
// resident blocks an SM of the instantiation for these shapes.
int f3dgs_raster_backward_attributes(int p_pix, int f_dim, int alpha_mm,
                                     int entries, int ring_rows, int* out) {
  if (p_pix <= 0 || p_pix > MAX_THREADS || p_pix % WARP != 0 ||
      !plan_ok(p_pix, entries, ring_rows))
    return (int)cudaErrorInvalidValue;
  Kernel kernel = pick_kernel(p_pix, alpha_mm != 0);
  const size_t smem =
      smem_bytes(p_pix, f_dim, alpha_mm != 0, entries, ring_rows);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                            p_pix, smem);
}

const char* f3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched). The
// caller guarantees that every tile's list lies in gid_sorted and holds
// valid Gaussian ids, and with n_per_camera = N > 0 that the per-camera
// arrays hold N rows for every camera the tiles tile_base .. tile_base +
// n_tiles reach; rows of gid_sorted that no tile's list covers are left
// unwritten. alpha_mm != 0 selects the alpha_matmul mode, which must be the
// mode of the forward that produced final_t and n_contrib. entries and
// ring_rows come from ops/cuda_raster.py:backward_plan.
int f3dgs_raster_backward(const float* xy, const float* conic,
                          const float* opacity, const float* rgb,
                          const float* depth, const float* feat,
                          const int* gid_sorted, const int* tile_starts,
                          const int* tile_counts, const float* g_color,
                          const float* g_feat, const float* g_depth,
                          const float* g_final_t, const float* final_t,
                          const int* n_contrib, int n_tiles, int tile_base,
                          int n_per_camera, int grid_x, int grid_y,
                          int tile_w, int tile_h, int f_dim, int fag,
                          int alpha_mm, int entries, int ring_rows,
                          float* d_geom, float* d_feat, void* stream) {
  const int p_pix = tile_w * tile_h;
  if (p_pix <= 0 || p_pix > MAX_THREADS || p_pix % WARP != 0 || f_dim < 0 ||
      grid_x <= 0 || grid_y <= 0 || tile_base < 0 || n_per_camera < 0 ||
      !plan_ok(p_pix, entries, ring_rows))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const bool mm = alpha_mm != 0;
  const size_t smem = smem_bytes(p_pix, f_dim, mm, entries, ring_rows);
  Kernel kernel = pick_kernel(p_pix, mm);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args a = {xy, conic, opacity, rgb, depth, feat, gid_sorted,
                  tile_starts, tile_counts, g_color, g_feat, g_depth,
                  g_final_t, final_t, n_contrib, tile_base, n_per_camera,
                  grid_x, grid_y, tile_w, tile_h, f_dim, fag, entries,
                  ring_rows, d_geom, d_feat};
  kernel<<<n_tiles, p_pix, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
