// Native host-side helpers for feature3dgs_tpu_torch, exposed via ctypes.
// A copy of feature3dgs_tpu/native/src/f3dgs_native.cc: both extern "C"
// functions are unchanged.
//
// 1) knn_mean_sq_dist: mean squared distance to each point's 3 nearest
//    neighbors — the setup-time scale initializer replacing the original
//    simple-knn CUDA extension (simple-knn/simple_knn.cu:185-221).
//    Algorithm: uniform-grid spatial hash with expanding-ring search (same
//    spatial-coherence idea as simple-knn's Morton boxes, on one CPU core).
//
// 2) colmap_scan_points3d: offsets/fields scan of COLMAP points3D.bin
//    (variable-length track records), the hot part of data loading for
//    multi-million-point scenes.
//
// Build: native/loader.py compiles it at first use into build/native/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Best3 {
  float d[3] = {1e30f, 1e30f, 1e30f};
  inline void offer(float v) {
    if (v < d[2]) {
      d[2] = v;
      if (d[2] < d[1]) std::swap(d[1], d[2]);
      if (d[1] < d[0]) std::swap(d[0], d[1]);
    }
  }
  inline float worst() const { return d[2]; }
  inline float mean() const { return (d[0] + d[1] + d[2]) / 3.0f; }
};

}  // namespace

extern "C" {

// pts: n x 3 float32, out: n float32 (mean of squared dists to 3 NN).
int knn_mean_sq_dist(const float* pts, int64_t n, float* out) {
  if (n <= 1) {
    for (int64_t i = 0; i < n; ++i) out[i] = 1e-6f;
    return 0;
  }
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], pts[3 * i + k]);
      hi[k] = std::max(hi[k], pts[3 * i + k]);
    }
  // grid resolution ~ cbrt(n/4) cells per axis -> ~4 points per cell
  int res = std::max(1, (int)std::cbrt((double)n / 4.0));
  res = std::min(res, 512);
  float ext[3], cell[3];
  for (int k = 0; k < 3; ++k) {
    ext[k] = std::max(hi[k] - lo[k], 1e-9f);
    cell[k] = ext[k] / res;
  }
  auto cell_of = [&](const float* p, int* c) {
    for (int k = 0; k < 3; ++k) {
      int v = (int)((p[k] - lo[k]) / cell[k]);
      c[k] = std::min(std::max(v, 0), res - 1);
    }
  };
  // counting-sort points into cells
  const int64_t ncells = (int64_t)res * res * res;
  std::vector<int32_t> counts(ncells + 1, 0);
  std::vector<int32_t> cidx(n);
  for (int64_t i = 0; i < n; ++i) {
    int c[3];
    cell_of(pts + 3 * i, c);
    cidx[i] = (c[2] * res + c[1]) * res + c[0];
    counts[cidx[i] + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) counts[c + 1] += counts[c];
  std::vector<int32_t> order(n);
  {
    std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cursor[cidx[i]]++] = (int32_t)i;
  }

  const float min_cell = std::min(cell[0], std::min(cell[1], cell[2]));
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + 3 * i;
    int c[3];
    cell_of(p, c);
    Best3 best;
    // expanding ring search: ring r covers cells at Chebyshev distance r.
    for (int r = 0;; ++r) {
      // all candidates within ring r examined; we can stop when the worst
      // of the current best-3 is closer than the nearest possible point in
      // ring r+1 (distance >= r * min_cell from the cell boundary).
      bool any_cell = false;
      int x0 = std::max(c[0] - r, 0), x1 = std::min(c[0] + r, res - 1);
      int y0 = std::max(c[1] - r, 0), y1 = std::min(c[1] + r, res - 1);
      int z0 = std::max(c[2] - r, 0), z1 = std::min(c[2] + r, res - 1);
      for (int z = z0; z <= z1; ++z)
        for (int y = y0; y <= y1; ++y)
          for (int x = x0; x <= x1; ++x) {
            // only the shell of the ring (interior was done at r-1)
            if (r > 0 && x != c[0] - r && x != c[0] + r && y != c[1] - r &&
                y != c[1] + r && z != c[2] - r && z != c[2] + r)
              continue;
            any_cell = true;
            int64_t ci = ((int64_t)z * res + y) * res + x;
            for (int32_t s = counts[ci]; s < counts[ci + 1]; ++s) {
              int32_t j = order[s];
              if (j == (int32_t)i) continue;
              const float* q = pts + 3 * j;
              float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
              best.offer(dx * dx + dy * dy + dz * dz);
            }
          }
      float safe = (float)r * min_cell;  // guaranteed covered radius
      if (best.worst() <= safe * safe) break;
      bool maxed = (x0 == 0 && y0 == 0 && z0 == 0 && x1 == res - 1 &&
                    y1 == res - 1 && z1 == res - 1);
      if (maxed) break;
      (void)any_cell;
    }
    out[i] = best.mean();
  }
  return 0;
}

// Scan COLMAP points3D.bin content (after the 8-byte count header).
// Returns 0 on success; fills xyz (n*3 f64), rgb (n*3 u8), err (n f64).
int colmap_scan_points3d(const uint8_t* data, int64_t size, int64_t n,
                         double* xyz, uint8_t* rgb, double* err) {
  int64_t off = 8;
  for (int64_t i = 0; i < n; ++i) {
    if (off + 43 + 8 > size) return 1;
    std::memcpy(xyz + 3 * i, data + off + 8, 24);
    std::memcpy(rgb + 3 * i, data + off + 32, 3);
    std::memcpy(err + i, data + off + 35, 8);
    uint64_t track_len;
    std::memcpy(&track_len, data + off + 43, 8);
    off += 51 + (int64_t)track_len * 8;
    if (off > size) return 1;
  }
  return 0;
}

}  // extern "C"
