// The segment-sum of the compositing backward for NVIDIA Hopper (sm_90a),
// plain C interface: per-entry gradient rows -> per-Gaussian sums.
//
// Replaces the jax.ops.segment_sum in feature3dgs_tpu/ops/pallas_raster.py:
// _cp_bwd, which XLA fuses into the backward's output; there is no Pallas
// kernel. The backward kernel writes one row per entry of gid_sorted (tile
// order); ops/segment.py:SegmentPlan sorts the ids stably once a backward
// (`order`, the entries grouped by Gaussian, tile order kept inside a group)
// and finds each Gaussian's group in it (`bounds`, [N + 1]). In PyTorch the
// sum was rows[order] (a full copy of the rows in Gaussian order) and then
// torch.segment_reduce over the copy, once for each row array. This kernel
// reads each row where the backward left it, through order[bounds[g] :
// bounds[g + 1]], and writes out[g]: nothing is gathered first, and where
// the two row arrays share the plan one launch sums both. The wrapper is
// ops/cuda_segment.py; the plain version it is held to, bit for bit on the
// card, is SegmentPlan.sums' torch.segment_reduce(rows[order], "sum",
// lengths=...).
//
// Same bits as the plain version: ATen's 2-D segment_reduce kernel gives a
// thread one (Gaussian, channel) and adds the group's values to 0 one after
// another in plan order. Here a lane does the same for its channels, with
// __fadd_rn from 0.0f, in the same order: rows may be loaded ahead, in any
// order, but they are added in order. No atomics, and no segment is split,
// so every run gives the same bits. A Gaussian with no entry gets zeros.
//
// What bounds it on the card: bytes. Each row is read once, the [N, C] sums
// written once, order and bounds read once. At the training cells (1 M
// Gaussians, ~5.48 M entries a view, both row arrays: the feature rows and
// the 10 geometric channels) that is ~13.6 GB at F = 512 and ~3.7 GB at
// F = 128: 4.07 / 1.10 ms at 3.35 TB/s. The plain version read and wrote
// the rows once more for the copy and read the copy again. On an H100
// (700 W), on a bench step's rows (F = 128 / 512): 1.42 / 4.73 ms against
// bounds of 1.07 / 3.96, bit-equal; the plain version 5.14 / 13.36. What
// stands in the way is latency: a Gaussian has ~5.5 entries, and its rows
// can only be asked for once its bounds and then its indices have arrived.
// A team that sums one Gaussian waits out those two round trips for ~5.5
// rows (at C = 10, 220 bytes), and too few teams fit on the card to cover
// them. Design:
//   * a team of lanes along the channels of the wider array: 16 bytes a
//     lane (float4) when C % 4 == 0 and the rows are 16-byte aligned, else
//     4. The wrapper takes the team from C and the alignment
//     (ops/cuda_segment.py:team_plan): a whole warp where a row has 32
//     vectors or more (F = 128: one float4 a lane; F = 512: four), fewer
//     lanes for narrow rows (C = 10: 16 lanes, a float each). Rows wider
//     than 4 vectors a lane take more passes;
//   * a second array of no more channels than the team has lanes (the 10
//     geometric channels beside F >= 64 feature channels) rides along: its
//     rows are loaded with the first array's, a float a lane, and summed in
//     the same walk. Its 40-byte rows cost more in DRAM accesses than in
//     bytes, and in a launch of their own they took ~0.33 ms against a
//     ~0.09 ms bound at the training cells; riding along, they add less;
//   * a team takes as many consecutive Gaussians as it has lanes and walks
//     their entries, one contiguous range of the plan, in order: lane k
//     holds Gaussian k's end (one coalesced load of bounds), a running sum
//     is stored where the walk crosses an end, and the rows stream across
//     the Gaussians' boundaries, so the round trips for bounds and indices
//     are paid once a team and not once a Gaussian;
//   * the team reads one index a lane of the walk in one coalesced load,
//     a chunk ahead of its use, and hands them round with __shfl_sync over
//     the team's lanes;
//   * a team loads 4 rows (2 at four vectors a lane) before it adds them;
//   * rows are read once: non-caching read-only loads
//     (ld.global.nc.L1::no_allocate); the sums are stored streaming
//     (__stcs). Offsets into the plan are 32-bit (the wrapper holds L and
//     N under 2^30).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load_once(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 load_once(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ void zero(float* v) { *v = 0.0f; }
__device__ __forceinline__ void zero(float4* v) {
  *v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

struct Args {
  const float* rows;  // [L, nvec] vectors of the kernel's type
  float* out;         // [n_gauss, nvec]
  int nvec;
  const float* rows2;  // [L, c2] floats, c2 <= lanes (0: no second array)
  float* out2;         // [n_gauss, c2]
  int c2;
  const long long* order;   // [L] row indices, grouped by Gaussian
  const long long* bounds;  // [n_gauss + 1] where each group starts
  int n_gauss;
  int lanes_log2;
};

// Stores Gaussian k's sums (vectors of the first array at dst + k * nvec,
// s * lanes apart; the second array's channel at dst2 + k * c2 where two)
// and starts the next from 0.
template <typename V, int PER_LANE>
__device__ __forceinline__ void flush(V (&acc)[PER_LANE], float& acc2,
                                      V* dst, float* dst2, int k,
                                      const Args& a, int v0, int lane,
                                      int lanes, bool two) {
#pragma unroll
  for (int s = 0; s < PER_LANE; ++s) {
    if (v0 + lane + s * lanes < a.nvec)
      __stcs(dst + static_cast<long long>(k) * a.nvec + s * lanes, acc[s]);
    zero(&acc[s]);
  }
  if (two) __stcs(dst2 + static_cast<long long>(k) * a.c2, acc2);
  acc2 = 0.0f;
}

// A team of lanes = 1 << lanes_log2 lanes takes the Gaussians g0 .. g0 +
// lanes - 1 and walks their entries order[bounds[g0] .. bounds[g0 +
// lanes]) in plan order, PER_LANE vectors V a lane a pass: it adds each row
// into the running sum and, where an entry starts the next Gaussian,
// stores the sum and starts again from 0 (a Gaussian with no entry gets
// zeros). In the first pass lane c < c2 does the same for channel c of the
// second array.
template <typename V, int PER_LANE>
__global__ void __launch_bounds__(THREADS) segment_sum_kernel(const Args a) {
  // rows loaded before they are added: 4, or 2 at four vectors a lane
  // (more left ptxas spilling, and ran no faster at the training cells)
  constexpr int ROWS = PER_LANE == 4 ? 2 : 4;
  const int lanes = 1 << a.lanes_log2;
  const int g0 = (static_cast<int>(blockIdx.x) * THREADS +
                  static_cast<int>(threadIdx.x)) & ~(lanes - 1);
  if (g0 >= a.n_gauss) return;  // whole teams leave together
  const int lane = threadIdx.x & (lanes - 1);
  const unsigned team =
      lanes == 32 ? 0xffffffffu
                  : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  const int gn = min(lanes, a.n_gauss - g0);
  // lane k holds where Gaussian g0 + k's entries end
  const int my_end =
      lane < gn ? static_cast<int>(__ldg(a.bounds + g0 + lane + 1)) : 0;
  const int begin = static_cast<int>(__ldg(a.bounds + g0));
  const int stop = __shfl_sync(team, my_end, gn - 1, lanes);
  const V* rows = reinterpret_cast<const V*>(a.rows);
  for (int v0 = 0; v0 < a.nvec; v0 += lanes * PER_LANE) {
    const bool two = v0 == 0 && lane < a.c2;
    V* dst = reinterpret_cast<V*>(a.out) +
             static_cast<long long>(g0) * a.nvec + v0 + lane;
    float* dst2 = two ? a.out2 + static_cast<long long>(g0) * a.c2 + lane
                      : nullptr;
    V acc[PER_LANE];
    float acc2 = 0.0f;
#pragma unroll
    for (int s = 0; s < PER_LANE; ++s) zero(&acc[s]);
    int k = 0;  // the Gaussian whose entries come next
    int end_k = __shfl_sync(team, my_end, 0, lanes);
    // the row indices of the walk's next `lanes` entries, one a lane,
    // loaded a chunk ahead of their use
    int mine = begin + lane < stop
                   ? static_cast<int>(__ldg(a.order + begin + lane))
                   : 0;
    for (int base = begin; base < stop; base += lanes) {
      const int n = min(lanes, stop - base);
      const int ahead = base + lanes + lane;
      const int next =
          ahead < stop ? static_cast<int>(__ldg(a.order + ahead)) : 0;
      for (int j = 0; j < n; j += ROWS) {
        V x[ROWS][PER_LANE];
        float y[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int row = __shfl_sync(team, mine, j + r, lanes);
          if (j + r < n) {
            const V* src = rows + static_cast<long long>(row) * a.nvec + v0 +
                           lane;
#pragma unroll
            for (int s = 0; s < PER_LANE; ++s)
              if (v0 + lane + s * lanes < a.nvec)
                x[r][s] = load_once(src + s * lanes);
            if (two)
              y[r] = load_once(a.rows2 + static_cast<long long>(row) * a.c2 +
                               lane);
          }
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (j + r < n) {
            // entry base + j + r is past Gaussian k's end: k is summed
            while (base + j + r >= end_k) {
              flush(acc, acc2, dst, dst2, k, a, v0, lane, lanes, two);
              ++k;
              end_k = __shfl_sync(team, my_end, k, lanes);
            }
#pragma unroll
            for (int s = 0; s < PER_LANE; ++s)
              if (v0 + lane + s * lanes < a.nvec)
                acc[s] = add(acc[s], x[r][s]);
            if (two) acc2 = add(acc2, y[r]);
          }
        }
      }
      mine = next;
    }
    // the last Gaussian with entries, and any empty ones after it
    for (; k < gn; ++k)
      flush(acc, acc2, dst, dst2, k, a, v0, lane, lanes, two);
  }
}

template <typename V, int PER_LANE>
int launch(const Args& a, cudaStream_t stream) {
  // a team takes as many Gaussians as it has lanes: one thread a Gaussian
  const unsigned int blocks =
      static_cast<unsigned int>((a.n_gauss + THREADS - 1) / THREADS);
  segment_sum_kernel<V, PER_LANE><<<blocks, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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

int f3dgs_segment_threads() { return THREADS; }

// out[0..2] = registers a thread, local (spill) bytes a thread, resident
// blocks an SM, of the instantiation on float4 (vec4 = 1) or float
// (vec4 = 0) vectors, per_lane (1, 2 or 4) vectors a lane.
int f3dgs_segment_attributes(int vec4, int per_lane, int* out) {
  switch (per_lane * 2 + (vec4 ? 1 : 0)) {
    case 2: return attributes_of(segment_sum_kernel<float, 1>, out);
    case 3: return attributes_of(segment_sum_kernel<float4, 1>, out);
    case 4: return attributes_of(segment_sum_kernel<float, 2>, out);
    case 5: return attributes_of(segment_sum_kernel<float4, 2>, out);
    case 8: return attributes_of(segment_sum_kernel<float, 4>, out);
    case 9: return attributes_of(segment_sum_kernel<float4, 4>, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// rows [L, channels] -> out [n_gauss, channels], and rows2 [L, channels2]
// -> out2 [n_gauss, channels2] in the same launch (channels2 = 0: none):
// out[g] = the sum of rows order[bounds[g]] .. order[bounds[g + 1] - 1],
// added in that order, on `stream`. order [L] holds row indices in [0, L)
// and bounds [n_gauss + 1] is non-decreasing within [0, L] (SegmentPlan's;
// L < 2^30). A team of 1 << lanes_log2 lanes takes per_lane vectors a lane
// of rows, on float4 vectors (vec4 = 1; rows and out 16-byte aligned,
// channels % 4 == 0) or floats, and channels2 <= its lanes. Returns
// cudaGetLastError() (0 = launched) or cudaErrorInvalidValue for a plan
// the kernel does not take.
int f3dgs_segment_sum(const long long* order, const long long* bounds,
                      int n_gauss, const float* rows, float* out,
                      int channels, int vec4, int lanes_log2, int per_lane,
                      const float* rows2, float* out2, int channels2,
                      cudaStream_t stream) {
  if (n_gauss < 0 || channels <= 0 || lanes_log2 < 0 || lanes_log2 > 5 ||
      (vec4 && channels % 4 != 0) || channels2 < 0 ||
      channels2 > (1 << lanes_log2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_gauss == 0) return 0;
  const Args a{rows,   out,     vec4 ? channels / 4 : channels,
               rows2,  out2,    channels2,
               order,  bounds,  n_gauss,
               lanes_log2};
  switch (per_lane * 2 + (vec4 ? 1 : 0)) {
    case 2: return launch<float, 1>(a, stream);
    case 3: return launch<float4, 1>(a, stream);
    case 4: return launch<float, 2>(a, stream);
    case 5: return launch<float4, 2>(a, stream);
    case 8: return launch<float, 4>(a, stream);
    case 9: return launch<float4, 4>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
