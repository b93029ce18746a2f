// Adam for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package's Adam
// (feature3dgs_tpu/model/optim.py:adam_update) is elementwise code that XLA
// fuses. Run op by op in PyTorch (model/optim.py:_adam_), it took ~14 ops a
// tensor plus three torch.where and three copy_ under the trainer's
// non-finite-loss gate, each with a temporary the size of the tensor: about
// 204 bytes an element moved against 28. This kernel is the same update as
// one multi-tensor pass: one launch updates every tensor of a group (the
// seven GaussianParams fields, or the decoder's w and b), reads p, g, m and v
// once, writes p, m and v once, and allocates nothing. The wrapper is
// ops/cuda_adam.py; the plain version it is held to, bit for bit on the
// card, is model/optim.py:_adam_.
//
// Same bits as the plain version: the update is written with __fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn and __fsqrt_rn in PyTorch's op order, so
// that nvcc's default -fmad=true cannot contract a multiply and an add:
//   c1 = 1 - b1^t, c2 = 1 - b2^t, t = step + 1 as float (powf, as torch.pow);
//   m' = b1*m + (1-b1)*g;  v' = b2*v + ((1-b2)*g)*g;
//   p' = p - (lr*(m'/c1)) / (sqrt(v'/c2) + eps),
// with b1, 1-b1, b2, 1-b2, eps and lr rounded to float32 on the host, as
// PyTorch rounds a Python scalar. Every block reads the step counter and
// the gate `keep` from the card (no host sync); where keep is 0 no block
// writes anything. The caller advances the counter after the launch, on
// the same stream.
//
// What bounds it on the card: bytes, 28 an element (4 floats read, 3
// written); the three IEEE divisions and the square root an element cost
// less than its bytes. At 1 M Gaussians and F = 512 (571 M elements) that
// is 16.0 GB, 4.77 ms at 3.35 TB/s; at F = 128 (187 M) 5.24 GB, 1.56 ms.
// Design:
//   * a block updates one chunk of CHUNK = 4096 elements of one tensor:
//     256 threads, VECS = 4 float4 of each array a thread, every load of
//     the chunk issued before the arithmetic (256 bytes in flight a thread);
//   * the launch's tensors come in a table passed by value. A block finds
//     its tensor from the prefix of the tensors' chunk counts, by compares
//     over the whole table at static indices, so the table stays in the
//     parameter bank and is not copied to local memory;
//   * 16-byte loads and stores, and a scalar tail for the last n % 4
//     elements of a tensor;
//   * a gradient may also be rows at a stride, each row contiguous: autograd
//     hands features_dc and features_rest their gradients as slices of the
//     one [N, 16, 3] gradient of their torch.cat. Such a gradient is read
//     element by element (one division a float4), the other arrays still as
//     float4; nothing is copied to make it contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TENSORS = 16;
constexpr int THREADS = 256;
constexpr int VECS = 4;
constexpr int CHUNK = THREADS * VECS * 4;

// ops/cuda_adam.py:AdamTable mirrors this field for field.
struct Table {
  float* p[MAX_TENSORS];
  const float* g[MAX_TENSORS];
  float* m[MAX_TENSORS];
  float* v[MAX_TENSORS];
  long long n[MAX_TENSORS];
  // 0: g is contiguous and 16-byte aligned; else g's element i is at
  // (i / g_row_len) * g_row_stride + i % g_row_len
  long long g_row_len[MAX_TENSORS];
  long long g_row_stride[MAX_TENSORS];
  float lr[MAX_TENSORS];
  // chunks of tensors 0..i; past the launch's tensors, the total
  int chunk_end[MAX_TENSORS];
  float b1, one_minus_b1, b2, one_minus_b2, eps;
};

struct Entry {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n, row_len, row_stride;
  float lr;
  int first_chunk;
};

__device__ __forceinline__ Entry pick(const Table& t, int chunk) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < MAX_TENSORS; ++i) k += chunk >= t.chunk_end[i];
  Entry e{};
#pragma unroll
  for (int i = 0; i < MAX_TENSORS; ++i) {
    if (i == k) {
      e = Entry{t.p[i], t.g[i], t.m[i], t.v[i], t.n[i], t.g_row_len[i],
                t.g_row_stride[i], t.lr[i], i ? t.chunk_end[i - 1] : 0};
    }
  }
  return e;
}

__device__ __forceinline__ float4 load4(const float* x, long long i) {
  return *reinterpret_cast<const float4*>(x + i);
}

__device__ __forceinline__ void store4(float* x, long long i, float4 a) {
  *reinterpret_cast<float4*>(x + i) = a;
}

// g's elements i .. i + 3, one row division for the four
__device__ __forceinline__ float4 gather4(const Entry& e, long long i) {
  if (e.row_len == 0) return load4(e.g, i);
  long long row = i / e.row_len, col = i - row * e.row_len;
  float r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j] = e.g[row * e.row_stride + col];
    if (++col == e.row_len) {
      col = 0;
      ++row;
    }
  }
  return make_float4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ float grad_at(const Entry& e, long long i) {
  if (e.row_len == 0) return e.g[i];
  const long long row = i / e.row_len;
  return e.g[row * e.row_stride + (i - row * e.row_len)];
}

struct Step {
  float b1, omb1, b2, omb2, eps, c1, c2, lr;

  __device__ __forceinline__ void operator()(float& p, float g, float& m,
                                             float& v) const {
    const float m1 = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
    const float v1 =
        __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(omb2, g), g));
    const float num = __fmul_rn(lr, __fdiv_rn(m1, c1));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, c2)), eps);
    p = __fsub_rn(p, __fdiv_rn(num, den));
    m = m1;
    v = v1;
  }

  __device__ __forceinline__ void operator()(float4& p, float4 g, float4& m,
                                             float4& v) const {
    (*this)(p.x, g.x, m.x, v.x);
    (*this)(p.y, g.y, m.y, v.y);
    (*this)(p.z, g.z, m.z, v.z);
    (*this)(p.w, g.w, m.w, v.w);
  }
};

__global__ void __launch_bounds__(THREADS)
    adam_kernel(const Table t, const int* __restrict__ step,
                const unsigned char* __restrict__ keep) {
  if (keep != nullptr && *keep == 0) return;
  const Entry e = pick(t, blockIdx.x);
  const float tf = __int2float_rn(*step + 1);
  const Step op{t.b1, t.one_minus_b1, t.b2, t.one_minus_b2, t.eps,
                __fsub_rn(1.0f, powf(t.b1, tf)),
                __fsub_rn(1.0f, powf(t.b2, tf)), e.lr};
  const long long base =
      static_cast<long long>(blockIdx.x - e.first_chunk) * CHUNK;

  long long at[VECS];
  float4 p[VECS], g[VECS], m[VECS], v[VECS];
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    at[u] = base + 4LL * (u * THREADS + threadIdx.x);
    if (at[u] + 4 <= e.n) {
      p[u] = load4(e.p, at[u]);
      g[u] = gather4(e, at[u]);
      m[u] = load4(e.m, at[u]);
      v[u] = load4(e.v, at[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    if (at[u] + 4 <= e.n) {
      op(p[u], g[u], m[u], v[u]);
      store4(e.p, at[u], p[u]);
      store4(e.m, at[u], m[u]);
      store4(e.v, at[u], v[u]);
    } else {
      // the tensor's last n % 4 elements (one thread of the tensor)
      for (long long i = at[u]; i < e.n; ++i) {
        float pi = e.p[i], mi = e.m[i], vi = e.v[i];
        op(pi, grad_at(e, i), mi, vi);
        e.p[i] = pi;
        e.m[i] = mi;
        e.v[i] = vi;
      }
    }
  }
}

}  // namespace

extern "C" {

int f3dgs_adam_chunk() { return CHUNK; }

int f3dgs_adam_max_tensors() { return MAX_TENSORS; }

size_t f3dgs_adam_table_bytes() { return sizeof(Table); }

// out[0..2] = registers a thread, bytes of local memory a thread (spills),
// resident blocks an SM.
int f3dgs_adam_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, adam_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], adam_kernel, THREADS, 0);
}

const char* f3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches `blocks` blocks (one a chunk: the table's chunk total) on
// `stream` and returns cudaGetLastError() (0 = launched). `table` points to
// a Table, which is copied into the launch, so the caller may free it on
// return. step is the int32 counter before this update, keep a bool or
// null (always update).
int f3dgs_adam(const void* table, int blocks, const int* step,
               const unsigned char* keep, cudaStream_t stream) {
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  adam_kernel<<<blocks, THREADS, 0, stream>>>(
      *static_cast<const Table*>(table), step, keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
