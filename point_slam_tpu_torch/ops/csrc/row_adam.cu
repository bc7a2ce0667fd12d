// Fused Adam kernels for sm_90a: K4, the masked step over the live rows of
// one (N, W) f32 leaf, and multi_adam, one launch over every leaf of an
// optimiser step.
//
// Replaces point_slam_tpu/ops/adam.py::_row_adam_kernel / update_rows: one
// pass of torch.optim.Adam's formula over the rows of the mapper's packed
// (CAP, 72) buffer that it is given, with a per-ROW gradient mask (the
// frustum) and per-COLUMN step counts and learning rates. Same result as
// the plain PyTorch version
// point_slam_tpu_torch/ops/adam.py::update_rows_reference, bit for bit:
//
//   c1 = 1 - b1^t,  c2 = 1 - b2^t              (per column, in the prologue)
//   g = g * mask[row]
//   m = (b1 * m) + ((1 - b1) * g)
//   v = (b2 * v) + (((1 - b2) * g) * g)
//   p = p - ((lr * (m / c1)) / (sqrt(v / c2) + eps))
//
// in that order, each op with a round-to-nearest intrinsic so nvcc cannot
// contract a product and a sum into an FMA (the rounding of separate
// PyTorch ops). The bias corrections are the f32 ops that PyTorch's CUDA
// `1.0 - b1 ** t` runs: powf on b1 rounded to f32, then a round-to-nearest
// subtraction. The scalars are Python doubles rounded once to f32, as
// PyTorch rounds them; t and lr come as (W,) rows or as one value each.
//
// Bound: memory. It reads p, g, m, v and writes p, m, v once (7 x n*W*4
// bytes) plus the n*4-byte mask, over the n rows given: the mapper hands
// only the cloud's live prefix (rows past the cloud have zero gradient,
// moments and mask, which Adam leaves as they are). At n = 18,006, W = 72
// that is 36.4 MB, ~11 us at 3.35 TB/s; about 15 flops an element, far
// below the compute rate. At that size a launch is a few microseconds, so
// the wrapper launches and does nothing else: no bias-correction ops, no
// per-call tensors.
// Design: one block a tile of kThreads x kVec float4 vectors (W is a
// multiple of 4, so a vector never straddles a row), the grid sized to the
// n*W/4 vectors given. Each thread issues its kVec x 4 independent 16-byte
// loads before any arithmetic, then fills shared memory with the per-column
// c1, c2 and lr (read back as float4) and the tile's row masks (each read
// once from global memory), then updates and stores in place.

// multi_adam replaces no TPU kernel: the JAX package's step over the
// decoders and the packed leaf is one XLA fusion; in eager PyTorch the same
// step was ~13 elementwise launches a tensor (point_slam_tpu_torch/ops/
// adam.py::update), ~480 an iteration of the mapper. It steps a table of up
// to kMaxTensors (p, g, m, v) in place, each with its step count and
// learning rate as one value or a (W,) row per column (the packed leaf's),
// by the same adam_elem as K4 without the mask, so it equals update bit for
// bit. The table travels by value in the kernel's parameters, as PyTorch's
// multi_tensor_apply passes its own: nothing is uploaded, nothing syncs.
// Bound: memory, 7 x 4 bytes an element (p, g, m, v read; p, m, v
// written). One grid covers the float4 vectors of all entries; a block
// finds its entry by the entries' prefix block offsets, so the small
// decoder tensors and the large leaf share one launch. An entry whose
// element count is no multiple of 4 ends in up to three scalar elements,
// stepped by the block that holds its last vector.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 2;  // float4 vectors a thread, per array, in flight
constexpr int kTile = kThreads * kVec;

__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, float c1, float c2,
                                          float lr, float b1, float omb1,
                                          float b2, float omb2, float eps) {
  m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
  v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(omb2, g), g));
  const float mhat = __fdiv_rn(m, c1);
  const float vhat = __fdiv_rn(v, c2);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, mhat),
                             __fadd_rn(__fsqrt_rn(vhat), eps)));
}

__device__ __forceinline__ void adam_vec(float4& p, const float4& g,
                                         float4& m, float4& v,
                                         const float4& c1, const float4& c2,
                                         const float4& lr, float b1,
                                         float omb1, float b2, float omb2,
                                         float eps) {
  adam_elem(p.x, g.x, m.x, v.x, c1.x, c2.x, lr.x, b1, omb1, b2, omb2, eps);
  adam_elem(p.y, g.y, m.y, v.y, c1.y, c2.y, lr.y, b1, omb1, b2, omb2, eps);
  adam_elem(p.z, g.z, m.z, v.z, c1.z, c2.z, lr.z, b1, omb1, b2, omb2, eps);
  adam_elem(p.w, g.w, m.w, v.w, c1.w, c2.w, lr.w, b1, omb1, b2, omb2, eps);
}

// c1 = 1 - b1^t, c2 = 1 - b2^t and lr of columns [0, n) into shared memory:
// column c takes t_row[c % w] (or t) and lr_row[c % w] (or lr).
__device__ __forceinline__ void fill_columns(float* c1, float* c2, float* lrs,
                                             int n, int w,
                                             const float* t_row, float t,
                                             const float* lr_row, float lr,
                                             float b1, float b2) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int col = c % w;
    const float tc = t_row ? t_row[col] : t;
    c1[c] = __fsub_rn(1.0f, powf(b1, tc));
    c2[c] = __fsub_rn(1.0f, powf(b2, tc));
    lrs[c] = lr_row ? lr_row[col] : lr;
  }
}

// t_row / lr_row: (W,) rows, or nullptr for the single values t / lr.
__global__ void __launch_bounds__(kThreads)
    row_adam_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                    float4* __restrict__ m, float4* __restrict__ v,
                    const float* __restrict__ mask,
                    const float* __restrict__ t_row, float t,
                    const float* __restrict__ lr_row, float lr, long n_vec,
                    int w4, float b1, float omb1, float b2, float omb2,
                    float eps) {
  extern __shared__ float4 smem[];  // c1 | c2 | lr (w4 each) | row masks
  float4* sc1 = smem;
  float4* sc2 = sc1 + w4;
  float4* slr = sc2 + w4;
  float* smask = reinterpret_cast<float*>(slr + w4);

  const long first = static_cast<long>(blockIdx.x) * kTile;
  float4 pp[kVec], gg[kVec], mm[kVec], vv[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const long i = first + u * kThreads + threadIdx.x;
    if (i < n_vec) {
      pp[u] = p[i];
      gg[u] = g[i];
      mm[u] = m[i];
      vv[u] = v[i];
    }
  }

  float* c1 = reinterpret_cast<float*>(sc1);
  float* c2 = reinterpret_cast<float*>(sc2);
  float* lrs = reinterpret_cast<float*>(slr);
  fill_columns(c1, c2, lrs, 4 * w4, 4 * w4, t_row, t, lr_row, lr, b1, b2);
  const long row0 = first / w4;
  const long last = (first + kTile < n_vec ? first + kTile : n_vec) - 1;
  for (int i = threadIdx.x; i <= last / w4 - row0; i += kThreads)
    smask[i] = mask[row0 + i];
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const long i = first + u * kThreads + threadIdx.x;
    if (i < n_vec) {
      const long row = i / w4;
      const int c4 = static_cast<int>(i - row * w4);
      const float mk = smask[row - row0];
      const float4 g4 = make_float4(__fmul_rn(gg[u].x, mk),
                                    __fmul_rn(gg[u].y, mk),
                                    __fmul_rn(gg[u].z, mk),
                                    __fmul_rn(gg[u].w, mk));
      adam_vec(pp[u], g4, mm[u], vv[u], sc1[c4], sc2[c4], slr[c4], b1, omb1,
               b2, omb2, eps);
      p[i] = pp[u];
      m[i] = mm[u];
      v[i] = vv[u];
    }
  }
}


// ---- multi_adam

constexpr int kMaxTensors = 56;   // the table stays under 4 KB of parameters
constexpr int kMaxPeriod = 4096;  // c1 | c2 | lr columns: 48 KB of smem

// The columns an entry keeps in shared memory: w rounded up to a multiple of
// 4 by repeating the row (so a float4 never straddles a period).
__host__ __device__ __forceinline__ int column_period(int w) {
  return w % 4 == 0 ? w : (w % 2 == 0 ? 2 * w : 4 * w);
}

// One launch's tensors. Entry e steps n[e] elements of p, g, m, v from the
// start; t_row / lr_row are (w[e],) rows (element k takes column k % w[e])
// or nullptr for the values t[e] / lr[e]; w[e] is 1 without rows. Blocks
// [block0[e], block0[e + 1]) step entry e.
struct AdamTable {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  const float* t_row[kMaxTensors];
  const float* lr_row[kMaxTensors];
  float t[kMaxTensors];
  float lr[kMaxTensors];
  int n[kMaxTensors];
  int w[kMaxTensors];
  int block0[kMaxTensors + 1];
};
static_assert(sizeof(AdamTable) + 64 <= 4096,
              "a kernel's parameters hold at most 4 KB");

__global__ void __launch_bounds__(kThreads)
    multi_adam_kernel(const __grid_constant__ AdamTable tab, float b1,
                      float omb1, float b2, float omb2, float eps) {
  extern __shared__ float4 smem[];  // c1 | c2 | lr, a period each
  const int block = static_cast<int>(blockIdx.x);
  int e = 0;
  while (block >= tab.block0[e + 1]) ++e;
  const int n = tab.n[e];
  const int n_vec = n / 4;  // whole float4 vectors; n % 4 scalars follow
  const int period = column_period(tab.w[e]);
  const int p4 = period / 4;
  float4* sc1 = smem;
  float4* sc2 = sc1 + p4;
  float4* slr = sc2 + p4;
  float4* p = reinterpret_cast<float4*>(tab.p[e]);
  const float4* g = reinterpret_cast<const float4*>(tab.g[e]);
  float4* m = reinterpret_cast<float4*>(tab.m[e]);
  float4* v = reinterpret_cast<float4*>(tab.v[e]);

  const int first = (block - tab.block0[e]) * kTile;
  float4 pp[kVec], gg[kVec], mm[kVec], vv[kVec];
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int i = first + u * kThreads + threadIdx.x;
    if (i < n_vec) {
      pp[u] = p[i];
      gg[u] = g[i];
      mm[u] = m[i];
      vv[u] = v[i];
    }
  }

  float* c1 = reinterpret_cast<float*>(sc1);
  float* c2 = reinterpret_cast<float*>(sc2);
  float* lrs = reinterpret_cast<float*>(slr);
  fill_columns(c1, c2, lrs, period, tab.w[e], tab.t_row[e], tab.t[e],
               tab.lr_row[e], tab.lr[e], b1, b2);
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int i = first + u * kThreads + threadIdx.x;
    if (i < n_vec) {
      const int c4 = i % p4;
      adam_vec(pp[u], gg[u], mm[u], vv[u], sc1[c4], sc2[c4], slr[c4], b1,
               omb1, b2, omb2, eps);
      p[i] = pp[u];
      m[i] = mm[u];
      v[i] = vv[u];
    }
  }
  // the last n % 4 elements, in the block that holds vector n_vec
  if (threadIdx.x == 0 && n % 4 && n_vec >= first && n_vec < first + kTile) {
    float* ps = tab.p[e];
    float* ms = tab.m[e];
    float* vs = tab.v[e];
    for (int k = 4 * n_vec; k < n; ++k) {
      const int c = k % period;
      adam_elem(ps[k], tab.g[e][k], ms[k], vs[k], c1[c], c2[c], lrs[c], b1,
                omb1, b2, omb2, eps);
    }
  }
}

}  // namespace

extern "C" {

// K4: p, g, m, v (n,W) f32, 16-byte aligned, W % 4 == 0; mask (n,) f32;
// t_row, lr_row (W,) f32 or nullptr for the values t, lr. p, m, v are
// updated in place. Returns cudaGetLastError().
int row_adam(void* p, const void* g, void* m, void* v, const void* mask,
             const void* t_row, float t, const void* lr_row, float lr,
             long n, int w, float b1, float omb1, float b2, float omb2,
             float eps, void* stream) {
  if (n <= 0 || w <= 0 || w % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w4 = w / 4;
  const long n_vec = n * w4;
  const long blocks = (n_vec + kTile - 1) / kTile;
  // a tile spans at most kTile / w4 + 2 rows
  const size_t smem = 3 * w4 * sizeof(float4) +
                      (kTile / w4 + 2) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  row_adam_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(p), static_cast<const float4*>(g),
      static_cast<float4*>(m), static_cast<float4*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(t_row), t,
      static_cast<const float*>(lr_row), lr, n_vec, w4, b1, omb1, b2, omb2,
      eps);
  return static_cast<int>(cudaGetLastError());
}

// The table's limits: tensors a launch, columns an entry's rows may span
// (column_period of its row width).
void multi_adam_limits(int* max_tensors, int* max_period) {
  *max_tensors = kMaxTensors;
  *max_period = kMaxPeriod;
}

// multi_adam: `count` entries (1..kMaxTensors); entry e's pointers at
// ptrs[6e .. 6e + 5] = p, g, m, v (f32, 16-byte aligned), t_row, lr_row
// ((w[e],) f32, or 0 for the values vals[2e] = t, vals[2e + 1] = lr); n[e]
// elements (> 0) from the start. p, m, v are updated in place in one
// launch. Returns cudaGetLastError().
int multi_adam(int count, const unsigned long long* ptrs, const float* vals,
               const int* n, const int* w, float b1, float omb1, float b2,
               float omb2, float eps, void* stream) {
  if (count <= 0 || count > kMaxTensors)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamTable tab{};
  long blocks = 0;
  int period = 4;
  for (int e = 0; e < count; ++e) {
    if (n[e] <= 0 || w[e] <= 0 || column_period(w[e]) > kMaxPeriod)
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned long long* q = ptrs + 6 * e;
    tab.p[e] = reinterpret_cast<float*>(q[0]);
    tab.g[e] = reinterpret_cast<const float*>(q[1]);
    tab.m[e] = reinterpret_cast<float*>(q[2]);
    tab.v[e] = reinterpret_cast<float*>(q[3]);
    tab.t_row[e] = reinterpret_cast<const float*>(q[4]);
    tab.lr_row[e] = reinterpret_cast<const float*>(q[5]);
    tab.t[e] = vals[2 * e];
    tab.lr[e] = vals[2 * e + 1];
    tab.n[e] = n[e];
    tab.w[e] = w[e];
    tab.block0[e] = static_cast<int>(blocks);
    blocks += ((n[e] + 3L) / 4 + kTile - 1) / kTile;
    if (column_period(w[e]) > period) period = column_period(w[e]);
  }
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  for (int e = count; e <= kMaxTensors; ++e)
    tab.block0[e] = static_cast<int>(blocks);
  multi_adam_kernel<<<static_cast<unsigned>(blocks), kThreads,
                      3 * period * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(tab, b1, omb1, b2,
                                                           omb2, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
