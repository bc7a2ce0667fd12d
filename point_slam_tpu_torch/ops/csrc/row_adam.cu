// Fused masked Adam over the live rows of one (N, W) f32 leaf, for sm_90a.
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 2;  // float4 vectors a thread, per array, in flight
constexpr int kTile = kThreads * kVec;

__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, float mask, float c1,
                                          float c2, float lr, float b1,
                                          float omb1, float b2, float omb2,
                                          float eps) {
  g = __fmul_rn(g, mask);
  m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
  v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(omb2, g), g));
  const float mhat = __fdiv_rn(m, c1);
  const float vhat = __fdiv_rn(v, c2);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, mhat),
                             __fadd_rn(__fsqrt_rn(vhat), eps)));
}

__device__ __forceinline__ void adam_vec(float4& p, const float4& g,
                                         float4& m, float4& v, float mk,
                                         const float4& c1, const float4& c2,
                                         const float4& lr, float b1,
                                         float omb1, float b2, float omb2,
                                         float eps) {
  adam_elem(p.x, g.x, m.x, v.x, mk, c1.x, c2.x, lr.x, b1, omb1, b2, omb2, eps);
  adam_elem(p.y, g.y, m.y, v.y, mk, c1.y, c2.y, lr.y, b1, omb1, b2, omb2, eps);
  adam_elem(p.z, g.z, m.z, v.z, mk, c1.z, c2.z, lr.z, b1, omb1, b2, omb2, eps);
  adam_elem(p.w, g.w, m.w, v.w, mk, c1.w, c2.w, lr.w, b1, omb1, b2, omb2, eps);
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
  for (int c = threadIdx.x; c < 4 * w4; c += kThreads) {
    const float tc = t_row ? t_row[c] : t;
    c1[c] = __fsub_rn(1.0f, powf(b1, tc));
    c2[c] = __fsub_rn(1.0f, powf(b2, tc));
    lrs[c] = lr_row ? lr_row[c] : lr;
  }
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
      adam_vec(pp[u], gg[u], mm[u], vv[u], smask[row - row0], sc1[c4],
               sc2[c4], slr[c4], b1, omb1, b2, omb2, eps);
      p[i] = pp[u];
      m[i] = mm[u];
      v[i] = vv[u];
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

}  // extern "C"
