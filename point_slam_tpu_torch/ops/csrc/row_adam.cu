// Fused masked Adam over one (N, W) f32 leaf, for sm_90a.
//
// Replaces point_slam_tpu/ops/adam.py::_row_adam_kernel / update_rows: one
// pass of torch.optim.Adam's formula over the mapper's packed (CAP, 72)
// buffer, with a per-ROW gradient mask (the frustum) and per-COLUMN bias
// corrections and learning rates. Same result as the plain PyTorch version
// point_slam_tpu_torch/ops/adam.py::update_rows_reference, bit for bit:
//
//   g = g * mask[row]
//   m = (b1 * m) + ((1 - b1) * g)
//   v = (b2 * v) + (((1 - b2) * g) * g)
//   p = p - ((lr * (m / c1)) / (sqrt(v / c2) + eps))
//
// in that order, each op with a round-to-nearest intrinsic so nvcc cannot
// contract a product and a sum into an FMA (the rounding of separate
// PyTorch ops). c1 = 1 - b1^t and c2 = 1 - b2^t come from the wrapper,
// computed with the same f32 torch ops as the plain version; the scalars
// are Python doubles rounded once to f32, as PyTorch rounds them.
//
// Bound: memory. It reads p, g, m, v and writes p, m, v once (7 x N*W*4
// bytes) plus the N*4-byte mask: 264.7 MB at N = 2^17, W = 72, ~79 us at
// 3.35 TB/s; about 15 flops an element, far below the compute rate.
// Design: a grid-stride loop with one thread per float4 (W is a multiple of
// 4, so a vector never straddles a row), 16-byte loads and stores, the
// three (W,) rows in shared memory, the row mask read once per vector.
// Outputs are written in place over p, m and v.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void row_adam_kernel(float4* __restrict__ p,
                                const float4* __restrict__ g,
                                float4* __restrict__ m,
                                float4* __restrict__ v,
                                const float* __restrict__ mask,
                                const float* __restrict__ c1,
                                const float* __restrict__ c2,
                                const float* __restrict__ lr, long n_vec,
                                int w, float b1, float omb1, float b2,
                                float omb2, float eps) {
  extern __shared__ float srow[];  // c1 | c2 | lr, W each
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    srow[i] = c1[i];
    srow[w + i] = c2[i];
    srow[2 * w + i] = lr[i];
  }
  __syncthreads();
  const int w4 = w / 4;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const long row = i / w4;
    const int col = static_cast<int>(i - row * w4) * 4;
    const float mk = mask[row];
    float4 pp = p[i], mm = m[i], vv = v[i];
    const float4 gg = g[i];
    adam_elem(pp.x, gg.x, mm.x, vv.x, mk, srow[col], srow[w + col],
              srow[2 * w + col], b1, omb1, b2, omb2, eps);
    adam_elem(pp.y, gg.y, mm.y, vv.y, mk, srow[col + 1], srow[w + col + 1],
              srow[2 * w + col + 1], b1, omb1, b2, omb2, eps);
    adam_elem(pp.z, gg.z, mm.z, vv.z, mk, srow[col + 2], srow[w + col + 2],
              srow[2 * w + col + 2], b1, omb1, b2, omb2, eps);
    adam_elem(pp.w, gg.w, mm.w, vv.w, mk, srow[col + 3], srow[w + col + 3],
              srow[2 * w + col + 3], b1, omb1, b2, omb2, eps);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

extern "C" {

// K4: p, g, m, v (N,W) f32, 16-byte aligned, W % 4 == 0; mask (N,) f32;
// c1, c2, lr (W,) f32. p, m, v are updated in place. Returns
// cudaGetLastError().
int row_adam(void* p, const void* g, void* m, void* v, const void* mask,
             const void* c1, const void* c2, const void* lr, long n, int w,
             float b1, float omb1, float b2, float omb2, float eps,
             int n_sm, void* stream) {
  if (n <= 0 || w <= 0 || w % 4 != 0 || n_sm <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long n_vec = n * (w / 4);
  long blocks = (n_vec + kThreads - 1) / kThreads;
  const long cap = 8L * n_sm;  // enough resident blocks to fill the card
  if (blocks > cap) blocks = cap;
  row_adam_kernel<<<static_cast<unsigned>(blocks), kThreads,
                    3 * w * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(p), static_cast<const float4*>(g),
      static_cast<float4*>(m), static_cast<float4*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(c1),
      static_cast<const float*>(c2), static_cast<const float*>(lr), n_vec, w,
      b1, omb1, b2, omb2, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
