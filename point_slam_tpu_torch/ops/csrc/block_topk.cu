// Per-ray top-k over an already gathered candidate block, for sm_90a.
//
// Replaces the ten Pallas bodies of the TPU kNN selection study:
// profiling/knn_pallas.py::_topk_kernel (P1), knn_pallas2.py::_kernel (P2)
// and ::_kernel2 (P2'), knn_pallas3.py::_kernel3 (P3),
// knn_pallas4.py::_kernel4 (P4), knn_layout_micro.py::_kernel4 (P5b) and
// ::_kernel_sep (P5c), knn_quad_micro.py::quad_kernel (P6q) and
// ::planes_kernel (P6p), and point_slam_tpu/ops/knn.py::_ray_topk_kernel's
// body run over a gathered block (knn_layout_micro.py's variant A). Same
// result as point_slam_tpu_torch/ops/block_topk.py::block_topk_reference,
// bit for bit.
//
// Per ray r and each of its ns samples s, over the ray's P*C candidate lanes
// l = p*C + slot: d^2 = ((dx*dx) + (dy*dy)) + (dz*dz), and the key is the f32
// bits of d^2 with the low bits under lane_mask replaced by l, so keys are
// unique and ties break by lane. The k smallest keys come out ascending;
// with an id view, each winner's id is the id view's value at its lane (0
// past the P*C lanes). That is the TPU bodies' masked sum
// sum(where(lane == win, ID, 0)): an empty or sentinel winner carries +inf.
//
// The four layouts of the study are strides over one function: each of the
// x, y, z (and id) views has its own base, row stride and probe stride, and
// slot stride 1 (see block_topk.py::layout_views).
//
// Unlike ray_topk.cu (K1-K3), the kernel does not read a cell table: the
// caller has already gathered the (R, P, C) block, which is how the TPU
// study fed its bodies. Bound: reading the block's coordinates, 12*P*C bytes
// a ray (the ids are read only at the ns*k winners), against ns*P*C keys of
// 8 f32 operations each. Design, simple first: one block per ray copies the
// ray's x, y, z lanes into dynamic shared memory (3*P*C floats: 48 KB at
// P=C=64, so the launch raises the block's dynamic shared-memory limit);
// then one warp per sample walks the lanes, each thread keeping a sorted
// top-k of keys in registers, and k rounds of a warp-wide minimum merge
// them. d^2 is computed with round-to-nearest intrinsics, so nvcc cannot
// contract it into FMAs: the rounding of separate PyTorch ops.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kSpentKey = 0x7FFFFFFF;

struct View {
  const float* base;
  int row_stride;
  int probe_stride;
};

__device__ __forceinline__ long view_offset(const View& v, long r, int p,
                                            int slot) {
  return r * v.row_stride + static_cast<long>(p) * v.probe_stride + slot;
}

__device__ __forceinline__ void insert_key(int (&best)[kMaxK], int key) {
  if (key < best[kMaxK - 1]) {
    best[kMaxK - 1] = key;
#pragma unroll
    for (int i = kMaxK - 1; i > 0; --i) {
      if (best[i] < best[i - 1]) {
        const int t = best[i];
        best[i] = best[i - 1];
        best[i - 1] = t;
      }
    }
  }
}

template <bool WITH_IDS>
__global__ void block_topk_kernel(View vx, View vy, View vz, View vid,
                                  const float* __restrict__ qx,
                                  const float* __restrict__ qy,
                                  const float* __restrict__ qz,
                                  int q_ray_stride, int q_sample_stride,
                                  int* __restrict__ keys_out,
                                  float* __restrict__ ids_out, int P, int C,
                                  int ns, int k, int lane_mask) {
  extern __shared__ float smem[];
  const int pc = P * C;
  float* sx = smem;
  float* sy = sx + pc;
  float* sz = sy + pc;
  const long r = blockIdx.x;
  const int tid = threadIdx.x;

  for (int l = tid; l < pc; l += blockDim.x) {
    const int p = l / C;
    const int slot = l - p * C;
    sx[l] = vx.base[view_offset(vx, r, p, slot)];
    sy[l] = vy.base[view_offset(vy, r, p, slot)];
    sz[l] = vz.base[view_offset(vz, r, p, slot)];
  }
  __syncthreads();

  const int lane = tid & 31;
  const int s = tid >> 5;  // one warp per sample
  if (s >= ns) return;
  const long qo = r * q_ray_stride + static_cast<long>(s) * q_sample_stride;
  const float px = qx[qo], py = qy[qo], pz = qz[qo];

  int best[kMaxK];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) best[i] = kSpentKey;

  for (int l = lane; l < pc; l += 32) {
    const float dx = __fsub_rn(sx[l], px);
    const float dy = __fsub_rn(sy[l], py);
    const float dz = __fsub_rn(sz[l], pz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    insert_key(best, (__float_as_int(d2) & ~lane_mask) | l);
  }

  for (int kk = 0; kk < k; ++kk) {
    int m = best[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    if (best[0] == m) {  // keys are unique: one thread owns the winner
#pragma unroll
      for (int i = 0; i < kMaxK - 1; ++i) best[i] = best[i + 1];
      best[kMaxK - 1] = kSpentKey;
    }
    if (lane == 0) {
      const long o = (r * ns + s) * k + kk;
      keys_out[o] = m;
      if constexpr (WITH_IDS) {
        const int win = m & lane_mask;
        float id = 0.0f;
        if (win < pc) {
          const int p = win / C;
          id = vid.base[view_offset(vid, r, p, win - p * C)];
        }
        ids_out[o] = id;
      }
    }
  }
}

template <bool WITH_IDS>
int launch(View vx, View vy, View vz, View vid, const float* qx,
           const float* qy, const float* qz, int q_ray_stride,
           int q_sample_stride, int* keys, float* ids, int R, int P, int C,
           int ns, int k, int lane_mask, cudaStream_t stream) {
  const long pc = static_cast<long>(P) * C;
  if (R <= 0 || P <= 0 || C <= 0 || ns <= 0 || ns > 32 || k <= 0 ||
      k > kMaxK || k > pc || pc > lane_mask + 1L || lane_mask >= (1 << 23) ||
      (lane_mask & (lane_mask + 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * sizeof(float) * pc;
  if (smem >= 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_topk_kernel<WITH_IDS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  block_topk_kernel<WITH_IDS><<<R, 32 * ns, smem, stream>>>(
      vx, vy, vz, vid, qx, qy, qz, q_ray_stride, q_sample_stride, keys, ids,
      P, C, ns, k, lane_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y, z (and id, or null for keys only): f32 views of logical shape
// (R, P, C), each with its own row and probe stride (elements) and slot
// stride 1. qx, qy, qz: f32 query components at r*q_ray_stride +
// s*q_sample_stride. keys (R, ns*k) i32 and, with an id view, ids
// (R, ns*k) f32 out. Returns cudaGetLastError().
int block_topk(const void* x, const void* y, const void* z, const void* id,
               int rs_x, int ps_x, int rs_y, int ps_y, int rs_z, int ps_z,
               int rs_id, int ps_id, const void* qx, const void* qy,
               const void* qz, int q_ray_stride, int q_sample_stride,
               void* keys, void* ids, int R, int P, int C, int ns, int k,
               int lane_mask, void* stream) {
  const View vx{static_cast<const float*>(x), rs_x, ps_x};
  const View vy{static_cast<const float*>(y), rs_y, ps_y};
  const View vz{static_cast<const float*>(z), rs_z, ps_z};
  const View vid{static_cast<const float*>(id), rs_id, ps_id};
  const auto* fx = static_cast<const float*>(qx);
  const auto* fy = static_cast<const float*>(qy);
  const auto* fz = static_cast<const float*>(qz);
  auto* k_out = static_cast<int*>(keys);
  auto* i_out = static_cast<float*>(ids);
  auto s = static_cast<cudaStream_t>(stream);
  if (id != nullptr)
    return launch<true>(vx, vy, vz, vid, fx, fy, fz, q_ray_stride,
                        q_sample_stride, k_out, i_out, R, P, C, ns, k,
                        lane_mask, s);
  return launch<false>(vx, vy, vz, vid, fx, fy, fz, q_ray_stride,
                       q_sample_stride, k_out, i_out, R, P, C, ns, k,
                       lane_mask, s);
}

}  // extern "C"
