// Ray-shared top-k neighbour selection over the cell table, for sm_90a.
//
// Replaces point_slam_tpu/ops/knn.py::_ray_topk_kernel_packed (the lattice-
// packed layout, PACKED=true) and ::_ray_topk_kernel (f32 coordinate
// planes, PACKED=false). Same result as the plain PyTorch version
// point_slam_tpu_torch/ops/knn.py::ray_topk_reference, bit for bit.
//
// Per ray r and each of its ns samples s: over the ray's P*C candidate lanes
// l (probe p = l / C, slot l % C of bucket row probes[r, p]), the key is the
// f32 bits of d^2(candidate, sample) with the low bits replaced by l
// (lane_mask = 2^bit_length(P*C-1) - 1), so keys are unique and ties break
// by lane. The k smallest keys come out in ascending order, each with the
// id-plane value of its lane.
//
// Bound: reading the candidates, P*C slots of 4 bytes of coordinates
// (packed) or 12 bytes (planes) a ray, plus ns*P*C key computations; the
// id plane is read only at the ns*k winners. Design: one block per ray.
// The block reads the ray's probe rows itself (each row is C contiguous
// values, so the loads are coalesced) and keeps the unpacked candidate
// coordinates in shared memory; then one warp per sample walks the lanes,
// each thread keeping a sorted top-k of keys in registers, and k rounds of
// a warp-wide minimum merge them. d^2 is ((dx*dx) + (dy*dy)) + (dz*dz) with
// round-to-nearest intrinsics, so nvcc cannot contract it into FMAs: the
// rounding of separate PyTorch ops.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kSpentKey = 0x7FFFFFFF;
constexpr int kQMask = 1023;
constexpr float kQPeriod = 1024.0f;

__device__ __forceinline__ float wrap_diff(float df) {
  df = df > 0.5f * kQPeriod ? __fsub_rn(df, kQPeriod) : df;
  return df < -0.5f * kQPeriod ? __fadd_rn(df, kQPeriod) : df;
}

template <bool PACKED>
__global__ void ray_topk_kernel(const int* __restrict__ probes,
                                const int* __restrict__ pxyz,
                                const float* __restrict__ px,
                                const float* __restrict__ py,
                                const float* __restrict__ pz,
                                const float* __restrict__ pid,
                                const float* __restrict__ q,
                                int* __restrict__ keys_out,
                                float* __restrict__ ids_out,
                                int P, int C, int ns, int k, int lane_mask) {
  extern __shared__ float smem[];
  const int pc = P * C;
  float* sx = smem;
  float* sy = sx + pc;
  float* sz = sy + pc;
  int* srow = reinterpret_cast<int*>(sz + pc);
  const long r = blockIdx.x;
  const int tid = threadIdx.x;

  for (int p = tid; p < P; p += blockDim.x) srow[p] = probes[r * P + p];
  __syncthreads();

  const float inf = __int_as_float(0x7F800000);
  for (int l = tid; l < pc; l += blockDim.x) {
    const int p = l / C;
    const long off = static_cast<long>(srow[p]) * C + (l - p * C);
    if constexpr (PACKED) {
      const int v = pxyz[off];
      sx[l] = v < 0 ? inf : static_cast<float>(v & kQMask);
      sy[l] = v < 0 ? inf : static_cast<float>((v >> 10) & kQMask);
      sz[l] = v < 0 ? inf : static_cast<float>((v >> 20) & kQMask);
    } else {
      sx[l] = px[off];
      sy[l] = py[off];
      sz[l] = pz[off];
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int s = tid >> 5;  // one warp per sample
  if (s >= ns) return;
  const float* qs = q + (r * ns + s) * 3;
  const float qx = qs[0], qy = qs[1], qz = qs[2];

  int best[kMaxK];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) best[i] = kSpentKey;

  for (int l = lane; l < pc; l += 32) {
    float dx = __fsub_rn(sx[l], qx);
    float dy = __fsub_rn(sy[l], qy);
    float dz = __fsub_rn(sz[l], qz);
    if constexpr (PACKED) {
      dx = wrap_diff(dx);
      dy = wrap_diff(dy);
      dz = wrap_diff(dz);
    }
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    const int key = (__float_as_int(d2) & ~lane_mask) | l;
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
      const int win = m & lane_mask;
      float id = 0.0f;
      if (win < pc) {
        const int p = win / C;
        id = pid[static_cast<long>(srow[p]) * C + (win - p * C)];
      }
      keys_out[o] = m;
      ids_out[o] = id;
    }
  }
}

template <bool PACKED>
int launch(const void* probes, const void* pxyz, const void* px,
           const void* py, const void* pz, const void* pid, const void* q,
           void* keys, void* ids, int R, int P, int C, int ns, int k,
           int lane_mask, void* stream) {
  if (R <= 0 || P <= 0 || C <= 0 || ns <= 0 || ns > 32 || k <= 0 ||
      k > kMaxK || P * C > lane_mask + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * sizeof(float) * P * C + sizeof(int) * P;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ray_topk_kernel<PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ray_topk_kernel<PACKED><<<R, 32 * ns, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(probes), static_cast<const int*>(pxyz),
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(pz), static_cast<const float*>(pid),
      static_cast<const float*>(q), static_cast<int*>(keys),
      static_cast<float*>(ids), P, C, ns, k, lane_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1: lattice-packed layout. probes (R,P) i32; pxyz (TABLE+1,C) i32;
// pid (TABLE+1,C) f32; q (R,ns,3) f32 lattice coords mod 1024;
// keys (R,ns*k) i32 and ids (R,ns*k) f32 out. Returns cudaGetLastError().
int ray_topk_packed(const void* probes, const void* pxyz, const void* pid,
                    const void* q, void* keys, void* ids, int R, int P, int C,
                    int ns, int k, int lane_mask, void* stream) {
  return launch<true>(probes, pxyz, nullptr, nullptr, nullptr, pid, q, keys,
                      ids, R, P, C, ns, k, lane_mask, stream);
}

// K2: f32 coordinate planes px, py, pz, pid (TABLE+1,C); q metric.
int ray_topk_planes(const void* probes, const void* px, const void* py,
                    const void* pz, const void* pid, const void* q, void* keys,
                    void* ids, int R, int P, int C, int ns, int k,
                    int lane_mask, void* stream) {
  return launch<false>(probes, nullptr, px, py, pz, pid, q, keys, ids, R, P,
                       C, ns, k, lane_mask, stream);
}

const char* ray_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
