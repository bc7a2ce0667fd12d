// Ray-shared top-k neighbour selection over the cell table, for sm_90a.
//
// Replaces point_slam_tpu/ops/knn.py::_ray_topk_kernel_packed (the lattice-
// packed layout, LAYOUT=kPacked), ::_ray_topk_kernel (f32 coordinate
// planes, kPlanes) and ::_ray_topk_kernel_fused (one coords|ids plane,
// kFused). Same result as the plain PyTorch version
// point_slam_tpu_torch/ops/knn.py::ray_topk_reference, bit for bit.
//
// Per ray r and each of its ns samples s: over the ray's candidate lanes l
// (probe p = l / C, slot l % C of bucket row probes[r, p]), the key is the
// f32 bits of d^2(candidate, sample) with the low bits replaced by l
// (lane_mask = 2^bit_length(lanes-1) - 1), so keys are unique and ties break
// by lane. The k smallest keys come out in ascending order, each with the
// id-plane value of its lane.
//
// The fused layout numbers its lanes over whole (2C)-wide rows: p*2C + slot
// for the coordinates, p*2C + C + slot for the id bits. Id lanes have
// d^2 = +inf: they never beat a finite candidate, but they do compete by
// lane number with empty coordinate lanes, so where a sample has fewer than
// k finite candidates some winners are id lanes. Only the k lowest id lanes
// can win, so the kernel adds those k keys and no others. A winner's id is
// the int32 at lane win + C of the same rows (0 past the last lane), copied
// as bits: for an id-lane winner that is the next probe's packed
// coordinates, which may be NaN bits as floats.
//
// Bound: reading the candidates, P*C slots of 4 bytes of coordinates
// (fused, packed) or 12 bytes (planes) a ray, plus ns*P*C key computations;
// the ids are read only at the ns*k winners. Design: one block per ray. The
// block reads the ray's probe rows itself (each row is C contiguous values,
// so the loads are coalesced) and keeps the unpacked candidate coordinates
// in shared memory (3*P*C floats, 20.7 KB at P=27, C=64); then one warp per
// sample walks the lanes, each thread keeping a sorted top-k of keys in
// registers, and k rounds of a warp-wide minimum merge them. d^2 is
// ((dx*dx) + (dy*dy)) + (dz*dz) with round-to-nearest intrinsics, so nvcc
// cannot contract it into FMAs: the rounding of separate PyTorch ops.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kSpentKey = 0x7FFFFFFF;
constexpr int kInfBits = 0x7F800000;
constexpr int kQMask = 1023;
constexpr float kQPeriod = 1024.0f;

enum Layout { kPlanes = 0, kPacked = 1, kFused = 2 };

__device__ __forceinline__ float wrap_diff(float df) {
  df = df > 0.5f * kQPeriod ? __fsub_rn(df, kQPeriod) : df;
  return df < -0.5f * kQPeriod ? __fadd_rn(df, kQPeriod) : df;
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

// pxyz: the packed coordinate plane (kPacked, row stride C) or the fused
// plane (kFused, row stride 2C); px/py/pz/pid: the f32 planes (kPlanes; pid
// also for kPacked).
template <int LAYOUT>
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
  const int row_w = LAYOUT == kFused ? 2 * C : C;
  float* sx = smem;
  float* sy = sx + pc;
  float* sz = sy + pc;
  int* srow = reinterpret_cast<int*>(sz + pc);
  const long r = blockIdx.x;
  const int tid = threadIdx.x;

  for (int p = tid; p < P; p += blockDim.x) srow[p] = probes[r * P + p];
  __syncthreads();

  const float inf = __int_as_float(kInfBits);
  for (int l = tid; l < pc; l += blockDim.x) {
    const int p = l / C;
    const long off = static_cast<long>(srow[p]) * row_w + (l - p * C);
    if constexpr (LAYOUT == kPlanes) {
      sx[l] = px[off];
      sy[l] = py[off];
      sz[l] = pz[off];
    } else {
      const int v = pxyz[off];
      sx[l] = v < 0 ? inf : static_cast<float>(v & kQMask);
      sy[l] = v < 0 ? inf : static_cast<float>((v >> 10) & kQMask);
      sz[l] = v < 0 ? inf : static_cast<float>((v >> 20) & kQMask);
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
    if constexpr (LAYOUT != kPlanes) {
      dx = wrap_diff(dx);
      dy = wrap_diff(dy);
      dz = wrap_diff(dz);
    }
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    int lane_no = l;
    if constexpr (LAYOUT == kFused) {
      const int p = l / C;
      lane_no = p * row_w + (l - p * C);
    }
    insert_key(best, (__float_as_int(d2) & ~lane_mask) | lane_no);
  }
  if constexpr (LAYOUT == kFused) {
    // the k lowest id lanes: +inf keys that may outrank empty coord lanes
    const int n_id = k < pc ? k : pc;
    for (int e = lane; e < n_id; e += 32) {
      const int p = e / C;
      insert_key(best, (kInfBits & ~lane_mask) | (p * row_w + C + (e - p * C)));
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
      keys_out[o] = m;
      if constexpr (LAYOUT == kFused) {
        const int at = win + C;
        int bits = 0;
        if (at < P * row_w) {
          const int p = at / row_w;
          bits = pxyz[static_cast<long>(srow[p]) * row_w + (at - p * row_w)];
        }
        reinterpret_cast<int*>(ids_out)[o] = bits;
      } else {
        float id = 0.0f;
        if (win < pc) {
          const int p = win / C;
          id = pid[static_cast<long>(srow[p]) * C + (win - p * C)];
        }
        ids_out[o] = id;
      }
    }
  }
}

template <int LAYOUT>
int launch(const void* probes, const void* pxyz, const void* px,
           const void* py, const void* pz, const void* pid, const void* q,
           void* keys, void* ids, int R, int P, int C, int ns, int k,
           int lane_mask, void* stream) {
  const int lanes = (LAYOUT == kFused ? 2 : 1) * P * C;
  if (R <= 0 || P <= 0 || C <= 0 || ns <= 0 || ns > 32 || k <= 0 ||
      k > kMaxK || lanes > lane_mask + 1 || lane_mask >= (1 << 23))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * sizeof(float) * P * C + sizeof(int) * P;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ray_topk_kernel<LAYOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ray_topk_kernel<LAYOUT><<<R, 32 * ns, smem, static_cast<cudaStream_t>(stream)>>>(
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
  return launch<kPacked>(probes, pxyz, nullptr, nullptr, nullptr, pid, q,
                         keys, ids, R, P, C, ns, k, lane_mask, stream);
}

// K2: f32 coordinate planes px, py, pz, pid (TABLE+1,C); q metric.
int ray_topk_planes(const void* probes, const void* px, const void* py,
                    const void* pz, const void* pid, const void* q, void* keys,
                    void* ids, int R, int P, int C, int ns, int k,
                    int lane_mask, void* stream) {
  return launch<kPlanes>(probes, nullptr, px, py, pz, pid, q, keys, ids, R,
                         P, C, ns, k, lane_mask, stream);
}

// K3: fused layout. plane (TABLE+1,2C) i32, rows [C packed coords | C id
// bits]; C is the number of coordinate slots a row; q as for K1. The ids
// out are the winners' id bits (an f32 tensor written as int32 bits).
int ray_topk_fused(const void* probes, const void* plane, const void* q,
                   void* keys, void* ids, int R, int P, int C, int ns, int k,
                   int lane_mask, void* stream) {
  return launch<kFused>(probes, plane, nullptr, nullptr, nullptr, nullptr, q,
                        keys, ids, R, P, C, ns, k, lane_mask, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
