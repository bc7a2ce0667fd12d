// Ray-shared top-k neighbour selection over the cell table, for sm_90a.
//
// Replaces point_slam_tpu/ops/knn.py::_ray_topk_kernel_packed (the lattice-
// packed layout, LAYOUT=kPacked), ::_ray_topk_kernel (f32 coordinate
// planes, kPlanes) and ::_ray_topk_kernel_fused (one coords|ids plane, the
// persistent kernel fused_topk below). Same result as the plain PyTorch
// version point_slam_tpu_torch/ops/knn.py::ray_topk_reference, bit for bit.
//
// Per ray r and each of its ns samples s: over the ray's candidate lanes l
// (probe p = l / C, slot l % C of bucket row probes[r, p]), the key is the
// f32 bits of d^2(candidate, sample) with the low bits replaced by l
// (lane_mask = 2^bit_length(lanes-1) - 1), so keys are unique and ties break
// by lane. The k smallest keys come out in ascending order, each with the
// id-plane value of its lane. d^2 is ((dx*dx) + (dy*dy)) + (dz*dz) with
// round-to-nearest intrinsics, so nvcc cannot contract it into FMAs: the
// rounding of separate PyTorch ops.
//
// ---- K1, K2 (ray_topk_kernel): bound by reading the candidates, P*C slots
// of 4 bytes of coordinates (packed) or 12 bytes (planes) a ray, plus
// ns*P*C key computations; the ids are read only at the ns*k winners. One
// block per ray reads the ray's probe rows itself (coalesced) into shared
// memory as unpacked coordinates (3*P*C floats, 20.7 KB at P=27, C=64);
// then one warp per sample walks the lanes, each thread keeping a sorted
// top-k of keys in registers, and k rounds of a warp-wide minimum merge
// them.
//
// ---- K3 (fused_topk): the fused layout numbers its lanes over whole
// (2C)-wide rows: p*2C + slot for the coordinates, p*2C + C + slot for the
// id bits. Id lanes have d^2 = +inf: they never beat a finite candidate, but
// they do compete by lane number with empty coordinate lanes, so where a
// sample has fewer than k finite candidates some winners are id lanes. Only
// the k lowest id lanes (C..C+k-1, k <= 8 <= C) can win, so the kernel seeds
// each sample's list with those k keys and adds no others. A winner's id is
// the int32 at lane win + C of the same rows (0 past the last lane), copied
// as bits: for an id-lane winner that is the next probe's packed
// coordinates, which may be NaN bits as floats.
//
// A call touches ~2,500 distinct 512-byte rows (1.3 MB) at R=5000, P=27,
// C=64, so it is bound by issue and latency, not memory: 43.2M (candidate,
// sample) pairs of 8 flops, of which only ~1 in 4.7 holds a point (a ray's
// 27 probed rows hold ~370 points in 1,728 slots on the synthetic room).
// The design:
// - C is a template parameter (64 and 32), so lane numbers and probe
//   indices are shifts and masks;
// - persistent blocks walk rays r = blockIdx.x, += gridDim.x through a
//   two-stage shared-memory ring: each stage holds one ray's P probe rows
//   at full width 2C (coordinates and id bits, 13.8 KB at P=27, C=64) and
//   its queries, brought by 16-byte cp.async copies, one warp per 512-byte
//   row; ray r + gridDim.x's rows are in flight while the block selects for
//   ray r, and the probe ids of the ray after that arrive one ray earlier
//   still, so no copy waits on a global load;
// - each candidate is unpacked once a ray: the block compacts the ray's
//   points into four shared arrays (x, y, z as exact f32 by the 2^23 trick,
//   and the lane number), a warp a 32-slot chunk appending at a shared
//   counter; then one warp a sample keys them 32 at a time: 4 shared loads
//   and ~24 ALU instructions a pair (the periodic wrap is one compare and a
//   sign-selected +-1024). Empty slots are not keyed: their keys are +inf,
//   and only probe 0's (lanes < C, below the seeded id lanes) can win, which
//   each warp keys last from the stage. The other option, one warp a ray
//   keying each candidate against all ns = 5 queries in registers (one
//   shared load and ~8 unpack instructions a candidate, ~22 a pair, 8 rays
//   an SM), took 1.55x the first option's device time on the H100 when
//   both keyed every slot;
// - each sample's list of the 8 smallest keys is held sorted in every lane
//   (registers, warp-uniform). It starts from a warp-wide bitonic sort of
//   the first 32 keys; after that a chunk inserts only when a ballot finds a
//   key below the list's last entry, smallest first (__reduce_min_sync), by
//   a branch-free compare-and-shift: at most 8 insertions a chunk, ~9 a
//   sample after the first chunk on the synthetic room. The compaction's
//   order varies from run to run; the list, a set of unique keys, does not;
// - lanes 0..k-1 then take the winners in order, read their id bits from
//   the shared-memory stage and store keys and ids coalesced: no global
//   loads in the epilogue.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kSpentKey = 0x7FFFFFFF;
constexpr int kInfBits = 0x7F800000;
constexpr int kQMask = 1023;
constexpr float kQPeriod = 1024.0f;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use

enum Layout { kPlanes = 0, kPacked = 1 };

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

// pxyz: the packed coordinate plane (kPacked, row stride C); px/py/pz/pid:
// the f32 planes (kPlanes; pid also for kPacked).
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
    const long off = static_cast<long>(srow[p]) * C + (l - p * C);
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
    if constexpr (LAYOUT == kPacked) {
      dx = wrap_diff(dx);
      dy = wrap_diff(dy);
      dz = wrap_diff(dz);
    }
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    insert_key(best, (__float_as_int(d2) & ~lane_mask) | l);
  }

  for (int kk = 0; kk < k; ++kk) {
    int m = best[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(kFull, m, o));
    if (best[0] == m) {  // keys are unique: one thread owns the winner
#pragma unroll
      for (int i = 0; i < kMaxK - 1; ++i) best[i] = best[i + 1];
      best[kMaxK - 1] = kSpentKey;
    }
    if (lane == 0) {
      const long o = (r * ns + s) * k + kk;
      const int win = m & lane_mask;
      keys_out[o] = m;
      float id = 0.0f;
      if (win < pc) {
        const int p = win / C;
        id = pid[static_cast<long>(srow[p]) * C + (win - p * C)];
      }
      ids_out[o] = id;
    }
  }
}

template <int LAYOUT>
int launch(const void* probes, const void* pxyz, const void* px,
           const void* py, const void* pz, const void* pid, const void* q,
           void* keys, void* ids, int R, int P, int C, int ns, int k,
           int lane_mask, void* stream) {
  const int lanes = P * C;
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

// ------------------------------------------------------------------ K3

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A 10-bit lattice field as an exact f32: the bits of 2^23 + f, minus 2^23.
__device__ __forceinline__ float lattice_coord(int v, int shift) {
  return __fsub_rn(__int_as_float(0x4B000000 | ((v >> shift) & kQMask)),
                   8388608.0f);
}

// The shortest difference on the 1024-periodic lattice: wrap_diff's two
// steps, of which at most one applies, as one compare and an add of
// -1024 (df > 0) or +1024 (df < 0); exact, as in wrap_diff.
__device__ __forceinline__ float wrap_fast(float df) {
  const float step =
      __int_as_float((__float_as_int(df) & 0x80000000) ^ 0xC4800000);
  return fabsf(df) > 0.5f * kQPeriod ? __fadd_rn(df, step) : df;
}

__device__ __forceinline__ int pair_key(float x, float y, float z, float qx,
                                        float qy, float qz, int keep,
                                        int lane_no) {
  const float dx = wrap_fast(__fsub_rn(x, qx));
  const float dy = wrap_fast(__fsub_rn(y, qy));
  const float dz = wrap_fast(__fsub_rn(z, qz));
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return (__float_as_int(d2) & keep) | lane_no;
}

// Insert x into the ascending list l (keys are unique): every entry moves
// up past x or takes min(x, itself); a no-op when x is above l[7].
__device__ __forceinline__ void insert_sorted(int (&l)[kMaxK], int x) {
#pragma unroll
  for (int j = kMaxK - 1; j > 0; --j)
    l[j] = x < l[j - 1] ? l[j - 1] : min(x, l[j]);
  l[0] = min(x, l[0]);
}

// Merge one key a lane into the warp-uniform list, smallest first: the
// warp's minimum key is inserted while it beats l[7], so at most 8 keys of
// a chunk are inserted and the first key that does not enter ends it.
__device__ __forceinline__ void merge_keys(int (&l)[kMaxK], int key) {
  if (!__any_sync(kFull, key < l[kMaxK - 1])) return;  // the common case
  int x = __reduce_min_sync(kFull, key);
  while (x < l[kMaxK - 1]) {
    insert_sorted(l, x);
    key = key == x ? kSpentKey : key;
    x = __reduce_min_sync(kFull, key);
  }
}

// The list from a sample's first 32 keys, one a lane: a warp-wide bitonic
// sort, whose 8 smallest become the list in one go instead of 8
// insertions; the seeds (the k lowest id lanes, +inf) enter only when the
// chunk holds fewer than 8 finite keys.
__device__ __forceinline__ void first_chunk(int (&l)[kMaxK], int key,
                                            int lane, int k, int C,
                                            int inf_key) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int other = __shfl_xor_sync(kFull, key, stride);
      const bool take_min = ((lane & stride) == 0) == ((lane & size) == 0);
      key = take_min ? min(key, other) : max(key, other);
    }
  }
#pragma unroll
  for (int e = 0; e < kMaxK; ++e) l[e] = __shfl_sync(kFull, key, e);
  if (l[kMaxK - 1] >= inf_key)
    for (int e = 0; e < k; ++e) insert_sorted(l, inf_key | (C + e));
}

// Shared memory of a block, in int32 words: two stages of [P rows of 2C |
// ns*3 queries, padded to 16 bytes], two slots of P probe ids, two
// candidate counters, and the ray's finite candidates compacted as four
// (P*C,) arrays: x, y, z (f32) and lane number.
__host__ __device__ __forceinline__ int stage_words(int P, int C, int ns) {
  return P * 2 * C + ((3 * ns + 3) & ~3);
}

__host__ __device__ __forceinline__ int block_words(int P, int C, int ns) {
  return 2 * stage_words(P, C, ns) + 2 * P + 2 + 4 * P * C;
}

__device__ __forceinline__ void fetch_ids(int* ids, const int* probes,
                                          long r, int P) {
  for (int j = threadIdx.x; j < P; j += blockDim.x)
    cp_async4(ids + j, probes + r * P + j);
}

// Ray r's rows (by the probe ids already in shared memory) and queries.
template <int C>
__device__ __forceinline__ void fetch_rows(int* st, const int* ids,
                                           const int* plane, const float* q,
                                           long r, int P, int ns) {
  constexpr int kChunks = C / 2;  // 16-byte chunks a 2C-int row
  for (int j = threadIdx.x; j < P * kChunks; j += blockDim.x) {
    const int p = j / kChunks;
    const int c16 = j % kChunks;
    cp_async16(st + p * 2 * C + c16 * 4,
               plane + static_cast<long>(ids[p]) * 2 * C + c16 * 4);
  }
  for (int j = threadIdx.x; j < 3 * ns; j += blockDim.x)
    cp_async4(st + P * 2 * C + j, q + r * ns * 3 + j);
}

// One block: ns warps, one a sample. keys_out, ids_out: (R, ns*k) int32
// each (the ids as f32 bits).
template <int C>
__global__ void fused_topk(const int* __restrict__ probes,
                           const int* __restrict__ plane,
                           const float* __restrict__ q,
                           int* __restrict__ keys_out,
                           int* __restrict__ ids_out, int R, int P, int ns,
                           int k, int lane_mask) {
  static_assert(C % 32 == 0 && (C & (C - 1)) == 0 && C >= kMaxK, "C");
  extern __shared__ __align__(16) int smem_i[];
  const int st_words = stage_words(P, C, ns);
  int* ids = smem_i + 2 * st_words;  // two slots of P
  int* count = ids + 2 * P;          // two counters
  float* cx = reinterpret_cast<float*>(count + 2);
  float* cy = cx + P * C;
  float* cz = cy + P * C;
  int* cl = reinterpret_cast<int*>(cz + P * C);
  const int lane = threadIdx.x & 31;
  const int s = threadIdx.x >> 5;
  const int keep = ~lane_mask;
  const long G = gridDim.x;

  // prologue: ray r's ids, then its rows and the next ray's ids
  long r = blockIdx.x;
  if (r < R) fetch_ids(ids, probes, r, P);
  cp_async_commit();
  if (threadIdx.x == 0) count[0] = 0;
  cp_async_wait_all();
  __syncthreads();
  if (r < R) fetch_rows<C>(smem_i, ids, plane, q, r, P, ns);
  if (r + G < R) fetch_ids(ids + P, probes, r + G, P);
  cp_async_commit();

  for (int it = 0; r < R; r += G, ++it) {
    cp_async_wait_all();  // ray r's rows, ray r + G's ids
    __syncthreads();      // and every warp is done with the ray before
    if (r + G < R)
      fetch_rows<C>(smem_i + ((it + 1) & 1) * st_words,
                    ids + ((it + 1) & 1) * P, plane, q, r + G, P, ns);
    if (r + 2 * G < R) fetch_ids(ids + (it & 1) * P, probes, r + 2 * G, P);
    cp_async_commit();
    const int* rows = smem_i + (it & 1) * st_words;
    const float* qs = reinterpret_cast<const float*>(rows + P * 2 * C);

    // compact the ray's finite candidates, unpacked once: each warp takes
    // 32-slot chunks and appends its points at a shared counter
    for (int ci = threadIdx.x; ci < P * C; ci += blockDim.x) {
      const int pos = ci + (ci & ~(C - 1));  // p*2C + slot
      const int v = rows[pos];
      const unsigned fin = __ballot_sync(kFull, v >= 0);
      if (fin) {
        int at = 0;
        if (lane == 0) at = atomicAdd(count + (it & 1), __popc(fin));
        at = __shfl_sync(kFull, at, 0) + __popc(fin & ((1u << lane) - 1));
        if (v >= 0) {
          cx[at] = lattice_coord(v, 0);
          cy[at] = lattice_coord(v, 10);
          cz[at] = lattice_coord(v, 20);
          cl[at] = pos;
        }
      }
    }
    if (threadIdx.x == 0) count[(it + 1) & 1] = 0;
    __syncthreads();
    const int n = count[it & 1];

    const float qx = qs[3 * s], qy = qs[3 * s + 1], qz = qs[3 * s + 2];
    int l[kMaxK];
#pragma unroll
    for (int e = 0; e < kMaxK; ++e)
      l[e] = e < k ? ((kInfBits & keep) | (C + e)) : kSpentKey;
    auto key_at = [&](int i) {
      return i < n ? pair_key(cx[i], cy[i], cz[i], qx, qy, qz, keep, cl[i])
                   : kSpentKey;
    };
    if (n > 0) first_chunk(l, key_at(lane), lane, k, C, kInfBits & keep);
    for (int base = 32; base < n; base += 64) {  // two chunks' keys at once
      const int a = key_at(base + lane), b = key_at(base + 32 + lane);
      merge_keys(l, a);
      merge_keys(l, b);
    }
    // empty lanes can win only in probe 0 (below the seeded id lanes):
    // +inf keys, lane = slot
#pragma unroll
    for (int j = 0; j < C / 32; ++j) {
      const int slot = j * 32 + lane;
      merge_keys(l, rows[slot] < 0 ? ((kInfBits & keep) | slot) : kSpentKey);
    }
    if (lane < k) {
      int win = l[0];
#pragma unroll
      for (int e = 1; e < kMaxK; ++e) win = lane == e ? l[e] : win;
      const int at = (win & lane_mask) + C;
      const long o = (r * ns + s) * k + lane;
      keys_out[o] = win;
      ids_out[o] = at < P * 2 * C ? rows[at] : 0;
    }
    // no barrier here: the next ray's first one, which every warp reaches
    // only when done with this ray, comes before anything is overwritten
  }
}

// The kernel's blocks an SM holds at this shape (0 if none), after raising
// its dynamic shared-memory limit and asking for the largest carveout.
template <int C>
int occupancy(int P, int ns, size_t* smem_out) {
  const size_t smem = sizeof(int) * static_cast<size_t>(block_words(P, C, ns));
  *smem_out = smem;
  if (smem > kMaxSmem) return 0;
  static size_t raised = 0;
  if (smem > raised) {
    if (cudaFuncSetAttribute(fused_topk<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaFuncSetAttribute(fused_topk<C>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared) != cudaSuccess)
      return 0;
    raised = smem;
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_topk<C>, 32 * ns, smem) != cudaSuccess)
    return 0;
  return per_sm;
}

template <int C>
int launch_fused(const void* probes, const void* plane, const void* q,
                 void* out, int R, int P, int ns, int k, int lane_mask,
                 int n_sm, void* stream) {
  size_t smem = 0;
  const int per_sm = occupancy<C>(P, ns, &smem);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long grid = static_cast<long>(per_sm) * n_sm < R
                        ? static_cast<long>(per_sm) * n_sm
                        : R;
  int* keys = static_cast<int*>(out);
  fused_topk<C><<<static_cast<unsigned>(grid), 32 * ns, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(probes), static_cast<const int*>(plane),
      static_cast<const float*>(q), keys,
      keys + static_cast<long>(R) * ns * k, R, P, ns, k, lane_mask);
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

// K3: fused layout. plane (TABLE+1,2C) i32 (16-byte aligned), rows [C
// packed coords | C id bits], C = 32 or 64; probes (R,P) i32; q (R,ns,3)
// f32 lattice coords mod 1024. out: one (2, R, ns*k) i32 buffer, the keys
// then the winners' id bits. n_sm: the card's SM count (the persistent
// grid is the blocks an SM holds times n_sm, at most R).
int ray_topk_fused(const void* probes, const void* plane, const void* q,
                   void* out, int R, int P, int C, int ns, int k,
                   int lane_mask, int n_sm, void* stream) {
  if (R <= 0 || P <= 0 || ns <= 0 || ns > 32 || k <= 0 || k > kMaxK ||
      n_sm <= 0 || P * 2 * C > lane_mask + 1 || lane_mask >= (1 << 23))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C == 64)
    return launch_fused<64>(probes, plane, q, out, R, P, ns, k, lane_mask,
                            n_sm, stream);
  if (C == 32)
    return launch_fused<32>(probes, plane, q, out, R, P, ns, k, lane_mask,
                            n_sm, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3's blocks an SM holds at (P, C, ns) and the block's shared memory in
// bytes; 0 blocks for a C it is not built for or a block that does not fit.
int ray_topk_fused_occupancy(int P, int C, int ns, long* smem_bytes) {
  size_t smem = 0;
  int n = 0;
  if (C == 64)
    n = occupancy<64>(P, ns, &smem);
  else if (C == 32)
    n = occupancy<32>(P, ns, &smem);
  *smem_bytes = static_cast<long>(smem);
  return n;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
