// Ray-shared top-k neighbour selection over the cell table, for sm_90a.
//
// One persistent kernel template, ray_topk_persistent<LAYOUT, C>, replaces
// the three Pallas kernels of point_slam_tpu/ops/knn.py:
// - K1 ::_ray_topk_kernel_packed, LAYOUT = kPacked: the lattice-packed
//   coordinate plane pxyz (TABLE+1, C) i32 (-1 empty) and the id plane pid
//   (TABLE+1, C) f32 (+inf empty); lanes p*C + slot;
// - K2 ::_ray_topk_kernel, kPlanes: the f32 planes px, py, pz, pid
//   (TABLE+1, C), +inf empty; lanes p*C + slot; metric queries, no wrap;
// - K3 ::_ray_topk_kernel_fused, kFused: one (TABLE+1, 2C) i32 plane, rows
//   [C packed coordinates | C id bits]; lanes p*2C + slot over whole rows,
//   the id lanes p*2C + C + slot included.
// Same result as the plain PyTorch version
// point_slam_tpu_torch/ops/knn.py::ray_topk_reference, bit for bit.
//
// Per ray r and each of its ns samples s: over the ray's lanes l (probe p,
// slot of bucket row probes[r, p]), the key is the f32 bits of
// d^2(candidate, sample) with the low bits replaced by l (lane_mask =
// 2^bit_length(lanes-1) - 1), so keys are unique and ties break by lane.
// The k smallest keys come out in ascending order, each with the id of its
// lane: the pid value (K1, K2; 0 past the last lane), or the int32 at lane
// win + C of the fused rows (K3; 0 past the last lane), copied as bits. d^2
// is ((dx*dx) + (dy*dy)) + (dz*dz) with round-to-nearest intrinsics, so nvcc
// cannot contract it into FMAs: the rounding of separate PyTorch ops. K1 and
// K3 unpack the 10-bit lattice fields exactly and wrap each difference on
// the 1024-periodic lattice.
//
// ---- What bounds it. At R=5000, ns=5, P=27, C=64 a call keys 43.2M
// (candidate, sample) pairs of 8 flops (0.0052 ms at the card's 67 TFLOP/s,
// the bound chip_smoke.py states) and touches ~2,500 distinct rows: 0.6 MB
// (K1 coordinates), 1.9 MB (K2 x, y, z), 1.3 MB (K3), plus K1's and K2's
// ids at the winners. In practice it is bound by issue and latency: of a
// ray's 1,728 slots only ~370 hold a point on the synthetic room, and each
// sample's top-8 is a chain of dependent insertions. The design:
// - the row width C: 64 and 32 are template parameters, so lane numbers
//   and probe indices are shifts and masks; every other C (the JAX
//   package takes any grid_max_per_cell, 96 by default) runs the generic
//   instantiation <LAYOUT, 0>, which takes C at run time and divides by it
//   with a multiply-high by a magic number computed on the host (Width<0>);
//   a row that is not a whole number of 16-byte chunks (C % 4 != 0) is
//   staged by 4-byte copies, and the loops over a ray's P*C slots keep
//   every lane of a warp in step when P*C is not a multiple of 32;
// - persistent blocks (the occupancy calculator's blocks an SM times the
//   SMs) walk rays r = blockIdx.x, += gridDim.x through a two-stage
//   shared-memory ring. A stage holds a ray's P rows of each staged plane
//   as (P, C) word planes (K1: coordinates, ids; K2: x, y, z; K3: the two
//   C-word halves of each 2C row) and its queries, brought by 16-byte
//   cp.async copies. Ray r + gridDim.x's rows are in flight while the block
//   selects for ray r, and the probe ids of the ray after that arrive one
//   ray earlier still (three slots), so no copy waits on a global load;
// - each slot is read once a ray: the block compacts the ray's points, a
//   warp a 32-slot chunk appending at a shared counter; then one warp a
//   sample keys them 32 at a time. K1 and K3 compact four arrays, x, y, z
//   unpacked exactly by the 2^23 trick and the lane number, so a point is
//   unpacked once and not once a sample. K2 has nothing to unpack and
//   compacts the lane alone, which is the point's slot in its f32 stage:
//   that keeps its block at 4 blocks an SM instead of 3, and it keyed
//   1.24x faster than compacting x, y, z too (device 0.0579 against 0.0720
//   ms at R=5000 on the H100);
// - each sample's list of the 8 smallest keys is held sorted in every lane
//   (registers, warp-uniform). It starts from a warp-wide bitonic sort of
//   the first 32 keys; after that a chunk inserts only when a ballot finds a
//   key below the list's last entry, smallest first (__reduce_min_sync), by
//   a branch-free compare-and-shift. The compaction's order varies from run
//   to run; the list, a set of unique keys, does not;
// - lanes 0..k-1 then take the winners in order and store keys and ids
//   coalesced. K1's and K3's ids come from the stage; K2 stages x, y, z
//   only and reads pid at the <= k winners from device memory (L2-hot), by
//   the probe ids its third slot still holds: staging pid as well cost
//   1.25-1.29x in device time (2 or 3 blocks an SM instead of 3 or 4).
//
// ---- The seeds. Every lane that holds no point has the key (+inf bits &
// ~lane_mask) | lane: the empty slots of K1 and K2 (the sentinel row, which
// duplicate and out-of-box probes point at, is all empty) and in K3 the
// empty coordinate slots and every id lane. Such keys beat no finite key
// and rank among themselves by lane number, so the winners past a sample's
// finite candidates are the k lowest-numbered such lanes of the whole ray.
// They are not keyed with the points: once a sample's candidates are
// merged and its k-th key is still not finite, the warp scans the stage in
// lane order, 32 lanes a step, merges those lanes' keys and stops when the
// next 32 lanes' keys cannot enter. With C >= 2k they lie in probe 0 (a
// sample short of k points leaves more than C - k >= k slots of it empty;
// K3: probe 0's empty slots, then its id lanes C, C+1, ...); the scan does
// not rely on that (chip_smoke.py's phase K0 holds C = 4 EQUAL), nor on
// the build filling a bucket from slot 0.
//
// ---- Shared memory and occupancy. A block holds two stages of
// kStaged*P*C words and the queries, three slots of P probe ids, two
// counters, and the compacted arrays sized for every slot: about 32*P*C
// bytes for K1 and K3 (two staged planes, 4*P*C compacted words) and
// 28*P*C for K2 (three staged planes, P*C compacted lanes), sized from the
// call's (P, C, ns) by block_words. At P=27, C=64, ns=5 (160 threads):
// K1 and K3 55,756 bytes, K2 48,844, 4 blocks an SM each. C <= 96 fits at
// every P <= 64 (K1 and K3 at P=64, C=96: 197,512 bytes, one block an
// SM), C = 128 at P <= 56. A block past kMaxSmem is refused (ops/knn.py
// raises first, naming the bytes); the occupancy calculator decides the
// blocks an SM. ptxas (sm_90a, CUDA 12.8), registers at C = 32 and 64 /
// generic: K1 30 / 32, K2 27 / 36, K3 44 / 38, no spills; at 160 threads
// a block the shared memory, not the registers, sets the blocks an SM.


#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kSpentKey = 0x7FFFFFFF;
constexpr int kInfBits = 0x7F800000;
constexpr int kQMask = 1023;
constexpr float kQPeriod = 1024.0f;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use
constexpr int kNoKernel = static_cast<int>(cudaErrorInvalidValue);

// ray_topk()'s layout codes (ops/knn.py passes them).
enum Layout { kPacked = 0, kPlanes = 1, kFused = 2 };

// What differs between the layouts, at compile time.
template <int LAYOUT>
struct Rows {
  // f32 coordinate planes with metric queries (no lattice, no wrap)
  static constexpr bool kMetric = LAYOUT == kPlanes;
  // (P, C) word planes a stage holds
  static constexpr int kStaged = LAYOUT == kPlanes ? 3 : 2;
  // words between two rows of a plane in device memory; lanes a probe
  __host__ __device__ static int row_stride(int c) {
    return LAYOUT == kFused ? 2 * c : c;
  }
};

// n / d for 0 <= n with n * d < 2^32 (the host checks it): the high word
// of n * ceil(2^32 / d), exact under that bound.
struct Div {
  int d;
  unsigned magic;  // ceil(2^32 / d); 0 for d == 1
  static Div of(int d) {
    return {d, d > 1 ? static_cast<unsigned>(((1ull << 32) + d - 1) / d)
                     : 0u};
  }
  __device__ __forceinline__ int quo(int n) const {
    return magic ? static_cast<int>(__umulhi(static_cast<unsigned>(n), magic))
                 : n;
  }
};

// The row width C. A built width (a power of two, >= 32) is a compile-time
// constant: quotients are shifts, and a row is C/4 16-byte chunks.
template <int C>
struct Width {
  static_assert(C % 32 == 0 && (C & (C - 1)) == 0, "C");
  static constexpr bool kWhole = true;  // P*C is a multiple of 32
  static Width make(int) { return {}; }
  __host__ __device__ int c() const { return C; }
  __device__ __forceinline__ int quo(int n) const {
    return static_cast<unsigned>(n) / C;
  }
  __device__ __forceinline__ int words() const { return 4; }
  __device__ __forceinline__ int chunk_quo(int j) const {
    return static_cast<unsigned>(j) / (C / 4);
  }
};

// Any other width, at run time: quotients by a magic number; 16-byte
// chunks where C % 4 == 0, single words otherwise.
template <>
struct Width<0> {
  static constexpr bool kWhole = false;
  Div by_c, by_chunk;
  static Width make(int c) {
    return {Div::of(c), Div::of(c % 4 == 0 ? c / 4 : c)};
  }
  __host__ __device__ int c() const { return by_c.d; }
  __device__ __forceinline__ int quo(int n) const { return by_c.quo(n); }
  __device__ __forceinline__ int words() const {
    return by_c.d % 4 == 0 ? 4 : 1;
  }
  __device__ __forceinline__ int chunk_quo(int j) const {
    return by_chunk.quo(j);
  }
};

// The planes' device pointers as int32 words: K1 pxyz, pid; K2 px, py, pz,
// pid; K3 the plane and the plane + C (the rows' id halves).
struct Planes {
  const int* p[4];
};

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

// The shortest difference on the 1024-periodic lattice, exact: of the two
// steps of the plain version's _wrap_diff at most one applies, so one
// compare and an add of -1024 (df > 0) or +1024 (df < 0).
__device__ __forceinline__ float wrap_fast(float df) {
  const float step =
      __int_as_float((__float_as_int(df) & 0x80000000) ^ 0xC4800000);
  return fabsf(df) > 0.5f * kQPeriod ? __fadd_rn(df, step) : df;
}

template <bool METRIC>
__device__ __forceinline__ int pair_key(float x, float y, float z, float qx,
                                        float qy, float qz, int keep,
                                        int lane_no) {
  float dx = __fsub_rn(x, qx), dy = __fsub_rn(y, qy), dz = __fsub_rn(z, qz);
  if constexpr (!METRIC) {
    dx = wrap_fast(dx);
    dy = wrap_fast(dy);
    dz = wrap_fast(dz);
  }
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return (__float_as_int(d2) & keep) | lane_no;
}

// Does a plane-0 word hold a point? (-1 empty; K2: +inf empty)
template <int LAYOUT>
__device__ __forceinline__ bool holds_point(int v) {
  return Rows<LAYOUT>::kMetric ? v != kInfBits : v >= 0;
}

// Is lane l of the staged ray one without a point (a +inf key)?
template <int LAYOUT, int C>
__device__ __forceinline__ bool empty_lane(const int* rows, int l,
                                           const Width<C>& w) {
  if constexpr (LAYOUT == kFused) {  // an id lane, or an empty coordinate
    const int h = w.quo(l);          // 2 * probe + (an id half)
    return (h & 1) || rows[(h >> 1) * w.c() + (l - h * w.c())] < 0;
  } else {
    return !holds_point<LAYOUT>(rows[l]);
  }
}

// The id of the winning lane win (P probes; ids: this ray's probe ids).
template <int LAYOUT, int C>
__device__ __forceinline__ int winner_id(const int* rows, const int* ids,
                                         const Planes& src, int win, int P,
                                         const Width<C>& w) {
  const int c = w.c();
  if constexpr (LAYOUT == kFused) {
    const int at = win + c;  // over whole 2C rows: the next probe's coords
    if (at >= P * 2 * c) return 0;  // for an id lane
    const int h = w.quo(at);
    return rows[((h & 1) ? P * c : 0) + (h >> 1) * c + (at - h * c)];
  } else {
    if (win >= P * c) return 0;
    if constexpr (LAYOUT == kPacked) {
      return rows[P * c + win];
    } else {  // pid in device memory, at the winner's bucket row
      const int p = w.quo(win);
      return src.p[3][static_cast<long>(ids[p]) * c + (win - p * c)];
    }
  }
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
// insertions.
__device__ __forceinline__ void first_chunk(int (&l)[kMaxK], int key,
                                            int lane) {
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
}

// l[i] for a run-time i, without indexing the register array
__device__ __forceinline__ int entry(const int (&l)[kMaxK], int i) {
  int v = l[0];
#pragma unroll
  for (int e = 1; e < kMaxK; ++e) v = e == i ? l[e] : v;
  return v;
}

// Shared memory of a block, in int32 words: two stages of [kStaged (P, C)
// planes | ns*3 queries, padded to 16 bytes], three slots of P probe ids,
// two candidate counters, and the ray's points compacted as four (P*C,)
// arrays, x, y, z (f32) and lane number (K2: the lane alone). ops/knn.py's
// ray_topk_smem_bytes repeats these sums.
template <int LAYOUT>
__host__ __device__ __forceinline__ long stage_words(int P, int c, int ns) {
  return Rows<LAYOUT>::kStaged * static_cast<long>(P) * c +
         ((3 * ns + 3) & ~3);
}

template <int LAYOUT>
__host__ __device__ __forceinline__ long block_words(int P, int c, int ns) {
  return 2 * stage_words<LAYOUT>(P, c, ns) + 3 * P + 2 +
         (Rows<LAYOUT>::kMetric ? 1 : 4) * static_cast<long>(P) * c;
}

__device__ __forceinline__ void fetch_ids(int* ids, const int* probes,
                                          long r, int P) {
  for (int j = threadIdx.x; j < P; j += blockDim.x)
    cp_async4(ids + j, probes + r * P + j);
}

// Ray r's rows (by the probe ids already in shared memory) and queries.
template <int LAYOUT, int C>
__device__ __forceinline__ void fetch_rows(int* st, const int* ids,
                                           const Planes& src, const float* q,
                                           long r, int P, int ns,
                                           const Width<C>& w) {
  using L = Rows<LAYOUT>;
  const int c = w.c();
  const int words = w.words();   // 4: 16-byte chunks; 1: single words
  const int chunks = c / words;  // a C-word row's copies
  const long stride = L::row_stride(c);
#pragma unroll
  for (int pl = 0; pl < L::kStaged; ++pl) {
    for (int j = threadIdx.x; j < P * chunks; j += blockDim.x) {
      const int p = w.chunk_quo(j);
      const int off = (j - p * chunks) * words;
      int* dst = st + (pl * P + p) * c + off;
      const int* from = src.p[pl] + ids[p] * stride + off;
      if (words == 4)
        cp_async16(dst, from);
      else
        cp_async4(dst, from);
    }
  }
  for (int j = threadIdx.x; j < 3 * ns; j += blockDim.x)
    cp_async4(st + L::kStaged * P * c + j, q + r * ns * 3 + j);
}

// One block: ns warps, one a sample. keys_out, ids_out: (R, ns*k) int32
// each (the ids as f32 bits).
template <int LAYOUT, int C>
__global__ void ray_topk_persistent(const int* __restrict__ probes,
                                    const Planes src,
                                    const float* __restrict__ q,
                                    int* __restrict__ keys_out,
                                    int* __restrict__ ids_out, int R, int P,
                                    int ns, int k, int lane_mask,
                                    const Width<C> w) {
  using L = Rows<LAYOUT>;
  extern __shared__ __align__(16) int smem_i[];
  const int c = w.c();
  const int pc = P * c;                            // staged slots a plane
  const int lanes = LAYOUT == kFused ? 2 * pc : pc;  // lanes a ray
  const int st_words = static_cast<int>(stage_words<LAYOUT>(P, c, ns));
  int* ids = smem_i + 2 * st_words;  // three slots of P
  int* count = ids + 3 * P;          // two counters
  float* cx = reinterpret_cast<float*>(count + 2);
  float* cy = cx + pc;
  float* cz = cy + pc;
  int* cl = count + 2 + (L::kMetric ? 0 : 3 * pc);
  const int lane = threadIdx.x & 31;
  const int s = threadIdx.x >> 5;
  const int keep = ~lane_mask;
  const int inf_key = kInfBits & keep;
  const long G = gridDim.x;

  // prologue: ray r's ids, then its rows and the next ray's ids
  long r = blockIdx.x;
  if (r < R) fetch_ids(ids, probes, r, P);
  cp_async_commit();
  if (threadIdx.x == 0) count[0] = 0;
  cp_async_wait_all();
  __syncthreads();
  if (r < R) fetch_rows<LAYOUT>(smem_i, ids, src, q, r, P, ns, w);
  if (r + G < R) fetch_ids(ids + P, probes, r + G, P);
  cp_async_commit();

  for (int it = 0; r < R; r += G, ++it) {
    cp_async_wait_all();  // ray r's rows, ray r + G's ids
    __syncthreads();      // and every warp is done with the ray before
    if (r + G < R)
      fetch_rows<LAYOUT>(smem_i + ((it + 1) & 1) * st_words,
                         ids + (it + 1) % 3 * P, src, q, r + G, P, ns, w);
    if (r + 2 * G < R) fetch_ids(ids + (it + 2) % 3 * P, probes, r + 2 * G, P);
    cp_async_commit();
    const int* rows = smem_i + (it & 1) * st_words;
    const float* qs = reinterpret_cast<const float*>(rows + L::kStaged * pc);

    // compact the ray's points, each read once: each warp takes 32-slot
    // chunks and appends its points at a shared counter (the chunk bases
    // are warp-uniform, so every lane reaches the ballot)
    for (int base = threadIdx.x - lane; base < pc; base += blockDim.x) {
      const int ci = base + lane;
      const bool in = Width<C>::kWhole || ci < pc;
      const int v = in ? rows[ci] : 0;
      const bool pt = in && holds_point<LAYOUT>(v);
      const unsigned fin = __ballot_sync(kFull, pt);
      if (fin) {
        int at = 0;
        if (lane == 0) at = atomicAdd(count + (it & 1), __popc(fin));
        at = __shfl_sync(kFull, at, 0) + __popc(fin & ((1u << lane) - 1));
        if (pt) {
          if constexpr (!L::kMetric) {
            cx[at] = lattice_coord(v, 0);
            cy[at] = lattice_coord(v, 10);
            cz[at] = lattice_coord(v, 20);
          }
          // K3's lane over whole 2C rows: the slot plus its probe's C
          cl[at] = LAYOUT == kFused ? ci + w.quo(ci) * c : ci;
        }
      }
    }
    if (threadIdx.x == 0) count[(it + 1) & 1] = 0;
    __syncthreads();
    const int n = count[it & 1];

    const float qx = qs[3 * s], qy = qs[3 * s + 1], qz = qs[3 * s + 2];
    int l[kMaxK];
#pragma unroll
    for (int e = 0; e < kMaxK; ++e) l[e] = kSpentKey;
    auto key_at = [&](int i) {
      if (i >= n) return kSpentKey;
      if constexpr (!L::kMetric)
        return pair_key<false>(cx[i], cy[i], cz[i], qx, qy, qz, keep, cl[i]);
      const int j = cl[i];  // K2: the lane is the point's stage slot
      return pair_key<true>(__int_as_float(rows[j]),
                            __int_as_float(rows[pc + j]),
                            __int_as_float(rows[2 * pc + j]), qx, qy, qz,
                            keep, j);
    };
    if (n > 0) first_chunk(l, key_at(lane), lane);
    for (int base = 32; base < n; base += 64) {  // two chunks' keys at once
      const int a = key_at(base + lane), b = key_at(base + 32 + lane);
      merge_keys(l, a);
      merge_keys(l, b);
    }
    // the seeds, only for a sample with fewer than k finite keys
    int kth = entry(l, k - 1);
    for (int base = 0; base < lanes && (inf_key | base) < kth; base += 32) {
      const int ln = base + lane;
      const bool seed = (Width<C>::kWhole || ln < lanes) &&
                        empty_lane<LAYOUT>(rows, ln, w);
      merge_keys(l, seed ? (inf_key | ln) : kSpentKey);
      kth = entry(l, k - 1);
    }
    if (lane < k) {
      const int win = entry(l, lane);
      const long o = (r * ns + s) * k + lane;
      keys_out[o] = win;
      ids_out[o] = winner_id<LAYOUT>(rows, ids + it % 3 * P, src,
                                     win & lane_mask, P, w);
    }
    // no barrier here: the next ray's first one, which every warp reaches
    // only when done with this ray, comes before anything is overwritten
  }
}

// The kernel's blocks an SM holds at this shape (0 if none), after raising
// its dynamic shared-memory limit and asking for the largest carveout.
template <int LAYOUT, int C>
int occupancy(int P, int c, int ns, size_t* smem_out) {
  const auto kernel = ray_topk_persistent<LAYOUT, C>;
  const size_t smem = sizeof(int) * block_words<LAYOUT>(P, c, ns);
  *smem_out = smem;
  if (smem > kMaxSmem) return 0;
  static size_t raised = 0;
  if (smem > raised) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared) != cudaSuccess)
      return 0;
    raised = smem;
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * ns,
                                                    smem) != cudaSuccess)
    return 0;
  return per_sm;
}

struct Call {
  const int* probes;
  Planes src;
  const float* q;
  int* out;
  int R, P, C, ns, k, lane_mask, n_sm;
  cudaStream_t stream;
};

template <int LAYOUT, int C>
int launch(const Call& a) {
  size_t smem = 0;
  const int per_sm = occupancy<LAYOUT, C>(a.P, a.C, a.ns, &smem);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long grid = static_cast<long>(per_sm) * a.n_sm < a.R
                        ? static_cast<long>(per_sm) * a.n_sm
                        : a.R;
  ray_topk_persistent<LAYOUT, C>
      <<<static_cast<unsigned>(grid), 32 * a.ns, smem, a.stream>>>(
          a.probes, a.src, a.q, a.out,
          a.out + static_cast<long>(a.R) * a.ns * a.k, a.R, a.P, a.ns, a.k,
          a.lane_mask, Width<C>::make(a.C));
  return static_cast<int>(cudaGetLastError());
}

template <int LAYOUT, int C>
struct Kernel {
  static constexpr int layout = LAYOUT, width = C;
};

// f(Kernel<layout, C>{}) with the built widths 64 and 32 as themselves and
// every other C as the generic instantiation (width 0).
template <int LAYOUT, class F>
int with_width(int C, F&& f) {
  if (C == 64) return f(Kernel<LAYOUT, 64>{});
  if (C == 32) return f(Kernel<LAYOUT, 32>{});
  return f(Kernel<LAYOUT, 0>{});
}

template <class F>
int with_kernel(int layout, int C, int missing, F&& f) {
  switch (layout) {
    case kPacked: return with_width<kPacked>(C, f);
    case kPlanes: return with_width<kPlanes>(C, f);
    case kFused: return with_width<kFused>(C, f);
  }
  return missing;
}

// The divisions' bound (Div): every quotient of the kernel is of a number
// below 2*P*C by C, or below P*C by C/4 or C.
bool divisible(int P, int C) {
  return 2ull * P * C * C < (1ull << 32);
}

}  // namespace

extern "C" {

// All three layouts. layout: kPacked (0), kPlanes (1) or kFused (2);
// probes (R, P) i32; p0..p3 the planes in ops/knn.py::index_planes' order
// (K1 pxyz, pid; K2 px, py, pz, pid; K3 the plane), each contiguous and
// 16-byte aligned, the unused ones null; C >= 1 the row width (K3's rows
// are 2C wide; 32 and 64 are built as constants, any other C runs the
// generic kernel); q (R, ns, 3) f32 (K1, K3 lattice coordinates mod 1024;
// K2 metric). out: one (2, R, ns*k) i32 buffer, the keys and then the
// winners' ids (f32 values; K3's as copied bits). n_sm: the card's SM
// count (the persistent grid is the blocks an SM holds times n_sm, at most
// R). Returns cudaGetLastError() after the launch; a block past the
// shared memory is refused (cudaErrorInvalidConfiguration).
int ray_topk(int layout, const void* probes, const void* p0, const void* p1,
             const void* p2, const void* p3, const void* q, void* out, int R,
             int P, int C, int ns, int k, int lane_mask, int n_sm,
             void* stream) {
  const long lanes = static_cast<long>(P) * (layout == kFused ? 2 * C : C);
  if (R <= 0 || P <= 0 || C <= 0 || ns <= 0 || ns > 32 || k <= 0 ||
      k > kMaxK || n_sm <= 0 || lanes > lane_mask + 1L ||
      lane_mask >= (1 << 23) || !divisible(P, C))
    return kNoKernel;
  const int* w0 = static_cast<const int*>(p0);
  const Planes src =
      layout == kFused
          ? Planes{{w0, w0 + C, nullptr, nullptr}}
          : Planes{{w0, static_cast<const int*>(p1),
                    static_cast<const int*>(p2), static_cast<const int*>(p3)}};
  const Call call{static_cast<const int*>(probes), src,
                  static_cast<const float*>(q), static_cast<int*>(out),
                  R, P, C, ns, k, lane_mask, n_sm,
                  static_cast<cudaStream_t>(stream)};
  return with_kernel(layout, C, kNoKernel, [&](auto kern) {
    using K = decltype(kern);
    return launch<K::layout, K::width>(call);
  });
}

// The blocks an SM holds of ray_topk's kernel for (layout, P, C, ns), and
// the block's shared memory in bytes; 0 blocks for a block that does not
// fit (or an unknown layout).
int ray_topk_occupancy(int layout, int P, int C, int ns, long* smem_bytes) {
  size_t smem = 0;
  const int n = P > 0 && C > 0 && divisible(P, C)
                    ? with_kernel(layout, C, 0,
                                  [&](auto kern) {
                                    using K = decltype(kern);
                                    return occupancy<K::layout, K::width>(
                                        P, C, ns, &smem);
                                  })
                    : 0;
  *smem_bytes = static_cast<long>(smem);
  return n;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
