// K1 — radius-limited k-nearest selection over per-cell candidate lists.
//
// Replaces the TPU kernel spurfies_tpu/ops/pallas_select.py
// (select_knn_pallas -> _select_kernel_t / _select_kernel_packed_t).
//
// What it computes, per query x[i] in cell cid[i] (cid outside [0, C):
// outside the grid, no neighbours): the squared distance to every candidate of the
// cell's list qidx[cid, :], qpos[cid, :, :]; the radius test d2 <= radius2;
// the k nearest, nearest first; -1 / +inf in the slots left empty.
//   * exact variant: order by (d2 ascending, id descending) -- on a d2 tie
//     the larger id wins, as in _select_kernel_t;
//   * packed variant: the key is the f32 bit pattern of d2 with its low 15
//     mantissa bits replaced by the candidate id, compared as an int32 --
//     the order and the ~2^-8 relative d2 rounding of
//     _select_kernel_packed_t (ids must be < 2^15).
//
// What bounds it on an H100: bytes, not operations (about ten f32 ops per
// candidate). The TPU kernel was fed [M, qcap] / [M, 3, qcap] candidate
// arrays that XLA gathered beforehand; here the kernel reads the per-cell
// table directly (20 MB for the 6k-point bench scene: L2 hits) and no
// [M, qcap] array is ever written. The table's lists are packed
// front-first (build_query_table), so a walk stops at the first empty slot
// and reads only the candidates a query really has. Each query still reads
// its whole list from L2 (16 bytes a candidate), where the DRAM bound
// counts each cell's row once (PERF.md, section 6, "K1 step 0").
//
// Design: a group of G lanes per query, so that a query's walk is 1/G as
// long (one thread a query walked up to 128 candidates, one dependent load
// after another, and a warp waited for its longest list) and the G lanes
// of a query read G consecutive candidates, one coalesced run of each of
// the four arrays a step. Lane gl walks the candidates gl, gl + G, ... and
// keeps its own k smallest keys in order; then k rounds of a group
// minimum (__shfl_xor_sync butterfly) over the lanes' heads give the k
// nearest in order, the lane that owns each one advancing. Keys are
// distinct within a list, so this is the plain version's k smallest keys,
// bit for bit. The warp stops its rounds once no group has a key left.
// One template, select_kernel<Key, K, G>, serves both variants:
//   * packed: an int32 key, d2's bits with the id in the low 15, G = 4
//     (8 lanes were slower on the render's shading query, 2 on its
//     probes: chip_k1_parts.py);
//   * exact: a uint64 key, high word the f32 bits of d2 (monotone for
//     d2 >= +0, and a sum of squares is never -0), low word 0xFFFFFFFF - id,
//     so that on a d2 tie the larger id comes first; the sentinel is all
//     ones, which no key reaches (d2 <= radius2 is no NaN). G = 8: on the
//     dense sphere's lists (qcap 128, 79 candidates a query) 8 lanes took
//     the least time on a training step's launches, and 8 % more than 4
//     on the render's shading query (chip_k1_parts.py). There it scans
//     candidates at the packed variant's rate, about one an SM clock:
//     the walk's instructions hold it, not its bytes, and staging a
//     block's lists in shared memory was slower (PERF.md, section 6).
// The [Q, T] transposes of the TPU kernel exist only for its vector layout
// and are gone. Distances use __fmul_rn/__fadd_rn so that nvcc does not
// contract them into FMAs: the plain PyTorch version gives the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPackedGroup = 4;   // lanes a query, packed variant
constexpr int kExactGroup = 8;    // lanes a query, exact variant

struct PackedKey {
  using T = int;
  static constexpr int kIdMask = (1 << 15) - 1;
  static constexpr T kSentinel = 1 << 30;  // > every packed key (d2 < 2)
  static __device__ __forceinline__ T make(float d, int id) {
    return (__float_as_int(d) & ~kIdMask) | id;
  }
  static __device__ __forceinline__ int id(T key) { return key & kIdMask; }
  static __device__ __forceinline__ float d2(T key) {
    return __int_as_float(key & ~kIdMask);
  }
};

struct ExactKey {
  using T = unsigned long long;
  static constexpr T kSentinel = ~0ull;
  static __device__ __forceinline__ T make(float d, int id) {
    return (static_cast<T>(__float_as_uint(d)) << 32) |
           (0xFFFFFFFFu - static_cast<unsigned>(id));
  }
  static __device__ __forceinline__ int id(T key) {
    return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
  }
  static __device__ __forceinline__ float d2(T key) {
    return __uint_as_float(static_cast<unsigned>(key >> 32));
  }
};

__device__ __forceinline__ float dist2(float x0, float x1, float x2,
                                       float p0, float p1, float p2) {
  float d0 = __fsub_rn(p0, x0);
  float d1 = __fsub_rn(p1, x1);
  float d2 = __fsub_rn(p2, x2);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                   __fmul_rn(d2, d2));
}

// A group of G lanes per query (see the header): lane gl takes the
// candidates gl, gl + G, ... of the query's list and keeps its own K
// smallest keys in order; then K rounds of a group minimum over the lanes'
// heads, the lane that owns it advancing.  Every lane of a warp reaches the
// shuffles: a lane past m or outside the grid takes part with no key.
template <class Key, int K, int G>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ x, const int* __restrict__ cid,
              const int* __restrict__ qidx, const float* __restrict__ qpos,
              int m, int n_cells, int q, float radius2,
              int* __restrict__ out_idx, float* __restrict__ out_d2) {
  using T = typename Key::T;
  constexpr int kSlots = (K + G - 1) / G;  // outputs a lane writes
  const int gl = threadIdx.x & (G - 1);
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  T best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = Key::kSentinel;
  const int c = i < m ? __ldg(cid + i) : -1;
  if (c >= 0 && c < n_cells) {
    const float x0 = __ldg(x + 3 * i), x1 = __ldg(x + 3 * i + 1),
                x2 = __ldg(x + 3 * i + 2);
    const int* ci = qidx + (size_t)c * q;
    const float* cp = qpos + (size_t)c * 3 * q;
    // the list is packed front-first: the lane's first empty slot ends it
    for (int t = gl; t < q; t += G) {
      const int id = __ldg(ci + t);
      const float p0 = __ldg(cp + t), p1 = __ldg(cp + q + t),
                  p2 = __ldg(cp + 2 * q + t);
      if (id < 0) break;
      const float d = dist2(x0, x1, x2, p0, p1, p2);
      if (!(d <= radius2)) continue;
      const T key = Key::make(d, id);
      if (key < best[K - 1]) {
        best[K - 1] = key;
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          const T lo = best[j] < best[j - 1] ? best[j] : best[j - 1];
          const T hi = best[j] < best[j - 1] ? best[j - 1] : best[j];
          best[j - 1] = lo;
          best[j] = hi;
        }
      }
    }
  }
  // K rounds: the group's smallest head is the query's next neighbour
  // (keys are distinct: ids are unique within a list); round r's key goes
  // to lane r / kSlots, its slot r % kSlots.  The warp stops once no group
  // has a key left.
  T res[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) res[s] = Key::kSentinel;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    T v = best[0];
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      const T u = __shfl_xor_sync(0xffffffffu, v, o);
      v = u < v ? u : v;
    }
    if (__all_sync(0xffffffffu, v == Key::kSentinel)) break;
    const bool pop = best[0] == v;   // one lane of the group, or none left
#pragma unroll
    for (int j = 0; j < K - 1; ++j) best[j] = pop ? best[j + 1] : best[j];
    best[K - 1] = pop ? Key::kSentinel : best[K - 1];
    if (gl == r / kSlots) res[r % kSlots] = v;
  }
  if (i >= m) return;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = gl * kSlots + s;
    if (j < K) {
      const bool ok = res[s] != Key::kSentinel;
      out_idx[(size_t)i * K + j] = ok ? Key::id(res[s]) : -1;
      out_d2[(size_t)i * K + j] = ok ? Key::d2(res[s]) : INFINITY;
    }
  }
}

template <class Key, int K, int G>
void launch_group(const float* x, const int* cid, const int* qidx,
                  const float* qpos, int m, int n_cells, int q, float radius2,
                  int* out_idx, float* out_d2, cudaStream_t stream) {
  const long long blocks = ((long long)m * G + kThreads - 1) / kThreads;
  select_kernel<Key, K, G><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(x, cid, qidx, qpos, m, n_cells, q,
                                       radius2, out_idx, out_d2);
}

template <int K>
void launch(bool packed, const float* x, const int* cid, const int* qidx,
            const float* qpos, int m, int n_cells, int q, float radius2,
            int* out_idx, float* out_d2, cudaStream_t stream) {
  if (packed)
    launch_group<PackedKey, K, kPackedGroup>(x, cid, qidx, qpos, m, n_cells,
                                             q, radius2, out_idx, out_d2,
                                             stream);
  else
    launch_group<ExactKey, K, kExactGroup>(x, cid, qidx, qpos, m, n_cells, q,
                                           radius2, out_idx, out_d2, stream);
}

}  // namespace

// x [m, 3] f32, cid [m] i32 (outside [0, n_cells): outside the grid),
// qidx [n_cells, q] i32, qpos [n_cells, 3, q] f32 -> out_idx [m, k] i32,
// out_d2 [m, k] f32. Returns the cudaError_t of the launch (0 on success).
extern "C" int select_knn_launch(const float* x, const int* cid,
                                 const int* qidx, const float* qpos, int m,
                                 int n_cells, int q, int k, float radius2,
                                 int packed, int* out_idx, float* out_d2,
                                 void* stream) {
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(packed, x, cid, qidx, qpos, m, n_cells, q, radius2, out_idx, out_d2, s); break;
    case 2: launch<2>(packed, x, cid, qidx, qpos, m, n_cells, q, radius2, out_idx, out_d2, s); break;
    case 4: launch<4>(packed, x, cid, qidx, qpos, m, n_cells, q, radius2, out_idx, out_d2, s); break;
    case 8: launch<8>(packed, x, cid, qidx, qpos, m, n_cells, q, radius2, out_idx, out_d2, s); break;
    case 16: launch<16>(packed, x, cid, qidx, qpos, m, n_cells, q, radius2, out_idx, out_d2, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
