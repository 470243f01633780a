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
// Design:
//   * exact variant: one thread per query keeps a sorted list of k (d2,
//     id) entries in registers (insertion with a fixed, unrolled bubble
//     step);
//   * packed variant: a group of kGroup = 4 lanes per query, so that a
//     query's walk is a quarter as long (one thread a query walked up to
//     ~40 candidates, one dependent load after another, and a warp waited
//     for its longest list). Lane gl walks the candidates gl, gl + 4, ...
//     and keeps its own k smallest keys in order; then k rounds of a group
//     minimum (__shfl_xor_sync butterfly) over the lanes' heads give the k
//     nearest in order, the lane that owns each one advancing. Keys are
//     distinct (ids are unique within a list and sit in the low bits), so
//     this is the plain version's k smallest keys, bit for bit. The warp
//     stops its rounds once no group has a key left. (8 lanes were slower
//     on the render's shading query, 2 on its probes: chip_k1_parts.py.)
// The [Q, T] transposes of the TPU kernel exist only for its vector layout
// and are gone. Distances use __fmul_rn/__fadd_rn so that nvcc does not
// contract them into FMAs: the plain PyTorch version gives the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kIdBits = 15;
constexpr int kIdMask = (1 << kIdBits) - 1;
constexpr int kSentinel = 1 << 30;  // > every packed key (d2 < 2)
constexpr int kThreads = 128;       // the exact variant: one query a thread
constexpr int kGroup = 4;           // the packed variant: lanes a query
constexpr int kGroupThreads = 256;

__device__ __forceinline__ float dist2(float x0, float x1, float x2,
                                       float p0, float p1, float p2) {
  float d0 = __fsub_rn(p0, x0);
  float d1 = __fsub_rn(p1, x1);
  float d2 = __fsub_rn(p2, x2);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                   __fmul_rn(d2, d2));
}

template <int K>
__global__ void __launch_bounds__(kThreads)
select_exact_kernel(const float* __restrict__ x, const int* __restrict__ cid,
                    const int* __restrict__ qidx,
                    const float* __restrict__ qpos, int m, int n_cells,
                    int q, float radius2, int* __restrict__ out_idx,
                    float* __restrict__ out_d2) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = INFINITY;
    bi[j] = -1;
  }
  const int c = cid[i];
  if (c >= 0 && c < n_cells) {
    const float x0 = x[3 * i], x1 = x[3 * i + 1], x2 = x[3 * i + 2];
    const int* ci = qidx + (size_t)c * q;
    const float* cp = qpos + (size_t)c * 3 * q;
    for (int t = 0; t < q; ++t) {
      const int id = __ldg(ci + t);
      if (id < 0) break;
      const float d = dist2(x0, x1, x2, __ldg(cp + t), __ldg(cp + q + t),
                            __ldg(cp + 2 * q + t));
      if (!(d <= radius2)) continue;
      if (d < bd[K - 1] || (d == bd[K - 1] && id > bi[K - 1])) {
        bd[K - 1] = d;
        bi[K - 1] = id;
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          const bool sw =
              bd[j] < bd[j - 1] || (bd[j] == bd[j - 1] && bi[j] > bi[j - 1]);
          const float td = sw ? bd[j - 1] : bd[j];
          const int ti = sw ? bi[j - 1] : bi[j];
          bd[j - 1] = sw ? bd[j] : bd[j - 1];
          bi[j - 1] = sw ? bi[j] : bi[j - 1];
          bd[j] = td;
          bi[j] = ti;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_idx[(size_t)i * K + j] = bi[j];
    out_d2[(size_t)i * K + j] = bd[j];
  }
}

// The packed variant, a group of kGroup lanes per query (see the header):
// lane gl takes the candidates gl, gl + kGroup, ... of the query's list and
// keeps its own K smallest keys in order; then K rounds of a group minimum
// over the lanes' heads, the lane that owns it advancing.  Every lane of a
// warp reaches the shuffles: a lane past m or outside the grid takes part
// with no key.
template <int K>
__global__ void __launch_bounds__(kGroupThreads)
select_packed_kernel(const float* __restrict__ x, const int* __restrict__ cid,
                     const int* __restrict__ qidx,
                     const float* __restrict__ qpos, int m, int n_cells,
                     int q, float radius2, int* __restrict__ out_idx,
                     float* __restrict__ out_d2) {
  constexpr int kSlots = (K + kGroup - 1) / kGroup;  // outputs a lane writes
  const int gl = threadIdx.x & (kGroup - 1);
  const long long i =
      ((long long)blockIdx.x * kGroupThreads + threadIdx.x) / kGroup;
  int best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = kSentinel;
  const int c = i < m ? __ldg(cid + i) : -1;
  if (c >= 0 && c < n_cells) {
    const float x0 = __ldg(x + 3 * i), x1 = __ldg(x + 3 * i + 1),
                x2 = __ldg(x + 3 * i + 2);
    const int* ci = qidx + (size_t)c * q;
    const float* cp = qpos + (size_t)c * 3 * q;
    // the list is packed front-first: the lane's first empty slot ends it
    for (int t = gl; t < q; t += kGroup) {
      const int id = __ldg(ci + t);
      const float p0 = __ldg(cp + t), p1 = __ldg(cp + q + t),
                  p2 = __ldg(cp + 2 * q + t);
      if (id < 0) break;
      const float d = dist2(x0, x1, x2, p0, p1, p2);
      if (!(d <= radius2)) continue;
      const int key = (__float_as_int(d) & ~kIdMask) | id;
      if (key < best[K - 1]) {
        best[K - 1] = key;
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          const int lo = min(best[j - 1], best[j]);
          const int hi = max(best[j - 1], best[j]);
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
  int res[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) res[s] = kSentinel;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    int v = best[0];
#pragma unroll
    for (int o = 1; o < kGroup; o <<= 1)
      v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (__all_sync(0xffffffffu, v == kSentinel)) break;
    const bool pop = best[0] == v;   // one lane of the group, or none left
#pragma unroll
    for (int j = 0; j < K - 1; ++j) best[j] = pop ? best[j + 1] : best[j];
    best[K - 1] = pop ? kSentinel : best[K - 1];
    if (gl == r / kSlots) res[r % kSlots] = v;
  }
  if (i >= m) return;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = gl * kSlots + s;
    if (j < K) {
      const bool ok = res[s] < kSentinel;
      out_idx[(size_t)i * K + j] = ok ? (res[s] & kIdMask) : -1;
      out_d2[(size_t)i * K + j] =
          ok ? __int_as_float(res[s] & ~kIdMask) : INFINITY;
    }
  }
}

template <int K>
void launch(bool packed, const float* x, const int* cid, const int* qidx,
            const float* qpos, int m, int n_cells, int q, float radius2,
            int* out_idx, float* out_d2, cudaStream_t stream) {
  if (packed) {
    const long long blocks =
        ((long long)m * kGroup + kGroupThreads - 1) / kGroupThreads;
    select_packed_kernel<K><<<static_cast<unsigned>(blocks), kGroupThreads,
                              0, stream>>>(x, cid, qidx, qpos, m, n_cells, q,
                                           radius2, out_idx, out_d2);
  } else {
    const int blocks = (m + kThreads - 1) / kThreads;
    select_exact_kernel<K><<<blocks, kThreads, 0, stream>>>(
        x, cid, qidx, qpos, m, n_cells, q, radius2, out_idx, out_d2);
  }
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
