// K5 — row scatter-add: the colour-latent gradient.
//
// Replaces the TPU kernel of spurfies_tpu/ops/pallas_scatter.py:
// scatter_add_rows -> _scatter_kernel. It computes
//   out[idx[m], :] += ct[m, :]   for every row m of ct [M, d],
// and drops a row whose idx lies outside [0, n). On the training path ct is
// the cotangent of the colour pair rows [M*K, 64 + 3], of which only the 64
// latent columns are scattered: the kernel reads them through a row stride,
// so the 3 position columns are never copied out.
//
// What bounded it on an H100: same-address atomics. Every invalid
// neighbour slot is clamped to row 0 before the gather, and its cotangent
// is exactly 0, so 40-56 % of a launch's rows are all-zero rows at index 0:
// with one atomic an element, each column of output row 0 took a chain of
// 80k-300k adds of zero, 91 % of the kernel's time (PERF.md, section 6).
// The real rows share targets too: consecutive rows are a point's k = 8
// neighbours and consecutive points one ray's samples, about 10 rows of a
// 256-row tile on each (tile, index).
//
// Why skipping a zero is exact: the output starts at +0 (the caller zeroes
// it), and an f32 sum that starts at +0 never becomes -0 in round-to-
// nearest (a + (-a) = +0), so adding +0 or -0 leaves its bits as they
// were. An add whose value compares equal to 0 can be dropped in any
// order; a NaN compares unequal and is still added. The result is the same
// function as _scatter_kernel's sequential sum, up to f32 reordering.
//
// Design: a block takes kTile consecutive rows, one thread a row. Each
// thread checks its row's index unsigned against n (a negative one is
// dropped too) and makes the key (index << 32 | row in the tile), or
// all ones for a dropped row; a bitonic sort of the tile's keys (warp
// shuffles below a distance of 32, shared memory above) orders them by
// index, then by row. Warp w then walks the sorted positions
// [32 w, 32 w + 32): lanes over columns, it sums each run of equal index
// in row order in registers and issues one red.global.add per (run,
// column) whose sum is not 0. A run that crosses into the next warp's
// positions is summed in pieces, each added atomically: at most 7 more
// adds a tile, and every warp walks at most 32 rows. Within a tile the
// order is fixed; across tiles the adds stay atomic, so sums agree with a
// sequential sum up to f32 reordering, never bit for bit. The kernel needs
// no scratch in device memory.
// What bounds it now: bytes. Each kept row of ct is read once (the zero
// rows too, to learn that they are zero): 0.017 ms at 3.35 TB/s on the
// colour path, where it takes 0.028 ms; its ~12k (tile, index) runs make
// no chain of atomics deeper than a few dozen (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;                // rows per block, one a thread
constexpr int kBatch = 8;                 // rows loaded ahead of their adds
constexpr unsigned long long kDropped = ~0ull;

__global__ void __launch_bounds__(kTile)
scatter_rows_kernel(const float* __restrict__ ct, long long ld,
                    const int* __restrict__ idx, long long m, int d, int n,
                    float* __restrict__ out) {
  __shared__ unsigned long long key_s[kTile];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;

  unsigned long long key = kDropped;
  if (row0 + tid < m) {
    const int i = __ldg(idx + row0 + tid);
    if (static_cast<unsigned>(i) < static_cast<unsigned>(n))
      key = (static_cast<unsigned long long>(i) << 32) |
            static_cast<unsigned>(tid);
  }
  // bitonic sort, ascending: thread t ends holding sorted position t
#pragma unroll
  for (int k = 2; k <= kTile; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        key_s[tid] = key;
        __syncthreads();
        other = key_s[tid ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, j);
      }
      const bool keep_min = ((tid & j) == 0) == ((tid & k) == 0);
      key = keep_min ? (key < other ? key : other)
                     : (key < other ? other : key);
    }
  }

  // warp w: sorted positions 32 w .. 32 w + 31, held one a lane
  const unsigned my_i = static_cast<unsigned>(key >> 32);
  const unsigned my_r = static_cast<unsigned>(key);
  const unsigned valid = __ballot_sync(0xffffffffu, key != kDropped);
  const int nv = __popc(valid);             // dropped keys sort last
  if (nv == 0) return;
  const unsigned next_i = __shfl_down_sync(0xffffffffu, my_i, 1);
  // a run ends before a new index, a dropped key or the next warp's rows
  const unsigned run_end =
      __ballot_sync(0xffffffffu, lane == 31 || next_i != my_i) & valid;

  for (int c0 = 0; c0 < d; c0 += 64) {
    const int ca = c0 + lane, cb = c0 + 32 + lane;
    const bool has_a = ca < d, has_b = cb < d;
    float sa = 0.f, sb = 0.f;
    for (int q = 0; q < nv; q += kBatch) {
      float va[kBatch], vb[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int p = q + e;
        const unsigned r = __shfl_sync(0xffffffffu, my_r, p & 31);
        const float* src = ct + (row0 + r) * ld;
        va[e] = (p < nv && has_a) ? __ldg(src + ca) : 0.f;
        vb[e] = (p < nv && has_b) ? __ldg(src + cb) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const int p = q + e;
        if (p >= nv) break;
        sa = __fadd_rn(sa, va[e]);
        sb = __fadd_rn(sb, vb[e]);
        if ((run_end >> p) & 1u) {
          const unsigned i = __shfl_sync(0xffffffffu, my_i, p);
          float* dst = out + static_cast<long long>(i) * d;
          if (has_a && sa != 0.f) atomicAdd(dst + ca, sa);
          if (has_b && sb != 0.f) atomicAdd(dst + cb, sb);
          sa = 0.f;
          sb = 0.f;
        }
      }
    }
  }
}

}  // namespace

// ct [m, d] f32 with row stride ld >= d (elements), idx [m] i32, out [n, d]
// f32, zeroed by the caller. Returns the launch's CUDA error code.
extern "C" int scatter_add_rows_launch(const float* ct, int ld, const int* idx,
                                       int m, int d, int n, float* out,
                                       void* stream) {
  if (m < 0 || d <= 0 || n <= 0 || ld < d)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const int blocks = static_cast<int>((m + (long long)kTile - 1) / kTile);
  scatter_rows_kernel<<<blocks, kTile, 0,
                        static_cast<cudaStream_t>(stream)>>>(ct, ld, idx, m,
                                                             d, n, out);
  return static_cast<int>(cudaGetLastError());
}
