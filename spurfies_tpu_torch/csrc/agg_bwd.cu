// K4 — the latent gradient of K3 (fused pair-SDF aggregate backward).
//
// Replaces the TPU kernel of spurfies_tpu/ops/pallas_mlp.py:
// _fused_agg_bwd_call -> _agg_bwd_kernel. For every pair row t = (point p,
// neighbour j) of K3's forward, with its residuals w[t] (f32) and
// r_lat[t, :] = ds/dlat (bf16, 32 columns), it computes
//   out[idx[t], :] += (num_bar[p] * w[t]) * r_lat[t, :]
// where num_bar is the cotangent of K3's per-point sum_k w s. A row whose
// idx lies outside [0, n) -- the dump row n of an invalid pair -- is
// dropped, and so is a row with w == 0, which adds exactly 0.
//
// What bounds it on an H100: bytes. A row reads 4 bytes of w, 4 of idx and
// 64 of r_lat, and adds 32 floats into the [n, 32] output (0.77 MB at 6k
// points, resident in L2). The TPU kernel's point was that the per-pair
// cotangent [P*k, 32] never reaches HBM: it expanded it in VMEM and
// scattered it row by row into a banked VMEM accumulator across a
// sequential grid. Here each lane recomputes its column of the cotangent in
// registers and adds it with a global atomic; blocks run in parallel and in
// no order, so there is no bank trick and no VMEM budget fallback.
//
// Design (simple first; a sorted segment-reduce is later work):
//   * one warp per pair row, lane j owns latent column j: one coalesced
//     64-byte read of r_lat and one 128-byte red.global.add.f32 sweep;
//   * dump-row and w == 0 rows leave before any load of r_lat or atomic
//     (in the eval render half of K3's rows are dump rows);
//   * the product is rounded as the TPU kernel's (num_bar * w) * r, with
//     __fmul_rn so that nothing is contracted;
//   * the output is zeroed by the caller on the same stream.
// The order of the atomic adds changes from run to run: sums agree with a
// sequential sum up to f32 reordering, never bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLat = 32;

__global__ void __launch_bounds__(kThreads)
agg_bwd_kernel(const float* __restrict__ num_bar, const float* __restrict__ w,
               const __nv_bfloat16* __restrict__ r_lat,
               const int* __restrict__ idx, int rows, int k, int n,
               float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int i = __ldg(idx + row);
  const float wr = __ldg(w + row);
  if (static_cast<unsigned>(i) >= static_cast<unsigned>(n) || wr == 0.f)
    return;
  const float sw = __fmul_rn(__ldg(num_bar + row / k), wr);
  const float r = __bfloat162float(r_lat[row * kLat + lane]);
  atomicAdd(out + static_cast<int64_t>(i) * kLat + lane, __fmul_rn(sw, r));
}

}  // namespace

// num_bar [rows / k] f32, w [rows] f32, r_lat [rows, 32] bf16, idx [rows]
// i32 (point-major pair rows, k per point), out [n, 32] f32, zeroed by the
// caller. Returns the launch's CUDA error code.
extern "C" int pair_sdf_aggregate_bwd_launch(const float* num_bar,
                                             const float* w, const void* r_lat,
                                             const int* idx, int rows, int k,
                                             int n, float* out, void* stream) {
  if (rows < 0 || k <= 0 || rows % k != 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int blocks = (rows + kWarps - 1) / kWarps;
  agg_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      num_bar, w, static_cast<const __nv_bfloat16*>(r_lat), idx, rows, k, n,
      out);
  return static_cast<int>(cudaGetLastError());
}
