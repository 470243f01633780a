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
// sequential grid. Here the cotangent is made in registers and added with
// global atomics; blocks run in parallel and in no order.
//
// What held the first design (one warp a row, one scalar atomic an
// element; PERF.md, section 6, "K4 step 0"): its idle warps. Half of a
// training step's rows are dump rows, and each took a warp that left after
// reading 8 bytes: with the dropped rows removed from its input it took 40 %
// less time, while rows in a random order or with no index repeated
// (no same-address chains) took no less.
//
// Design:
//   * a grid of at most 8 blocks an SM walks the rows 32 at a time, a
//     warp a window: lane l reads idx and w of row 32 j + l (coalesced), and
//     a ballot marks the kept rows, so a dropped row costs 8 bytes and no
//     lane's time after that, and leaves before any load of r_lat;
//   * the window's kept rows go 4 at a time to the warp's four groups of 8
//     lanes; lane l of a group owns the columns 4 l .. 4 l + 3 of its row:
//     one 8-byte load of r_lat and one red.global.add.v4.f32 (Hopper's
//     atomicAdd(float4 *, float4)), 8 atomics a row instead of 32;
//   * the product is rounded as the TPU kernel's (num_bar * w) * r, with
//     __fmul_rn so that nothing is contracted;
//   * the kernel zeroes the output itself, and a grid barrier separates
//     that from the adds: one cooperative launch (its grid capped at the
//     blocks that fit on the card at once), where a memset and a kernel
//     made two CUDA calls. At a training step's small launch (8,192
//     rows) the host's time per call is the kernel's cost.
// The order of the atomic adds changes from run to run: sums agree with a
// sequential sum up to f32 reordering, never bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;   // 2048 threads: a full SM
constexpr int kLat = 32;

__global__ void __launch_bounds__(kThreads)
agg_bwd_kernel(const float* __restrict__ num_bar, const float* __restrict__ w,
               const __nv_bfloat16* __restrict__ r_lat,
               const int* __restrict__ idx, int rows, int k, int n,
               float* __restrict__ out) {
  // zero the output, then wait for the whole grid: any row may be added
  // to by any block
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < static_cast<long long>(n) * (kLat / 4); e += threads)
    out4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  cooperative_groups::this_grid().sync();

  const int lane = threadIdx.x & 31;
  const int group = lane >> 3;        // which of the 4 rows a pass takes
  const int col = (lane & 7) * 4;     // the group lane's 4 columns
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * 32;
  for (long long base = (static_cast<long long>(blockIdx.x) * kWarps +
                         (threadIdx.x >> 5)) * 32;
       base < rows; base += stride) {
    const long long row = base + lane;
    int i = 0;
    float sw = 0.f;
    bool keep = false;
    if (row < rows) {
      i = __ldg(idx + row);
      const float wr = __ldg(w + row);
      keep = static_cast<unsigned>(i) < static_cast<unsigned>(n) &&
             wr != 0.f;
      if (keep)
        sw = __fmul_rn(__ldg(num_bar + static_cast<int>(row) / k), wr);
    }
    unsigned kept = __ballot_sync(0xffffffffu, keep);
    while (kept) {
      // the next four kept rows of the window, lowest first
      int src = -1;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int b = __ffs(kept) - 1;   // -1 once none is left
        if (g == group) src = b;
        kept &= kept - 1;
      }
      const int from = src < 0 ? lane : src;
      const int ti = __shfl_sync(0xffffffffu, i, from);
      const float tsw = __shfl_sync(0xffffffffu, sw, from);
      if (src >= 0) {
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
            r_lat + (base + src) * kLat + col));
        const float2 r01 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 r23 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        atomicAdd(reinterpret_cast<float4*>(
                      out + static_cast<long long>(ti) * kLat + col),
                  make_float4(__fmul_rn(tsw, r01.x), __fmul_rn(tsw, r01.y),
                              __fmul_rn(tsw, r23.x), __fmul_rn(tsw, r23.y)));
      }
    }
  }
}

}  // namespace

// num_bar [rows / k] f32, w [rows] f32, r_lat [rows, 32] bf16, idx [rows]
// i32 (point-major pair rows, k per point), out [n, 32] f32, zeroed by the
// kernel itself (one cooperative launch: a grid barrier between the zero
// fill and the adds). Returns the first CUDA error code.
extern "C" int pair_sdf_aggregate_bwd_launch(const float* num_bar,
                                             const float* w, const void* r_lat,
                                             const int* idx, int rows, int k,
                                             int n, float* out, void* stream) {
  if (rows < 0 || k <= 0 || rows % k != 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int max_blocks = 0;   // co-resident blocks: the grid barrier's cap
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, agg_bwd_kernel, kThreads, 0)) != cudaSuccess)
      return static_cast<int>(err);
    max_blocks = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  }
  // a warp a window of 32 rows, and at most 4 float4 of zeros a thread
  const long long windows = (rows + 31LL) / 32;
  long long need = (windows + kWarps - 1) / kWarps;
  const long long zero = (static_cast<long long>(n) * (kLat / 4) +
                          4 * kThreads - 1) / (4 * kThreads);
  if (need < zero) need = zero;
  const int blocks = static_cast<int>(need < max_blocks ? need : max_blocks);
  const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(r_lat);
  void* args[] = {&num_bar, &w, &r, &idx, &rows, &k, &n, &out};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(agg_bwd_kernel), blocks, kThreads, args, 0,
      static_cast<cudaStream_t>(stream)));
}
