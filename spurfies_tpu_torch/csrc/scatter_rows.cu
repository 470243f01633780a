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
// What bounds it on an H100: same-address atomic contention. Its byte bound
// (d * 4 bytes of ct and 4 of idx per row, into an [n, d] output small
// enough to stay in L2: n * 64 * 4 = 1.5 MB at 6k points) is about 17 us on
// the training path; it measures about 24x that, the same as index_add_ of
// the same rows (PERF.md, section 6). About 58 pair rows land on each
// colour-latent row, and a ray's top samples share their neighbours, so
// consecutive warps add into the same addresses and the L2 serializes them.
// The TPU kernel kept the whole accumulator in VMEM across a sequential grid
// and added rows one by one from SMEM indices, with several accumulator
// banks so that consecutive adds could overlap. Blocks on this card run in
// parallel and in no order, so there is no bank trick and no VMEM budget
// fallback: rows are summed with global atomics.
//
// Design (simple first): one warp per row; lane j adds columns j, j + 32,
// ... with red.global.add.f32 (atomicAdd whose result is unused); the
// output is zeroed by the caller on the same stream; the index is checked
// unsigned against n before any atomic, so a negative index is dropped too.
// A warp-level pre-sum of equal indices or a sorted segment-reduce would cut
// the contention (PERF.md, section 7); neither is measured yet.
// The order of the atomic adds changes from run to run: sums agree with a
// sequential sum up to f32 reordering, never bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const float* __restrict__ ct, int ld,
                    const int* __restrict__ idx, int m, int d, int n,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= m) return;
  const int i = __ldg(idx + row);
  if (static_cast<unsigned>(i) >= static_cast<unsigned>(n)) return;
  const float* src = ct + row * ld;
  float* dst = out + static_cast<int64_t>(i) * d;
  for (int c = lane; c < d; c += 32) atomicAdd(dst + c, __ldg(src + c));
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
  const int blocks = (m + kWarps - 1) / kWarps;
  scatter_rows_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(ct, ld, idx, m,
                                                             d, n, out);
  return static_cast<int>(cudaGetLastError());
}
