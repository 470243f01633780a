// K9 — row gather: out[m, :] = table[idx[m], :].
//
// Replaces the TPU kernel of scripts/micro_gather.py:
// gather_rows_pallas -> _gather_kernel, a microbenchmark that reads rows by
// index from a table held whole in VMEM (6144 x 40 f32 = 983 KB there).
// On an H100 that table does not fit in a block's 227 KB of shared memory,
// and it need not: the 50 MB L2 holds it after the first touch, so every
// block reads its rows straight from global memory through L2.
//
// What bounds it on an H100: bytes. Each output row is written once
// (m * d * 4 bytes) and each index read once; the table is read from HBM
// once and the gathered reads hit L2. At 655,360 x 40 that is 105 MB of
// output, 0.032 ms at 3.35 TB/s (PERF.md, section 6).
//
// Design: one thread per 16-byte vector of an output row (float4 when
// d % 4 == 0 and both pointers are 16-byte aligned, else one float), so
// that a warp writes consecutive addresses of consecutive rows. A block
// takes rows_per_block consecutive rows (rows_per_block * vectors-a-row
// threads, at most 1024); the microbenchmark sweeps rows_per_block. An
// index outside [0, n) reads nothing and writes a zero row (the JAX kernel
// leaves such a row undefined; its caller keeps indices in range).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table, int n,
                                   int vpr, const int* __restrict__ idx,
                                   long long m, V* __restrict__ out,
                                   int rows_per_block) {
  const int local_row = threadIdx.x / vpr;
  const int col = threadIdx.x - local_row * vpr;
  const long long row =
      (long long)blockIdx.x * rows_per_block + local_row;
  if (local_row >= rows_per_block || row >= m) return;
  const int i = __ldg(idx + row);
  V v;
  if ((unsigned)i < (unsigned)n) {
    v = __ldg(table + (long long)i * vpr + col);
  } else {
    v = V{};
  }
  out[row * vpr + col] = v;
}

template <typename V>
int launch(const void* table, int n, int vpr, const int* idx, long long m,
           void* out, int rows_per_block, cudaStream_t stream) {
  const int threads = rows_per_block * vpr;
  const long long blocks = (m + rows_per_block - 1) / rows_per_block;
  if (m > 0) {
    gather_rows_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const V*>(table), n, vpr, idx, m, static_cast<V*>(out),
        rows_per_block);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: [n, d] f32, contiguous; idx: [m] int32; out: [m, d] f32.
// vec4: 1 when d % 4 == 0 and table and out are 16-byte aligned (the
// wrapper decides). rows_per_block * (d / 4 or d) must be <= 1024.
int gather_rows_launch(const void* table, int n, int d, const void* idx,
                       long long m, void* out, int rows_per_block, int vec4,
                       cudaStream_t stream) {
  const int* ix = static_cast<const int*>(idx);
  if (vec4) {
    return launch<float4>(table, n, d / 4, ix, m, out, rows_per_block,
                          stream);
  }
  return launch<float>(table, n, d, ix, m, out, rows_per_block, stream);
}

}  // extern "C"
