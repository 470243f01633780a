// K2 / K3 — fused gather + frozen-prior pair MLP + RBF weight + per-point
// aggregation; K6 / K7 — the same prior per pair row, without them.
//
// Replaces the TPU kernels of spurfies_tpu/ops/pallas_mlp.py:
//   * K2: _fused_value_agg_call -> _value_kernel_agg (value only; the
//     sampler's no-grad SDF probe),
//   * K3: _fused_agg_call -> _mlp_kernel_agg (value + input gradient by a
//     down sweep with transposed weights; the render-path SDF and normal),
//   * K6a / K6b: _fused_mlp_gx_call -> _mlp_kernel_gx and
//     _fused_value_gx_call -> _value_kernel_gx (raw gathered rows
//     [lat | pos] and a query per row; model.fused_agg=false),
//   * K7a / K7b: _fused_mlp_call -> _mlp_kernel and _fused_value_call ->
//     _value_kernel (a pre-assembled u = [lat | x_pi]; the pair-compacted
//     SDF of model.pair_budget_frac, and the pair-MLP microbenchmark).
// K6 and K7 share K2/K3's sweeps (mlp_sweeps) and rounding points: a block
// owns 128 consecutive rows, reads them as one contiguous run, and writes s
// (and r = ds/du, all 35 columns in f32, staged in shared memory so that
// the write is one contiguous run too); the ragged last block is masked.
// Their first layer is one 48-deep product over bf16(u), equal to the TPU
// body's g_lat @ W_lat + x_pi @ W_pos up to f32 summation order.
//
// What they compute, per pair row t = (point p, neighbour j) with table row
// g = table[idx[p, j]] = [lat (32) | pos (3)] (row N is the dump row, pos
// 1e9, so w == 0; an index outside [0, N] reads the dump row too):
//   x_pi = x[p] - pos;  w = exp(-rbf^2 |x_pi|^2)
//   a0 = lat @ W_lat + x_pi @ W_pos + b0; then 3 x (LeakyReLU(0.01), 256x256)
//   s  = LeakyReLU(a3) @ w_v + b_v   (F_geometry[4] and T pre-fused, f32)
//   K3 only: r = ds/du by the down sweep, gates (a > 0 ? 1 : 0.01)
//   per point: K2 (sum w s, sum w); K3 (sum w s, sum w, sum w r_pos)
//   K3 residuals per pair: w (f32) and r_lat (bf16), for the latent
//   gradient of the training slice.
// Rounding follows _mlp_kernel_agg: bf16 operands, f32 accumulation, bias
// added in f32, activations rounded to bf16 after each LeakyReLU, the
// down-sweep delta rounded to bf16 after each product and after each gate.
//
// What bounds it on an H100: operations. About 0.41 MFLOP per pair for K2
// and 0.82 for K3 against ~150 bytes of input and output per pair: far
// above the card's ~295 FLOP/byte ridge. K6/K7 do the same work per row
// against 150-310 bytes (r is written in f32). The TPU kernel's point was to keep
// the [rows, 256] activations out of HBM; here they live in shared memory
// and the matrix products run on the tensor cores (mma.sync m16n8k16,
// bf16 -> f32), 128 pair rows per block.
//
// Design (simple first; wgmma, TMA and a persistent grid are later work):
//   * a block owns 128 pair rows (128 / k whole points), gathers its rows
//     from the table by index itself -- no [P*k, 35] array in HBM;
//   * activations: [128, 256] bf16 in shared memory (67.6 KB with padding);
//     one layer's weights [256, 256] bf16 at a time (135 KB with padding),
//     stored n-major so that both the up sweep (W^T) and the down sweep (W)
//     read B fragments as contiguous pairs; row strides of 264 elements
//     make the fragment loads bank-conflict free;
//   * 8 warps; warp w computes rows 32 (w & 3) .. +32 and columns
//     128 (w >> 2) .. +128 of each layer (2 x 16 mma tiles held in
//     registers), so a layer's output overwrites its input in place after a
//     barrier;
//   * K3 keeps the four layers' gates as bitmasks (4 x 4 KB) for the down
//     sweep;
//   * the 8 rows of a point are summed by one thread in a fixed order.
// The TPU kernel's iota band matrices (per-point sums and broadcasts as
// 0/1 matmuls) were a device for its vector unit and are gone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;     // pair rows per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kHid = 256;
constexpr int kLat = 32;       // latent columns of a table row
constexpr int kRowW = kLat + 3;
constexpr int kIn0 = 48;       // first-layer depth: 32 lat + 3 pos + 13 zero
constexpr int kOut0 = 40;      // last down-sweep width: 35 padded to 8s
constexpr int kAStr = kHid + 8;   // activation row stride (elements)
constexpr int kWStr = kHid + 8;   // weight row stride, 256-deep layers
constexpr int kW0Str = kIn0 + 8;  // weight row stride, first layer (up)
constexpr int kI0Str = kIn0 + 8;  // first-layer input row stride

// Weight buffer layout (bf16 elements), written by ops/pair_mlp.py.
constexpr int kOffUp0 = 0;                        // W0^T [256][48]
constexpr int kOffUp1 = kOffUp0 + kHid * kIn0;    // W_l^T [256][256], l=1..3
constexpr int kOffDn1 = kOffUp1 + 3 * kHid * kHid;  // W_l [256][256], l=1..3
constexpr int kOffDn0 = kOffDn1 + 3 * kHid * kHid;  // W0 [40][256]
constexpr int kOffWv = kOffDn0 + kOut0 * kHid;      // w_v [256]
// Bias buffer (f32): b0..b3 [4][256], then b_v.

// Shared memory layout (bytes).
constexpr int kSmAct = 0;
constexpr int kSmW = kSmAct + kRows * kAStr * 2;
constexpr int kSmXpi = kSmW + kHid * kWStr * 2;          // f32 [128][3]
constexpr int kSmWr = kSmXpi + kRows * 3 * 4;            // f32 [128]
constexpr int kSmS = kSmWr + kRows * 4;                  // f32 [128]
constexpr int kSmRp = kSmS + kRows * 4;                  // f32 [128][3]
constexpr int kSmIdx = kSmRp + kRows * 3 * 4;            // i32 [128]
constexpr int kSmWv = kSmIdx + kRows * 4;                // f32 [256]
constexpr int kSmGate = kSmWv + kHid * 4;                // u32 [4][128][8]
constexpr int kSmemValue = kSmGate;
constexpr int kSmemGrad = kSmGate + 4 * kRows * 8 * 4;
static_assert(kRows * kI0Str * 2 <= kRows * kAStr * 2, "layer-0 input");
static_assert(kSmemGrad <= 232448, "shared memory");

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rn(lo),
                                        __float2bfloat16_rn(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `rows` rows of `cols` bf16 (a multiple of 8) from a dense global
// array into shared memory with row stride `stride`, 16 bytes a thread.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int stride,
                                          const __nv_bfloat16* src, int rows,
                                          int cols) {
  const int chunks = cols / 8;
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int r = c / chunks, q = c - r * chunks;
    *reinterpret_cast<uint4*>(dst + r * stride + q * 8) =
        __ldg(reinterpret_cast<const uint4*>(src + r * cols + q * 8));
  }
}

// acc[2][16][4] += A[rows of warp] @ B, with A [128][K] row-major (stride
// AS) and B given n-major as Bt [256][K] (stride BS), K = 16 * KSTEPS.
template <int KSTEPS, int AS, int BS>
__device__ __forceinline__ void warp_gemm(const __nv_bfloat16* A,
                                          const __nv_bfloat16* Bt,
                                          float acc[2][16][4], int rg, int cg,
                                          int g, int t) {
#pragma unroll 1
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int k0 = ks * 16 + 2 * t;
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* ar = A + (rg * 32 + mi * 16 + g) * AS + k0;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(ar);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * AS);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(ar + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * AS + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 16; ++ni) {
      const __nv_bfloat16* br = Bt + (cg * 128 + ni * 8 + g) * BS + k0;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 8);
      mma_bf16(acc[0][ni], a[0], b0, b1);
      mma_bf16(acc[1][ni], a[1], b0, b1);
    }
  }
}

__device__ __forceinline__ void zero_acc(float acc[2][16][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 16; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// Up-sweep epilogue: a = acc + b (f32), x = bf16(max(a, 0.01 a)) written
// over the activations; with `gates`, the bits (a > 0) of this layer.
__device__ __forceinline__ void epilogue_up(float acc[2][16][4],
                                            __nv_bfloat16* act,
                                            const float* __restrict__ bias,
                                            uint32_t* gates, int rg, int cg,
                                            int g, int t) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rg * 32 + mi * 16 + g + 8 * h;
      uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int col = cg * 128 + ni * 8 + 2 * t;
        const float v0 = __fadd_rn(acc[mi][ni][2 * h], __ldg(bias + col));
        const float v1 = __fadd_rn(acc[mi][ni][2 * h + 1], __ldg(bias + col + 1));
        const uint32_t bits = (v0 > 0.f ? 1u : 0u) | (v1 > 0.f ? 2u : 0u);
        words[ni >> 2] |= bits << (2 * t + 8 * (ni & 3));
        *reinterpret_cast<uint32_t*>(act + row * kAStr + col) =
            pack_bf16(fmaxf(v0, __fmul_rn(0.01f, v0)),
                      fmaxf(v1, __fmul_rn(0.01f, v1)));
      }
      if (gates != nullptr) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t v = words[w];
          v |= __shfl_xor_sync(0xffffffffu, v, 1);
          v |= __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0) gates[row * 8 + cg * 4 + w] = v;
        }
      }
    }
  }
}

__device__ __forceinline__ float gate_of(const uint32_t* gates, int row,
                                         int col, float slope) {
  return ((gates[row * 8 + (col >> 5)] >> (col & 31)) & 1u) ? 1.f : slope;
}

// Down-sweep epilogue for a 256-wide layer: delta = bf16(bf16(acc) * gate)
// with the gate of the layer below, written over the activations.
__device__ __forceinline__ void epilogue_down(float acc[2][16][4],
                                              __nv_bfloat16* act,
                                              const uint32_t* gates, int rg,
                                              int cg, int g, int t,
                                              float slope) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rg * 32 + mi * 16 + g + 8 * h;
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int col = cg * 128 + ni * 8 + 2 * t;
        const float d0 = __fmul_rn(bf16_round(acc[mi][ni][2 * h]),
                                   gate_of(gates, row, col, slope));
        const float d1 = __fmul_rn(bf16_round(acc[mi][ni][2 * h + 1]),
                                   gate_of(gates, row, col + 1, slope));
        *reinterpret_cast<uint32_t*>(act + row * kAStr + col) =
            pack_bf16(d0, d1);
      }
    }
  }
}

// The prior's sweeps for one block of 128 rows.  On entry the first
// layer's input [lat | x_pi | 0] is in act (row stride kI0Str), W0^T in
// wsm and w_v in wv_s, after a barrier.  It runs the up sweep and the fused
// 256 -> 1 tail into s_s; with kGrad it also runs the down sweep down to the
// last product, whose [128, 40] accumulator it leaves in acc0 (warp w: rows
// 16 w .. 16 w + 15, all five n-tiles) for the caller to round and write.
// It ends without a barrier: other warps may still read act and wsm.
template <bool kGrad>
__device__ __forceinline__ void mlp_sweeps(unsigned char* smem,
                                           const __nv_bfloat16* __restrict__ wbuf,
                                           const float* __restrict__ bbuf,
                                           float acc0[5][4]) {
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + kSmAct);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + kSmW);
  float* s_s = reinterpret_cast<float*>(smem + kSmS);
  const float* wv_s = reinterpret_cast<const float*>(smem + kSmWv);
  uint32_t* gates = kGrad ? reinterpret_cast<uint32_t*>(smem + kSmGate)
                          : nullptr;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const float slope = bf16_round(0.01f);

  float acc[2][16][4];

  // --- up sweep ---
  // layer 0: the latent block (k = 0..31) and then the x_pi block
  // (k = 32..47), as two products into one f32 accumulator
  zero_acc(acc);
  warp_gemm<kIn0 / 16, kI0Str, kW0Str>(act, wsm, acc, rg, cg, g, t);
  __syncthreads();
  epilogue_up(acc, act, bbuf, gates, rg, cg, g, t);
  load_rows(wsm, kWStr, wbuf + kOffUp1, kHid, kHid);
  __syncthreads();
#pragma unroll 1
  for (int l = 1; l < 4; ++l) {
    zero_acc(acc);
    warp_gemm<kHid / 16, kAStr, kWStr>(act, wsm, acc, rg, cg, g, t);
    __syncthreads();
    epilogue_up(acc, act, bbuf + l * kHid,
                kGrad ? gates + l * kRows * 8 : nullptr, rg, cg, g, t);
    if (l < 3) {
      load_rows(wsm, kWStr, wbuf + kOffUp1 + l * kHid * kHid, kHid, kHid);
    } else if (kGrad) {
      load_rows(wsm, kWStr, wbuf + kOffDn1 + 2 * kHid * kHid, kHid, kHid);
    }
    __syncthreads();
  }

  // fused linear tail 256 -> 1: s = bf16(x4 . w_v + b_v), 16 rows a warp
  {
    const float bv = __ldg(bbuf + 4 * kHid);
#pragma unroll 1
    for (int i = 0; i < 16; ++i) {
      const int row = warp * 16 + i;
      const __nv_bfloat16* xr = act + row * kAStr + lane * 8;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        part = fmaf(__bfloat162float(xr[c]), wv_s[lane * 8 + c], part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) s_s[row] = bf16_round(__fadd_rn(part, bv));
    }
  }
  if (!kGrad) return;

  __syncthreads();
  // --- down sweep: delta = bf16(bf16(w_v) * gate3), then through the
  // transposed layers 3, 2, 1 and finally W0^T (256 -> 35) ---
  const uint32_t* gate3 = gates + 3 * kRows * 8;
  for (int e = tid; e < kRows * kHid; e += kThreads) {
    const int r = e >> 8, c = e & (kHid - 1);
    act[r * kAStr + c] = __float2bfloat16_rn(
        __fmul_rn(wv_s[c], gate_of(gate3, r, c, slope)));
  }
  __syncthreads();
#pragma unroll 1
  for (int l = 3; l >= 1; --l) {
    zero_acc(acc);
    warp_gemm<kHid / 16, kAStr, kWStr>(act, wsm, acc, rg, cg, g, t);
    __syncthreads();
    epilogue_down(acc, act, gates + (l - 1) * kRows * 8, rg, cg, g, t, slope);
    if (l > 1) {
      load_rows(wsm, kWStr, wbuf + kOffDn1 + (l - 2) * kHid * kHid, kHid,
                kHid);
    } else {
      load_rows(wsm, kWStr, wbuf + kOffDn0, kOut0, kHid);
    }
    __syncthreads();
  }
  // last product: [128, 256] x W0^T -> [128, 40]
#pragma unroll
  for (int ni = 0; ni < 5; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[ni][e] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < kHid / 16; ++ks) {
    const int k0 = ks * 16 + 2 * t;
    const __nv_bfloat16* ar = act + (warp * 16 + g) * kAStr + k0;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(ar);
    a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kAStr);
    a[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kAStr + 8);
#pragma unroll
    for (int ni = 0; ni < 5; ++ni) {
      const __nv_bfloat16* br = wsm + (ni * 8 + g) * kWStr + k0;
      mma_bf16(acc0[ni], a, *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// W0^T and w_v into shared memory (the first layer's input is the caller's).
__device__ __forceinline__ void load_first(unsigned char* smem,
                                           const __nv_bfloat16* wbuf) {
  float* wv_s = reinterpret_cast<float*>(smem + kSmWv);
  for (int c = threadIdx.x; c < kHid; c += kThreads)
    wv_s[c] = __bfloat162float(wbuf[kOffWv + c]);
  load_rows(reinterpret_cast<__nv_bfloat16*>(smem + kSmW), kW0Str,
            wbuf + kOffUp0, kHid, kIn0);
}

// K2 / K3: gather by index, RBF weight, prior, per-point sums.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 1)
pair_mlp_kernel(const float* __restrict__ table, int n_rows,
                const int* __restrict__ idx, const float* __restrict__ xq,
                int k,
                const __nv_bfloat16* __restrict__ wbuf,
                const float* __restrict__ bbuf, float rbf2,
                float* __restrict__ out_pt, float* __restrict__ out_w,
                __nv_bfloat16* __restrict__ out_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* in0 = reinterpret_cast<__nv_bfloat16*>(smem + kSmAct);
  float* xpi_s = reinterpret_cast<float*>(smem + kSmXpi);
  float* w_s = reinterpret_cast<float*>(smem + kSmWr);
  float* s_s = reinterpret_cast<float*>(smem + kSmS);
  float* rp_s = reinterpret_cast<float*>(smem + kSmRp);
  int* idx_s = reinterpret_cast<int*>(smem + kSmIdx);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int pts = kRows / k;
  const size_t pt0 = (size_t)blockIdx.x * pts;

  // --- gather: x_pi, w and the first layer's input [lat | x_pi | 0] ---
  if (tid < kRows) {
    const int raw = idx[row0 + tid];
    const int id = (raw >= 0 && raw < n_rows) ? raw : n_rows - 1;
    idx_s[tid] = id;
    const float* gr = table + (size_t)id * kRowW;
    const float* xp = xq + (pt0 + tid / k) * 3;
    const float e0 = __fsub_rn(xp[0], gr[kLat]);
    const float e1 = __fsub_rn(xp[1], gr[kLat + 1]);
    const float e2 = __fsub_rn(xp[2], gr[kLat + 2]);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1)),
                               __fmul_rn(e2, e2));
    w_s[tid] = expf(__fmul_rn(-rbf2, d2));
    xpi_s[tid * 3] = e0;
    xpi_s[tid * 3 + 1] = e1;
    xpi_s[tid * 3 + 2] = e2;
    __nv_bfloat16* ir = in0 + tid * kI0Str + kLat;
    ir[0] = __float2bfloat16_rn(e0);
    ir[1] = __float2bfloat16_rn(e1);
    ir[2] = __float2bfloat16_rn(e2);
    for (int c = 3; c < kIn0 - kLat; ++c) ir[c] = __float2bfloat16_rn(0.f);
  }
  load_first(smem, wbuf);
  __syncthreads();
  for (int e = tid; e < kRows * kLat; e += kThreads) {
    const int r = e / kLat, c = e - r * kLat;
    in0[r * kI0Str + c] =
        __float2bfloat16_rn(__ldg(table + (size_t)idx_s[r] * kRowW + c));
  }
  __syncthreads();

  float acc0[5][4];
  mlp_sweeps<kGrad>(smem, wbuf, bbuf, acc0);
  if (kGrad) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + g + 8 * h;
#pragma unroll
      for (int ni = 0; ni < 5; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = ni * 8 + 2 * t + j;
          const float r = bf16_round(acc0[ni][2 * h + j]);
          if (col < kLat) {
            out_r[(row0 + row) * kLat + col] = __float2bfloat16_rn(r);
          } else if (col < kRowW) {
            rp_s[row * 3 + (col - kLat)] = r;
          }
        }
      }
    }
  }
  __syncthreads();

  // --- per-pair residual w and per-point sums, in a fixed order ---
  if (kGrad && tid < kRows) out_w[row0 + tid] = w_s[tid];
  if (tid < pts) {
    float num = 0.f, den = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f;
    for (int j = 0; j < k; ++j) {
      const int r = tid * k + j;
      const float w = w_s[r];
      num = __fadd_rn(num, __fmul_rn(w, s_s[r]));
      den = __fadd_rn(den, w);
      if (kGrad) {
        g0 = __fadd_rn(g0, __fmul_rn(w, rp_s[r * 3]));
        g1 = __fadd_rn(g1, __fmul_rn(w, rp_s[r * 3 + 1]));
        g2 = __fadd_rn(g2, __fmul_rn(w, rp_s[r * 3 + 2]));
      }
    }
    if (kGrad) {
      float* o = out_pt + (pt0 + tid) * 5;
      o[0] = num;
      o[1] = den;
      o[2] = g0;
      o[3] = g1;
      o[4] = g2;
    } else {
      float* o = out_pt + (pt0 + tid) * 2;
      o[0] = num;
      o[1] = den;
    }
  }
}

template <bool kGrad>
int launch(const float* table, int n_rows, const int* idx, const float* x,
           int n_pts, int k, const void* wbuf, const float* bbuf, float rbf2,
           float* out_pt, float* out_w, void* out_r, void* stream) {
  if (k <= 0 || kRows % k != 0 || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pts = kRows / k;
  if (n_pts % pts != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pts == 0) return 0;
  const int smem = kGrad ? kSmemGrad : kSmemValue;
  cudaError_t err = cudaFuncSetAttribute(
      pair_mlp_kernel<kGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_mlp_kernel<kGrad><<<n_pts / pts, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      table, n_rows, idx, x, k, static_cast<const __nv_bfloat16*>(wbuf), bbuf,
      rbf2, out_pt, out_w, static_cast<__nv_bfloat16*>(out_r));
  return static_cast<int>(cudaGetLastError());
}

// K6 / K7: the prior on each of m pair rows, no weight and no sum.  The
// input `in` is [m, 35] f32: with kRowsIn (K6) raw table rows g = [lat | pos]
// and xq [m, 3] the query of each row, so that u = [lat | x - pos] is made
// here and x_pi = x - pos (f32) written to out_xpi [m, 3]; else (K7) u
// itself.  out_s [m] = bf16(s) as f32; with kGrad (K6a / K7a) out_r [m, 35]
// = r = ds/du, the bf16 delta of the down sweep, as f32.  The last block
// is ragged: its missing rows read zeros and are not written.
template <bool kGrad, bool kRowsIn>
__global__ void __launch_bounds__(kThreads, 1)
pair_rows_kernel(const float* __restrict__ in, const float* __restrict__ xq,
                 long long m, const __nv_bfloat16* __restrict__ wbuf,
                 const float* __restrict__ bbuf, float* __restrict__ out_s,
                 float* __restrict__ out_r, float* __restrict__ out_xpi) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* in0 = reinterpret_cast<__nv_bfloat16*>(smem + kSmAct);
  float* r_s = reinterpret_cast<float*>(smem + kSmAct);  // after the sweeps
  float* xpi_s = reinterpret_cast<float*>(smem + kSmXpi);
  const float* s_s = reinterpret_cast<const float*>(smem + kSmS);

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = static_cast<int>(min((long long)kRows, m - row0));

  // the block's rows are one contiguous run of rows * 35 floats
  const float* src = in + row0 * kRowW;
  for (int e = tid; e < kRows * kRowW; e += kThreads) {
    const int r = e / kRowW, c = e - r * kRowW;
    float v = r < rows ? __ldg(src + e) : 0.f;
    if (kRowsIn && c >= kLat) {
      const float xv =
          r < rows ? __ldg(xq + (row0 + r) * 3 + (c - kLat)) : 0.f;
      v = __fsub_rn(xv, v);
      xpi_s[r * 3 + (c - kLat)] = v;
    }
    in0[r * kI0Str + c] = __float2bfloat16_rn(v);
  }
  constexpr int kPad = kIn0 - kRowW;
  for (int e = tid; e < kRows * kPad; e += kThreads) {
    const int r = e / kPad;
    in0[r * kI0Str + kRowW + (e - r * kPad)] = __float2bfloat16_rn(0.f);
  }
  load_first(smem, wbuf);
  __syncthreads();

  float acc0[5][4];
  mlp_sweeps<kGrad>(smem, wbuf, bbuf, acc0);
  if (kGrad) {
    __syncthreads();  // every warp is done reading act: stage r there
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + g + 8 * h;
#pragma unroll
      for (int ni = 0; ni < 5; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = ni * 8 + 2 * t + j;
          if (col < kRowW)
            r_s[row * kRowW + col] = bf16_round(acc0[ni][2 * h + j]);
        }
      }
    }
  }
  __syncthreads();
  if (tid < rows) out_s[row0 + tid] = s_s[tid];
  if (kGrad) {
    for (int e = tid; e < rows * kRowW; e += kThreads)
      out_r[row0 * kRowW + e] = r_s[e];
  }
  if (kRowsIn) {
    for (int e = tid; e < rows * 3; e += kThreads)
      out_xpi[row0 * 3 + e] = xpi_s[e];
  }
}

template <bool kGrad, bool kRowsIn>
int launch_rows(const float* in, const float* x, long long m,
                const void* wbuf, const float* bbuf, float* out_s,
                float* out_r, float* out_xpi, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const int smem = kGrad ? kSmemGrad : kSmemValue;
  cudaError_t err = cudaFuncSetAttribute(
      pair_rows_kernel<kGrad, kRowsIn>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (m + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pair_rows_kernel<kGrad, kRowsIn><<<static_cast<unsigned>(blocks), kThreads,
                                     smem, static_cast<cudaStream_t>(stream)>>>(
      in, x, m, static_cast<const __nv_bfloat16*>(wbuf), bbuf, out_s, out_r,
      out_xpi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [n_rows, 35] f32 (row n_rows - 1: the dump row), idx [n_pts, k]
// i32, x [n_pts, 3] f32, wbuf / bbuf: the packed weights of
// ops/pair_mlp.py. K2: out_pt [n_pts, 2] = (sum w s, sum w).
extern "C" int pair_sdf_value_agg_launch(const float* table, int n_rows,
                                         const int* idx, const float* x,
                                         int n_pts, int k, const void* wbuf,
                                         const float* bbuf, float rbf2,
                                         float* out_pt, void* stream) {
  return launch<false>(table, n_rows, idx, x, n_pts, k, wbuf, bbuf, rbf2,
                       out_pt, nullptr, nullptr, stream);
}

// K3: out_pt [n_pts, 5] = (sum w s, sum w, sum w r_pos), out_w [n_pts*k],
// out_r [n_pts*k, 32] bf16.
extern "C" int pair_sdf_aggregate_launch(const float* table, int n_rows,
                                         const int* idx, const float* x,
                                         int n_pts, int k, const void* wbuf,
                                         const float* bbuf, float rbf2,
                                         float* out_pt, float* out_w,
                                         void* out_r, void* stream) {
  return launch<true>(table, n_rows, idx, x, n_pts, k, wbuf, bbuf, rbf2,
                      out_pt, out_w, out_r, stream);
}

// K7b: u [m, 35] f32 -> out_s [m].
extern "C" int pair_sdf_value_launch(const float* u, long long m,
                                     const void* wbuf, const float* bbuf,
                                     float* out_s, void* stream) {
  return launch_rows<false, false>(u, nullptr, m, wbuf, bbuf, out_s, nullptr,
                                   nullptr, stream);
}

// K7a: u [m, 35] f32 -> out_s [m], out_r [m, 35].
extern "C" int pair_sdf_value_and_input_grad_launch(const float* u,
                                                    long long m,
                                                    const void* wbuf,
                                                    const float* bbuf,
                                                    float* out_s,
                                                    float* out_r,
                                                    void* stream) {
  return launch_rows<true, false>(u, nullptr, m, wbuf, bbuf, out_s, out_r,
                                  nullptr, stream);
}

// K6b: g [m, 35] f32, x [m, 3] f32 -> out_s [m], out_xpi [m, 3].
extern "C" int pair_sdf_rows_value_launch(const float* g, const float* x,
                                          long long m, const void* wbuf,
                                          const float* bbuf, float* out_s,
                                          float* out_xpi, void* stream) {
  return launch_rows<false, true>(g, x, m, wbuf, bbuf, out_s, nullptr,
                                  out_xpi, stream);
}

// K6a: g [m, 35] f32, x [m, 3] f32 -> out_s [m], out_r [m, 35],
// out_xpi [m, 3].
extern "C" int pair_sdf_rows_grad_launch(const float* g, const float* x,
                                         long long m, const void* wbuf,
                                         const float* bbuf, float* out_s,
                                         float* out_r, float* out_xpi,
                                         void* stream) {
  return launch_rows<true, true>(g, x, m, wbuf, bbuf, out_s, out_r, out_xpi,
                                 stream);
}
