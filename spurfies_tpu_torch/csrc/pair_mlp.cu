// K7b -- the frozen prior's value per pair row.  (K2, K3, K6a, K6b and
// K7a, the same prior on Hopper's wgmma pipeline, are csrc/sdf_agg.cu.)
//
// Replaces the TPU kernel of spurfies_tpu/ops/pallas_mlp.py:
//   * K7b: _fused_value_call -> _value_kernel (a pre-assembled u = [lat |
//     x_pi]; the pair-MLP microbenchmark).
// It follows K3's rounding points: a block owns 128 consecutive rows,
// reads them as one contiguous run and writes s; the ragged last block is
// masked.  Its first layer is one 48-deep product over bf16(u), equal to
// the TPU body's bf16(u) @ W0 up to f32 summation order.
//
// What it computes, per row with u = [lat (32) | x_pi (3)]:
//   a0 = u @ W0 + b0; then 3 x (LeakyReLU(0.01), 256x256)
//   s  = LeakyReLU(a3) @ w_v + b_v   (F_geometry[4] and T pre-fused, f32)
// Rounding follows _mlp_kernel_agg: bf16 operands, f32 accumulation, bias
// added in f32, activations rounded to bf16 after each LeakyReLU.
//
// What bounds it on an H100: operations.  About 0.41 MFLOP per row against
// 144 bytes of input and output per row: far above the card's ~295
// FLOP/byte ridge.  The TPU kernel's point was to keep the [rows, 256]
// activations out of HBM; here they live in shared memory and the matrix
// products run on the tensor cores (mma.sync m16n8k16, bf16 -> f32), 128
// rows per block.
//
// Design (simple first; sdf_agg.cu's wgmma pipeline is its next design):
//   * activations: [128, 256] bf16 in shared memory (67.6 KB with padding);
//     one layer's weights [256, 256] bf16 at a time (135 KB with padding),
//     stored n-major (W^T) so that B fragments are contiguous pairs; row
//     strides of 264 elements make the fragment loads bank-conflict free;
//   * 8 warps; warp w computes rows 32 (w & 3) .. +32 and columns
//     128 (w >> 2) .. +128 of each layer (2 x 16 mma tiles held in
//     registers), so a layer's output overwrites its input in place after a
//     barrier.

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
constexpr int kAStr = kHid + 8;   // activation row stride (elements)
constexpr int kWStr = kHid + 8;   // weight row stride, 256-deep layers
constexpr int kW0Str = kIn0 + 8;  // weight row stride, first layer (up)
constexpr int kI0Str = kIn0 + 8;  // first-layer input row stride

// Weight buffer layout (bf16 elements), PriorLayers.kernel_buffers.
constexpr int kOffUp0 = 0;                        // W0^T [256][48]
constexpr int kOffUp1 = kOffUp0 + kHid * kIn0;    // W_l^T [256][256], l=1..3
constexpr int kOffWv = kOffUp1 + 3 * kHid * kHid;   // w_v [256]
// Bias buffer (f32): b0..b3 [4][256], then b_v.

// Shared memory layout (bytes).
constexpr int kSmAct = 0;
constexpr int kSmW = kSmAct + kRows * kAStr * 2;
constexpr int kSmS = kSmW + kHid * kWStr * 2;            // f32 [128]
constexpr int kSmWv = kSmS + kRows * 4;                  // f32 [256]
constexpr int kSmem = kSmWv + kHid * 4;
static_assert(kRows * kI0Str * 2 <= kRows * kAStr * 2, "layer-0 input");
static_assert(kSmem <= 232448, "shared memory");

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
// over the activations.
__device__ __forceinline__ void epilogue_up(float acc[2][16][4],
                                            __nv_bfloat16* act,
                                            const float* __restrict__ bias,
                                            int rg, int cg, int g, int t) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rg * 32 + mi * 16 + g + 8 * h;
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int col = cg * 128 + ni * 8 + 2 * t;
        const float v0 = __fadd_rn(acc[mi][ni][2 * h], __ldg(bias + col));
        const float v1 = __fadd_rn(acc[mi][ni][2 * h + 1], __ldg(bias + col + 1));
        *reinterpret_cast<uint32_t*>(act + row * kAStr + col) =
            pack_bf16(fmaxf(v0, __fmul_rn(0.01f, v0)),
                      fmaxf(v1, __fmul_rn(0.01f, v1)));
      }
    }
  }
}

// The prior's up sweep for one block of 128 rows.  On entry the first
// layer's input [lat | x_pi | 0] is in act (row stride kI0Str), W0^T in wsm
// and w_v in wv_s, after a barrier.  It runs the four layers and the fused
// 256 -> 1 tail into s_s, and ends without a barrier.
__device__ __forceinline__ void mlp_up_sweep(
    unsigned char* smem, const __nv_bfloat16* __restrict__ wbuf,
    const float* __restrict__ bbuf) {
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + kSmAct);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + kSmW);
  float* s_s = reinterpret_cast<float*>(smem + kSmS);
  const float* wv_s = reinterpret_cast<const float*>(smem + kSmWv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;

  float acc[2][16][4];

  // layer 0: the latent block (k = 0..31) and then the x_pi block
  // (k = 32..47), as two products into one f32 accumulator
  zero_acc(acc);
  warp_gemm<kIn0 / 16, kI0Str, kW0Str>(act, wsm, acc, rg, cg, g, t);
  __syncthreads();
  epilogue_up(acc, act, bbuf, rg, cg, g, t);
  load_rows(wsm, kWStr, wbuf + kOffUp1, kHid, kHid);
  __syncthreads();
#pragma unroll 1
  for (int l = 1; l < 4; ++l) {
    zero_acc(acc);
    warp_gemm<kHid / 16, kAStr, kWStr>(act, wsm, acc, rg, cg, g, t);
    __syncthreads();
    epilogue_up(acc, act, bbuf + l * kHid, rg, cg, g, t);
    if (l < 3)
      load_rows(wsm, kWStr, wbuf + kOffUp1 + l * kHid * kHid, kHid, kHid);
    __syncthreads();
  }

  // fused linear tail 256 -> 1: s = bf16(x4 . w_v + b_v), 16 rows a warp
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

// W0^T and w_v into shared memory (the first layer's input is the caller's).
__device__ __forceinline__ void load_first(unsigned char* smem,
                                           const __nv_bfloat16* wbuf) {
  float* wv_s = reinterpret_cast<float*>(smem + kSmWv);
  for (int c = threadIdx.x; c < kHid; c += kThreads)
    wv_s[c] = __bfloat162float(wbuf[kOffWv + c]);
  load_rows(reinterpret_cast<__nv_bfloat16*>(smem + kSmW), kW0Str,
            wbuf + kOffUp0, kHid, kIn0);
}

// K7b: the prior on each of m pair rows u [m, 35] f32, no weight and no
// sum: out_s [m] = bf16(s) as f32.  The last block is ragged: its missing
// rows read zeros and are not written.
__global__ void __launch_bounds__(kThreads, 1)
pair_value_kernel(const float* __restrict__ in, long long m,
                  const __nv_bfloat16* __restrict__ wbuf,
                  const float* __restrict__ bbuf, float* __restrict__ out_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* in0 = reinterpret_cast<__nv_bfloat16*>(smem + kSmAct);
  const float* s_s = reinterpret_cast<const float*>(smem + kSmS);

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = static_cast<int>(min((long long)kRows, m - row0));

  // the block's rows are one contiguous run of rows * 35 floats
  const float* src = in + row0 * kRowW;
  for (int e = tid; e < kRows * kRowW; e += kThreads) {
    const int r = e / kRowW, c = e - r * kRowW;
    in0[r * kI0Str + c] = __float2bfloat16_rn(r < rows ? __ldg(src + e) : 0.f);
  }
  constexpr int kPad = kIn0 - kRowW;
  for (int e = tid; e < kRows * kPad; e += kThreads) {
    const int r = e / kPad;
    in0[r * kI0Str + kRowW + (e - r * kPad)] = __float2bfloat16_rn(0.f);
  }
  load_first(smem, wbuf);
  __syncthreads();

  mlp_up_sweep(smem, wbuf, bbuf);
  __syncthreads();
  if (tid < rows) out_s[row0 + tid] = s_s[tid];
}

}  // namespace

// K7b: u [m, 35] f32 -> out_s [m].
extern "C" int pair_sdf_value_launch(const float* u, long long m,
                                     const void* wbuf, const float* bbuf,
                                     float* out_s, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      pair_value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (m + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pair_value_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      u, m, static_cast<const __nv_bfloat16*>(wbuf), bbuf, out_s);
  return static_cast<int>(cudaGetLastError());
}
