// K8a / K8b -- the fused colour MLP stack, forward and backward, on Hopper
// (sm_90a).
//
// Replaces the TPU kernels of spurfies_tpu/ops/pallas_color.py:
//   * K8a: _color_fwd_call -> _color_fwd_kernel (call :205, body :92);
//   * K8b: _color_bwd_call -> _color_bwd_kernel (call :256, body :108):
//     the forward recomputed, the reverse sweeps, dW/db of every layer and
//     dlat.
// Per pair t = (point p, neighbour j), with x_pi [3], lat [64], wn (the
// normalized RBF weight, 0 for an invalid pair) and per point dir_enc [21]:
//   u    = [posenc(x_pi) (39) | lat (64)]          (posenc multires 6)
//   h    = u; 3 x h = bf16(max(a, 0.01 a)), a = h @ W_i + b_i (f32 bias)
//   feat = bf16(h @ W_3 + b_3)                     (no activation)
//   agg  = sum_j wn * feat                         (f32, j in order)
//   g    = bf16([dir_enc | agg]) (277); 2 x LeakyReLU layers, then
//   rgb  = sigmoid(g2 @ R_2 + b)                   (f32)
// with bf16 operands and f32 accumulation in every product.  The backward
// rounds each delta to bf16 for its products, gates it with (a > 0 ? 1 :
// 0.01) in f32, sums db from the f32 delta, and dlat is the last 64
// columns of d/du.  F_color's gates are bits of a > 0 kept by the
// recompute; R's are read from the sign of the stored bf16 activation,
// which is the sign of a except for a positive pre-activation below
// bf16's smallest subnormal.
//
// What bounds them on an H100: operations.  F_color does 446 kFLOP per
// pair and R 274 kFLOP per point against ~270 bytes of input per pair, far
// above the ~295 FLOP/byte ridge; K8b does about three times K8a's work.
//
// Design.  The weights are trainable, so they are packed once a step
// (color_pack_kernel: the 7 f32 matrices rounded to bf16 as W^T for the
// forward and W for the reverse products, 46 chunks of 32 KB in the byte
// layout of a shared-memory stage; FusedColor keeps the pack for the
// backward).  Every product then runs on one pipeline, as in sdf_agg.cu: a
// persistent grid of one block per SM, a producer warp that streams the
// chunks by cp.async.bulk into a four-stage mbarrier ring, and two consumer
// warpgroups that multiply by wgmma (m64n256k16; m64n64k16 for dlat,
// m64n8k16 for rgb) with A and B in shared memory and f32 accumulators in
// registers (setmaxnreg 40 / 232).  The stack is split where the TPU body
// already rounds, g = bf16([dir_enc | agg]), so the split is exact:
//   * pair kernels, 128 pair rows (16 points) a tile, 64 a warpgroup:
//     F_color, the wn-sum and g (K8a: color_pair_fwd_kernel; K8b's
//     recompute, color_pair_recompute_kernel, also stores the layers'
//     inputs u, h1-h3);
//   * point kernels, 128 points a tile: R on g (K8a: color_point_fwd_kernel
//     -> rgb; K8b: color_point_bwd_kernel, R forward and reverse -> R's
//     deltas and d_agg = delta_R0 @ R0[21:]^T in f32);
//   * K8b's reverse pair kernel (color_pair_bwd_kernel): delta_F3 = wn
//     d_agg[point], the reverse sweep through F3..F1 with the recompute's
//     gate bits (16 bytes a thread and layer, read before the product),
//     and dlat.
// dW/db without atomics, in a fixed order, so two launches give the same
// bits: each delta goes to a bf16 scratch beside its layer's input, and
// color_dw_kernel computes dW_l = X_l^T delta_l as a split-K product (each
// block a 128 x 128 tile over a fixed row range, mma.sync with
// ldmatrix.trans, its partial written once to [splits, 360,192]); db's
// partials are each warpgroup tile's f32 column sums (the 4 warps' sums
// added in order).  color_reduce_kernel then adds the splits and the tiles
// in order.  Cost at the training shape (26,624 points): 1.05 GB of
// scratch (1.3 % of the card; 3,840 bytes a pair row for F_color) and
// about 3 GB of HBM traffic, some 0.9 ms at 3.35 TB/s: each X and delta
// is written once and read twice by the dW pass (two 128-wide tiles).
// posenc uses sincosf (accurate, not the fast intrinsics): an invalid
// slot reads row 0, so its x_pi can be ~1, which is ~32 rad at 2^5.  Ragged tiles read zeros and
// write no output past the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kK = 8;               // neighbours per point
constexpr int kHid = 256;
constexpr int kLat = 64;
constexpr int kPos = 39;            // posenc(x_pi): 3 + 6 bands x (sin, cos) x 3
constexpr int kIn0 = kPos + kLat;   // 103
constexpr int kDir = 21;
constexpr int kRIn = kDir + kHid;   // 277
constexpr int kOut = 3;

// Output buffer of K8b (f32): dW of F0..F3, R0..R2 ([in, out] each), then
// db of F0..F3, R0, R1, R2.
constexpr int kGwR0 = kIn0 * kHid + 3 * kHid * kHid;   // 222,976
constexpr int kGwR1 = kGwR0 + kRIn * kHid;
constexpr int kGwR2 = kGwR1 + kHid * kHid;
constexpr int kGb = kGwR2 + kHid * kOut;               // 360,192
constexpr int kGrads = kGb + 6 * kHid + kOut;          // 361,731
static_assert(kGrads == 361731, "dW/db layout");

// K8b's scratch, per pair row (bf16): the inputs X_l of F_color's layers
// [u (103, zero to 128) | h1 | h2 | h3] and their deltas [d0 | d1 | d2 |
// d3]; per point (bf16): R's inputs [g (277, zero to 384) | r1 | r2] and
// deltas [d_R0 | d_R1 | d_R2 (3, zero to 128)], and d_agg (f32, 256); the
// db partials, a row per warpgroup tile (f32: F's 1,024, R's 515); the dW
// partials [splits][360,192]; F_color's gate bits (96 bytes a pair row).
constexpr int kXs = 128 + 3 * kHid;     // 896
constexpr int kDs = 4 * kHid;           // 1024
constexpr int kXr = 384 + 2 * kHid;     // 896
constexpr int kDr = 2 * kHid + 128;     // 640
constexpr int kDbF = 4 * kHid;          // 1,024
constexpr int kDbR = 2 * kHid + kOut;   // 515
constexpr int kMaxSplits = 64;
constexpr int kSplitRows = 2048;        // pair rows per split, at least

struct Biases {
  const float* b[7];   // F0..F3, R0..R2: f32 [out]
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
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

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// ---------------------------------------------------------------------------
// The Hopper pipeline (see the header): the pack, the ring, the wgmma
// products and the pair and point kernels.
namespace wg {

constexpr int kWgRows = 64;                 // rows of a consumer warpgroup
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kTile = 2 * kWgRows;          // rows (pairs or points) a tile
constexpr int kStages = 4;
constexpr int kChunk = 32768;               // bytes of a ring stage
constexpr int kBlk = kWgRows * 128;         // a 64-column block of act
constexpr int kGld = 320;                   // g as R0's A: 277 -> 5 blocks

// The packed weights: chunks of kChunk bytes, each an image of stage
// blocks ([n][64] bf16, K-major, 128-byte swizzled).  Forward products
// read W^T ([out][in]), reverse products W ([in][out]).
constexpr int kCF0 = 0;     // F0^T [256][128]: 2 chunks
constexpr int kCF1 = 2;     // F1^T, F2^T, F3^T [256][256]: 4 chunks each
constexpr int kCR0 = 14;    // R0^T [256][320]: 5 chunks
constexpr int kCR1 = 19;    // R1^T [256][256]: 4 chunks
constexpr int kCR2 = 23;    // R2^T [8][256]: 4 blocks of 1 KB
constexpr int kCR2b = 24;   // R2 [256][64] (k < 3)
constexpr int kCR1b = 25;   // R1 [256][256]: 4 chunks
constexpr int kCR0b = 29;   // R0[21:277] [256][256]: 4 chunks
constexpr int kCF3b = 33;   // F3, F2, F1 [256][256]: 4 chunks each
constexpr int kCF0b = 45;   // F0[39:103] [64][256]: 4 blocks of 8 KB
constexpr int kNChunks = 46;
constexpr int kR2Bytes = 4 * 8 * 128;

// One matrix of the pack: B[n][k] = W[k][n] (trans) or W[n + row0][k],
// zero outside W, for n < rows and k < kpad, from byte `at` (in = 0: all
// zero, for the tail of R2^T's chunk).
struct PackSeg {
  const float* w;
  int in, out, trans, rows, kpad, row0, at;
};
constexpr int kSegs = 15;
struct PackSegs {
  PackSeg s[kSegs];
  int unit0[kSegs + 1];  // first 16-byte unit of each segment
};

// One thread a 16-byte unit (8 bf16) of the packed image: unit u of a
// segment is block u / (8 rows), row r, stored chunk sc of the row, which
// holds the row's logical chunk sc ^ (r % 8).
__global__ void __launch_bounds__(256)
color_pack_kernel(PackSegs segs, bf16* __restrict__ out) {
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < segs.unit0[kSegs];
       u += gridDim.x * blockDim.x) {
    int i = 0;
    while (u >= segs.unit0[i + 1]) ++i;
    const PackSeg sg = segs.s[i];
    const int v = u - segs.unit0[i];
    const int blk = v / (sg.rows * 8), rem = v - blk * sg.rows * 8;
    const int r = rem >> 3, sc = rem & 7;
    const int c0 = blk * 64 + ((sc ^ (r & 7)) << 3);
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = c0 + e;
      if (sg.trans)
        x[e] = (k < sg.in && r < sg.out) ? __ldg(sg.w + (size_t)k * sg.out + r)
                                         : 0.f;
      else
        x[e] = (r + sg.row0 < sg.in && k < sg.out)
                   ? __ldg(sg.w + (size_t)(r + sg.row0) * sg.out + k)
                   : 0.f;
    }
    *reinterpret_cast<uint4*>(
        reinterpret_cast<char*>(out) + (size_t)sg.at +
        (size_t)blk * sg.rows * 128 + r * 128 + sc * 16) =
        make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]), pack2(x[4], x[5]),
                   pack2(x[6], x[7]));
  }
}

PackSegs pack_segs(const void* const* ws) {
  auto w = [&](int i) { return static_cast<const float*>(ws[i]); };
  constexpr int c = kChunk;
  const PackSeg s[kSegs] = {
      {w(0), kIn0, kHid, 1, kHid, 128, 0, kCF0 * c},
      {w(1), kHid, kHid, 1, kHid, kHid, 0, kCF1 * c},
      {w(2), kHid, kHid, 1, kHid, kHid, 0, (kCF1 + 4) * c},
      {w(3), kHid, kHid, 1, kHid, kHid, 0, (kCF1 + 8) * c},
      {w(4), kRIn, kHid, 1, kHid, 320, 0, kCR0 * c},
      {w(5), kHid, kHid, 1, kHid, kHid, 0, kCR1 * c},
      {w(6), kHid, kOut, 1, 8, kHid, 0, kCR2 * c},
      {w(6), 0, 0, 0, (c - kR2Bytes) / 128, 64, 0, kCR2 * c + kR2Bytes},
      {w(6), kHid, kOut, 0, kHid, 64, 0, kCR2b * c},
      {w(5), kHid, kHid, 0, kHid, kHid, 0, kCR1b * c},
      {w(4), kRIn, kHid, 0, kHid, kHid, kDir, kCR0b * c},
      {w(3), kHid, kHid, 0, kHid, kHid, 0, kCF3b * c},
      {w(2), kHid, kHid, 0, kHid, kHid, 0, (kCF3b + 4) * c},
      {w(1), kHid, kHid, 0, kHid, kHid, 0, (kCF3b + 8) * c},
      {w(0), kIn0, kHid, 0, kLat, kHid, kPos, kCF0b * c}};
  PackSegs segs;
  int at = 0;
  for (int i = 0; i < kSegs; ++i) {
    segs.s[i] = s[i];
    segs.unit0[i] = at;
    at += s[i].rows * s[i].kpad / 8;
  }
  segs.unit0[kSegs] = at;
  return segs;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) in a K-major image of 64-column blocks of
// 64 rows, 128-byte swizzled (16-byte chunk c / 8 of row r stored at chunk
// (c / 8) ^ (r % 8)): a warpgroup's activations.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * kBlk + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Expect `bytes` on `bar` and copy them from global src to shared dst,
// completion reported to `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Descriptor of a K-major, 128-byte-swizzled operand at shared address
// `addr`: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[128] (+)= A [64, 16] . B [16, 256] by descriptors; scale_d 0 overwrites.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] (+)= A [64, 16] . B [16, 64].
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[4] (+)= A [64, 16] . B [16, 8].
__device__ __forceinline__ void wgmma_8(float (&d)[4], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The ring: full[s] (the chunk arrived), empty[s] (the 8 consumer warps
// are done with it); `it` counts the chunks taken.
struct Ring {
  uint32_t base;  // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
};

// acc = A [64, 64 NKB] . B over NKB chunks of the ring (KSTEPS k16 steps
// each, one [256][64] block a chunk), each stage released when read.
template <int NKB, int KSTEPS>
__device__ __forceinline__ void layer(float (&acc)[128], uint32_t act,
                                      const Ring& ring, int& it, int lane) {
  wg_fence();
  int prev = 0;
#pragma unroll 1
  for (int kb = 0; kb < NKB; ++kb) {
    const int stage = it & (kStages - 1);
    mbar_wait(ring.full + stage, (it / kStages) & 1);
    const uint32_t a = act + kb * kBlk;
    const uint32_t b = ring.base + stage * kChunk;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      wgmma_256(acc, wg_desc(a + ks * 32), wg_desc(b + ks * 32),
                (kb | ks) != 0);
    wg_commit();
    if (kb > 0) {
      wg_wait<1>();
      if (lane == 0) mbar_arrive(ring.empty + prev);
    }
    prev = stage;
    ++it;
  }
  wg_wait<0>();
  if (lane == 0) mbar_arrive(ring.empty + prev);
}

// acc = A [64, 256] . B from one chunk holding B as four [N][64] blocks
// (N = 64: F0's latent rows; N = 8: R2^T).
template <int N>
__device__ __forceinline__ void narrow_product(float (&acc)[N / 2],
                                               uint32_t act, const Ring& ring,
                                               int& it, int lane) {
  const int stage = it & (kStages - 1);
  mbar_wait(ring.full + stage, (it / kStages) & 1);
  const uint32_t b = ring.base + stage * kChunk;
  wg_fence();
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = wg_desc(act + kb * kBlk + ks * 32);
      const uint64_t db = wg_desc(b + kb * N * 128 + ks * 32);
      if constexpr (N == 64) {
        wgmma_64(acc, da, db, (kb | ks) != 0);
      } else {
        wgmma_8(acc, da, db, (kb | ks) != 0);
      }
    }
  wg_commit();
  wg_wait<0>();
  if (lane == 0) mbar_arrive(ring.empty + stage);
  ++it;
}

// The producer's lane 0: chunk c of the packed weights into the stage of
// the stream's chunk number `it`, once the consumers have released it.
__device__ __forceinline__ void issue_chunk(const Ring& ring,
                                            unsigned char* ring_ptr,
                                            const char* wsrc, int c, int it) {
  const int stage = it & (kStages - 1);
  mbar_wait(ring.empty + stage, ((it / kStages) & 1) ^ 1);
  bulk_load(ring_ptr + stage * kChunk, wsrc + (size_t)c * kChunk,
            c == kCR2 ? kR2Bytes : kChunk, ring.full + stage);
}

// The block's dynamic shared memory, from a 1024-aligned base.
__device__ __forceinline__ unsigned char* block_smem() {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  return smem_raw + (((raw + 1023u) & ~1023u) - raw);
}

// Shared memory: the ring, two warpgroups' activations (kActW bytes
// each), f32 biases, f32 scratch, then the ring's barriers.
template <int kActW, int kBias, int kF32>
struct Smem {
  static constexpr int ring = 0;
  static constexpr int act = kStages * kChunk;
  static constexpr int act_w = kActW;
  static constexpr int bias = act + 2 * kActW;
  static constexpr int f32 = bias + kBias * 4;
  static constexpr int bar = (f32 + kF32 * 4 + 7) / 8 * 8;
  static constexpr int bytes = bar + 2 * kStages * 8 + 1024;
  static_assert(bytes <= 232448, "shared memory");
};
// pair kernels: F's biases and wn; K8b's reverse: the column-sum staging
// [2 warpgroups][4 warps][256]; point kernels: R's biases and the staging
using PairSmem = Smem<kWgRows * kHid * 2, 4 * kHid, kTile>;
using PairBwdSmem = Smem<kWgRows * kHid * 2, 0, 8 * kHid>;
using PointSmem = Smem<kWgRows * kGld * 2, 2 * kHid + 8, 8 * kHid>;

// Barriers initialised and the ring described; every thread calls it.
__device__ __forceinline__ Ring ring_setup(unsigned char* sm, int bar_off) {
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + bar_off);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return Ring{smem_u32(sm), full, empty};
}

// The producer warp: for each of the block's tiles, the chunks c0 .. c1 - 1.
__device__ __forceinline__ void produce(const Ring& ring, unsigned char* sm,
                                        const bf16* wbuf, long long n_tiles,
                                        int c0, int c1) {
  if ((threadIdx.x & 31) != 0) return;
  const char* wsrc = reinterpret_cast<const char*>(wbuf);
  int it = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x)
    for (int c = c0; c < c1; ++c) issue_chunk(ring, sm, wsrc, c, it++);
}

// A layer's epilogue over the warpgroup's accumulators (element
// 4 i + 2 h + j: row 16 w4 + g + 8 h, column 8 i + 2 t + j):
// x = bf16(max(a, 0.01 a)) (kLeaky) or bf16(a), a = acc + b in f32,
// written over the activations.  With `gate`, also the gate bits (a > 0)
// of the thread's elements: word 2 h + i / 16, bit 2 (i % 16) + j.
template <bool kLeaky>
__device__ __forceinline__ void epi_act(const float (&acc)[128],
                                        unsigned char* act, const float* bias,
                                        int w4, int g, int t,
                                        uint32_t* gate = nullptr) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * t;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w4 * 16 + g + 8 * h;
      float v0 = __fadd_rn(acc[4 * i + 2 * h], b0);
      float v1 = __fadd_rn(acc[4 * i + 2 * h + 1], b1);
      if (gate)
        gate[2 * h + (i >> 4)] |=
            ((v0 > 0.f ? 1u : 0u) | (v1 > 0.f ? 2u : 0u)) << (2 * (i & 15));
      if (kLeaky) {
        v0 = fmaxf(v0, __fmul_rn(0.01f, v0));
        v1 = fmaxf(v1, __fmul_rn(0.01f, v1));
      }
      *reinterpret_cast<uint32_t*>(act + swz(row, col)) = pack2(v0, v1);
    }
  }
}

// The consumer thread's place: warpgroup wg, its warp w4, lane = 4 g + t.
struct Me {
  int wg, ti, lane, w4, g, t;
};

__device__ __forceinline__ Me me() {
  const int tid = threadIdx.x, lane = tid & 31;
  return Me{tid / 128, tid & 127, lane, (tid >> 5) & 3, lane >> 2, lane & 3};
}

// The 4 warps' column sums staged in part [4][ld] (by stage_colsum),
// added in order into out[0, ncols); between two warpgroup barriers.
__device__ __forceinline__ void colsum_out(const float* part, int ld,
                                           int ncols, float* __restrict__ out,
                                           const Me& c) {
  bar_sync(1 + c.wg, 128);
  for (int col = c.ti; col < ncols; col += 128)
    out[col] = ((part[col] + part[ld + col]) + part[2 * ld + col]) +
               part[3 * ld + col];
  bar_sync(1 + c.wg, 128);
}

// The warp's sums of columns (col, col + 1) from each thread's sums over
// its rows: a shuffle tree over the 8 row groups, stored by g == 0 into
// the warp's row of part [4][ld].
__device__ __forceinline__ void stage_colsum(float s0, float s1, int col,
                                             float* part, int ld,
                                             const Me& c) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if (c.g == 0) {
    part[c.w4 * ld + col] = s0;
    part[c.w4 * ld + col + 1] = s1;
  }
}

// A reverse epilogue: delta = acc * (h > 0 ? 1 : 0.01) in f32, h the bf16
// activation of the layer below at (row, col): in the warpgroup's
// activations themselves, or (kGlobal) in the row-major gate_src.  delta
// is written over the activations as bf16 and its column sums staged in
// part [4][256].
template <bool kGlobal>
__device__ __forceinline__ void epi_delta(const float (&acc)[128],
                                          unsigned char* act,
                                          const bf16* gate_src, int ld,
                                          float* part, const Me& c) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * c.t;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = c.w4 * 16 + c.g + 8 * h;
      const __nv_bfloat162 hv =
          kGlobal ? *reinterpret_cast<const __nv_bfloat162*>(
                        gate_src + (size_t)row * ld + col)
                  : *reinterpret_cast<const __nv_bfloat162*>(act +
                                                             swz(row, col));
      const float d0 = acc[4 * i + 2 * h] *
                       (__bfloat162float(hv.x) > 0.f ? 1.f : 0.01f);
      const float d1 = acc[4 * i + 2 * h + 1] *
                       (__bfloat162float(hv.y) > 0.f ? 1.f : 0.01f);
      *reinterpret_cast<uint32_t*>(act + swz(row, col)) = pack2(d0, d1);
      s0 += d0;
      s1 += d1;
    }
    stage_colsum(s0, s1, col, part, kHid, c);
  }
}

// The same from gate bits (epi_act's layout, four words a thread).
__device__ __forceinline__ void epi_delta_bits(const float (&acc)[128],
                                               unsigned char* act,
                                               const uint4 gb, float* part,
                                               const Me& c) {
  const uint32_t gate[4] = {gb.x, gb.y, gb.z, gb.w};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * c.t;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = c.w4 * 16 + c.g + 8 * h;
      const uint32_t bits = gate[2 * h + (i >> 4)] >> (2 * (i & 15));
      const float d0 = acc[4 * i + 2 * h] * ((bits & 1u) ? 1.f : 0.01f);
      const float d1 = acc[4 * i + 2 * h + 1] * ((bits & 2u) ? 1.f : 0.01f);
      *reinterpret_cast<uint32_t*>(act + swz(row, col)) = pack2(d0, d1);
      s0 += d0;
      s1 += d1;
    }
    stage_colsum(s0, s1, col, part, kHid, c);
  }
}

// The warpgroup's activations, columns [0, 8 n8) of its 64 rows, to the
// global row-major dst (row stride ld), zero from 8 n8 to 8 w8.
__device__ __forceinline__ void act_out(bf16* __restrict__ dst, int ld,
                                        const unsigned char* act, int n8,
                                        int w8, int ti) {
  for (int e = ti; e < kWgRows * w8; e += 128) {
    const int r = e / w8, q = e - r * w8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + q * 8) =
        q < n8 ? *reinterpret_cast<const uint4*>(act + swz(r, q * 8))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}


// The pair half: F_color on 128 pair rows (16 points) a tile, the wn-sum,
// and g = bf16([dir_enc | agg]) into g_out [P, ldg] (zero from 277 to
// gcols).  kStore (K8b's recompute): also each layer's input, u and h1-h3,
// into xs [rows, kXs] for the dW products, and the gate bits of layers 0-2
// into gbits [warpgroup tile][3][128 threads] (uint4 a thread).
template <bool kStore>
__device__ __forceinline__ void pair_fwd_body(
    const float* __restrict__ x_pi, const float* __restrict__ lat,
    const float* __restrict__ wn, const float* __restrict__ dir_enc,
    long long n_pts, const bf16* __restrict__ wbuf, Biases p,
    bf16* __restrict__ g_out, int ldg, int gcols, bf16* __restrict__ xs,
    uint4* __restrict__ gbits) {
  using S = PairSmem;
  unsigned char* sm = block_smem();
  float* bias_s = reinterpret_cast<float*>(sm + S::bias);
  float* wn_s = reinterpret_cast<float*>(sm + S::f32);
  for (int e = threadIdx.x; e < 4 * kHid; e += kThreads)
    bias_s[e] = __ldg(p.b[e / kHid] + (e % kHid));
  const Ring ring = ring_setup(sm, S::bar);
  __syncthreads();
  const long long m = n_pts * kK;
  const long long n_tiles = (m + kTile - 1) / kTile;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x / 32 == 8)
      produce(ring, sm + S::ring, wbuf, n_tiles, kCF0, kCR0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const Me c = me();
  unsigned char* act = sm + S::act + c.wg * S::act_w;
  const uint32_t act_a = smem_u32(act);
  float* wn_w = wn_s + c.wg * kWgRows;
  int it = 0;
  float acc[128];
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kTile + c.wg * kWgRows;
    // u = [posenc(x_pi) | lat | 0] (128 columns) and wn; rows past m
    // zero.  Two threads a row: half h takes bands 3 h .. 3 h + 2 (one
    // sincosf for each band's sin and cos) and lat's columns 32 h ..
    {
      const int r = c.ti >> 1, h = c.ti & 1;
      const long long row = row0 + r;
      const bool in = row < m;
      auto put = [&](int col, float v) {
        *reinterpret_cast<bf16*>(act + swz(r, col)) = __float2bfloat16_rn(v);
      };
      float x[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = in ? __ldg(x_pi + row * 3 + k) : 0.f;
      if (h == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) put(k, x[k]);
      }
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int band = 3 * h + b;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float sv, cv;
          sincosf(x[k] * static_cast<float>(1 << band), &sv, &cv);
          put(3 + 6 * band + k, in ? sv : 0.f);
          put(6 + 6 * band + k, in ? cv : 0.f);
        }
      }
      const float4* lp =
          reinterpret_cast<const float4*>(lat + (in ? row : 0) * kLat) + 8 * h;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4 v = in ? __ldg(lp + k) : make_float4(0.f, 0.f, 0.f, 0.f);
        const int col = kPos + 32 * h + 4 * k;
        put(col, v.x);
        put(col + 1, v.y);
        put(col + 2, v.z);
        put(col + 3, v.w);
      }
      if (h == 1) {
        put(kIn0, 0.f);
#pragma unroll
        for (int q = 13; q < 16; ++q)
          *reinterpret_cast<uint4*>(act + swz(r, q * 8)) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (c.ti < kWgRows)
      wn_w[c.ti] = row0 + c.ti < m ? __ldg(wn + row0 + c.ti) : 0.f;
    fence_async_smem();
    bar_sync(1 + c.wg, 128);
    if (kStore) act_out(xs + row0 * kXs, kXs, act, 16, 16, c.ti);
#pragma unroll 1
    for (int l = 0; l < 4; ++l) {
      if (l == 0)
        layer<2, 4>(acc, act_a, ring, it, c.lane);
      else
        layer<4, 4>(acc, act_a, ring, it, c.lane);
      bar_sync(1 + c.wg, 128);
      if (l < 3 && kStore) {
        uint32_t gate[4] = {0u, 0u, 0u, 0u};
        epi_act<true>(acc, act, bias_s + l * kHid, c.w4, c.g, c.t, gate);
        gbits[((t * 2 + c.wg) * 3 + l) * 128 + c.ti] =
            make_uint4(gate[0], gate[1], gate[2], gate[3]);
      } else if (l < 3) {
        epi_act<true>(acc, act, bias_s + l * kHid, c.w4, c.g, c.t);
      } else {
        epi_act<false>(acc, act, bias_s + l * kHid, c.w4, c.g, c.t);
      }
      fence_async_smem();
      bar_sync(1 + c.wg, 128);
      if (kStore && l < 3)
        act_out(xs + row0 * kXs + 128 + l * kHid, kXs, act, 32, 32, c.ti);
    }
    // agg = sum_j wn feat (f32, j in order) and g of the warpgroup's 8
    // points: columns 2 ti, 2 ti + 1 of each
    const long long pt0 = row0 / kK;
#pragma unroll 1
    for (int pp = 0; pp < kWgRows / kK; ++pp) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const int r = pp * kK + j;
        const __nv_bfloat162 f = *reinterpret_cast<const __nv_bfloat162*>(
            act + swz(r, 2 * c.ti));
        s0 = __fadd_rn(s0, __fmul_rn(__low2float(f), wn_w[r]));
        s1 = __fadd_rn(s1, __fmul_rn(__high2float(f), wn_w[r]));
      }
      const long long pt = pt0 + pp;
      if (pt < n_pts) {
        bf16* gr = g_out + pt * ldg;
        gr[kDir + 2 * c.ti] = __float2bfloat16_rn(s0);
        gr[kDir + 2 * c.ti + 1] = __float2bfloat16_rn(s1);
        if (c.ti < kDir)
          gr[c.ti] = __float2bfloat16_rn(__ldg(dir_enc + pt * kDir + c.ti));
        for (int col = kRIn + c.ti; col < gcols; col += 128)
          gr[col] = __float2bfloat16_rn(0.f);
      }
    }
    bar_sync(1 + c.wg, 128);  // act is read before the next tile's u
  }
}

// The point half: R on 128 points a tile (64 a warpgroup) from g [P, ldg]
// bf16.  K8a: rgb [P, 3] f32.  kBwd (K8b): from rgb_bar, R's reverse
// sweep: r1, r2 into xr (g is there already), the bf16 deltas into dr,
// their f32 column sums into dbp (a row of 515 a warpgroup tile), and
// d_agg = delta_R0 @ R0[21:]^T (f32) into d_agg [P, 256].
template <bool kBwd>
__device__ __forceinline__ void point_body(
    const bf16* __restrict__ g_in, int ldg, long long n_pts,
    const bf16* __restrict__ wbuf, Biases p, float* __restrict__ rgb,
    const float* __restrict__ rgb_bar, bf16* __restrict__ xr,
    bf16* __restrict__ dr, float* __restrict__ d_agg,
    float* __restrict__ dbp) {
  using S = PointSmem;
  unsigned char* sm = block_smem();
  float* bias_s = reinterpret_cast<float*>(sm + S::bias);
  for (int e = threadIdx.x; e < 2 * kHid + 8; e += kThreads)
    bias_s[e] = e < 2 * kHid ? __ldg(p.b[4 + e / kHid] + (e % kHid))
                             : (e - 2 * kHid < kOut
                                    ? __ldg(p.b[6] + (e - 2 * kHid))
                                    : 0.f);
  const Ring ring = ring_setup(sm, S::bar);
  __syncthreads();
  const long long n_tiles = (n_pts + kTile - 1) / kTile;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x / 32 == 8)
      produce(ring, sm + S::ring, wbuf, n_tiles, kCR0,
              kBwd ? kCF3b : kCR2 + 1);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const Me c = me();
  unsigned char* act = sm + S::act + c.wg * S::act_w;
  const uint32_t act_a = smem_u32(act);
  float* part = reinterpret_cast<float*>(sm + S::f32) + c.wg * 4 * kHid;
  int it = 0;
  float acc[128];
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long pt0 = t * kTile + c.wg * kWgRows;
    // g (320 columns); points past P zero
    for (int e = c.ti; e < kWgRows * (kGld / 8); e += 128) {
      const int r = e / (kGld / 8), q = e - r * (kGld / 8);
      const long long pt = pt0 + r;
      *reinterpret_cast<uint4*>(act + swz(r, q * 8)) =
          pt < n_pts ? *reinterpret_cast<const uint4*>(g_in + pt * ldg + q * 8)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    fence_async_smem();
    bar_sync(1 + c.wg, 128);
    layer<5, 4>(acc, act_a, ring, it, c.lane);
    bar_sync(1 + c.wg, 128);
    epi_act<true>(acc, act, bias_s, c.w4, c.g, c.t);
    fence_async_smem();
    bar_sync(1 + c.wg, 128);
    if (kBwd) act_out(xr + pt0 * kXr + 384, kXr, act, 32, 32, c.ti);
    layer<4, 4>(acc, act_a, ring, it, c.lane);
    bar_sync(1 + c.wg, 128);
    epi_act<true>(acc, act, bias_s + kHid, c.w4, c.g, c.t);
    fence_async_smem();
    bar_sync(1 + c.wg, 128);
    if (kBwd) act_out(xr + pt0 * kXr + 384 + kHid, kXr, act, 32, 32, c.ti);
    float z[4];
    narrow_product<8>(z, act_a, ring, it, c.lane);
    if (!kBwd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = c.w4 * 16 + c.g + 8 * (e >> 1),
                  col = 2 * c.t + (e & 1);
        const long long pt = pt0 + row;
        if (col < kOut && pt < n_pts)
          rgb[pt * kOut + col] =
              1.f / (1.f + expf(-__fadd_rn(z[e], bias_s[2 * kHid + col])));
      }
      bar_sync(1 + c.wg, 128);  // act is read before the next tile's g
      continue;
    }
    // --- R, reverse: d3 = rgb_bar s (1 - s) (f32), bf16 into block 4 ---
    float* db_row = dbp + (t * 2 + c.wg) * kDbR;
    unsigned char* act4 = act + 4 * kBlk;
    float d3[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = c.w4 * 16 + c.g + 8 * (e >> 1), col = 2 * c.t + (e & 1);
      const long long pt = pt0 + row;
      const float s =
          1.f / (1.f + expf(-__fadd_rn(z[e], bias_s[2 * kHid + col])));
      const float rb = (col < kOut && pt < n_pts)
                           ? __ldg(rgb_bar + pt * kOut + col) : 0.f;
      d3[e] = __fmul_rn(__fmul_rn(rb, s), __fsub_rn(1.f, s));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          act4 + swz(c.w4 * 16 + c.g + 8 * h, 2 * c.t)) =
          pack2(d3[2 * h], d3[2 * h + 1]);
    for (int e = c.ti; e < kWgRows * 7; e += 128) {
      const int r = e / 7, q = 1 + e - r * 7;
      *reinterpret_cast<uint4*>(act4 + swz(r, q * 8)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    stage_colsum(d3[0] + d3[2], d3[1] + d3[3], 2 * c.t, part, 8, c);
    fence_async_smem();
    colsum_out(part, 8, kOut, db_row + 2 * kHid, c);
    act_out(dr + pt0 * kDr + 2 * kHid, kDr, act4, 8, 16, c.ti);
    // delta_R1 = (d3 @ R2^T) * gate(r2), r2 in act
    layer<1, 1>(acc, act_a + 4 * kBlk, ring, it, c.lane);
    bar_sync(1 + c.wg, 128);
    epi_delta<false>(acc, act, nullptr, 0, part, c);
    fence_async_smem();
    colsum_out(part, kHid, kHid, db_row + kHid, c);
    act_out(dr + pt0 * kDr + kHid, kDr, act, 32, 32, c.ti);
    // delta_R0 = (delta_R1 @ R1^T) * gate(r1), r1 in xr
    layer<4, 4>(acc, act_a, ring, it, c.lane);
    bar_sync(1 + c.wg, 128);
    epi_delta<true>(acc, act, xr + pt0 * kXr + 384, kXr, part, c);
    fence_async_smem();
    colsum_out(part, kHid, kHid, db_row, c);
    act_out(dr + pt0 * kDr, kDr, act, 32, 32, c.ti);
    // d_agg = delta_R0 @ R0[21:]^T (f32)
    layer<4, 4>(acc, act_a, ring, it, c.lane);
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long pt = pt0 + c.w4 * 16 + c.g + 8 * h;
        *reinterpret_cast<float2*>(d_agg + pt * kHid + 8 * i + 2 * c.t) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    bar_sync(1 + c.wg, 128);  // act is read before the next tile's g
  }
}

// K8b's reverse pair kernel: for 128 pair rows a tile, delta_F3 = bf16(wn
// d_agg[point]), then delta_{l-1} = (delta_l @ F_l^T) * gate(h_l) for l =
// 3, 2, 1 (the gate bits of the recompute), each bf16 delta into ds and
// its f32 column sums
// into dbp (a row of 1,024 a warpgroup tile), and dlat = (delta_F0 @
// F0[39:103]^T) (f32).
__device__ __forceinline__ void pair_bwd_body(
    const float* __restrict__ wn, const float* __restrict__ d_agg,
    long long n_pts, const bf16* __restrict__ wbuf,
    const uint4* __restrict__ gbits, bf16* __restrict__ ds,
    float* __restrict__ dlat, float* __restrict__ dbp) {
  using S = PairBwdSmem;
  unsigned char* sm = block_smem();
  const Ring ring = ring_setup(sm, S::bar);
  __syncthreads();
  const long long m = n_pts * kK;
  const long long n_tiles = (m + kTile - 1) / kTile;
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x / 32 == 8)
      produce(ring, sm + S::ring, wbuf, n_tiles, kCF3b, kNChunks);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const Me c = me();
  unsigned char* act = sm + S::act + c.wg * S::act_w;
  const uint32_t act_a = smem_u32(act);
  float* part = reinterpret_cast<float*>(sm + S::f32) + c.wg * 4 * kHid;
  int it = 0;
  float acc[128];
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kTile + c.wg * kWgRows;
    float* db_row = dbp + (t * 2 + c.wg) * (4 * kHid);
    // delta_F3 = wn d_agg[point] (f32): thread ti takes 8 columns (q) of
    // rows ti / 32 + 4 k; rows past m zero
    {
      const int q = c.ti & 31, rg = c.ti >> 5;
      float s[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = 0.f;
#pragma unroll 4
      for (int k = 0; k < kWgRows / 4; ++k) {
        const int r = rg + 4 * k;
        const long long row = row0 + r;
        const float w = row < m ? __ldg(wn + row) : 0.f;
        const float4* src =
            reinterpret_cast<const float4*>(d_agg + (row / kK) * kHid + q * 8);
        const float4 a = __ldg(src), b = __ldg(src + 1);
        const float d[8] = {a.x * w, a.y * w, a.z * w, a.w * w,
                            b.x * w, b.y * w, b.z * w, b.w * w};
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e] += d[e];
        *reinterpret_cast<uint4*>(act + swz(r, q * 8)) =
            make_uint4(pack2(d[0], d[1]), pack2(d[2], d[3]), pack2(d[4], d[5]),
                       pack2(d[6], d[7]));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) part[rg * kHid + q * 8 + e] = s[e];
    }
    fence_async_smem();
    colsum_out(part, kHid, kHid, db_row + 3 * kHid, c);
    act_out(ds + row0 * kDs + 3 * kHid, kDs, act, 32, 32, c.ti);
#pragma unroll 1
    for (int l = 3; l >= 1; --l) {
      const uint4 gb = __ldg(gbits + ((t * 2 + c.wg) * 3 + l - 1) * 128 + c.ti);
      layer<4, 4>(acc, act_a, ring, it, c.lane);
      bar_sync(1 + c.wg, 128);
      epi_delta_bits(acc, act, gb, part, c);
      fence_async_smem();
      colsum_out(part, kHid, kHid, db_row + (l - 1) * kHid, c);
      act_out(ds + row0 * kDs + (l - 1) * kHid, kDs, act, 32, 32, c.ti);
    }
    // dlat = (delta_F0 @ F0[39:103]^T)[:, 0:64] (f32, no gate)
    float a[32];
    narrow_product<64>(a, act_a, ring, it, c.lane);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + c.w4 * 16 + c.g + 8 * h;
        if (row < m)
          *reinterpret_cast<float2*>(dlat + row * kLat + 8 * i + 2 * c.t) =
              make_float2(a[4 * i + 2 * h], a[4 * i + 2 * h + 1]);
      }
    bar_sync(1 + c.wg, 128);  // act is read before the next tile's delta
  }
}

__global__ void __launch_bounds__(kThreads, 1)
color_pair_fwd_kernel(const float* __restrict__ x_pi,
                      const float* __restrict__ lat,
                      const float* __restrict__ wn,
                      const float* __restrict__ dir_enc, long long n_pts,
                      const bf16* __restrict__ wbuf, Biases p,
                      bf16* __restrict__ g_out) {
  pair_fwd_body<false>(x_pi, lat, wn, dir_enc, n_pts, wbuf, p, g_out, kGld,
                       kGld, nullptr, nullptr);
}

__global__ void __launch_bounds__(kThreads, 1)
color_point_fwd_kernel(const bf16* __restrict__ g_in, long long n_pts,
                       const bf16* __restrict__ wbuf, Biases p,
                       float* __restrict__ rgb) {
  point_body<false>(g_in, kGld, n_pts, wbuf, p, rgb, nullptr, nullptr,
                    nullptr, nullptr, nullptr);
}

__global__ void __launch_bounds__(kThreads, 1)
color_pair_recompute_kernel(const float* __restrict__ x_pi,
                            const float* __restrict__ lat,
                            const float* __restrict__ wn,
                            const float* __restrict__ dir_enc,
                            long long n_pts, const bf16* __restrict__ wbuf,
                            Biases p, bf16* __restrict__ xr,
                            bf16* __restrict__ xs,
                            uint4* __restrict__ gbits) {
  pair_fwd_body<true>(x_pi, lat, wn, dir_enc, n_pts, wbuf, p, xr, kXr, 384,
                      xs, gbits);
}

__global__ void __launch_bounds__(kThreads, 1)
color_point_bwd_kernel(long long n_pts, const bf16* __restrict__ wbuf,
                       Biases p, const float* __restrict__ rgb_bar,
                       bf16* __restrict__ xr, bf16* __restrict__ dr,
                       float* __restrict__ d_agg, float* __restrict__ dbp) {
  point_body<true>(xr, kXr, n_pts, wbuf, p, nullptr, rgb_bar, xr, dr, d_agg,
                   dbp);
}

__global__ void __launch_bounds__(kThreads, 1)
color_pair_bwd_kernel(const float* __restrict__ wn,
                      const float* __restrict__ d_agg, long long n_pts,
                      const bf16* __restrict__ wbuf,
                      const uint4* __restrict__ gbits, bf16* __restrict__ ds,
                      float* __restrict__ dlat, float* __restrict__ dbp) {
  pair_bwd_body(wn, d_agg, n_pts, wbuf, gbits, ds, dlat, dbp);
}

// One block per SM, at most one a tile; the kernel's shared memory allowed.
cudaError_t grid_for(const void* kernel, int smem, long long tiles,
                     int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  *grid = static_cast<int>(sms < tiles ? sms : tiles);
  return err;
}

Biases biases(const void* const* bs) {
  Biases p;
  for (int i = 0; i < 7; ++i) p.b[i] = static_cast<const float*>(bs[i]);
  return p;
}

}  // namespace wg

// --- dW = X^T delta as a split-K product, and the fixed-order sums ---

// One layer's product for the dW kernel: X [rows, .] and delta [rows, .]
// bf16 (row strides ldx, ldd; first column x0, d0), dW [m_real, n_real]
// at `out` of each split's partial.
struct DwJob {
  const bf16* x;
  const bf16* d;
  int ldx, ldd, x0, d0, m_real, n_real;
  long long rows;
  int out;
};

// The 7 layers' jobs; layer l's 128 x 128 output tiles are the blocks
// tile0[l] .. tile0[l + 1] - 1 of gridDim.x; blockIdx.y is the split.
struct DwJobs {
  DwJob l[7];
  int tile0[8];
};

constexpr int kDwThreads = 256;          // 8 warps
constexpr int kDwRows = 32;              // rows of a k-chunk
constexpr int kDwS = 136;                // shared row stride (bf16)

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// Block (tile, split): a 128 x 128 tile of dW_l = X^T delta over the
// split's rows, in k-chunks of 32 rows (cp.async, two buffers); 8 warps
// of 64 x 32; A = X^T and B = delta both read with ldmatrix.trans from
// their row-major chunks.  The partial goes to part[split][...], written
// once: no atomics, so the sum over splits is in a fixed order.
__global__ void __launch_bounds__(kDwThreads)
color_dw_kernel(DwJobs jobs, float* __restrict__ part) {
  __shared__ __align__(16) bf16 xs_s[2][kDwRows][kDwS];
  __shared__ __align__(16) bf16 ds_s[2][kDwRows][kDwS];
  int l = 0;
  while ((int)blockIdx.x >= jobs.tile0[l + 1]) ++l;
  const DwJob j = jobs.l[l];
  const int tile = blockIdx.x - jobs.tile0[l];
  const int n_tiles = (j.n_real + 127) / 128;
  const int mt = tile / n_tiles, nt = tile - mt * n_tiles;
  const long long per =
      ((j.rows + gridDim.y - 1) / gridDim.y + kDwRows - 1) / kDwRows * kDwRows;
  const long long r0 = (long long)blockIdx.y * per;
  const long long r1 = min(j.rows, r0 + per);
  const int chunks = r1 > r0 ? (int)((r1 - r0 + kDwRows - 1) / kDwRows) : 0;
  const bf16* xb = j.x + j.x0 + mt * 128;
  const bf16* db = j.d + j.d0 + nt * 128;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  auto load = [&](int c, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kDwThreads, r = e >> 4, q = e & 15;
      const long long row = r0 + (long long)c * kDwRows + r;
      const bool on = row < r1;
      const long long src = on ? row : r0;
      cp_async16(&xs_s[buf][r][q * 8], xb + src * j.ldx + q * 8, on);
      cp_async16(&ds_s[buf][r][q * 8], db + src * j.ldd + q * 8, on);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[4][4][4];
  zero_acc(acc);
  if (chunks > 0) load(0, 0);
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) {
      load(c + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kDwRows / 16; ++ks) {
      const int k0 = ks * 16;
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_t(a[mi], &xs_s[buf][k0 + (lane & 7) + ((lane >> 4) << 3)]
                              [wm * 64 + mi * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_t(b[np], &ds_s[buf][k0 + (lane & 7) + ((lane >> 3) & 1) * 8]
                              [wn * 32 + np * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni >> 1][2 * (ni & 1)],
                   b[ni >> 1][2 * (ni & 1) + 1]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * kGb + j.out;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 128 + wm * 64 + mi * 16 + g + 8 * (e >> 1);
        const int col = nt * 128 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (row < j.m_real && col < j.n_real)
          out[(size_t)row * j.n_real + col] = acc[mi][ni][e];
      }
}

// grads = the dW partials summed over the splits and the db partials over
// the warpgroup tiles, each in a fixed order.  Blocks below dw_blocks: one
// dW value a thread; the rest: 32 db columns a block, warp w summing the
// tiles w, w + 8, ... and lane 0..31 then adding the 8 warps' sums in
// order.
__global__ void __launch_bounds__(kDwThreads)
color_reduce_kernel(const float* __restrict__ part, int splits,
                    const float* __restrict__ dbf, int n_f,
                    const float* __restrict__ dbr, int n_r, int dw_blocks,
                    float* __restrict__ grads) {
  constexpr int kWarps = kDwThreads / 32;
  __shared__ float sums[kWarps][32];
  if ((int)blockIdx.x < dw_blocks) {
    const int e = blockIdx.x * kDwThreads + threadIdx.x;
    if (e >= kGb) return;
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * kGb + e];
    grads[e] = s;
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = (blockIdx.x - dw_blocks) * 32 + lane;
  const bool f = col < kDbF;
  const float* src = f ? dbf + col : dbr + (col - kDbF);
  const int ld = f ? kDbF : kDbR, n = f ? n_f : n_r;
  float s = 0.f;
  if (col < kDbF + kDbR)
    for (int b = warp; b < n; b += kWarps) s += src[(size_t)b * ld];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < kDbF + kDbR) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += sums[w][lane];
    grads[kGb + col] = v;
  }
}

// K8b's scratch, carved from one buffer: xs, ds, xr, dr, d_agg, the db
// partials of the pair and point tiles, the dW partials, the gate bits.
struct BwdScratch {
  size_t off[9];
  size_t bytes;
  long long pair_tiles, point_tiles;
  int splits;
};

BwdScratch bwd_scratch(long long n_pts) {
  BwdScratch sc;
  sc.pair_tiles = (n_pts * kK + wg::kTile - 1) / wg::kTile;
  sc.point_tiles = (n_pts + wg::kTile - 1) / wg::kTile;
  const long long rows = sc.pair_tiles * wg::kTile;
  const long long pts = sc.point_tiles * wg::kTile;
  const long long split = (n_pts * kK + kSplitRows - 1) / kSplitRows;
  sc.splits = static_cast<int>(split < 1            ? 1
                               : split > kMaxSplits ? kMaxSplits
                                                    : split);
  const size_t sizes[9] = {(size_t)rows * kXs * 2,
                           (size_t)rows * kDs * 2,
                           (size_t)pts * kXr * 2,
                           (size_t)pts * kDr * 2,
                           (size_t)pts * kHid * 4,
                           (size_t)sc.pair_tiles * 2 * kDbF * 4,
                           (size_t)sc.point_tiles * 2 * kDbR * 4,
                           (size_t)sc.splits * kGb * 4,
                           (size_t)sc.pair_tiles * 2 * 3 * 128 * 16};
  size_t at = 0;
  for (int i = 0; i < 9; ++i) {
    sc.off[i] = at;
    at += (sizes[i] + 255) / 256 * 256;
  }
  sc.bytes = at;
  return sc;
}

}  // namespace

// The pack (once a step): ws, host array of the 7 device pointers of
// F_color's and R's f32 weights [in, out] -> out, bf16 [46 * 16384]
// (wg::pack_segs' images; fused_color.pack_color_weights_ref is its plain
// version).
extern "C" int color_pack_launch(const void* const* ws, void* out,
                                 void* stream) {
  const wg::PackSegs segs = wg::pack_segs(ws);
  const int units = segs.unit0[wg::kSegs];
  wg::color_pack_kernel<<<(units + 255) / 256, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      segs, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K8a. x_pi [8P, 3], lat [8P, 64], wn [8P], dir_enc [P, 21] f32; wbuf: the
// pack; bs: host array of the 7 device pointers of the f32 biases; g:
// bf16 [P, 320] scratch (g = [dir_enc | agg | 0]); rgb [P, 3] f32.
extern "C" int fused_color_fwd_launch(const float* x_pi, const float* lat,
                                      const float* wn, const float* dir_enc,
                                      long long n_pts, const void* wbuf,
                                      const void* const* bs, void* g,
                                      float* rgb, void* stream) {
  if (n_pts < 0 || n_pts > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pts == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Biases p = wg::biases(bs);
  const bf16* w = static_cast<const bf16*>(wbuf);
  bf16* gb = static_cast<bf16*>(g);
  int grid = 0;
  cudaError_t err = wg::grid_for(
      reinterpret_cast<const void*>(wg::color_pair_fwd_kernel),
      wg::PairSmem::bytes, (n_pts * kK + wg::kTile - 1) / wg::kTile, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  wg::color_pair_fwd_kernel<<<grid, wg::kThreads, wg::PairSmem::bytes, st>>>(
      x_pi, lat, wn, dir_enc, n_pts, w, p, gb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = wg::grid_for(reinterpret_cast<const void*>(wg::color_point_fwd_kernel),
                     wg::PointSmem::bytes,
                     (n_pts + wg::kTile - 1) / wg::kTile, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  wg::color_point_fwd_kernel<<<grid, wg::kThreads, wg::PointSmem::bytes,
                               st>>>(gb, n_pts, w, p, rgb);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of K8b's scratch for n_pts points.
extern "C" long long fused_color_bwd_scratch_bytes(long long n_pts) {
  return n_pts > 0 ? static_cast<long long>(bwd_scratch(n_pts).bytes) : 0;
}

// K8b. The inputs of K8a and rgb_bar [P, 3] f32 -> dlat [8P, 64] f32 and
// grads [361731] f32 (dW then db, every value written); scratch:
// fused_color_bwd_scratch_bytes(P) bytes.  Five launches: the pair
// recompute, the point kernel (R forward and reverse), the reverse pair
// kernel, the split-K dW product and the fixed-order sums.
extern "C" int fused_color_bwd_launch(const float* x_pi, const float* lat,
                                      const float* wn, const float* dir_enc,
                                      long long n_pts, const void* wbuf,
                                      const void* const* bs,
                                      const float* rgb_bar, float* dlat,
                                      float* grads, void* scratch,
                                      void* stream) {
  if (n_pts < 0 || n_pts > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pts == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Biases p = wg::biases(bs);
  const bf16* w = static_cast<const bf16*>(wbuf);
  const BwdScratch sc = bwd_scratch(n_pts);
  char* base = static_cast<char*>(scratch);
  bf16* xs = reinterpret_cast<bf16*>(base + sc.off[0]);
  bf16* ds = reinterpret_cast<bf16*>(base + sc.off[1]);
  bf16* xr = reinterpret_cast<bf16*>(base + sc.off[2]);
  bf16* dr = reinterpret_cast<bf16*>(base + sc.off[3]);
  float* d_agg = reinterpret_cast<float*>(base + sc.off[4]);
  float* dbf = reinterpret_cast<float*>(base + sc.off[5]);
  float* dbr = reinterpret_cast<float*>(base + sc.off[6]);
  float* part = reinterpret_cast<float*>(base + sc.off[7]);
  uint4* gbits = reinterpret_cast<uint4*>(base + sc.off[8]);
  int grid = 0;
  cudaError_t err = wg::grid_for(
      reinterpret_cast<const void*>(wg::color_pair_recompute_kernel),
      wg::PairSmem::bytes, sc.pair_tiles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  wg::color_pair_recompute_kernel<<<grid, wg::kThreads, wg::PairSmem::bytes,
                                    st>>>(x_pi, lat, wn, dir_enc, n_pts, w, p,
                                          xr, xs, gbits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = wg::grid_for(reinterpret_cast<const void*>(wg::color_point_bwd_kernel),
                     wg::PointSmem::bytes, sc.point_tiles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  wg::color_point_bwd_kernel<<<grid, wg::kThreads, wg::PointSmem::bytes,
                               st>>>(n_pts, w, p, rgb_bar, xr, dr, d_agg,
                                     dbr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = wg::grid_for(reinterpret_cast<const void*>(wg::color_pair_bwd_kernel),
                     wg::PairBwdSmem::bytes, sc.pair_tiles, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  wg::color_pair_bwd_kernel<<<grid, wg::kThreads, wg::PairBwdSmem::bytes,
                              st>>>(wn, d_agg, n_pts, w, gbits, ds, dlat,
                                    dbf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the 7 layers' split-K jobs: F_color over the pair rows, R over points
  const long long rows = n_pts * kK;
  DwJobs jobs;
  const int f_in[4] = {kIn0, kHid, kHid, kHid};
  for (int l = 0; l < 4; ++l)
    jobs.l[l] = DwJob{xs, ds, kXs, kDs, l == 0 ? 0 : 128 + (l - 1) * kHid,
                      l * kHid, f_in[l], kHid, rows,
                      l == 0 ? 0 : kIn0 * kHid + (l - 1) * kHid * kHid};
  jobs.l[4] = DwJob{xr, dr, kXr, kDr, 0, 0, kRIn, kHid, n_pts, kGwR0};
  jobs.l[5] = DwJob{xr, dr, kXr, kDr, 384, kHid, kHid, kHid, n_pts, kGwR1};
  jobs.l[6] = DwJob{xr, dr, kXr, kDr, 384 + kHid, 2 * kHid, kHid, kOut,
                    n_pts, kGwR2};
  int at = 0;
  for (int l = 0; l < 7; ++l) {
    jobs.tile0[l] = at;
    at += ((jobs.l[l].m_real + 127) / 128) * ((jobs.l[l].n_real + 127) / 128);
  }
  jobs.tile0[7] = at;
  color_dw_kernel<<<dim3(at, sc.splits), kDwThreads, 0, st>>>(jobs, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dw_blocks = (kGb + kDwThreads - 1) / kDwThreads;
  const int db_blocks = (kDbF + kDbR + 31) / 32;
  color_reduce_kernel<<<dw_blocks + db_blocks, kDwThreads, 0, st>>>(
      part, sc.splits, dbf, static_cast<int>(sc.pair_tiles * 2), dbr,
      static_cast<int>(sc.point_tiles * 2), dw_blocks, grads);
  return static_cast<int>(cudaGetLastError());
}
