// K3, K2, K6a, K6b, K7a and K7b -- the frozen prior's pair MLP on Hopper
// (sm_90a), on one pipeline: a persistent grid, a producer warp that streams the
// weights into a shared-memory ring by cp.async.bulk, and two consumer
// warpgroups that run the products on wgmma.
//
// Replaces the TPU kernels of spurfies_tpu/ops/pallas_mlp.py:
//   * K3 (sdf_agg_kernel): _fused_agg_call -> _mlp_kernel_agg (call :747,
//     body :576): the render path's SDF and normal, and the training step's
//     render SDF and pseudo-SDF;
//   * K2 (value_agg_kernel): _fused_value_agg_call -> _value_kernel_agg
//     (call :787, body :640): the sampler's no-grad SDF probe, K3 without
//     the down sweep;
//   * K6a (rows_grad_kernel): _fused_mlp_gx_call -> _mlp_kernel_gx (call
//     :322, body :195): model.fused_agg=false, K3's sweeps on rows given
//     one by one, with per-row outputs;
//   * K6b (rows_value_kernel): _fused_value_gx_call -> _value_kernel_gx
//     (call :363, body :260): model.fused_agg=false's probe, K6a without
//     the down sweep;
//   * K7a (rows_pre_grad_kernel): _fused_mlp_call -> _mlp_kernel (call
//     :126, body :51): model.pair_budget_frac's pair-compacted SDF, K6a on
//     pre-assembled rows u = [lat | x_pi];
//   * K7b (rows_pre_value_kernel): _fused_value_call -> _value_kernel (call
//     :182, body :146): the prior's value on pre-assembled rows (the
//     pair-MLP microbenchmark), K7a without the down sweep.
//
// What they compute, per pair row t = (point p, neighbour j) with table row
// g = table[idx[p, j]] = [lat (32) | pos (3)] (K6a: g and the query x given
// per row; K7a and K7b: u = [lat | x_pi] given per row):
//   x_pi = x[p] - pos;  w = exp(-rbf^2 |x_pi|^2)
//   a0 = [lat | x_pi] @ W0 + b0; then 3 x (LeakyReLU(0.01), 256x256)
//   s  = LeakyReLU(a3) @ w_v + b_v   (F_geometry[4] and T pre-fused, f32)
//   r  = ds/du by the down sweep, gates (a > 0 ? 1 : 0.01)   (K3, K6a)
//   K3: per point (sum w s, sum w, sum w r_pos); per pair w (f32), r_lat
//   (bf16).  K2: per point (sum w s, sum w).  K6a: per row s, r [35] and
//   x_pi, all f32.  K6b: per row s and x_pi.  K7a: per row s and r.  K7b:
//   per row s.
// Rounding follows _mlp_kernel_agg: bf16 operands, f32 accumulation, bias
// added in f32, activations rounded to bf16 after each LeakyReLU, the
// down-sweep delta rounded to bf16 after each product and after each gate.
// The up sweep's first product is one 48-deep product over
// [bf16(lat) | bf16(x_pi) | 0], equal to the TPU body's
// g_lat @ W_lat + x_pi @ W_pos (K7a's and K7b's: bf16(u) @ W0) up to f32
// summation order.
//
// What bounds them on an H100: operations.  0.82 MFLOP per real pair or
// row for K3, K6a and K7a (up and down sweep 0.21 MMACs each), 0.41 for
// K2, K6b and K7b, against ~110 (K3), ~50 (K2), ~310 (K6a), ~170 (K6b),
// ~284 (K7a) and ~144 (K7b) bytes of input and output:
// far above the card's ~295 FLOP/byte ridge.  What a block reads most is
// the weights: 820 KB per tile of 128 rows (K2: the up sweep's 410 KB),
// from L2.
//
// Design:
//   * K3 and K2 compute no dump pair.  A pair is real when its index lies
//     in [0, N), N = n_rows - 1; every other pair (the dump row N, an index
//     out of range) has w == 0 exactly, adds +-0 to its point's sums, and
//     K4 never reads its r_lat.  K3 gives it w = 0 and r_lat = 0.
//   * Persistent grid, one block per SM.  K3 and K2: block b owns the
//     points [b P / G, (b + 1) P / G) and walks them in order, packing the
//     real rows of whole points into tiles of up to 128 rows (fill_tile:
//     each lane of one warp counts one point's real rows, a warp scan
//     places them).  A point's rows stay in one tile, in j order, so its
//     sums are taken in the fixed order j = 0..k-1 with the +-0 terms left
//     out, bit-identical to adding them.  The work list is made on the card,
//     inside the kernel: no host sync and no extra launch.  (A device-side
//     compaction pass was the alternative: a second kernel and a [P*k]
//     index array in HBM.)
//   * K2 is K3 without the down sweep, one template (agg_body<kGrad>): the
//     same tiles, the same up-sweep instructions and tail (sweeps<kGrad>),
//     no gate bits and no per-pair outputs, and only the up sweep's 13
//     weight chunks streamed; so its (sum w s, sum w) are K3's pt[:, :2]
//     bit for bit.
//   * K6a computes every row it is given (invalid slots arrive as gathered
//     row 0 and the caller masks them, as the TPU kernel has them).  K7a is
//     K6a whose gather reads x_pi from u instead of forming it (no query
//     read, no x_pi written): given u = [g_lat | K6a's x_pi], its s and r
//     are K6a's bit for bit.  K6b and K7b are K6a and K7a without the down
//     sweep (rows_body<false, kPre>), so all four give the same s.  Their
//     tiles are 128 contiguous rows, block b taking tiles b, b + G, ...;
//     each warpgroup reads its 64 rows itself (the ragged last tile reads
//     zeros and writes nothing past m).  Once a warpgroup's last product
//     has completed, its r is staged over its own activations, so that it
//     writes its rows' r as one contiguous run.
//   * Warp roles: warps 0-3 and 4-7 are two consumer warpgroups, each
//     owning 64 rows of the tile; warp 8 is the producer (warps 9-11 only
//     hand their registers over: setmaxnreg gives the producer warpgroup
//     40 a thread and the consumers 232; ptxas still reports 168, 65,536
//     over 384 threads, so the 128 accumulators leave little room and the
//     gate bits are kept in shared memory).  The producer fills the next
//     tile's row list (K3, K2: a two-slot ring of tile descriptors) and
//     streams the weight chunks of every tile (26; K2, K6b and K7b 13) into a
//     four-stage ring of 32 KB shared-memory stages: one cp.async.bulk per
//     chunk, completed on the stage's mbarrier, so the next chunk (or the
//     next layer's first one) loads while the current one is multiplied.
//   * The weights are packed once (PriorLayers.k3_buffer) in exactly the
//     byte layout of the stages: each layer as K-major [n][k] blocks of 64
//     k-columns, 128-byte swizzled, which is what the wgmma descriptors
//     read.  It reads the same 820 KB per tile from L2 as before; a larger
//     tile or a cluster multicast would cut that, later.
//   * Products: wgmma.mma_async m64n256k16, and m64n40k16 for the last,
//     256 -> 40 product (N = 40 is a legal wgmma width, so it stays on
//     wgmma too), with A (the activations) and B (the weights) read from
//     shared memory by descriptor and the f32 accumulators in registers.
//     Warp w of a warpgroup holds rows 16 w .. 16 w + 15 and all 256
//     columns.  The epilogues read the accumulators in place: bias,
//     LeakyReLU, bf16 rounding and the gate bits (to shared memory, read
//     back by the thread that wrote them) for the up sweep,
//     bf16(bf16(acc) * gate) for the down sweep, and the fused 256 -> 1
//     tail in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;       // pair rows per tile
constexpr int kWgRows = 64;      // rows per consumer warpgroup
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kHid = 256;
constexpr int kLat = 32;
constexpr int kRowW = kLat + 3;
constexpr int kOut0 = 40;        // last product's width: 35 padded to 8s
constexpr int kStages = 4;
constexpr int kStageBytes = kHid * 64 * 2;           // [256][64] bf16
constexpr int kChunks = 26;  // up0, up1-3 x 4, down 3-1 x 4, down0
constexpr int kUpChunks = 13;                        // up0, up1-3 x 4
constexpr int kDn0Bytes = kOut0 * kHid * 2;          // [40][256] bf16
constexpr int kWvOff = ((kChunks - 1) * kStageBytes + kDn0Bytes) / 2;
constexpr int kActBytes = kWgRows * kHid * 2;        // one warpgroup's
constexpr int kKbBytes = kWgRows * 128;              // a 64-column block

// Shared memory (bytes from a 1024-aligned base).
constexpr int kSmRing = 0;
constexpr int kSmAct = kSmRing + kStages * kStageBytes;
constexpr int kLayerGates = kWgRows * 8;             // u32 words a layer
constexpr int kGateWords = 4 * kLayerGates;          // a warpgroup's gates
constexpr int kSmGate = kSmAct + 2 * kActBytes;      // u32 [2][4][64][8]
constexpr int kSmBias = kSmGate + 2 * kGateWords * 4;  // f32 [4][256]
constexpr int kSmWv = kSmBias + 4 * kHid * 4;        // f32 [256]
constexpr int kSmW = kSmWv + kHid * 4;               // f32 [128]
constexpr int kSmS = kSmW + kRows * 4;               // f32 [128]
constexpr int kSmRp = kSmS + kRows * 4;              // f32 [128][3]
constexpr int kSmPair = kSmRp + kRows * 3 * 4;       // i32 [2][128]
constexpr int kSmNrows = kSmPair + 2 * kRows * 4;    // i32 [2]
constexpr int kSmBar = kSmNrows + 16;                // u64 barriers
// full_w[4], empty_w[4], dfull[2], dempty[2]
constexpr int kSmem = kSmBar + 12 * 8 + 1024;        // + base alignment
static_assert(kSmem <= 232448, "shared memory");
static_assert(kSmBar % 8 == 0, "barrier alignment");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rn(lo),
                                        __float2bfloat16_rn(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of element (r, c) in a K-major tile of 64-column blocks of
// `rows` rows each, 128-byte swizzled (16-byte chunk c / 8 of row r is
// stored at chunk (c / 8) ^ (r % 8)).
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (c >> 6) * rows * 128 + r * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// --- mbarriers, bulk copies, fences ---
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

// Expect `bytes` on `bar`, and copy them from global `src` to shared `dst`
// with completion reported to `bar`.
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

// Generic-proxy writes to shared memory, made visible to the async proxy
// (wgmma's operand reads).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// --- wgmma ---
// Descriptor of a K-major, 128-byte-swizzled operand at shared address
// `addr`: 8-row groups 1024 bytes apart (SBO), LBO unused (1).
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

// d[128] (+)= A [64, 16] . B [16, 256], both from shared memory by descriptor
// (K-major, 128-byte swizzle), f32 accumulators; scale_d == 0 overwrites d.
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

// d[20] (+)= A [64, 16] . B [16, 40], both from shared memory by descriptor
// (K-major, 128-byte swizzle), f32 accumulators; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_40(float (&d)[20], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One layer's product acc = A [64, 64 NKB] . B over NKB weight chunks of the
// ring (KSTEPS k16 steps of each), releasing each stage when read.
template <int NKB, int KSTEPS>
__device__ __forceinline__ void layer(float (&acc)[128], uint32_t act,
                                      uint32_t ring, uint64_t* full,
                                      uint64_t* empty, int& it, int lane) {
  wg_fence();
  int prev = 0;
#pragma unroll 1
  for (int kb = 0; kb < NKB; ++kb) {
    const int stage = it & (kStages - 1);
    mbar_wait(full + stage, (it / kStages) & 1);
    const uint32_t a = act + kb * kKbBytes;
    const uint32_t b = ring + stage * kStageBytes;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      wgmma_256(acc, wg_desc(a + ks * 32), wg_desc(b + ks * 32),
                (kb | ks) != 0);
    wg_commit();
    if (kb > 0) {
      wg_wait<1>();
      if (lane == 0) mbar_arrive(empty + prev);
    }
    prev = stage;
    ++it;
  }
  wg_wait<0>();
  if (lane == 0) mbar_arrive(empty + prev);
}

// The last product [64, 256] . W0^T -> [64, 40], from one chunk holding
// W0 as four [40][64] blocks.
__device__ __forceinline__ void last_product(float (&acc)[20], uint32_t act,
                                             uint32_t ring, uint64_t* full,
                                             uint64_t* empty, int& it,
                                             int lane) {
  const int stage = it & (kStages - 1);
  mbar_wait(full + stage, (it / kStages) & 1);
  const uint32_t b = ring + stage * kStageBytes;
  wg_fence();
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_40(acc, wg_desc(act + kb * kKbBytes + ks * 32),
               wg_desc(b + kb * kOut0 * 128 + ks * 32), (kb | ks) != 0);
  wg_commit();
  wg_wait<0>();
  if (lane == 0) mbar_arrive(empty + stage);
  ++it;
}

// --- epilogues; element e = 4 i + 2 h + j of a thread's accumulator is
// (row 16 w4 + g + 8 h, column 8 i + 2 t + j) of its warpgroup's tile ---

// A layer's gate bits (a > 0) live in shared memory, [64 rows][8 words]
// per warpgroup: the thread that owns (row, column 8 i + 2 t + j) keeps
// them in word 2 t + i / 16 of the row, bit 2 (i % 16) + j, and is the one
// that reads them back in the down sweep.  (In registers they would be 16
// words a thread beside the 128 accumulators, and the epilogues spill.)
__device__ __forceinline__ int gate_word(int w4, int g, int t, int e) {
  return (w4 * 16 + g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1);
}

// Word e = 2 h + i / 16 of the thread's gates: its row 16 w4 + g + 8 h.
__device__ __forceinline__ void load_gates(const uint32_t* gates,
                                           uint32_t (&gate)[4], int w4,
                                           int g, int t) {
#pragma unroll
  for (int e = 0; e < 4; ++e) gate[e] = gates[gate_word(w4, g, t, e)];
}

// Up sweep: a = acc + b (f32), x = bf16(max(a, 0.01 a)) written over the
// activations, with kGates the bits (a > 0) into `gates`.  kTail (the last
// layer): x is not stored, only part[h] += x . w_v over the thread's
// columns.
template <bool kTail, bool kGates>
__device__ __forceinline__ void epi_up(const float (&acc)[128],
                                       uint32_t* gates, unsigned char* act,
                                       const float* bias, const float* wv,
                                       float (&part)[2], int w4, int g,
                                       int t) {
  uint32_t gate[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * t;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w4 * 16 + g + 8 * h;
      const float v0 = __fadd_rn(acc[4 * i + 2 * h], b0);
      const float v1 = __fadd_rn(acc[4 * i + 2 * h + 1], b1);
      if (kGates)
        gate[2 * h + (i >> 4)] |=
            ((v0 > 0.f ? 1u : 0u) | (v1 > 0.f ? 2u : 0u)) << (2 * (i & 15));
      const uint32_t x = pack_bf16(fmaxf(v0, __fmul_rn(0.01f, v0)),
                                   fmaxf(v1, __fmul_rn(0.01f, v1)));
      if (!kTail) {
        *reinterpret_cast<uint32_t*>(act + swz(row, col, kWgRows)) = x;
      } else {
        const __nv_bfloat162 xb = *reinterpret_cast<const __nv_bfloat162*>(&x);
        part[h] = fmaf(__low2float(xb), wv[col], part[h]);
        part[h] = fmaf(__high2float(xb), wv[col + 1], part[h]);
      }
    }
  }
  if (kGates) {
#pragma unroll
    for (int e = 0; e < 4; ++e) gates[gate_word(w4, g, t, e)] = gate[e];
  }
}

__device__ __forceinline__ float gate_at(const uint32_t (&gate)[4], int i,
                                         int h, int j, float slope) {
  return ((gate[2 * h + (i >> 4)] >> (2 * (i & 15) + j)) & 1u) ? 1.f : slope;
}

// Down sweep: delta = bf16(bf16(acc) * gate) with the gate of the layer
// below, written over the activations.
__device__ __forceinline__ void epi_down(const float (&acc)[128],
                                         const uint32_t* gates,
                                         unsigned char* act, float slope,
                                         int w4, int g, int t) {
  uint32_t gate[4];
  load_gates(gates, gate, w4, g, t);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w4 * 16 + g + 8 * h;
      const float d0 = __fmul_rn(bf16_round(acc[4 * i + 2 * h]),
                                 gate_at(gate, i, h, 0, slope));
      const float d1 = __fmul_rn(bf16_round(acc[4 * i + 2 * h + 1]),
                                 gate_at(gate, i, h, 1, slope));
      *reinterpret_cast<uint32_t*>(act + swz(row, 8 * i + 2 * t, kWgRows)) =
          pack_bf16(d0, d1);
    }
  }
}

// The down sweep's first delta bf16(w_v * gate3), written as activations.
__device__ __forceinline__ void delta_init(const uint32_t* gates,
                                           unsigned char* act,
                                           const float* wv, float slope,
                                           int w4, int g, int t) {
  uint32_t gate[4];
  load_gates(gates, gate, w4, g, t);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = 8 * i + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w4 * 16 + g + 8 * h;
      *reinterpret_cast<uint32_t*>(act + swz(row, col, kWgRows)) =
          pack_bf16(__fmul_rn(wv[col], gate_at(gate, i, h, 0, slope)),
                    __fmul_rn(wv[col + 1], gate_at(gate, i, h, 1, slope)));
    }
  }
}

// The block's next tile of real rows: up to kRows pair indices p * k + j
// into `pair` (point-major, j ascending), taken from whole points of
// [cursor, end), which advances.  It writes what no product computes: pt
// = 0 on a point with no real pair (kGrad, K3: 5 columns, else 2), and
// with kGrad w = 0 and r_lat = 0 on dump pairs.
// One whole warp calls it; every lane returns the tile's row count (0: the
// range is done).  Requires k <= 32.
template <bool kGrad>
__device__ int fill_tile(const int* __restrict__ idx, int n_real, int k,
                         long long& cursor, long long end, int* pair,
                         float* __restrict__ out_pt, float* __restrict__ out_w,
                         __nv_bfloat16* __restrict__ out_r) {
  constexpr int kPtW = kGrad ? 5 : 2;
  const int lane = threadIdx.x & 31;
  int rows = 0;
  while (cursor < end) {
    const long long p = cursor + lane;
    uint32_t bits = 0u;
    int c = 0;
    if (p < end) {
      const int* ip = idx + p * k;
      for (int j = 0; j < k; ++j) {
        const int id = __ldg(ip + j);
        if (id >= 0 && id < n_real) {
          bits |= 1u << j;
          ++c;
        }
      }
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    // lanes 0 .. nfit-1 fit: incl grows with the lane
    const bool fit = p < end && rows + incl <= kRows;
    const int nfit = __popc(__ballot_sync(0xffffffffu, fit));
    if (fit) {
      int r = rows + incl - c;
      for (int j = 0; j < k; ++j) {
        const long long q = p * k + j;
        if ((bits >> j) & 1u) {
          pair[r++] = static_cast<int>(q);
        } else if (kGrad) {
          out_w[q] = 0.f;
          uint4* o = reinterpret_cast<uint4*>(out_r + q * kLat);
#pragma unroll
          for (int e = 0; e < kLat / 8; ++e) o[e] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      if (c == 0) {
#pragma unroll
        for (int e = 0; e < kPtW; ++e) out_pt[p * kPtW + e] = 0.f;
      }
    }
    if (nfit == 0) break;                    // the tile is full
    rows += __shfl_sync(0xffffffffu, incl, nfit - 1);
    cursor += nfit;
    if (nfit < 32 && cursor < end) break;    // the next point does not fit
  }
  return rows;
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// The block's dynamic shared memory, from a 1024-aligned base.
__device__ __forceinline__ unsigned char* block_smem() {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  return smem_raw + (((raw + 1023u) & ~1023u) - raw);
}

// Biases and w_v into shared memory, and the barriers: full_w[4],
// empty_w[4] (the weight ring), dfull[2], dempty[2] (the tile lists).
__device__ __forceinline__ void block_setup(unsigned char* sm,
                                            const __nv_bfloat16* wbuf,
                                            const float* bbuf) {
  float* bias_s = reinterpret_cast<float*>(sm + kSmBias);
  float* wv_s = reinterpret_cast<float*>(sm + kSmWv);
  uint64_t* full_w = reinterpret_cast<uint64_t*>(sm + kSmBar);
  uint64_t* empty_w = full_w + kStages;
  uint64_t* dfull = empty_w + kStages;
  uint64_t* dempty = dfull + 2;
  const int tid = threadIdx.x;
  for (int e = tid; e < 4 * kHid; e += kThreads) bias_s[e] = bbuf[e];
  for (int e = tid; e < kHid; e += kThreads)
    wv_s[e] = __bfloat162float(wbuf[kWvOff + e]);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_w + s, 1);
      mbar_init(empty_w + s, kConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(dfull + s, 32);
      mbar_init(dempty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's lane 0: weight chunk c into the ring's stage for the
// stream's chunk number `it`, once the consumers have released that stage.
__device__ __forceinline__ void issue_chunk(unsigned char* sm,
                                            const char* wsrc, int c, int it) {
  uint64_t* full_w = reinterpret_cast<uint64_t*>(sm + kSmBar);
  uint64_t* empty_w = full_w + kStages;
  const int stage = it & (kStages - 1);
  mbar_wait(empty_w + stage, ((it / kStages) & 1) ^ 1);
  bulk_load(sm + kSmRing + stage * kStageBytes,
            wsrc + (size_t)c * kStageBytes,
            c == kChunks - 1 ? kDn0Bytes : kStageBytes, full_w + stage);
}

// A consumer warpgroup's share of the block's shared memory, and the
// thread's place in it: warp w4 of the warpgroup, lane = 4 g + t4.
struct Wg {
  unsigned char* act;  // the warpgroup's [64][256] bf16 activations
  uint32_t act_a;      // their shared-memory address
  uint32_t ring_a;     // the weight ring's
  uint64_t* full;      // the ring's barriers
  uint64_t* empty;
  uint32_t* gates;     // the warpgroup's gate bits [4][64][8]
  const float* bias;   // f32 b0..b3 [4][256]
  const float* wv;     // f32 w_v [256]
  int wg, lane, w4, g, t4;
};

__device__ __forceinline__ Wg consumer(unsigned char* sm, int wg) {
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t sbase = smem_u32(sm);
  uint64_t* full_w = reinterpret_cast<uint64_t*>(sm + kSmBar);
  return Wg{sm + kSmAct + wg * kActBytes,
            sbase + kSmAct + wg * kActBytes,
            sbase + kSmRing,
            full_w,
            full_w + kStages,
            reinterpret_cast<uint32_t*>(sm + kSmGate) + wg * kGateWords,
            reinterpret_cast<const float*>(sm + kSmBias),
            reinterpret_cast<const float*>(sm + kSmWv),
            wg,
            lane,
            (tid >> 5) & 3,
            lane >> 2,
            lane & 3};
}

// The prior on the warpgroup's 64 rows, whose first layer's input
// [bf16(lat) | bf16(x_pi) | 0] is in its activations (fenced, after a
// barrier of the warpgroup): the up sweep and the fused tail 256 -> 1,
// s = bf16(x4 . w_v + b_v), into s_out[row]; with kGrad also the gate bits
// and the down sweep, down to the last product's accumulators acc0
// (element 4 i + 2 h + j: row 16 w4 + g + 8 h, column 8 i + 2 t4 + j).
// `it` counts the weight chunks taken from the ring.
template <bool kGrad>
__device__ __forceinline__ void sweeps(const Wg& c, float* s_out, float bv,
                                       float slope, int& it,
                                       float (&acc0)[20]) {
  const int w4 = c.w4, g = c.g, t4 = c.t4;
  float acc[128];
  float part[2] = {0.f, 0.f};
  // --- up sweep ---
  layer<1, 3>(acc, c.act_a, c.ring_a, c.full, c.empty, it, c.lane);
  bar_sync(1 + c.wg, 128);  // the warpgroup's reads of act are done
  epi_up<false, kGrad>(acc, c.gates, c.act, c.bias, c.wv, part, w4, g, t4);
  fence_async_smem();
  bar_sync(1 + c.wg, 128);
#pragma unroll 1
  for (int l = 1; l < 4; ++l) {
    layer<4, 4>(acc, c.act_a, c.ring_a, c.full, c.empty, it, c.lane);
    bar_sync(1 + c.wg, 128);
    uint32_t* gl = c.gates + l * kLayerGates;
    if (l < 3) {
      epi_up<false, kGrad>(acc, gl, c.act, c.bias + l * kHid, c.wv, part, w4,
                           g, t4);
      fence_async_smem();
      bar_sync(1 + c.wg, 128);
    } else {
      epi_up<true, kGrad>(acc, gl, c.act, c.bias + l * kHid, c.wv, part, w4,
                          g, t4);
    }
  }
  // fused tail 256 -> 1: the four threads of a row hold its 256 columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = part[h];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (t4 == 0) s_out[w4 * 16 + g + 8 * h] = bf16_round(__fadd_rn(s, bv));
  }
  if (!kGrad) return;
  // --- down sweep ---
  delta_init(c.gates + 3 * kLayerGates, c.act, c.wv, slope, w4, g, t4);
  fence_async_smem();
  bar_sync(1 + c.wg, 128);
#pragma unroll 1
  for (int l = 3; l >= 1; --l) {
    layer<4, 4>(acc, c.act_a, c.ring_a, c.full, c.empty, it, c.lane);
    bar_sync(1 + c.wg, 128);
    epi_down(acc, c.gates + (l - 1) * kLayerGates, c.act, slope, w4, g, t4);
    fence_async_smem();
    bar_sync(1 + c.wg, 128);
  }
  last_product(acc0, c.act_a, c.ring_a, c.full, c.empty, it, c.lane);
}

// K3 (kGrad) and K2.  wbuf: PriorLayers.k3_buffer (kChunks chunks, then
// w_v); bbuf: f32 b0..b3 [4][256], then b_v.  out_pt [n_pts, 5] (K2: 2);
// K3 only: out_w, out_r.
template <bool kGrad>
__device__ __forceinline__ void agg_body(
    const float* __restrict__ table, int n_rows, const int* __restrict__ idx,
    const float* __restrict__ xq, int n_pts, int k,
    const __nv_bfloat16* __restrict__ wbuf, const float* __restrict__ bbuf,
    float rbf2, float* __restrict__ out_pt, float* __restrict__ out_w,
    __nv_bfloat16* __restrict__ out_r) {
  constexpr int kPtW = kGrad ? 5 : 2;
  constexpr int kTileChunks = kGrad ? kChunks : kUpChunks;
  unsigned char* sm = block_smem();
  block_setup(sm, wbuf, bbuf);
  float* w_s = reinterpret_cast<float*>(sm + kSmW);
  float* s_s = reinterpret_cast<float*>(sm + kSmS);
  float* rp_s = reinterpret_cast<float*>(sm + kSmRp);
  int* pair_s = reinterpret_cast<int*>(sm + kSmPair);
  int* nrows_s = reinterpret_cast<int*>(sm + kSmNrows);
  uint64_t* dfull = reinterpret_cast<uint64_t*>(sm + kSmBar) + 2 * kStages;
  uint64_t* dempty = dfull + 2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long per = ((long long)n_pts + gridDim.x - 1) / gridDim.x;
  const long long begin = (long long)blockIdx.x * per;
  const long long end = min((long long)n_pts, begin + per);
  // warp-uniform role: the compiler sees the wgmma paths as not divergent
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (role == kConsumers / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != kConsumers / 32) return;
    // --- producer: tile lists and the weight stream ---
    long long cursor = begin;
    const char* wsrc = reinterpret_cast<const char*>(wbuf);
    auto publish = [&](int t) {
      const int slot = t & 1;
      mbar_wait(dempty + slot, ((t >> 1) & 1) ^ 1);
      const int rows = fill_tile<kGrad>(idx, n_rows - 1, k, cursor, end,
                                        pair_s + slot * kRows, out_pt, out_w,
                                        out_r);
      if (lane == 0) nrows_s[slot] = rows;
      mbar_arrive(dfull + slot);
      return rows;
    };
    int it = 0;
    int rows = publish(0);
    for (int t = 0; rows > 0; ++t) {
      int next = 0;
      for (int c = 0; c < kTileChunks; ++c) {
        if (lane == 0) issue_chunk(sm, wsrc, c, it);
        ++it;
        // the next tile's list, once this one's first stages are taken
        __syncwarp();
        if (c == kStages) next = publish(t + 1);
      }
      rows = next;
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // --- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ---
    const int wg = role;
    const Wg cw = consumer(sm, wg);
    const int ti = tid & 127;
    unsigned char* act = cw.act;
    const float slope = bf16_round(0.01f);
    const float bv = __ldg(bbuf + 4 * kHid);
    int it = 0;
    for (int t = 0;; ++t) {
      const int slot = t & 1;
      mbar_wait(dfull + slot, (t >> 1) & 1);
      const int rows = __shfl_sync(0xffffffffu, nrows_s[slot], 0);
      if (rows == 0) break;
      const int* pairs = pair_s + slot * kRows;

      // --- gather [lat | x_pi | 0] (48 columns) of the warpgroup's rows;
      // two threads a row, rows past `rows` are zeros ---
      {
        const int rl = ti & 63, half = ti >> 6, rg = wg * kWgRows + rl;
        float v[8];
        if (rg < rows) {
          const int q = pairs[rg];
          const int raw_id = __ldg(idx + q);
          const int id =
              (raw_id >= 0 && raw_id < n_rows) ? raw_id : n_rows - 1;
          const float* gr = table + (size_t)id * kRowW;
#pragma unroll
          for (int c8 = 0; c8 < 2; ++c8) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = __ldg(gr + half * 16 + c8 * 8 + e);
            *reinterpret_cast<uint4*>(act + swz(rl, half * 16 + c8 * 8,
                                                kWgRows)) = pack8(v);
          }
          if (half == 0) {
            const float* xp = xq + (size_t)(q / k) * 3;
            const float e0 = __fsub_rn(xp[0], gr[kLat]);
            const float e1 = __fsub_rn(xp[1], gr[kLat + 1]);
            const float e2 = __fsub_rn(xp[2], gr[kLat + 2]);
            const float d2 = __fadd_rn(
                __fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1)),
                __fmul_rn(e2, e2));
            const float w = expf(__fmul_rn(-rbf2, d2));
            w_s[rg] = w;
            if (kGrad) out_w[q] = w;
            *reinterpret_cast<uint4*>(act + swz(rl, kLat, kWgRows)) =
                make_uint4(pack_bf16(e0, e1), pack_bf16(e2, 0.f), 0u, 0u);
            *reinterpret_cast<uint4*>(act + swz(rl, kLat + 8, kWgRows)) =
                make_uint4(0u, 0u, 0u, 0u);
          }
        } else {
          const uint4 z = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(act + swz(rl, half * 16, kWgRows)) = z;
          *reinterpret_cast<uint4*>(act + swz(rl, half * 16 + 8, kWgRows)) = z;
          *reinterpret_cast<uint4*>(act + swz(rl, kLat + half * 8, kWgRows)) =
              z;
        }
      }
      fence_async_smem();
      bar_sync(1 + wg, 128);

      if (wg * kWgRows < rows) {
        float acc0[20];
        sweeps<kGrad>(cw, s_s + wg * kWgRows, bv, slope, it, acc0);
        if (kGrad) {
          // r = bf16 delta: r_lat to HBM, r_pos for the sums
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rg = wg * kWgRows + cw.w4 * 16 + cw.g + 8 * h;
            if (rg >= rows) continue;
            const size_t q = static_cast<size_t>(pairs[rg]);
#pragma unroll
            for (int i = 0; i < 5; ++i) {
              const int col = 8 * i + 2 * cw.t4;
              const float r0 = bf16_round(acc0[4 * i + 2 * h]);
              const float r1 = bf16_round(acc0[4 * i + 2 * h + 1]);
              if (col < kLat) {
                *reinterpret_cast<uint32_t*>(out_r + q * kLat + col) =
                    pack_bf16(r0, r1);
              } else if (col < kRowW) {
                rp_s[rg * 3 + col - kLat] = r0;
                if (col + 1 < kRowW) rp_s[rg * 3 + col + 1 - kLat] = r1;
              }
            }
          }
        }
      } else {
        // no rows: release every stage of this tile's weight stream
#pragma unroll 1
        for (int c = 0; c < kTileChunks; ++c) {
          const int stage = it & (kStages - 1);
          mbar_wait(cw.full + stage, (it / kStages) & 1);
          __syncwarp();
          if (lane == 0) mbar_arrive(cw.empty + stage);
          ++it;
        }
      }
      bar_sync(3, kConsumers);

      // --- per-point sums over the point's real rows, in j order, by the
      // thread of its first row ---
      if (tid < rows) {
        const int p = pairs[tid] / k;
        if (tid == 0 || pairs[tid - 1] / k != p) {
          float num = 0.f, den = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f;
          for (int r = tid; r < rows && pairs[r] / k == p; ++r) {
            const float w = w_s[r];
            num = __fadd_rn(num, __fmul_rn(w, s_s[r]));
            den = __fadd_rn(den, w);
            if (kGrad) {
              g0 = __fadd_rn(g0, __fmul_rn(w, rp_s[r * 3]));
              g1 = __fadd_rn(g1, __fmul_rn(w, rp_s[r * 3 + 1]));
              g2 = __fadd_rn(g2, __fmul_rn(w, rp_s[r * 3 + 2]));
            }
          }
          float* o = out_pt + (size_t)p * kPtW;
          o[0] = num;
          o[1] = den;
          if (kGrad) {
            o[2] = g0;
            o[3] = g1;
            o[4] = g2;
          }
        }
      }
      mbar_arrive(dempty + slot);
      bar_sync(3, kConsumers);  // before the next tile's gather
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
sdf_agg_kernel(const float* __restrict__ table, int n_rows,
               const int* __restrict__ idx, const float* __restrict__ xq,
               int n_pts, int k, const __nv_bfloat16* __restrict__ wbuf,
               const float* __restrict__ bbuf, float rbf2,
               float* __restrict__ out_pt, float* __restrict__ out_w,
               __nv_bfloat16* __restrict__ out_r) {
  agg_body<true>(table, n_rows, idx, xq, n_pts, k, wbuf, bbuf, rbf2, out_pt,
                 out_w, out_r);
}

__global__ void __launch_bounds__(kThreads, 1)
value_agg_kernel(const float* __restrict__ table, int n_rows,
                 const int* __restrict__ idx, const float* __restrict__ xq,
                 int n_pts, int k, const __nv_bfloat16* __restrict__ wbuf,
                 const float* __restrict__ bbuf, float rbf2,
                 float* __restrict__ out_pt, float* __restrict__ out_w,
                 __nv_bfloat16* __restrict__ out_r) {
  agg_body<false>(table, n_rows, idx, xq, n_pts, k, wbuf, bbuf, rbf2, out_pt,
                  out_w, out_r);
}

// K6a (kGrad) and K6b.  g [m, 35] f32 rows [lat | pos], xq [m, 3] the
// query of each row; out_s [m] = bf16(s) as f32, out_xpi [m, 3] = x - pos
// in f32; K6a only: out_r [m, 35] = r = ds/du, the bf16 delta of the down
// sweep, as f32.  K6b streams the up sweep's 13 weight chunks a tile and
// keeps no gate bits; its s and x_pi are K6a's bit for bit.  With kPre
// (K7a, and K7b without the down sweep), g is u [m, 35] = [lat | x_pi]:
// the gather rounds its columns as they are, and xq and out_xpi are
// neither read nor written.
template <bool kGrad, bool kPre = false>
__device__ __forceinline__ void rows_body(
    const float* __restrict__ g_in, const float* __restrict__ xq,
    long long m, const __nv_bfloat16* __restrict__ wbuf,
    const float* __restrict__ bbuf, float* __restrict__ out_s,
    float* __restrict__ out_r, float* __restrict__ out_xpi) {
  constexpr int kTileChunks = kGrad ? kChunks : kUpChunks;
  unsigned char* sm = block_smem();
  block_setup(sm, wbuf, bbuf);
  float* s_s = reinterpret_cast<float*>(sm + kSmS);
  const long long n_tiles = (m + kRows - 1) / kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (role == kConsumers / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != kConsumers / 32) return;
    // --- producer: the weight chunks of each of the block's tiles ---
    const char* wsrc = reinterpret_cast<const char*>(wbuf);
    int it = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      for (int c = 0; c < kTileChunks; ++c) {
        if (lane == 0) issue_chunk(sm, wsrc, c, it);
        ++it;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // --- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile
    const int wg = role;
    const Wg cw = consumer(sm, wg);
    const int ti = tid & 127;
    unsigned char* act = cw.act;
    float* r_s = reinterpret_cast<float*>(act);  // [64][35], after the sweeps
    const float slope = bf16_round(0.01f);
    const float bv = __ldg(bbuf + 4 * kHid);
    int it = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const long long row0 = t * kRows + wg * kWgRows;
      const int n = static_cast<int>(min((long long)kWgRows, m - row0));

      // --- [lat | x_pi | 0] (48 columns), two threads a row; x_pi to
      // HBM (kPre: read from u); rows past m are zeros ---
      {
        const int rl = ti & 63, half = ti >> 6;
        if (rl < n) {
          const float* gr = g_in + (row0 + rl) * kRowW;
          float v[8];
#pragma unroll
          for (int c8 = 0; c8 < 2; ++c8) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = __ldg(gr + half * 16 + c8 * 8 + e);
            *reinterpret_cast<uint4*>(act + swz(rl, half * 16 + c8 * 8,
                                                kWgRows)) = pack8(v);
          }
          if (half == 0) {
            float e0, e1, e2;
            if (kPre) {
              e0 = __ldg(gr + kLat);
              e1 = __ldg(gr + kLat + 1);
              e2 = __ldg(gr + kLat + 2);
            } else {
              const float* xp = xq + (row0 + rl) * 3;
              e0 = __fsub_rn(__ldg(xp), __ldg(gr + kLat));
              e1 = __fsub_rn(__ldg(xp + 1), __ldg(gr + kLat + 1));
              e2 = __fsub_rn(__ldg(xp + 2), __ldg(gr + kLat + 2));
              float* xo = out_xpi + (row0 + rl) * 3;
              xo[0] = e0;
              xo[1] = e1;
              xo[2] = e2;
            }
            *reinterpret_cast<uint4*>(act + swz(rl, kLat, kWgRows)) =
                make_uint4(pack_bf16(e0, e1), pack_bf16(e2, 0.f), 0u, 0u);
            *reinterpret_cast<uint4*>(act + swz(rl, kLat + 8, kWgRows)) =
                make_uint4(0u, 0u, 0u, 0u);
          }
        } else {
          const uint4 z = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(act + swz(rl, half * 16, kWgRows)) = z;
          *reinterpret_cast<uint4*>(act + swz(rl, half * 16 + 8, kWgRows)) = z;
          *reinterpret_cast<uint4*>(act + swz(rl, kLat + half * 8, kWgRows)) =
              z;
        }
      }
      fence_async_smem();
      bar_sync(1 + wg, 128);

      float acc0[20];
      sweeps<kGrad>(cw, s_s + wg * kWgRows, bv, slope, it, acc0);
      bar_sync(1 + wg, 128);  // every product of the warpgroup has read act
      if (kGrad) {
        // r = the bf16 delta of columns 0..34, staged over the activations
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = cw.w4 * 16 + cw.g + 8 * h;
#pragma unroll
          for (int i = 0; i < 5; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = 8 * i + 2 * cw.t4 + j;
              if (col < kRowW)
                r_s[row * kRowW + col] = bf16_round(acc0[4 * i + 2 * h + j]);
            }
          }
        }
        bar_sync(1 + wg, 128);
      }
      // the warpgroup's n rows: s, and r as one contiguous run
      if (ti < n) out_s[row0 + ti] = s_s[wg * kWgRows + ti];
      if (kGrad) {
        float* ro = out_r + row0 * kRowW;
        for (int e = ti; e < n * kRowW; e += 128) ro[e] = r_s[e];
        bar_sync(1 + wg, 128);  // r_s is read before the next tile's gather
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
rows_grad_kernel(const float* __restrict__ g_in, const float* __restrict__ xq,
                 long long m, const __nv_bfloat16* __restrict__ wbuf,
                 const float* __restrict__ bbuf, float* __restrict__ out_s,
                 float* __restrict__ out_r, float* __restrict__ out_xpi) {
  rows_body<true>(g_in, xq, m, wbuf, bbuf, out_s, out_r, out_xpi);
}

__global__ void __launch_bounds__(kThreads, 1)
rows_value_kernel(const float* __restrict__ g_in,
                  const float* __restrict__ xq, long long m,
                  const __nv_bfloat16* __restrict__ wbuf,
                  const float* __restrict__ bbuf, float* __restrict__ out_s,
                  float* __restrict__ out_r, float* __restrict__ out_xpi) {
  rows_body<false>(g_in, xq, m, wbuf, bbuf, out_s, out_r, out_xpi);
}

__global__ void __launch_bounds__(kThreads, 1)
rows_pre_grad_kernel(const float* __restrict__ u, long long m,
                     const __nv_bfloat16* __restrict__ wbuf,
                     const float* __restrict__ bbuf, float* __restrict__ out_s,
                     float* __restrict__ out_r) {
  rows_body<true, true>(u, nullptr, m, wbuf, bbuf, out_s, out_r, nullptr);
}

__global__ void __launch_bounds__(kThreads, 1)
rows_pre_value_kernel(const float* __restrict__ u, long long m,
                      const __nv_bfloat16* __restrict__ wbuf,
                      const float* __restrict__ bbuf,
                      float* __restrict__ out_s) {
  rows_body<false, true>(u, nullptr, m, wbuf, bbuf, out_s, nullptr, nullptr);
}

// One block per SM, at most one per unit of work (`units` > 0); the
// kernel's shared memory allowed.
cudaError_t grid_for(const void* kernel, long long units, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
  *grid = static_cast<int>(sms < units ? sms : units);
  return err;
}

template <bool kGrad>
int launch_agg(const float* table, int n_rows, const int* idx,
               const float* x, int n_pts, int k, const void* wbuf,
               const float* bbuf, float rbf2, float* out_pt, float* out_w,
               void* out_r, void* stream) {
  if (k <= 0 || k > 32 || n_rows <= 1 || n_pts < 0 ||
      (long long)n_pts * k > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pts == 0) return 0;
  const auto kernel = kGrad ? sdf_agg_kernel : value_agg_kernel;
  int grid = 0;
  const cudaError_t err =
      grid_for(reinterpret_cast<const void*>(kernel), n_pts, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      table, n_rows, idx, x, n_pts, k,
      static_cast<const __nv_bfloat16*>(wbuf), bbuf, rbf2, out_pt, out_w,
      static_cast<__nv_bfloat16*>(out_r));
  return static_cast<int>(cudaGetLastError());
}

// One of the per-row kernels on m rows (one unit of work a 128-row tile),
// with its own arguments.
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, long long m, void* stream, Args... args) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  int grid = 0;
  const cudaError_t err = grid_for(reinterpret_cast<const void*>(kernel),
                                   (m + kRows - 1) / kRows, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [n_rows, 35] f32 (row n_rows - 1: the dump row), idx [n_pts, k]
// i32, x [n_pts, 3] f32, wbuf: PriorLayers.k3_buffer (bf16), bbuf: f32
// b0..b3, b_v.  K3: out_pt [n_pts, 5] = (sum w s, sum w, sum w r_pos),
// out_w [n_pts*k], out_r [n_pts*k, 32] bf16.
extern "C" int pair_sdf_aggregate_launch(const float* table, int n_rows,
                                         const int* idx, const float* x,
                                         int n_pts, int k, const void* wbuf,
                                         const float* bbuf, float rbf2,
                                         float* out_pt, float* out_w,
                                         void* out_r, void* stream) {
  return launch_agg<true>(table, n_rows, idx, x, n_pts, k, wbuf, bbuf, rbf2,
                          out_pt, out_w, out_r, stream);
}

// K2, the same inputs: out_pt [n_pts, 2] = (sum w s, sum w).
extern "C" int pair_sdf_value_agg_launch(const float* table, int n_rows,
                                         const int* idx, const float* x,
                                         int n_pts, int k, const void* wbuf,
                                         const float* bbuf, float rbf2,
                                         float* out_pt, void* stream) {
  return launch_agg<false>(table, n_rows, idx, x, n_pts, k, wbuf, bbuf, rbf2,
                           out_pt, nullptr, nullptr, stream);
}

// K6a: g [m, 35] f32, x [m, 3] f32, wbuf / bbuf as above -> out_s [m],
// out_r [m, 35], out_xpi [m, 3].
extern "C" int pair_sdf_rows_grad_launch(const float* g, const float* x,
                                         long long m, const void* wbuf,
                                         const float* bbuf, float* out_s,
                                         float* out_r, float* out_xpi,
                                         void* stream) {
  return launch_rows(rows_grad_kernel, m, stream, g, x, m,
                     static_cast<const __nv_bfloat16*>(wbuf), bbuf, out_s,
                     out_r, out_xpi);
}

// K6b: the same inputs -> out_s [m], out_xpi [m, 3].
extern "C" int pair_sdf_rows_value_launch(const float* g, const float* x,
                                          long long m, const void* wbuf,
                                          const float* bbuf, float* out_s,
                                          float* out_xpi, void* stream) {
  return launch_rows(rows_value_kernel, m, stream, g, x, m,
                     static_cast<const __nv_bfloat16*>(wbuf), bbuf, out_s,
                     static_cast<float*>(nullptr), out_xpi);
}

// K7a: u [m, 35] f32 = [lat | x_pi], wbuf / bbuf as above -> out_s [m],
// out_r [m, 35].
extern "C" int pair_sdf_pre_grad_launch(const float* u, long long m,
                                        const void* wbuf, const float* bbuf,
                                        float* out_s, float* out_r,
                                        void* stream) {
  return launch_rows(rows_pre_grad_kernel, m, stream, u, m,
                     static_cast<const __nv_bfloat16*>(wbuf), bbuf, out_s,
                     out_r);
}

// K7b: the same input -> out_s [m].
extern "C" int pair_sdf_pre_value_launch(const float* u, long long m,
                                         const void* wbuf, const float* bbuf,
                                         float* out_s, void* stream) {
  return launch_rows(rows_pre_value_kernel, m, stream, u, m,
                     static_cast<const __nv_bfloat16*>(wbuf), bbuf, out_s);
}
