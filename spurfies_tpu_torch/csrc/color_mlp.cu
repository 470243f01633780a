// K8a / K8b — the fused colour MLP stack, forward and backward.
//
// Replaces the TPU kernels of spurfies_tpu/ops/pallas_color.py:
//   * K8a: _color_fwd_call -> _color_fwd_kernel (math _fwd_body),
//   * K8b: _color_bwd_call -> _color_bwd_kernel (recompute, reverse sweeps,
//     dW/db of every layer, dlat).
// Per pair t = (point p, neighbour j), with x_pi [3], lat [64], wn (the
// normalized RBF weight, 0 for an invalid pair) and per point dir_enc [21]:
//   u    = [posenc(x_pi) (39) | lat (64)]          (posenc multires 6)
//   h    = u; 3 x h = bf16(max(a, 0.01 a)), a = h @ W_i + b_i (f32 bias)
//   feat = bf16(h @ W_3 + b_3)                     (no activation)
//   agg  = sum_j wn * feat                         (f32)
//   g    = bf16([dir_enc | agg]) (277); 2 x LeakyReLU layers, then
//   rgb  = sigmoid(g2 @ R_2 + b)                   (f32)
// with bf16 operands and f32 accumulation in every product. K8b recomputes
// all of that and then runs the reverse sweeps as the TPU body does: each
// delta stays f32, is rounded to bf16 for each product, is gated by
// (a > 0 ? 1 : 0.01) in f32, and db is its f32 column sum; dlat is the last
// 64 columns of d/du. The gate is read from the sign of the stored bf16
// activation, which is the sign of a except for a positive pre-activation
// below bf16's smallest subnormal.
//
// What bounds it on an H100: operations. F_color does 446 kFLOP per pair
// and R 274 kFLOP per point against ~270 bytes of input per pair, far above
// the ~295 FLOP/byte ridge; K8b does about three times K8a's work. The
// weights are trainable, so unlike the frozen prior of pair_mlp.cu they
// cannot be packed once: every block reads the f32 [in, out] matrices and
// rounds them on load (1.44 MB a block, from L2).
//
// Design (simple first; wgmma, TMA and a persistent grid are later work):
//   * a block owns 16 points = 128 pair rows (the TPU tile of 128 points
//     would need 512 KB per activation); 8 warps; mma.sync m16n8k16 bf16;
//   * activations [128, 256] bf16 in shared memory, one layer's weights at a
//     time (the largest, R0^T, [256, 288]); F_color's layers write their
//     output over their input after a barrier (warp w: rows 32 (w & 3),
//     columns 128 (w >> 2));
//   * the R head runs on the block's 16 points in the freed activation
//     buffer;
//   * K8b keeps the inputs of F_color's layers 1-3 for the reverse sweep in
//     a bf16 global scratch (768 values a pair, written and read back by the
//     same block, mostly from L2); u is recomputed from x_pi and lat;
//   * the cross-block dW/db sum (the TPU grid ran in order and accumulated
//     into revisited output blocks): each block adds its 361,731 partial
//     sums into one zeroed f32 buffer with atomicAdd (float2 where the
//     layout allows), ~361k adds a block; the order of the adds changes
//     from run to run, so dW/db agree with a sequential sum up to f32
//     reordering;
//   * posenc uses sinf/cosf (accurate): an invalid slot reads row 0, so its
//     x_pi can be ~1, which is ~32 rad at 2^5;
//   * the ragged last block reads zeros and writes nothing past the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPts = 16;            // points per block
constexpr int kK = 8;               // neighbours per point
constexpr int kRows = kPts * kK;    // 128 pair rows per block
constexpr int kThreads = 256;       // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHid = 256;
constexpr int kLat = 64;
constexpr int kPos = 39;            // posenc(x_pi): 3 + 6 bands x (sin, cos) x 3
constexpr int kIn0 = kPos + kLat;   // 103
constexpr int kIn0P = 112;          // padded to whole k-steps
constexpr int kDir = 21;
constexpr int kRIn = kDir + kHid;   // 277
constexpr int kRInP = 288;
constexpr int kOut = 3;
constexpr int kS = kHid + 8;        // row stride of 256-wide bf16 tiles
constexpr int kS0 = kIn0P + 8;      // row stride of F0^T
constexpr int kSR0 = kRInP + 8;     // row stride of R0^T and of g
constexpr int kSR2 = 24;            // row stride of R2 and of its delta

// Output buffer of K8b (f32): dW of F0..F3, R0..R2 ([in, out] each), then
// db of F0..F3, R0, R1, R2.
constexpr int kGwF0 = 0;
constexpr int kGwR0 = kIn0 * kHid + 3 * kHid * kHid;   // 222,976
constexpr int kGwR1 = kGwR0 + kRIn * kHid;
constexpr int kGwR2 = kGwR1 + kHid * kHid;
constexpr int kGb = kGwR2 + kHid * kOut;               // 360,192
constexpr int kGbR0 = kGb + 4 * kHid;
constexpr int kGbR1 = kGbR0 + kHid;
constexpr int kGbR2 = kGbR1 + kHid;
constexpr int kGrads = kGbR2 + kOut;                   // 361,731

// Shared memory (bytes).
constexpr int kSmAct = 0;                          // bf16 [128][264]
constexpr int kSmW = kSmAct + kRows * kS * 2;      // bf16 weights or X
constexpr int kSmWn = kSmW + kHid * kSR0 * 2;      // f32 [128]
constexpr int kSmem = kSmWn + kRows * 4;
// The R head's buffers, inside the activation buffer once F_color's output
// is aggregated.
constexpr int kSmG = 0;                            // bf16 [16][296]
constexpr int kSmR1 = kSmG + kPts * kSR0 * 2;      // bf16 [16][264]
constexpr int kSmR2 = kSmR1 + kPts * kS * 2;       // bf16 [16][264]
constexpr int kSmDa = kSmR2 + kPts * kS * 2;       // bf16 [16][264]
constexpr int kSmDb = kSmDa + kPts * kS * 2;       // bf16 [16][264]
constexpr int kSmD3 = kSmDb + kPts * kS * 2;       // bf16 [16][24]
constexpr int kSmD3f = kSmD3 + kPts * kSR2 * 2;    // f32 [16][4]
constexpr int kSmAgg = kSmD3f + kPts * 4 * 4;      // f32 [16][256]
constexpr int kSmREnd = kSmAgg + kPts * kHid * 4;
static_assert(kSmREnd <= kRows * kS * 2, "the R head fits in act");
static_assert(kRows * kS * 2 <= kHid * kSR0 * 2, "X fits in the weights");
static_assert(kSmem <= 232448, "shared memory");
static_assert(kGrads == 361731, "dW/db layout");

struct Weights {
  const float* w[7];   // F0..F3, R0..R2: f32 [in, out]
  const float* b[7];   // f32 [out]
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

// Two bf16 at p and p + step (k and k + 1 of a fragment), packed.
template <bool kContig>
__device__ __forceinline__ uint32_t ld2(const bf16* p, int step) {
  if (kContig) return *reinterpret_cast<const uint32_t*>(p);
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[step];
  return *reinterpret_cast<uint32_t*>(&v);
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

// acc += A[m0 .. m0 + 16 MT, 0 .. 16 ksteps] @ B[.., n0 .. n0 + 8 NT] for
// one warp, with A(m, k) = A[m am + k ak] and B(k, n) = B[k bk + n bn];
// kAK / kBK: k is the contiguous index (ak == 1 / bk == 1).
template <int MT, int NT, bool kAK, bool kBK>
__device__ __forceinline__ void mma_tile(const bf16* A, int am, int ak,
                                         const bf16* B, int bk, int bn,
                                         int m0, int n0, int ksteps,
                                         float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * 16 + 2 * t;
    uint32_t a[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const bf16* ar = A + (m0 + mi * 16 + g) * am + k0 * ak;
      a[mi][0] = ld2<kAK>(ar, ak);
      a[mi][1] = ld2<kAK>(ar + 8 * am, ak);
      a[mi][2] = ld2<kAK>(ar + 8 * ak, ak);
      a[mi][3] = ld2<kAK>(ar + 8 * am + 8 * ak, ak);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const bf16* br = B + k0 * bk + (n0 + ni * 8 + g) * bn;
      const uint32_t b0 = ld2<kBK>(br, bk);
      const uint32_t b1 = ld2<kBK>(br + 8 * bk, bk);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

// The [16 MT m_tiles, 8 NT n_tiles] product in tiles dealt out to the warps;
// epi(m0, n0, acc) after each tile (nothing is written in place).
template <int MT, int NT, bool kAK, bool kBK, class Epi>
__device__ __forceinline__ void tile_gemm(const bf16* A, int am, int ak,
                                          const bf16* B, int bk, int bn,
                                          int m_tiles, int n_tiles,
                                          int ksteps, Epi epi) {
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int tile = warp; tile < m_tiles * n_tiles; tile += kWarps) {
    const int m0 = (tile / n_tiles) * 16 * MT;
    const int n0 = (tile % n_tiles) * 8 * NT;
    float acc[MT][NT][4];
    zero_acc(acc);
    mma_tile<MT, NT, kAK, kBK>(A, am, ak, B, bk, bn, m0, n0, ksteps, acc);
    epi(m0, n0, acc);
  }
}

// Bt[n][k] = bf16(W[k][n]) for k < K, n < N, zero elsewhere up to
// [n_pad][k_pad]; W f32 [K, N] (the forward products' B, k contiguous).
__device__ __forceinline__ void load_wt(bf16* dst, int stride,
                                        const float* __restrict__ W, int K,
                                        int N, int k_pad, int n_pad) {
  const int pairs = k_pad / 2;
  for (int e = threadIdx.x; e < pairs * n_pad; e += kThreads) {
    const int kp = e / n_pad, n = e - kp * n_pad, k = 2 * kp;
    const float lo = (k < K && n < N) ? __ldg(W + (size_t)k * N + n) : 0.f;
    const float hi =
        (k + 1 < K && n < N) ? __ldg(W + (size_t)(k + 1) * N + n) : 0.f;
    *reinterpret_cast<uint32_t*>(dst + n * stride + k) = pack2(lo, hi);
  }
}

// Ws[r][c] = bf16(W[row0 + r][c]) for c < N, zero for N <= c < n_pad; W f32
// [., N] (the backward products' B = W^T, k contiguous).
__device__ __forceinline__ void load_wn(bf16* dst, int stride,
                                        const float* __restrict__ W, int row0,
                                        int rows, int N, int n_pad) {
  const int pairs = n_pad / 2;
  for (int e = threadIdx.x; e < rows * pairs; e += kThreads) {
    const int r = e / pairs, c = 2 * (e - r * pairs);
    const float* src = W + (size_t)(row0 + r) * N + c;
    const float lo = c < N ? __ldg(src) : 0.f;
    const float hi = c + 1 < N ? __ldg(src + 1) : 0.f;
    *reinterpret_cast<uint32_t*>(dst + r * stride + c) = pack2(lo, hi);
  }
}

// u = [posenc(x_pi) | lat | 0] of the block's rows, bf16 [128][112] at
// stride kS; rows past m are zero.
__device__ __forceinline__ void build_u(bf16* dst,
                                        const float* __restrict__ x_pi,
                                        const float* __restrict__ lat,
                                        long long row0, long long m) {
  for (int e = threadIdx.x; e < kRows * kIn0P; e += kThreads) {
    const int r = e / kIn0P, c = e - r * kIn0P;
    const long long q = row0 + r;
    float v = 0.f;
    if (q < m) {
      if (c < 3) {
        v = __ldg(x_pi + q * 3 + c);
      } else if (c < kPos) {
        const int j = c - 3, band = j / 6, w = j - band * 6;
        const float xf =
            __ldg(x_pi + q * 3 + w % 3) * static_cast<float>(1 << band);
        v = w < 3 ? sinf(xf) : cosf(xf);
      } else if (c < kIn0) {
        v = __ldg(lat + q * kLat + (c - kPos));
      }
    }
    dst[r * kS + c] = __float2bfloat16_rn(v);
  }
}

// Per-column sums of a 16-row tile's values (v[ni][j]: this thread's rows g
// and g + 8 already added), into db[n0 + ...] with one atomic a column.
template <int NT>
__device__ __forceinline__ void add_colsum(float (&v)[NT][2],
                                           float* __restrict__ db, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = v[ni][j];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) atomicAdd(db + n0 + ni * 8 + 2 * t + j, s);
    }
}

// A 16-row dW tile's partial sums into dw [., ncols] (rows < m_real).
template <int NT>
__device__ __forceinline__ void add_dw(float (&acc)[1][NT][4],
                                       float* __restrict__ dw, int ncols,
                                       int m_real, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + g + 8 * h, col = n0 + ni * 8 + 2 * t;
      if (row >= m_real) continue;
      float* d = dw + (size_t)row * ncols + col;
      if ((ncols & 1) == 0) {
        atomicAdd(reinterpret_cast<float2*>(d),
                  make_float2(acc[0][ni][2 * h], acc[0][ni][2 * h + 1]));
      } else {
        if (col < ncols) atomicAdd(d, acc[0][ni][2 * h]);
        if (col + 1 < ncols) atomicAdd(d + 1, acc[0][ni][2 * h + 1]);
      }
    }
}

// An R-head layer's epilogue on a 16-point tile: a = acc + b, stored as
// bf16(max(a, 0.01 a)).
template <int NT>
__device__ __forceinline__ void epi_leaky(float (&acc)[1][NT][4], bf16* dst,
                                          const float* __restrict__ bias,
                                          int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h, col = n0 + ni * 8 + 2 * t;
      const float a0 = acc[0][ni][2 * h] + __ldg(bias + col);
      const float a1 = acc[0][ni][2 * h + 1] + __ldg(bias + col + 1);
      *reinterpret_cast<uint32_t*>(dst + row * kS + col) =
          pack2(fmaxf(a0, 0.01f * a0), fmaxf(a1, 0.01f * a1));
    }
}

// A reverse-sweep epilogue of the R head: delta = acc * gate(act > 0), its
// bf16 copy into dst and its column sums into db.
template <int NT>
__device__ __forceinline__ void epi_delta(float (&acc)[1][NT][4], bf16* dst,
                                          const bf16* act,
                                          float* __restrict__ db, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float v[NT][2];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    v[ni][0] = v[ni][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h, col = n0 + ni * 8 + 2 * t;
      const float d0 = acc[0][ni][2 * h] *
          (__bfloat162float(act[row * kS + col]) > 0.f ? 1.f : 0.01f);
      const float d1 = acc[0][ni][2 * h + 1] *
          (__bfloat162float(act[row * kS + col + 1]) > 0.f ? 1.f : 0.01f);
      *reinterpret_cast<uint32_t*>(dst + row * kS + col) = pack2(d0, d1);
      v[ni][0] += d0;
      v[ni][1] += d1;
    }
  }
  add_colsum(v, db, n0);
}

__device__ __forceinline__ int gw_f(int l) {
  return l == 0 ? kGwF0 : kIn0 * kHid + (l - 1) * kHid * kHid;
}

template <bool kBwd>
__global__ void __launch_bounds__(kThreads, 1)
color_kernel(const float* __restrict__ x_pi, const float* __restrict__ lat,
             const float* __restrict__ wn, const float* __restrict__ dir_enc,
             long long n_pts, Weights p, const float* __restrict__ rgb_bar,
             float* __restrict__ rgb, float* __restrict__ dlat,
             float* __restrict__ grads, bf16* __restrict__ hs) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem + kSmAct);
  bf16* wsm = reinterpret_cast<bf16*>(smem + kSmW);
  float* wn_s = reinterpret_cast<float*>(smem + kSmWn);
  bf16* gb = reinterpret_cast<bf16*>(smem + kSmAct + kSmG);
  bf16* r1b = reinterpret_cast<bf16*>(smem + kSmAct + kSmR1);
  bf16* r2b = reinterpret_cast<bf16*>(smem + kSmAct + kSmR2);
  bf16* dab = reinterpret_cast<bf16*>(smem + kSmAct + kSmDa);
  bf16* dbb = reinterpret_cast<bf16*>(smem + kSmAct + kSmDb);
  bf16* d3b = reinterpret_cast<bf16*>(smem + kSmAct + kSmD3);
  float* d3f = reinterpret_cast<float*>(smem + kSmAct + kSmD3f);
  float* dagg = reinterpret_cast<float*>(smem + kSmAct + kSmAgg);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, cg = warp >> 2;
  const long long pt0 = (long long)blockIdx.x * kPts;
  const long long row0 = pt0 * kK;
  const long long m = n_pts * kK;

  // --- inputs: u, wn and F0^T ---
  build_u(act, x_pi, lat, row0, m);
  if (tid < kRows) wn_s[tid] = row0 + tid < m ? __ldg(wn + row0 + tid) : 0.f;
  load_wt(wsm, kS0, p.w[0], kIn0, kHid, kIn0P, kHid);
  __syncthreads();

  // --- F_color on the 128 pair rows, each layer over its input ---
  float acc[2][16][4];
#pragma unroll 1
  for (int l = 0; l < 4; ++l) {
    zero_acc(acc);
    if (l == 0) {
      mma_tile<2, 16, true, true>(act, kS, 1, wsm, 1, kS0, rg * 32, cg * 128,
                                  kIn0P / 16, acc);
    } else {
      mma_tile<2, 16, true, true>(act, kS, 1, wsm, 1, kS, rg * 32, cg * 128,
                                  kHid / 16, acc);
    }
    __syncthreads();
    const float* bias = p.b[l];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rg * 32 + mi * 16 + g + 8 * h;
#pragma unroll
        for (int ni = 0; ni < 16; ++ni) {
          const int col = cg * 128 + ni * 8 + 2 * t;
          const float a0 = acc[mi][ni][2 * h] + __ldg(bias + col);
          const float a1 = acc[mi][ni][2 * h + 1] + __ldg(bias + col + 1);
          uint32_t v;
          if (l < 3) {
            v = pack2(fmaxf(a0, 0.01f * a0), fmaxf(a1, 0.01f * a1));
            if (kBwd)
              *reinterpret_cast<uint32_t*>(
                  hs + ((row0 + row) * 3 + l) * kHid + col) = v;
          } else {
            v = pack2(a0, a1);
          }
          *reinterpret_cast<uint32_t*>(act + row * kS + col) = v;
        }
      }
    if (l < 3) {
      load_wt(wsm, kS, p.w[l + 1], kHid, kHid, kHid, kHid);
    } else {
      load_wt(wsm, kSR0, p.w[4], kRIn, kHid, kRInP, kHid);
    }
    __syncthreads();
  }

  // --- agg = sum_j wn feat (f32), then g = bf16([dir_enc | agg]) ---
  {
    float aggv[kPts];
#pragma unroll
    for (int pp = 0; pp < kPts; ++pp) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const int r = pp * kK + j;
        s = __fadd_rn(s, __fmul_rn(__bfloat162float(act[r * kS + tid]),
                                   wn_s[r]));
      }
      aggv[pp] = s;
    }
    __syncthreads();
#pragma unroll
    for (int pp = 0; pp < kPts; ++pp)
      gb[pp * kSR0 + kDir + tid] = __float2bfloat16_rn(aggv[pp]);
    for (int e = tid; e < kPts * kDir; e += kThreads) {
      const int pp = e / kDir, c = e - pp * kDir;
      const float v =
          pt0 + pp < n_pts ? __ldg(dir_enc + (pt0 + pp) * kDir + c) : 0.f;
      gb[pp * kSR0 + c] = __float2bfloat16_rn(v);
    }
    for (int e = tid; e < kPts * (kSR0 - kRIn); e += kThreads) {
      const int pp = e / (kSR0 - kRIn);
      gb[pp * kSR0 + kRIn + (e - pp * (kSR0 - kRIn))] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();
  }

  // --- R head on the 16 points ---
  tile_gemm<1, 4, true, true>(
      gb, kSR0, 1, wsm, 1, kSR0, 1, kHid / 32, kRInP / 16,
      [&](int, int n0, float (&a)[1][4][4]) { epi_leaky(a, r1b, p.b[4], n0); });
  __syncthreads();
  load_wt(wsm, kS, p.w[5], kHid, kHid, kHid, kHid);
  __syncthreads();
  tile_gemm<1, 4, true, true>(
      r1b, kS, 1, wsm, 1, kS, 1, kHid / 32, kHid / 16,
      [&](int, int n0, float (&a)[1][4][4]) { epi_leaky(a, r2b, p.b[5], n0); });
  __syncthreads();
  load_wt(wsm, kS, p.w[6], kHid, kOut, kHid, 8);
  __syncthreads();
  if (warp == 0) {
    float a[1][1][4];
    zero_acc(a);
    mma_tile<1, 1, true, true>(r2b, kS, 1, wsm, 1, kS, 0, 0, kHid / 16, a);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = g + 8 * h, col = 2 * t + j;
        if (col >= kOut) continue;
        const long long pt = pt0 + row;
        const float z = a[0][0][2 * h + j] + __ldg(p.b[6] + col);
        const float s = 1.f / (1.f + expf(-z));
        if (!kBwd) {
          if (pt < n_pts) rgb[pt * kOut + col] = s;
        } else {
          const float rb = pt < n_pts ? __ldg(rgb_bar + pt * kOut + col) : 0.f;
          d3f[row * 4 + col] = __fmul_rn(__fmul_rn(rb, s), __fsub_rn(1.f, s));
        }
      }
  }
  if (!kBwd) return;
  __syncthreads();

  // --- R head, reverse ---
  for (int e = tid; e < kPts * kSR2; e += kThreads) {
    const int pp = e / kSR2, c = e - pp * kSR2;
    d3b[e] = __float2bfloat16_rn(c < kOut ? d3f[pp * 4 + c] : 0.f);
  }
  if (tid < kOut) {
    float s = 0.f;
    for (int pp = 0; pp < kPts; ++pp) s += d3f[pp * 4 + tid];
    atomicAdd(grads + kGbR2 + tid, s);
  }
  load_wn(wsm, kSR2, p.w[6], 0, kHid, kOut, 16);
  __syncthreads();
  // dW_R2 = r2^T d3 [256, 3]; delta2 = (d3 @ R2^T) * gate(r2) [16, 256]
  tile_gemm<1, 1, false, false>(
      r2b, 1, kS, d3b, kSR2, 1, kHid / 16, 1, 1,
      [&](int m0, int n0, float (&a)[1][1][4]) {
        add_dw(a, grads + kGwR2, kOut, kHid, m0, n0);
      });
  tile_gemm<1, 4, true, true>(
      d3b, kSR2, 1, wsm, 1, kSR2, 1, kHid / 32, 1,
      [&](int, int n0, float (&a)[1][4][4]) {
        epi_delta(a, dab, r2b, grads + kGbR1, n0);
      });
  __syncthreads();
  // dW_R1 = r1^T delta2; delta1 = (delta2 @ R1^T) * gate(r1)
  tile_gemm<1, 8, false, false>(
      r1b, 1, kS, dab, kS, 1, kHid / 16, kHid / 64, 1,
      [&](int m0, int n0, float (&a)[1][8][4]) {
        add_dw(a, grads + kGwR1, kHid, kHid, m0, n0);
      });
  load_wn(wsm, kS, p.w[5], 0, kHid, kHid, kHid);
  __syncthreads();
  tile_gemm<1, 4, true, true>(
      dab, kS, 1, wsm, 1, kS, 1, kHid / 32, kHid / 16,
      [&](int, int n0, float (&a)[1][4][4]) {
        epi_delta(a, dbb, r1b, grads + kGbR0, n0);
      });
  __syncthreads();
  // dW_R0 = g^T delta1 [277, 256]; d_agg = delta1 @ R0[21:]^T (f32)
  tile_gemm<1, 8, false, false>(
      gb, 1, kSR0, dbb, kS, 1, kRInP / 16, kHid / 64, 1,
      [&](int m0, int n0, float (&a)[1][8][4]) {
        add_dw(a, grads + kGwR0, kHid, kRIn, m0, n0);
      });
  load_wn(wsm, kS, p.w[4], kDir, kHid, kHid, kHid);
  __syncthreads();
  tile_gemm<1, 4, true, true>(
      dbb, kS, 1, wsm, 1, kS, 1, kHid / 32, kHid / 16,
      [&](int, int n0, float (&a)[1][4][4]) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = g + 8 * h, col = n0 + ni * 8 + 2 * t;
            dagg[row * kHid + col] = a[0][ni][2 * h];
            dagg[row * kHid + col + 1] = a[0][ni][2 * h + 1];
          }
      });
  __syncthreads();

  // --- d_feat = wn * d_agg[point] (f32) into act as bf16; db_F3 ---
  {
    float dv[kPts];
#pragma unroll
    for (int pp = 0; pp < kPts; ++pp) dv[pp] = dagg[pp * kHid + tid];
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int pp = 0; pp < kPts; ++pp)
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const int r = pp * kK + j;
        const float d = dv[pp] * wn_s[r];
        s += d;
        act[r * kS + tid] = __float2bfloat16_rn(d);
      }
    atomicAdd(grads + kGb + 3 * kHid + tid, s);
  }

  // --- F_color, reverse: layer l's input X (h_l from the scratch, or u) ---
  bf16* xb = wsm;
#pragma unroll 1
  for (int l = 3; l >= 0; --l) {
    if (l > 0) {
      for (int e = tid; e < kRows * (kHid / 8); e += kThreads) {
        const int r = e / (kHid / 8), q = e - r * (kHid / 8);
        *reinterpret_cast<uint4*>(xb + r * kS + q * 8) =
            *reinterpret_cast<const uint4*>(
                hs + ((row0 + r) * 3 + (l - 1)) * kHid + q * 8);
      }
    } else {
      build_u(xb, x_pi, lat, row0, m);
    }
    __syncthreads();
    // dW_l = X^T delta, K = the 128 pair rows
    tile_gemm<1, 8, false, false>(
        xb, 1, kS, act, kS, 1, (l > 0 ? kHid : kIn0P) / 16, kHid / 64,
        kRows / 16, [&](int m0, int n0, float (&a)[1][8][4]) {
          add_dw(a, grads + gw_f(l), kHid, l > 0 ? kHid : kIn0, m0, n0);
        });
    __syncthreads();
    if (l > 0) {
      // delta = (delta @ W_l^T) * gate(h_l) over act; db_{l-1}
      load_wn(wsm, kS, p.w[l], 0, kHid, kHid, kHid);
      __syncthreads();
      zero_acc(acc);
      mma_tile<2, 16, true, true>(act, kS, 1, wsm, 1, kS, rg * 32, cg * 128,
                                  kHid / 16, acc);
      __syncthreads();
#pragma unroll
      for (int ni = 0; ni < 16; ++ni) {
        const int col = cg * 128 + ni * 8 + 2 * t;
        float v[1][2] = {{0.f, 0.f}};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rg * 32 + mi * 16 + g + 8 * h;
            const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(
                hs + ((row0 + row) * 3 + (l - 1)) * kHid + col);
            const float d0 = acc[mi][ni][2 * h] *
                (__bfloat162float(hv.x) > 0.f ? 1.f : 0.01f);
            const float d1 = acc[mi][ni][2 * h + 1] *
                (__bfloat162float(hv.y) > 0.f ? 1.f : 0.01f);
            *reinterpret_cast<uint32_t*>(act + row * kS + col) = pack2(d0, d1);
            v[0][0] += d0;
            v[0][1] += d1;
          }
        add_colsum<1>(v, grads + kGb + (l - 1) * kHid, col - 2 * t);
      }
      __syncthreads();
    } else {
      // dlat = (delta @ F0^T)[:, 39:103] (f32, no gate)
      load_wn(wsm, kS, p.w[0], kPos, kLat, kHid, kHid);
      __syncthreads();
      tile_gemm<1, 8, true, true>(
          act, kS, 1, wsm, 1, kS, kRows / 16, kLat / 64, kHid / 16,
          [&](int m0, int n0, float (&a)[1][8][4]) {
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const long long q = row0 + m0 + g + 8 * h;
                if (q < m)
                  *reinterpret_cast<float2*>(dlat + q * kLat + n0 + ni * 8 +
                                             2 * t) =
                      make_float2(a[0][ni][2 * h], a[0][ni][2 * h + 1]);
              }
          });
    }
  }
}

template <bool kBwd>
int launch(const float* x_pi, const float* lat, const float* wn,
           const float* dir_enc, long long n_pts, const void* const* ws,
           const void* const* bs, const float* rgb_bar, float* rgb,
           float* dlat, float* grads, void* hs, void* stream) {
  if (n_pts < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pts == 0) return 0;
  const long long blocks = (n_pts + kPts - 1) / kPts;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      color_kernel<kBwd>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Weights p;
  for (int i = 0; i < 7; ++i) {
    p.w[i] = static_cast<const float*>(ws[i]);
    p.b[i] = static_cast<const float*>(bs[i]);
  }
  color_kernel<kBwd><<<static_cast<unsigned>(blocks), kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      x_pi, lat, wn, dir_enc, n_pts, p, rgb_bar, rgb, dlat, grads,
      static_cast<bf16*>(hs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8a. x_pi [8P, 3], lat [8P, 64], wn [8P], dir_enc [P, 21] f32; ws / bs:
// host arrays of the 7 device pointers of F_color's and R's f32 weights
// [in, out] and biases [out]. rgb [P, 3] f32.
extern "C" int fused_color_fwd_launch(const float* x_pi, const float* lat,
                                      const float* wn, const float* dir_enc,
                                      long long n_pts, const void* const* ws,
                                      const void* const* bs, float* rgb,
                                      void* stream) {
  return launch<false>(x_pi, lat, wn, dir_enc, n_pts, ws, bs, nullptr, rgb,
                       nullptr, nullptr, nullptr, stream);
}

// K8b. The inputs of K8a and rgb_bar [P, 3] f32 -> dlat [8P, 64] f32 and
// grads [361731] f32 (dW then db, zeroed by the caller); hs: bf16 scratch
// of ceil(P / 16) * 128 * 768 values.
extern "C" int fused_color_bwd_launch(const float* x_pi, const float* lat,
                                      const float* wn, const float* dir_enc,
                                      long long n_pts, const void* const* ws,
                                      const void* const* bs,
                                      const float* rgb_bar, float* dlat,
                                      float* grads, void* hs, void* stream) {
  return launch<true>(x_pi, lat, wn, dir_enc, n_pts, ws, bs, rgb_bar, nullptr,
                      dlat, grads, hs, stream);
}
