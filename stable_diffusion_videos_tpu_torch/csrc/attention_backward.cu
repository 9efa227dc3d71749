// Backward of non-causal attention for Hopper (sm_90a).
//
// The JAX package has no Pallas backward: its Pallas kernel carries no
// custom_vjp, and its trainers differentiate the XLA route
// (stable_diffusion_videos_tpu/ops/attention.py:79, xla_attention) with
// XLA's autodiff.  This is the same gradient for the port's forward kernel
// (flash_attention.cu): given q, k, v (B, S, H, D), the forward's output o
// and its cotangent do, it writes dq, dk, dv in the inputs' dtype (f32 or
// bf16), FlashAttention-2 style, with the S×S scores never in device memory:
//
//   1. lse_kernel, a block per (b, h, q tile): the forward writes no
//      log-sum-exp, so this pass recomputes each row's LSE over every key
//      tile (online max and sum, log2 domain) and D_i = rowsum(do∘o);
//   2. dkdv_kernel, a block per (b, h, key tile): over every q tile,
//      P = exp(s - lse), dP = do·vᵀ, dS = P∘(dP - D_i), and
//      dv += Pᵀ·do, dk += dSᵀ·q·scale, accumulated in registers;
//   3. dq_kernel, a block per (b, h, q tile): over every key tile the same
//      P and dS, and dq += dS·k·scale.
//
// No atomics anywhere: every sum runs in one block in a fixed order, so the
// gradients are the same bit for bit from run to run (the trainer's remat
// check compares two runs exactly).
//
// What bounds it: 10·Sq·Sk·D operations a (b, h) (five products of the
// scores' size) plus the LSE pass's 2·Sq·Sk·D, against O((Sq+Sk)·D) bytes,
// so operations.  Two paths, chosen by dtype and depth (not on failure):
//
// * bf16 with D a multiple of 8 up to 80 (SD 1.x's levels 0 and 1, where
//   nearly all of the UNet's attention work is): the tensor cores, with
//   mma.sync (below, after the FMA path).  P and dS are rounded to bf16
//   before their products, as FlashAttention-2 does.
// * everything else (fp32; D=160 and the VAE's D=512): the FMA units in
//   fp32, tiles in shared memory as fp32, a 16×16 thread grid, each thread
//   a register micro-tile.  The tiles are padded to 48, 64, 80, 160 or 512
//   columns (zeros past D); at 512 (the VAE mid-block, one head, S=4096)
//   they shrink to 32 q rows and 16 keys so that q, do, k and v fit shared
//   memory whole.  At D=160 the tensor-core path's two accumulators of 16
//   rows × 160 would not fit a thread's registers beside the scores; a
//   layout for D=160 and 512 is later work.
//
// sdv_attention_backward_tensor_cores(0) sends the bf16 calls at D <= 80 to
// the FMA path as well: chip_smoke.py checks that path at those shapes and
// times a training step with each path in turns.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // a 16×16 grid for every product
constexpr float kLog2e = 1.4426950408889634f;

template <int DP_, int BQ_, int BK_>
struct BwdCfg {
  static constexpr int DP = DP_;  // padded depth, a multiple of 16
  static constexpr int BQ = BQ_;  // q rows a tile
  static constexpr int BK = BK_;  // keys a tile
  static constexpr int LD = DP + 1;  // row stride of [row][depth] tiles
  static constexpr int LS = BK + 1;  // row stride of [q row][key] tiles
  // q and do tiles, k and v tiles, P and dS, lse and D of the q rows
  static constexpr int SMEM =
      4 * (2 * BQ * LD + 2 * BK * LD + 2 * BQ * LS + 2 * BQ);
  static_assert(DP % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "tiles");
};

// Every instantiation, by padded depth: (DP, BQ, BK).
#define SDV_BWD_CONFIGS(X) \
  X(48, 64, 64) X(64, 64, 64) X(80, 64, 64) X(160, 64, 32) X(512, 32, 16)

int padded_depth(int D) {
  for (int dp : {48, 64, 80, 160, 512})
    if (D <= dp) return dp;
  return 0;
}

struct Smem {
  float *q, *dout, *k, *v, *p, *ds, *lse, *delta;
};

template <class C>
__device__ __forceinline__ Smem carve(float* base) {
  Smem s;
  s.q = base;
  s.dout = s.q + C::BQ * C::LD;
  s.k = s.dout + C::BQ * C::LD;
  s.v = s.k + C::BK * C::LD;
  s.p = s.v + C::BK * C::LD;
  s.ds = s.p + C::BQ * C::LS;
  s.lse = s.ds + C::BQ * C::LS;
  s.delta = s.lse + C::BQ;
  return s;
}

// rows [row0, row0 + ROWS) of head h of item b of a (B, S, H, D) tensor
// into a [ROWS][LD] fp32 tile; zeros past S and past D
template <class C, int ROWS, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int h, int row0, int S, int H,
                                          int D) {
  for (int idx = threadIdx.x; idx < ROWS * C::DP; idx += kThreads) {
    const int r = idx / C::DP, d = idx % C::DP, row = row0 + r;
    float val = 0.f;
    if (row < S && d < D)
      val = sdv::to_f32(src[(((long long)b * S + row) * H + h) * D + d]);
    dst[r * C::LD + d] = val;
  }
}

// acc[r][c] += sum over kk < K of A(tm + 16 r, kk) · B(tn + 16 c, kk), with
// A(m, kk) = A[m·am + kk·ak] and B(n, kk) = B[n·bn + kk·bk] in shared memory
template <int RM, int RN>
__device__ __forceinline__ void gemm(float (&acc)[RM][RN], const float* A,
                                     int am, int ak, const float* B, int bn,
                                     int bk, int K, int tm, int tn) {
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[RM], bv[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = A[(tm + 16 * r) * am + kk * ak];
#pragma unroll
    for (int c = 0; c < RN; ++c) bv[c] = B[(tn + 16 * c) * bn + kk * bk];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
}

// reduce over the 16 lanes that share a row of the thread grid
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Pass 1: lse (log2 domain: log2 of sum of 2^(s·scale·log2e)) and
// D_i = rowsum(do∘o) of every q row, into (B·H, Sq) fp32 scratch.
template <class C, typename T>
__global__ void __launch_bounds__(kThreads)
    lse_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ lse, float* __restrict__ delta, int Sq,
               int Sk, int H, int D, float scale_log2) {
  extern __shared__ float smem[];
  const Smem s = carve<C>(smem);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BQ;
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  constexpr int RM = C::BQ / 16, RN = C::BK / 16;
  load_tile<C, C::BQ>(s.q, q, b, h, q0, Sq, H, D);
  // D_i: a warp a row, lanes over the depth
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < C::BQ; r += kThreads / 32) {
    const int i = q0 + r;
    if (i >= Sq) break;
    const long long base = (((long long)b * Sq + i) * H + h) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc += sdv::to_f32(dout[base + d]) * sdv::to_f32(o[base + d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[(long long)bh * Sq + i] = acc;
  }
  float m_run[RM], l_run[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) m_run[r] = -INFINITY, l_run[r] = 0.f;
  for (int k0 = 0; k0 < Sk; k0 += C::BK) {
    __syncthreads();
    load_tile<C, C::BK>(s.k, k, b, h, k0, Sk, H, D);
    __syncthreads();
    float sc[RM][RN];
    zero(sc);
    gemm(sc, s.q, C::LD, 1, s.k, C::LD, 1, C::DP, tm, tn);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        sc[r][c] = k0 + tn + 16 * c < Sk ? sc[r][c] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
      const float m_new = fmaxf(m_run[r], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < RN; ++c) sum += exp2f(sc[r][c] - m_new);
      l_run[r] = l_run[r] * exp2f(m_run[r] - m_new) + row_sum16(sum);
      m_run[r] = m_new;
    }
  }
  if (tn == 0) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int i = q0 + tm + 16 * r;
      if (i < Sq) lse[(long long)bh * Sq + i] = m_run[r] + log2f(l_run[r]);
    }
  }
}

// P and dS of one (q tile, key tile) pair into shared memory, from the q,
// do, k and v tiles and the rows' lse and D there
template <class C>
__device__ __forceinline__ void probs_and_dscores(const Smem& s, int k0,
                                                  int Sk, float scale_log2,
                                                  int tm, int tn) {
  constexpr int RM = C::BQ / 16, RN = C::BK / 16;
  float sc[RM][RN], dp[RM][RN];
  zero(sc);
  zero(dp);
  gemm(sc, s.q, C::LD, 1, s.k, C::LD, 1, C::DP, tm, tn);
  gemm(dp, s.dout, C::LD, 1, s.v, C::LD, 1, C::DP, tm, tn);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = tm + 16 * r;
    const float lse = s.lse[i], di = s.delta[i];
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int j = tn + 16 * c;
      const float p =
          k0 + j < Sk ? exp2f(sc[r][c] * scale_log2 - lse) : 0.f;
      s.p[i * C::LS + j] = p;
      s.ds[i * C::LS + j] = p * (dp[r][c] - di);
    }
  }
}

// the rows' lse and D into shared memory: lse +inf past Sq, so P is 0 there
template <class C>
__device__ __forceinline__ void load_rows(const Smem& s, const float* lse,
                                          const float* delta, long long bh,
                                          int q0, int Sq) {
  for (int r = threadIdx.x; r < C::BQ; r += kThreads) {
    const int i = q0 + r;
    s.lse[r] = i < Sq ? lse[bh * Sq + i] : INFINITY;
    s.delta[r] = i < Sq ? delta[bh * Sq + i] : 0.f;
  }
}

// a [ROWS][DP] register accumulator (rows tm + 16 r, columns tn + 16 c)
// times `mul` into rows [row0, ..) of head h of item b of a (B, S, H, D)
// tensor
template <int RM, int RN, typename T>
__device__ __forceinline__ void store_acc(T* dst, const float (&acc)[RM][RN],
                                          float mul, int b, int h, int row0,
                                          int S, int H, int D, int tm,
                                          int tn) {
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = row0 + tm + 16 * r;
    if (row >= S) continue;
    const long long base = (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int d = tn + 16 * c;
      if (d < D) dst[base + d] = sdv::from_f32<T>(acc[r][c] * mul);
    }
  }
}

// Pass 2: dk and dv of one key tile, over every q tile.
template <class C, typename T>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Sq, int Sk, int H, int D, float scale,
                float scale_log2) {
  extern __shared__ float smem[];
  const Smem s = carve<C>(smem);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * C::BK;
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  constexpr int RM = C::BK / 16, RN = C::DP / 16;
  load_tile<C, C::BK>(s.k, k, b, h, k0, Sk, H, D);
  load_tile<C, C::BK>(s.v, v, b, h, k0, Sk, H, D);
  float acc_k[RM][RN], acc_v[RM][RN];
  zero(acc_k);
  zero(acc_v);
  for (int q0 = 0; q0 < Sq; q0 += C::BQ) {
    __syncthreads();
    load_tile<C, C::BQ>(s.q, q, b, h, q0, Sq, H, D);
    load_tile<C, C::BQ>(s.dout, dout, b, h, q0, Sq, H, D);
    load_rows<C>(s, lse, delta, bh, q0, Sq);
    __syncthreads();
    probs_and_dscores<C>(s, k0, Sk, scale_log2, tm, tn);
    __syncthreads();
    // dv[j][d] += sum_i P[i][j] do[i][d]; dk[j][d] += sum_i dS[i][j] q[i][d]
    gemm(acc_v, s.p, 1, C::LS, s.dout, 1, C::LD, C::BQ, tm, tn);
    gemm(acc_k, s.ds, 1, C::LS, s.q, 1, C::LD, C::BQ, tm, tn);
  }
  store_acc(dk, acc_k, scale, b, h, k0, Sk, H, D, tm, tn);
  store_acc(dv, acc_v, 1.f, b, h, k0, Sk, H, D, tm, tn);
}

// Pass 3: dq of one q tile, over every key tile.
template <class C, typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Sk, int H, int D, float scale,
              float scale_log2) {
  extern __shared__ float smem[];
  const Smem s = carve<C>(smem);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BQ;
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  constexpr int RM = C::BQ / 16, RN = C::DP / 16;
  load_tile<C, C::BQ>(s.q, q, b, h, q0, Sq, H, D);
  load_tile<C, C::BQ>(s.dout, dout, b, h, q0, Sq, H, D);
  load_rows<C>(s, lse, delta, bh, q0, Sq);
  float acc[RM][RN];
  zero(acc);
  for (int k0 = 0; k0 < Sk; k0 += C::BK) {
    __syncthreads();
    load_tile<C, C::BK>(s.k, k, b, h, k0, Sk, H, D);
    load_tile<C, C::BK>(s.v, v, b, h, k0, Sk, H, D);
    __syncthreads();
    probs_and_dscores<C>(s, k0, Sk, scale_log2, tm, tn);
    __syncthreads();
    // dq[i][d] += sum_j dS[i][j] k[j][d]
    gemm(acc, s.ds, C::LS, 1, s.k, 1, C::LD, C::BK, tm, tn);
  }
  store_acc(dq, acc, scale, b, h, q0, Sq, H, D, tm, tn);
}

// ---------------------------------------------------------------------------
// bf16 at depths up to 80 (every SD 1.x UNet level with most of the work:
// D=40 at 4096 positions, D=80 at 1024): the same three passes on the tensor
// cores with mma.sync (m16n8k16, bf16 in, fp32 accumulate).  A block is 4
// warps; tiles of 64 rows sit in shared memory as bf16 (rows padded by 8
// columns so ldmatrix reads no two rows from one bank); each warp owns 16
// rows of the block's tile.  P and dS never leave registers: an mma's fp32
// accumulator of two adjacent 8-column tiles, packed to bf16, is the next
// mma's A operand (FlashAttention-2's layout trick).  The fp32 statistics,
// the masking and the fixed summation order are those of the FMA path.

constexpr int kMmaWarps = 4, kMmaThreads = 32 * kMmaWarps, kMmaRows = 64;

template <int DP_>
struct MmaCfg {
  static constexpr int DP = DP_;
  static constexpr int LDH = DP + 8;  // bf16 row stride, 16-byte rows
  // four [64][LDH] bf16 tiles, then lse and D of 64 q rows
  static constexpr int SMEM = 4 * kMmaRows * LDH * 2 + 2 * kMmaRows * 4;
  static_assert(DP % 16 == 0, "depth");
};

#define SDV_MMA_CONFIGS(X) X(48) X(64) X(80)

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sdv::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sdv::smem_u32(p)));
}

// c += a · b on one 16×8 tile: a the m16k16 A fragment, b0/b1 the k16n8 B
// fragment
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of head h of item b of a (B, S, H, D) bf16 tensor
// (D % 8 == 0, 16-byte aligned) into a [64][LDH] bf16 tile, 16 bytes a
// thread; zeros past S and past D
template <class C>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int b, int h, int row0, int S,
                                               int H, int D) {
  constexpr int VEC = C::DP / 8;  // 16-byte vectors a padded row
  for (int idx = threadIdx.x; idx < kMmaRows * VEC; idx += kMmaThreads) {
    const int r = idx / VEC, c = (idx % VEC) * 8, row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < S && c < D)
      val = *reinterpret_cast<const uint4*>(
          src + (((long long)b * S + row) * H + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * C::LDH + c) = val;
  }
}

// A operand (16 rows from row0, k16 from k0) of a [rows][LDH] tile
template <class C>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* t, int row0,
                                       int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, t + (row0 + l % 16) * C::LDH + k0 + (l / 16) * 8);
}

// B operands of two 8-wide n tiles (n0, n0 + 8), k16 from k0, from a tile
// held as [n][k] (k contiguous): b[0..1] for n0, b[2..3] for n0 + 8
template <class C>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* t, int n0,
                                          int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(b, t + (n0 + l % 8 + (l / 16) * 8) * C::LDH + k0 + (l / 8) % 2 * 8);
}

// the same from a tile held as [k][n] (n contiguous)
template <class C>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* t, int n0,
                                          int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_trans(b, t + (k0 + l % 8 + (l / 8) % 2 * 8) * C::LDH + n0 +
                       (l / 16) * 8);
}

// acc[n] (16 rows × 64 columns, 8 tiles) += A(16 × DP, rows row0 of ta) ·
// B(64 × DP, rows of tb held [n][k])ᵀ
template <class C>
__device__ __forceinline__ void scores16x64(float (&acc)[8][4],
                                            const __nv_bfloat16* ta,
                                            int row0,
                                            const __nv_bfloat16* tb) {
#pragma unroll
  for (int k0 = 0; k0 < C::DP; k0 += 16) {
    uint32_t a[4];
    load_a<C>(a, ta, row0, k0);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      load_b_nk<C>(b, tb, n * 8, k0);
      mma16816(acc[n], a, b[0], b[1]);
      mma16816(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 rows × DP, DP/8 tiles) += X(16 × 64, registers: 8 tiles of the
// scores' layout) · B(64 × DP, held [k][n] in tb)
template <class C>
__device__ __forceinline__ void times_tile(float (&acc)[C::DP / 8][4],
                                           const float (&x)[8][4],
                                           const __nv_bfloat16* tb) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t a[4] = {pack_bf16x2(x[2 * ks][0], x[2 * ks][1]),
                           pack_bf16x2(x[2 * ks][2], x[2 * ks][3]),
                           pack_bf16x2(x[2 * ks + 1][0], x[2 * ks + 1][1]),
                           pack_bf16x2(x[2 * ks + 1][2], x[2 * ks + 1][3])};
#pragma unroll
    for (int n = 0; n < C::DP / 8; n += 2) {
      uint32_t b[4];
      load_b_kn<C>(b, tb, n * 8, ks * 16);
      mma16816(acc[n], a, b[0], b[1]);
      mma16816(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// a 16 × DP accumulator (rows row0 + g, + 8; columns 8 n + 2 t, + 1)
// times `mul` into rows of head h of item b of a (B, S, H, D) bf16 tensor
template <class C>
__device__ __forceinline__ void store_mma(__nv_bfloat16* dst,
                                          const float (&acc)[C::DP / 8][4],
                                          float mul, int b, int h, int row0,
                                          int S, int H, int D) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= S) continue;
    __nv_bfloat16* out = dst + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < C::DP / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D)
        *reinterpret_cast<uint32_t*>(out + d) = pack_bf16x2(
            acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

struct MmaSmem {
  __nv_bfloat16 *q, *dout, *k, *v;
  float *lse, *delta;
};

template <class C>
__device__ __forceinline__ MmaSmem carve_mma(unsigned char* base) {
  MmaSmem s;
  s.q = reinterpret_cast<__nv_bfloat16*>(base);
  s.dout = s.q + kMmaRows * C::LDH;
  s.k = s.dout + kMmaRows * C::LDH;
  s.v = s.k + kMmaRows * C::LDH;
  s.lse = reinterpret_cast<float*>(s.v + kMmaRows * C::LDH);
  s.delta = s.lse + kMmaRows;
  return s;
}

// Pass 1 on the tensor cores: the rows' lse (log2 domain) and D_i.
template <class C>
__global__ void __launch_bounds__(kMmaThreads)
    lse_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   float* __restrict__ lse, float* __restrict__ delta,
                   int Sq, int Sk, int H, int D, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem s = carve_mma<C>(smem_raw);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32, t = l % 4;
  load_tile_bf16<C>(s.q, q, b, h, q0, Sq, H, D);
  for (int r = warp; r < kMmaRows; r += kMmaWarps) {
    const int i = q0 + r;
    if (i >= Sq) break;
    const long long base = (((long long)b * Sq + i) * H + h) * D;
    float acc = 0.f;
    for (int d = l; d < D; d += 32)
      acc += __bfloat162float(dout[base + d]) * __bfloat162float(o[base + d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (l == 0) delta[(long long)bh * Sq + i] = acc;
  }
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < Sk; k0 += kMmaRows) {
    __syncthreads();
    load_tile_bf16<C>(s.k, k, b, h, k0, Sk, H, D);
    __syncthreads();
    float sc[8][4] = {};
    scores16x64<C>(sc, s.q, warp * 16, s.k);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[n][2 * half + e];
          x = k0 + n * 8 + 2 * t + e < Sk ? x * scale_log2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        sum += exp2f(sc[n][2 * half] - m_new) +
               exp2f(sc[n][2 * half + 1] - m_new);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[half] = l_run[half] * exp2f(m_run[half] - m_new) + sum;
      m_run[half] = m_new;
    }
  }
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = q0 + warp * 16 + l / 4 + 8 * half;
      if (i < Sq)
        lse[(long long)bh * Sq + i] = m_run[half] + log2f(l_run[half]);
    }
  }
}

// P and dS of a warp's 16 rows against 64 columns, in the scores' layout:
// `rows` are q rows (lse/D per row) when by_row, else keys (lse/D per
// column, the transposed scores of the dk/dv pass); `valid` counts the
// columns (or rows) that are real keys
template <bool BY_ROW>
__device__ __forceinline__ void probs_mma(float (&sc)[8][4],
                                          float (&dp)[8][4],
                                          const float* lse,
                                          const float* delta, int row0,
                                          int valid, float scale_log2) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e / 2), col = n * 8 + 2 * t + e % 2;
      const int qi = BY_ROW ? row : col, key = BY_ROW ? col : row;
      const float p = key < valid
                          ? exp2f(sc[n][e] * scale_log2 - lse[qi])
                          : 0.f;
      sc[n][e] = p;
      dp[n][e] = p * (dp[n][e] - delta[qi]);
    }
}

// Pass 2 on the tensor cores: dk and dv of 64 keys (16 a warp), over
// every q tile; the scores are computed transposed (keys × q rows), so P
// and dS are the A operands of dv += Pᵀ·do and dk += dSᵀ·q.
template <class C>
__global__ void __launch_bounds__(kMmaThreads)
    dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                    int D, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem s = carve_mma<C>(smem_raw);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kMmaRows, warp = threadIdx.x / 32;
  load_tile_bf16<C>(s.k, k, b, h, k0, Sk, H, D);
  load_tile_bf16<C>(s.v, v, b, h, k0, Sk, H, D);
  float acc_k[C::DP / 8][4] = {}, acc_v[C::DP / 8][4] = {};
  for (int q0 = 0; q0 < Sq; q0 += kMmaRows) {
    __syncthreads();
    load_tile_bf16<C>(s.q, q, b, h, q0, Sq, H, D);
    load_tile_bf16<C>(s.dout, dout, b, h, q0, Sq, H, D);
    for (int r = threadIdx.x; r < kMmaRows; r += kMmaThreads) {
      const int i = q0 + r;
      s.lse[r] = i < Sq ? lse[(long long)bh * Sq + i] : INFINITY;
      s.delta[r] = i < Sq ? delta[(long long)bh * Sq + i] : 0.f;
    }
    __syncthreads();
    float st[8][4] = {}, dpt[8][4] = {};
    scores16x64<C>(st, s.k, warp * 16, s.q);
    scores16x64<C>(dpt, s.v, warp * 16, s.dout);
    probs_mma<false>(st, dpt, s.lse, s.delta, warp * 16, Sk - k0,
                     scale_log2);
    times_tile<C>(acc_v, st, s.dout);
    times_tile<C>(acc_k, dpt, s.q);
  }
  store_mma<C>(dk, acc_k, scale, b, h, k0 + warp * 16, Sk, H, D);
  store_mma<C>(dv, acc_v, 1.f, b, h, k0 + warp * 16, Sk, H, D);
}

// Pass 3 on the tensor cores: dq of 64 q rows (16 a warp), over every key
// tile.
template <class C>
__global__ void __launch_bounds__(kMmaThreads)
    dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                  int D, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem s = carve_mma<C>(smem_raw);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kMmaRows, warp = threadIdx.x / 32;
  load_tile_bf16<C>(s.q, q, b, h, q0, Sq, H, D);
  load_tile_bf16<C>(s.dout, dout, b, h, q0, Sq, H, D);
  for (int r = threadIdx.x; r < kMmaRows; r += kMmaThreads) {
    const int i = q0 + r;
    s.lse[r] = i < Sq ? lse[(long long)bh * Sq + i] : INFINITY;
    s.delta[r] = i < Sq ? delta[(long long)bh * Sq + i] : 0.f;
  }
  float acc[C::DP / 8][4] = {};
  for (int k0 = 0; k0 < Sk; k0 += kMmaRows) {
    __syncthreads();
    load_tile_bf16<C>(s.k, k, b, h, k0, Sk, H, D);
    load_tile_bf16<C>(s.v, v, b, h, k0, Sk, H, D);
    __syncthreads();
    float sc[8][4] = {}, dp[8][4] = {};
    scores16x64<C>(sc, s.q, warp * 16, s.k);
    scores16x64<C>(dp, s.dout, warp * 16, s.v);
    probs_mma<true>(sc, dp, s.lse, s.delta, warp * 16, Sk - k0,
                    scale_log2);
    times_tile<C>(acc, dp, s.k);
  }
  store_mma<C>(dq, acc, scale, b, h, q0 + warp * 16, Sq, H, D);
}

template <class C>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* lse,
               float* delta, int B, int Sq, int Sk, int H, int D, float scale,
               cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const bf *tq = static_cast<const bf*>(q), *tk = static_cast<const bf*>(k),
           *tv = static_cast<const bf*>(v), *to = static_cast<const bf*>(o),
           *tdo = static_cast<const bf*>(dout);
  const float scale_log2 = scale * kLog2e;
  const dim3 gq((Sq + kMmaRows - 1) / kMmaRows, B * H);
  const dim3 gk((Sk + kMmaRows - 1) / kMmaRows, B * H);
  lse_mma_kernel<C><<<gq, kMmaThreads, C::SMEM, stream>>>(
      tq, tk, to, tdo, lse, delta, Sq, Sk, H, D, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_mma_kernel<C><<<gk, kMmaThreads, C::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
      Sq, Sk, H, D, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_mma_kernel<C><<<gq, kMmaThreads, C::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf*>(dq), Sq, Sk, H, D, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

template <class C>
cudaError_t prepare_mma() {
  cudaError_t err = cudaFuncSetAttribute(
      lse_mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_mma_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_mma_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
  return err;
}

template <class C, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int B, int Sq, int Sk, int H, int D, float scale,
           cudaStream_t stream) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(o),
          *tdo = static_cast<const T*>(dout);
  const float scale_log2 = scale * kLog2e;
  const dim3 gq((Sq + C::BQ - 1) / C::BQ, B * H);
  const dim3 gk((Sk + C::BK - 1) / C::BK, B * H);
  lse_kernel<C, T><<<gq, kThreads, C::SMEM, stream>>>(
      tq, tk, to, tdo, lse, delta, Sq, Sk, H, D, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<C, T><<<gk, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, D, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<C, T><<<gq, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), Sq, Sk, H, D, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

template <class C, typename T>
cudaError_t prepare_one() {
  cudaError_t err = cudaFuncSetAttribute(
      lse_kernel<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_kernel<C, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<C, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
  return err;
}

// 0 routes every call to the FMA path (an end-to-end comparison of the two
// paths; see sdv_attention_backward_tensor_cores)
int g_tensor_cores = 1;

}  // namespace

// q, o, do: (B, Sq, H, D); k, v: (B, Sk, H, D); dq, dk, dv like q, k, v;
// all contiguous and of one dtype (f32 or bf16), D <= 512.  lse and delta:
// (B·H·Sq) fp32 scratch.  Returns a cudaError_t value (0 = launched).
extern "C" int sdv_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int B, int Sq, int Sk, int H, int D, float scale, int dtype,
    void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || D < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16 rows of a multiple of 8 up to 80 on the tensor cores (16-byte
  // loads); the rest on the FMA path
  if (g_tensor_cores && dtype == sdv::kBFloat16 && D % 8 == 0 && D <= 80) {
    switch (padded_depth(D)) {
#define SDV_MMA(DP)                                                         \
  case DP:                                                                  \
    return launch_mma<MmaCfg<DP>>(q, k, v, o, dout, dq, dk, dv, lse, delta, \
                                  B, Sq, Sk, H, D, scale, s);
      SDV_MMA_CONFIGS(SDV_MMA)
#undef SDV_MMA
    }
  }
  switch (padded_depth(D)) {
#define SDV_BWD(DP, BQ, BK)                                                 \
  case DP:                                                                  \
    if (dtype == sdv::kFloat32)                                             \
      return launch<BwdCfg<DP, BQ, BK>, float>(q, k, v, o, dout, dq, dk, dv, \
                                               lse, delta, B, Sq, Sk, H, D, \
                                               scale, s);                   \
    if (dtype == sdv::kBFloat16)                                            \
      return launch<BwdCfg<DP, BQ, BK>, __nv_bfloat16>(                     \
          q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, H, D, scale, \
          s);                                                               \
    return (int)cudaErrorInvalidValue;
    SDV_BWD_CONFIGS(SDV_BWD)
#undef SDV_BWD
  }
  return (int)cudaErrorInvalidValue;
}

// Whether bf16 calls at D <= 80 take the tensor cores (on > 0) or the FMA
// path (on == 0), for calls launched after it returns; on < 0 only reads.
// Returns the setting before the call.  It is process-wide: a comparison of
// the two paths sets it between runs, never while one is launching.
extern "C" int sdv_attention_backward_tensor_cores(int on) {
  const int was = g_tensor_cores;
  if (on >= 0) g_tensor_cores = on > 0;
  return was;
}

// The backward kernels' shared-memory attributes, set once when the library
// loads (under its loader's lock).  Returns a cudaError_t value (0 = ready).
extern "C" int sdv_prepare_attention_backward() {
  const cudaError_t set[] = {
#define SDV_BWD(DP, BQ, BK)                              \
  prepare_one<BwdCfg<DP, BQ, BK>, float>(),             \
      prepare_one<BwdCfg<DP, BQ, BK>, __nv_bfloat16>(),
      SDV_BWD_CONFIGS(SDV_BWD)
#undef SDV_BWD
#define SDV_MMA(DP) prepare_mma<MmaCfg<DP>>(),
      SDV_MMA_CONFIGS(SDV_MMA)
#undef SDV_MMA
  };
  for (cudaError_t e : set)
    if (e != cudaSuccess) return (int)e;
  return 0;
}
