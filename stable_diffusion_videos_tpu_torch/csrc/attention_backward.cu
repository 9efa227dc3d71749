// Backward of non-causal attention for Hopper (sm_90a).
//
// The JAX package has no Pallas backward: its Pallas kernel carries no
// custom_vjp, and its trainers differentiate the XLA route
// (stable_diffusion_videos_tpu/ops/attention.py:79, xla_attention) with
// XLA's autodiff.  This is the same gradient for the port's forward kernel
// (flash_attention.cu): given q, k, v (B, S, H, D), the forward's output o
// and its cotangent do, it writes dq, dk, dv in the inputs' dtype (f32 or
// bf16).  With s = q·kᵀ·scale, P = exp(s − lse) (lse each row's
// log-sum-exp), D_i = rowsum(do∘o), dP = do·vᵀ and dS = P∘(dP − D_i):
// dv = Pᵀ·do, dk = dSᵀ·q·scale, dq = dS·k·scale.
//
// What bounds it: five products the size of the scores (q·kᵀ, do·vᵀ, Pᵀ·do,
// dSᵀ·q, dS·k: 10·Sq·Sk·D operations a (b, h)) against O((Sq + Sk)·D)
// bytes, so operations, on the tensor cores in bf16.  No atomics anywhere:
// every sum runs in one block, or over fixed scratch in a fixed order, so
// the gradients repeat bit for bit from run to run (the trainers' remat and
// resume checks compare runs exactly).  The route is chosen by dtype and
// depth before any launch, never on failure (the wrapper,
// ops/flash_attention.py, picks it and counts each):
//
// * bf16, D ≤ 80 (padded to 48, 64 or 80 as the forward pads; SD 1.x's
//   levels 0 and 1, SD 2.x's and SDXL's D=64): "fused", the scores never
//   in device memory.  The forward saves each row's lse, and a D_i pre-pass
//   (delta_kernel, bytes-bound) reads do and o once; then two
//   warp-specialised kernels, each a producer warpgroup whose one thread
//   streams tiles with TMA into a ring of mbarrier stages and two consumer
//   warpgroups of 64 rows on wgmma:
//   - bwd_dkdv_wgmma, a block per 128 keys: k and v loaded once; per 64 q
//     rows, Sᵀ = k·qᵀ and dPᵀ = v·doᵀ (ss), Pᵀ and dSᵀ formed in registers,
//     then dv += Pᵀ·do and dk += dSᵀ·q (rs: the re-packed bf16 accumulator
//     is the A fragment, do and q read through the transpose bit);
//   - bwd_dq_wgmma, a block per 128 q rows, mirroring the forward: per 64
//     keys S = q·kᵀ and dP = do·vᵀ (ss, two commit groups, so P is formed
//     while dP runs), dq += dS·k (rs).  (The same split in the dk/dv kernel
//     measured slower, so it waits for both products.)
//   dq recomputes S and dP rather than summing across key blocks with
//   atomics: 7 products in place of 5.  With Sk ≤ 128 each (b, h) has one
//   key block, so the dk/dv kernel splits its q loop over enough blocks to
//   fill the card; each writes fp32 partial dk, dv, and split_sum_kernel
//   adds them in split order.
// * bf16, D > 80 (padded to 160 or 512: the UNet's level 2 and mid block,
//   the VAE's mid-block): "materialised".  A 64-key tile's dk and dv
//   accumulators no longer fit a warpgroup's registers (at D=512 they are
//   256 KB, one SM's whole register file), and the work a byte is high
//   enough to write the scores out: five products of 2·Sq·Sk·D operations
//   against about 10 bytes a score (P and dS written in bf16 and read back)
//   is about D operations a byte, above the card's ridge (~295) at D=512.
//   bwd_scores_wgmma (a block per 128 q rows × 128 keys) computes S and dP
//   with ss wgmma, 64 columns of depth a stage, and stores P and dS in
//   bf16; every block reads its q, do, k and v tiles whole, so at D=512 the
//   blocks pull about 512 MB through L2, which is what holds this kernel
//   back (its stage depth measured no difference).  bwd_gemm_wgmma, one
//   GEMM on TMA and wgmma, then makes dv = Pᵀ·do and dk = dSᵀ·q·scale in
//   one launch (column tiles of 256 at D=512) and dq = dS·k·scale in a
//   second (tiles of 128, so that one job still fills the card), the
//   transposed operands read through the descriptors' transpose bits, each
//   output tile summed over its k loop in order.  Where P and dS of
//   every q row would pass the wrapper's cap, the wrapper runs the q rows
//   in chunks and dk, dv accumulate over the chunks, in order, in fp32
//   scratch (the plan is Python's: materialised_chunks).
// * fp32 (gradient checks, the fp32 UNet gradient): the FMA path below,
//   exact to fp32 rounding, with its own LSE pass.  It serves bf16 too when
//   sdv_attention_backward_tensor_cores(0) is set, so a comparison can run
//   both in turns.
//
// P and dS are rounded to bf16 before their products on the tensor-core
// routes, as FlashAttention-2 does.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The FMA path (fp32; bf16 when the tensor cores are switched off).
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by TMA (see the note at the top).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using sdv::desc_b32;
using sdv::ex2;
using sdv::fence_regs;
using sdv::mbar_arrive;
using sdv::mbar_expect_tx;
using sdv::mbar_init;
using sdv::mbar_wait;
using sdv::pack_bf16;
using sdv::smem_u32;
using sdv::tma_load;
using sdv::wgmma_commit;
using sdv::wgmma_fence;
using sdv::wgmma_wait;

constexpr int WG = 128;      // threads of a warpgroup
constexpr int CREGS = 240;   // a consumer's registers after setmaxnreg (two
                             // consumers; the producer keeps 24)
constexpr int ROWS = 128;    // rows a block owns: two consumers of 64

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void init_ring(uint64_t* once, uint64_t* full,
                                          uint64_t* empty, int nstage,
                                          int consumers) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < nstage; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * consumers);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// D_i = rowsum(do∘o) in fp32 into (B·H, stat_ld(Sq)): eight lanes a row,
// 16 bytes a load (D % 8 == 0), summed in a fixed order
__global__ void __launch_bounds__(256)
    delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, int B, int Sq, int H, int D) {
  const long long rows = (long long)B * Sq * H;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  float acc = 0.f;
  if (r < rows) {
    const uint4* po = reinterpret_cast<const uint4*>(o + r * D);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + r * D);
    for (int v = part; v < D / 8; v += 8) {
      const uint4 a = po[v], c = pd[v];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(c2[e]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (r < rows && part == 0) {
    const int h = (int)(r % H), i = (int)(r / H % Sq), b = (int)(r / H / Sq);
    delta[((long long)b * H + h) * sdv::stat_ld(Sq) + i] = acc;
  }
}

// ---- the fused route (D ≤ 80) ----------------------------------------------

// Tiles of one depth.  A block owns ROWS resident rows (keys in the dk/dv
// kernel, q rows in the dq kernel; 64 a consumer) and streams the other
// side in tiles of 64 rows through NSTAGE stages.  Every bf16 tile lies in
// NS slabs of 16 columns (32-byte swizzle): the resident ones ROWS × 16,
// the streamed ones 64 × 16.
template <int DP_>
struct FusedCfg {
  static constexpr int DP = DP_, NS = DP / 16, NSTAGE = 3;
  static constexpr int THREADS = 3 * WG;  // two consumers and the producer
  static constexpr int SLAB_R = ROWS * 16, SLAB_S = 64 * 16;
  static constexpr int RES_BYTES = NS * SLAB_R * 2;  // one resident tile
  static constexpr int STR_BYTES = NS * SLAB_S * 2;  // one streamed tile
  static constexpr int STR_OFF = 2 * RES_BYTES;      // stages of two tiles
  // the dk/dv kernel's lse and D_i of each stage's 64 q rows
  static constexpr int STAT_OFF = STR_OFF + NSTAGE * 2 * STR_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + NSTAGE * 2 * 64 * 4;
  // + 1024 to align the base: the swizzled tiles sit on 1024-byte bounds
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * NSTAGE) + 1024;
  static_assert(DP % 16 == 0 && DP <= 80, "depth");
  static_assert(RES_BYTES % 1024 == 0 && STR_BYTES % 1024 == 0, "bounds");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

#define SDV_FUSED_DEPTHS(X) X(48) X(64) X(80)

// dk and dv of ROWS keys over q tiles [z·per, z·per + per) of one (b, h).
// Written in bf16 (dk scaled) when partial is null; else, unscaled, into
// fp32 partial[2][splits][B·H][ROWS][DP] (dk, then dv) for split_sum_kernel.
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_lse,
                   const __grid_constant__ CUtensorMap tm_delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv,
                   float* __restrict__ partial, int Sq, int Sk, int H, int D,
                   float scale, float scale_log2, int per) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + C::RES_BYTES);
  bf16* Str = reinterpret_cast<bf16*>(smem + C::STR_OFF);
  float* stat = reinterpret_cast<float*>(smem + C::STAT_OFF);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + C::NSTAGE;

  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * ROWS;
  const int j0 = blockIdx.z * per;
  const int j1 = min((Sq + 63) / 64, j0 + per);
  const int active = min(2, (Sk - k0 + 63) / 64);
  init_ring(kvbar, full, empty, C::NSTAGE, active);

  if (wg == 2) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(kvbar, 2 * C::RES_BYTES);
      for (int s = 0; s < C::NS; ++s) {
        tma_load(Ks + s * C::SLAB_R, &tm_k, kvbar, 16 * s, h, k0, b);
        tma_load(Vs + s * C::SLAB_R, &tm_v, kvbar, 16 * s, h, k0, b);
      }
      for (int j = j0; j < j1; ++j) {
        const int n = j - j0, st = n % C::NSTAGE;
        bf16* qt = Str + st * 2 * C::NS * C::SLAB_S;
        bf16* dot = qt + C::NS * C::SLAB_S;
        float* ls = stat + st * 128;
        mbar_wait(empty + st, ((n / C::NSTAGE) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * C::STR_BYTES + 2 * 64 * 4);
        for (int s = 0; s < C::NS; ++s) {
          tma_load(qt + s * C::SLAB_S, &tm_q, full + st, 16 * s, h, 64 * j, b);
          tma_load(dot + s * C::SLAB_S, &tm_do, full + st, 16 * s, h, 64 * j,
                   b);
        }
        tma_load(ls, &tm_lse, full + st, 64 * j, bh);
        tma_load(ls + 64, &tm_delta, full + st, 64 * j, bh);
      }
    }
  } else if (wg < active) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS));
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    constexpr int NA = C::DP / 2;
    float dk_acc[NA], dv_acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const bf16* kw = Ks + wg * 64 * 16;
    const bf16* vw = Vs + wg * 64 * 16;
    mbar_wait(kvbar, 0);
    for (int j = j0; j < j1; ++j) {
      const int n = j - j0, st = n % C::NSTAGE;
      const bf16* qt = Str + st * 2 * C::NS * C::SLAB_S;
      const bf16* dot = qt + C::NS * C::SLAB_S;
      const float* ls = stat + st * 128;
      // Sᵀ = k·qᵀ and dPᵀ = v·doᵀ: rows are this consumer's keys, columns
      // the tile's 64 q rows
      float s_acc[32], p_acc[32];
      mbar_wait(full + st, (n / C::NSTAGE) & 1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < C::NS; ++s)
        sdv::Wgmma<64>::ss(s_acc, desc_b32(kw + s * C::SLAB_R, 16, 256),
                           desc_b32(qt + s * C::SLAB_S, 16, 256), s > 0);
#pragma unroll
      for (int s = 0; s < C::NS; ++s)
        sdv::Wgmma<64>::ss(p_acc, desc_b32(vw + s * C::SLAB_R, 16, 256),
                           desc_b32(dot + s * C::SLAB_S, 16, 256), s > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(p_acc);
      // Pᵀ and dSᵀ; this thread's columns are q rows 8c + 2·t4 + {0, 1}.
      // Keys past Sk (zero-filled) only touch their own rows, never stored;
      // q rows past Sq are zero-filled (q, do, lse, D_i), so they add 0.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * t4 + (i & 1);
        const float p = ex2(fmaf(s_acc[i], scale_log2, -ls[col]));
        s_acc[i] = p;
        p_acc[i] = p * (p_acc[i] - ls[64 + col]);
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack_bf16(s_acc[8 * kk + 2 * e], s_acc[8 * kk + 2 * e + 1]);
          da[kk][e] = pack_bf16(p_acc[8 * kk + 2 * e], p_acc[8 * kk + 2 * e + 1]);
        }
      // dv += Pᵀ·do and dk += dSᵀ·q, 16 q rows a step; do and q are
      // MN-major here: atoms of 16 columns SLAB_S·2 bytes apart, 8-row
      // groups 256 bytes apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sdv::Wgmma<C::DP>::rs(dv_acc, pa[kk],
                              desc_b32(dot + kk * 16 * 16, C::SLAB_S * 2, 256));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sdv::Wgmma<C::DP>::rs(dk_acc, da[kk],
                              desc_b32(qt + kk * 16 * 16, C::SLAB_S * 2, 256));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      if (lane == 0) mbar_arrive(empty + st);
    }

    const long long splits = gridDim.z, nbh = gridDim.y;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wg * 64 + 16 * warp + g + 8 * r, key = k0 + row;
#pragma unroll
      for (int c = 0; c < C::DP / 8; ++c) {
        const int col = 8 * c + 2 * t4, i = 4 * c + 2 * r;
        if (partial == nullptr) {
          if (key < Sk && col < D) {
            const long long at = (((long long)b * Sk + key) * H + h) * D + col;
            *reinterpret_cast<uint32_t*>(dk + at) =
                pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + at) =
                pack_bf16(dv_acc[i], dv_acc[i + 1]);
          }
        } else {
          float* pk = partial +
                      (((long long)blockIdx.z * nbh + bh) * ROWS + row) *
                          C::DP + col;
          float* pv = pk + splits * nbh * ROWS * C::DP;
          *reinterpret_cast<float2*>(pk) = make_float2(dk_acc[i], dk_acc[i + 1]);
          *reinterpret_cast<float2*>(pv) = make_float2(dv_acc[i], dv_acc[i + 1]);
        }
      }
    }
  }
}

// dq of ROWS q rows of one (b, h), over every key tile of 64.
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int Sq, int Sk, int H, int D, float scale,
                 float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = reinterpret_cast<bf16*>(smem + C::RES_BYTES);
  bf16* Str = reinterpret_cast<bf16*>(smem + C::STR_OFF);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + C::NSTAGE;

  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * ROWS;
  const int nt = (Sk + 63) / 64;
  const int active = min(2, (Sq - q0 + 63) / 64);
  init_ring(qbar, full, empty, C::NSTAGE, active);

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(qbar, 2 * C::RES_BYTES);
      for (int s = 0; s < C::NS; ++s) {
        tma_load(Qs + s * C::SLAB_R, &tm_q, qbar, 16 * s, h, q0, b);
        tma_load(Ds + s * C::SLAB_R, &tm_do, qbar, 16 * s, h, q0, b);
      }
      for (int j = 0; j < nt; ++j) {
        const int st = j % C::NSTAGE;
        bf16* kt = Str + st * 2 * C::NS * C::SLAB_S;
        bf16* vt = kt + C::NS * C::SLAB_S;
        mbar_wait(empty + st, ((j / C::NSTAGE) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * C::STR_BYTES);
        for (int s = 0; s < C::NS; ++s) {
          tma_load(kt + s * C::SLAB_S, &tm_k, full + st, 16 * s, h, 64 * j, b);
          tma_load(vt + s * C::SLAB_S, &tm_v, full + st, 16 * s, h, 64 * j, b);
        }
      }
    }
  } else if (wg < active) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS));
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    constexpr int NA = C::DP / 2;
    float dq_acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dq_acc[i] = 0.f;
    // this thread's two q rows: their lse and D_i (rows past Sq are
    // zero-filled and not stored)
    float row_lse[2], row_di[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + wg * 64 + 16 * warp + g + 8 * r;
      const long long at = (long long)bh * sdv::stat_ld(Sq) + qi;
      row_lse[r] = qi < Sq ? lse[at] : 0.f;
      row_di[r] = qi < Sq ? delta[at] : 0.f;
    }
    const bf16* qw = Qs + wg * 64 * 16;
    const bf16* dw = Ds + wg * 64 * 16;
    mbar_wait(qbar, 0);
    for (int j = 0; j < nt; ++j) {
      const int st = j % C::NSTAGE;
      const bf16* kt = Str + st * 2 * C::NS * C::SLAB_S;
      const bf16* vt = kt + C::NS * C::SLAB_S;
      // S = q·kᵀ and dP = do·vᵀ, two commit groups: P is formed while dP
      // runs
      float s_acc[32], p_acc[32];
      mbar_wait(full + st, (j / C::NSTAGE) & 1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < C::NS; ++s)
        sdv::Wgmma<64>::ss(s_acc, desc_b32(qw + s * C::SLAB_R, 16, 256),
                           desc_b32(kt + s * C::SLAB_S, 16, 256), s > 0);
      wgmma_commit();
#pragma unroll
      for (int s = 0; s < C::NS; ++s)
        sdv::Wgmma<64>::ss(p_acc, desc_b32(dw + s * C::SLAB_R, 16, 256),
                           desc_b32(vt + s * C::SLAB_S, 16, 256), s > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s_acc);
      // P; keys past Sk (zero-filled, not -inf) get P = 0
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = 64 * j + 8 * (i / 4) + 2 * t4 + (i & 1);
        s_acc[i] = key < Sk ? ex2(fmaf(s_acc[i], scale_log2,
                                       -row_lse[(i >> 1) & 1]))
                            : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(p_acc);
      uint32_t da[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        p_acc[i] = s_acc[i] * (p_acc[i] - row_di[(i >> 1) & 1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          da[kk][e] = pack_bf16(p_acc[8 * kk + 2 * e], p_acc[8 * kk + 2 * e + 1]);
      // dq += dS·k, 16 keys a step; k MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sdv::Wgmma<C::DP>::rs(dq_acc, da[kk],
                              desc_b32(kt + kk * 16 * 16, C::SLAB_S * 2, 256));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      if (lane == 0) mbar_arrive(empty + st);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + wg * 64 + 16 * warp + g + 8 * r;
      if (qi >= Sq) continue;
      bf16* out = dq + (((long long)b * Sq + qi) * H + h) * D;
#pragma unroll
      for (int c = 0; c < C::DP / 8; ++c) {
        const int col = 8 * c + 2 * t4, i = 4 * c + 2 * r;
        if (col < D)
          *reinterpret_cast<uint32_t*>(out + col) =
              pack_bf16(dq_acc[i] * scale, dq_acc[i + 1] * scale);
      }
    }
  }
}

// dk = scale · Σ_z partial dk, dv = Σ_z partial dv, over the splits in
// order (Sk ≤ ROWS: one key block a (b, h))
__global__ void __launch_bounds__(256)
    split_sum_kernel(const float* __restrict__ partial, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int splits, int BH, int Sk, int H,
                     int D, int DP, float scale) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)BH * Sk * D) return;
  const int d = (int)(idx % D), key = (int)(idx / D % Sk);
  const int bh = (int)(idx / D / Sk), b = bh / H, h = bh % H;
  const long long stride = (long long)BH * ROWS * DP;  // one split
  const float* pk = partial + ((long long)bh * ROWS + key) * DP + d;
  const float* pv = pk + splits * stride;
  float sk = 0.f, sv = 0.f;
  for (int z = 0; z < splits; ++z) {
    sk += pk[z * stride];
    sv += pv[z * stride];
  }
  const long long at = (((long long)b * Sk + key) * H + h) * D + d;
  dk[at] = __float2bfloat16(sk * scale);
  dv[at] = __float2bfloat16(sv);
}

template <class C>
int launch_fused(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, float* partial, int B, int Sq,
                 int Sk, int H, int D, float scale, int splits,
                 cudaStream_t stream) {
  const int BH = B * H, ld = sdv::stat_ld(Sq);
  const int nqt = (Sq + 63) / 64, per = (nqt + splits - 1) / splits;
  CUtensorMap tq, tk, tv, tdo, tq_r, tdo_r, tk_s, tv_s, tl, td;
  int err = sdv::bind_device(q);
  // dk/dv: k, v resident (ROWS rows), q, do streamed (64 rows)
  if (err == 0) err = sdv::encode_map(&tk, k, B, Sk, H, D, ROWS);
  if (err == 0) err = sdv::encode_map(&tv, v, B, Sk, H, D, ROWS);
  if (err == 0) err = sdv::encode_map(&tq, q, B, Sq, H, D, 64);
  if (err == 0) err = sdv::encode_map(&tdo, dout, B, Sq, H, D, 64);
  if (err == 0) err = sdv::encode_rows_f32(&tl, lse, Sq, ld, BH, 64);
  if (err == 0) err = sdv::encode_rows_f32(&td, delta, Sq, ld, BH, 64);
  // dq: q, do resident, k, v streamed
  if (err == 0) err = sdv::encode_map(&tq_r, q, B, Sq, H, D, ROWS);
  if (err == 0) err = sdv::encode_map(&tdo_r, dout, B, Sq, H, D, ROWS);
  if (err == 0) err = sdv::encode_map(&tk_s, k, B, Sk, H, D, 64);
  if (err == 0) err = sdv::encode_map(&tv_s, v, B, Sk, H, D, 64);
  if (err != 0) return err;
  const float scale_log2 = scale * kLog2e;
  bf16 *pq = static_cast<bf16*>(dq), *pk = static_cast<bf16*>(dk),
       *pv = static_cast<bf16*>(dv);
  const dim3 gkv((Sk + ROWS - 1) / ROWS, BH, (nqt + per - 1) / per);
  bwd_dkdv_wgmma<C><<<gkv, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, tl, td, pk, pv, splits > 1 ? partial : nullptr, Sq,
      Sk, H, D, scale, scale_log2, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const long long n = (long long)BH * Sk * D;
    split_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        partial, pk, pv, (int)gkv.z, BH, Sk, H, D, C::DP, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 gq((Sq + ROWS - 1) / ROWS, BH);
  bwd_dq_wgmma<C><<<gq, C::THREADS, C::SMEM, stream>>>(
      tq_r, tk_s, tv_s, tdo_r, lse, delta, pq, Sq, Sk, H, D,
      scale, scale_log2);
  return (int)cudaGetLastError();
}

// ---- the materialised route (D > 80) ---------------------------------------

constexpr int MAT_STAGES = 4;     // the GEMM's ring
constexpr int SCORE_STAGES = 3;   // the scores kernel's ring
constexpr int SCORE_SLABS = 4;    // 16-column slabs of each operand a stage

// P = exp2(S·scale_log2 − lse) and dS = P∘(dP − D_i) of ROWS q rows
// (chunk rows m0.., sequence rows r0 + m0..) × 128 keys, S = q·kᵀ and
// dP = do·vᵀ summed over the padded depth, 64 columns (four 16-column slabs
// of q, do, k and v) a stage; stored in bf16 to P, dS [B·H][rows_p][SkP],
// zeros past Sq and past Sk.
__global__ void __launch_bounds__(3 * WG, 1)
    bwd_scores_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ P,
                     bf16* __restrict__ dS, int r0, int rows_p, int SkP,
                     int Sq, int Sk, int H, int ns, float scale_log2) {
  constexpr int SLAB = ROWS * 16;           // elements of one slab
  constexpr int OPER = SCORE_SLABS * SLAB;  // one operand's part of a stage
  constexpr int STAGE = 4 * OPER;           // q, do, k, v
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  uint64_t* once =
      reinterpret_cast<uint64_t*>(smem + SCORE_STAGES * STAGE * 2);
  uint64_t* full = once + 1;
  uint64_t* empty = full + SCORE_STAGES;
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * ROWS, n0 = blockIdx.y * 128;
  const int nst = (ns + SCORE_SLABS - 1) / SCORE_SLABS;
  init_ring(once, full, empty, SCORE_STAGES, 2);

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      for (int t = 0; t < nst; ++t) {
        const int st = t % SCORE_STAGES;
        const int n = min(SCORE_SLABS, ns - SCORE_SLABS * t);
        bf16* base = ring + st * STAGE;
        mbar_wait(empty + st, ((t / SCORE_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + st, n * 4 * SLAB * 2);
        for (int j = 0; j < n; ++j) {
          const int d0 = 16 * (SCORE_SLABS * t + j);
          tma_load(base + j * SLAB, &tm_q, full + st, d0, h, r0 + m0, b);
          tma_load(base + OPER + j * SLAB, &tm_do, full + st, d0, h, r0 + m0,
                   b);
          tma_load(base + 2 * OPER + j * SLAB, &tm_k, full + st, d0, h, n0,
                   b);
          tma_load(base + 3 * OPER + j * SLAB, &tm_v, full + st, d0, h, n0,
                   b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS));
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    float s_acc[64], p_acc[64];
    // one stage's products in flight while the next stage's are issued
    for (int t = 0; t < nst; ++t) {
      const int st = t % SCORE_STAGES;
      const int n = min(SCORE_SLABS, ns - SCORE_SLABS * t);
      const bf16* base = ring + st * STAGE;
      mbar_wait(full + st, (t / SCORE_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < SCORE_SLABS; ++j) {
        if (j < n) {
          sdv::Wgmma<128>::ss(
              s_acc, desc_b32(base + j * SLAB + wg * 64 * 16, 16, 256),
              desc_b32(base + 2 * OPER + j * SLAB, 16, 256), t > 0 || j > 0);
          sdv::Wgmma<128>::ss(
              p_acc, desc_b32(base + OPER + j * SLAB + wg * 64 * 16, 16, 256),
              desc_b32(base + 3 * OPER + j * SLAB, 16, 256), t > 0 || j > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (t > 0 && lane == 0) mbar_arrive(empty + (t - 1) % SCORE_STAGES);
    }
    wgmma_wait<0>();
    fence_regs(s_acc);
    fence_regs(p_acc);
    const int ld = sdv::stat_ld(Sq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wg * 64 + 16 * warp + g + 8 * r, qi = r0 + row;
      // rows past Sq: lse = +inf gives P = 0 (their q and do are zeros)
      const float l = qi < Sq ? lse[(long long)bh * ld + qi] : INFINITY;
      const float di = qi < Sq ? delta[(long long)bh * ld + qi] : 0.f;
      const long long at = ((long long)bh * rows_p + row) * SkP;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int i = 4 * c + 2 * r, key = n0 + 8 * c + 2 * t4;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = key + e < Sk ? ex2(fmaf(s_acc[i + e], scale_log2, -l)) : 0.f;
          ds[e] = p[e] * (p_acc[i + e] - di);
        }
        *reinterpret_cast<uint32_t*>(P + at + key) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dS + at + key) = pack_bf16(ds[0], ds[1]);
      }
    }
  }
}

// One output of the GEMM kernel: out = mul · A·B (+ acc), A one of the
// scratch matrices, B rows of a (B, S, H, D) tensor.
struct GemmJob {
  CUtensorMap a, b;
  bf16* out;        // (B, S_out, H, D), rows out_row0.., or null
  float* acc;       // fp32 [B·H][M_pad][DP] sums across chunks, or null
  float mul;
  int b_row0;       // B's first sequence row
  int out_row0;     // the output's first sequence row
  int S_out;        // the output's sequence length
};
struct GemmJobs {
  GemmJob job[2];
};

// C[M × N] = A[M × K]·B[K × N] a (b, h), for 128 output rows (two
// consumers of 64) × BN columns a block, the k loop in tiles of 64 through
// MAT_STAGES stages.  A is K-major ([row][k], the dq product's dS) or, with
// A_MN, MN-major ([k][row]: Pᵀ and dSᵀ read from P and dS as they lie);
// B is [k][n] (MN-major).  Epilogue by job: with acc, add its old value
// (accum_in) and keep the sum there unless the job writes out; with out,
// write mul·sum in bf16 (rows < S_out, columns < D).
template <bool A_MN, int BN>
__global__ void __launch_bounds__(3 * WG, 1)
    bwd_gemm_wgmma(const __grid_constant__ GemmJobs jobs, int njobs, int K,
                   int M_pad, int H, int D, int DP, int accum_in) {
  constexpr int A_BYTES = ROWS * 64 * 2, B_SLAB = 64 * 16;
  constexpr int STAGE = A_BYTES + BN / 16 * B_SLAB * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* once = reinterpret_cast<uint64_t*>(smem + MAT_STAGES * STAGE);
  uint64_t* full = once + 1;
  uint64_t* empty = full + MAT_STAGES;
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const GemmJob& job = jobs.job[blockIdx.z % njobs];
  const int bh = blockIdx.z / njobs, b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * ROWS, n0 = blockIdx.y * BN;
  const int nk = K / 64;
  init_ring(once, full, empty, MAT_STAGES, 2);

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % MAT_STAGES;
        bf16* a = reinterpret_cast<bf16*>(smem + st * STAGE);
        bf16* bt = a + A_BYTES / 2;
        mbar_wait(empty + st, ((kt / MAT_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + st, STAGE);
        if (A_MN)  // slabs of 16 rows (M) × 64 k
          for (int s = 0; s < ROWS / 16; ++s)
            tma_load(a + s * 64 * 16, &job.a, full + st, m0 + 16 * s, 64 * kt,
                     bh);
        else  // slabs of 16 k × ROWS rows
          for (int s = 0; s < 4; ++s)
            tma_load(a + s * ROWS * 16, &job.a, full + st, 64 * kt + 16 * s,
                     m0, bh);
        for (int s = 0; s < BN / 16; ++s)
          tma_load(bt + s * B_SLAB, &job.b, full + st, n0 + 16 * s, h,
                   job.b_row0 + 64 * kt, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS));
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    float acc[BN / 2];
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % MAT_STAGES;
      const bf16* a = reinterpret_cast<const bf16*>(smem + st * STAGE);
      const bf16* bt = a + A_BYTES / 2;
      mbar_wait(full + st, (kt / MAT_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // A MN-major: atoms of 16 rows 64·32 bytes apart, 8-k groups 256
        // bytes apart; K-major: this consumer's 64 rows of slab kk
        const uint64_t da =
            A_MN ? desc_b32(a + 4 * wg * 64 * 16 + kk * 16 * 16, 64 * 32, 256)
                 : desc_b32(a + kk * ROWS * 16 + wg * 64 * 16, 16, 256);
        sdv::Wgmma<BN>::template ss_t<A_MN ? 1 : 0>(
            acc, da, desc_b32(bt + kk * 16 * 16, B_SLAB * 2, 256),
            kt > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % MAT_STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wg * 64 + 16 * warp + g + 8 * r;
      const int row = job.out_row0 + m;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int n = n0 + 8 * c + 2 * t4, i = 4 * c + 2 * r;
        float v0 = acc[i], v1 = acc[i + 1];
        if (job.acc != nullptr) {
          float2* pa = reinterpret_cast<float2*>(
              job.acc + ((long long)bh * M_pad + m) * DP + n);
          if (accum_in) {
            const float2 old = *pa;
            v0 += old.x;
            v1 += old.y;
          }
          if (job.out == nullptr) *pa = make_float2(v0, v1);
        }
        if (job.out != nullptr && row < job.S_out && n < D)
          *reinterpret_cast<uint32_t*>(
              job.out + (((long long)b * job.S_out + row) * H + h) * D + n) =
              pack_bf16(v0 * job.mul, v1 * job.mul);
      }
    }
  }
}

constexpr int scores_smem() {
  return SCORE_STAGES * 4 * SCORE_SLABS * ROWS * 16 * 2 +
         8 * (1 + 2 * SCORE_STAGES) + 1024;
}

template <int BN>
constexpr int gemm_smem() {
  return MAT_STAGES * (ROWS * 64 * 2 + BN / 16 * 64 * 16 * 2) +
         8 * (1 + 2 * MAT_STAGES) + 1024;
}
static_assert(scores_smem() <= 232448 && gemm_smem<256>() <= 232448,
              "shared memory of one block");

// One q-row chunk [r0, r0 + rows_p) of the materialised route: P and dS of
// its rows, then dv and dk (one launch, two jobs), then dq of its rows.
// first/last place the chunk in the plan: dk and dv go straight to their
// outputs when the chunk is both; else they are summed in acc ([2][B·H]
// [SkP][DP] fp32: dk, then dv), in chunk order, and written by the last.
template <int BN_KV, int BN_Q>
int launch_chunk(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 bf16* P, bf16* dS, void* dq, void* dk, void* dv, float* acc,
                 int B, int Sq, int Sk, int H, int D, int DP, int r0,
                 int rows_p, int SkP, float scale, int first, int last,
                 cudaStream_t stream) {
  const int BH = B * H;
  CUtensorMap tq, tk, tv, tdo;
  int err = sdv::bind_device(q);
  if (err == 0) err = sdv::encode_map(&tq, q, B, Sq, H, D, ROWS);
  if (err == 0) err = sdv::encode_map(&tk, k, B, Sk, H, D, 128);
  if (err == 0) err = sdv::encode_map(&tv, v, B, Sk, H, D, 128);
  if (err == 0) err = sdv::encode_map(&tdo, dout, B, Sq, H, D, ROWS);
  if (err != 0) return err;
  bwd_scores_wgmma<<<dim3(rows_p / ROWS, SkP / 128, BH), 3 * WG,
                     scores_smem(), stream>>>(
      tq, tk, tv, tdo, lse, delta, P, dS, r0, rows_p, SkP, Sq, Sk, H,
      DP / 16, scale * kLog2e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // dv = Pᵀ·do, dk = scale·dSᵀ·q over the chunk's q rows
  GemmJobs kv = {};
  const bool alone = first && last;
  float* acc_dk = acc;
  float* acc_dv = acc == nullptr ? nullptr : acc + (long long)BH * SkP * DP;
  GemmJob& jv = kv.job[0];
  GemmJob& jk = kv.job[1];
  err = sdv::encode_matrices(&jv.a, P, SkP, SkP, rows_p, BH, 64);
  if (err == 0) err = sdv::encode_matrices(&jk.a, dS, SkP, SkP, rows_p, BH, 64);
  if (err == 0) err = sdv::encode_map(&jv.b, dout, B, Sq, H, D, 64);
  if (err == 0) err = sdv::encode_map(&jk.b, q, B, Sq, H, D, 64);
  if (err != 0) return err;
  jv.out = last ? static_cast<bf16*>(dv) : nullptr;
  jk.out = last ? static_cast<bf16*>(dk) : nullptr;
  jv.acc = alone ? nullptr : acc_dv;
  jk.acc = alone ? nullptr : acc_dk;
  jv.mul = 1.f;
  jk.mul = scale;
  jv.b_row0 = jk.b_row0 = r0;
  jv.out_row0 = jk.out_row0 = 0;
  jv.S_out = jk.S_out = Sk;
  bwd_gemm_wgmma<true, BN_KV><<<dim3(SkP / ROWS, DP / BN_KV, 2 * BH),
                                3 * WG, gemm_smem<BN_KV>(), stream>>>(
      kv, 2, rows_p, SkP, H, D, DP, first ? 0 : 1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // dq = scale·dS·k for the chunk's rows
  GemmJobs jq = {};
  GemmJob& j = jq.job[0];
  err = sdv::encode_matrices(&j.a, dS, SkP, SkP, rows_p, BH, ROWS);
  if (err == 0) err = sdv::encode_map(&j.b, k, B, Sk, H, D, 64);
  if (err != 0) return err;
  j.out = static_cast<bf16*>(dq);
  j.acc = nullptr;
  j.mul = scale;
  j.b_row0 = 0;
  j.out_row0 = r0;
  j.S_out = Sq;
  bwd_gemm_wgmma<false, BN_Q><<<dim3(rows_p / ROWS, DP / BN_Q, BH), 3 * WG,
                                gemm_smem<BN_Q>(), stream>>>(
      jq, 1, SkP, rows_p, H, D, DP, 0);
  return (int)cudaGetLastError();
}


// 0 routes every call to the FMA path (an end-to-end comparison of the
// paths; see sdv_attention_backward_tensor_cores)
int g_tensor_cores = 1;

bool bad_shape(int B, int Sq, int Sk, int H, int D) {
  return B < 1 || Sq < 1 || Sk < 1 || H < 1 || D < 1 || B * H > 65535;
}

}  // namespace

// The FMA path: q, o, do: (B, Sq, H, D); k, v: (B, Sk, H, D); dq, dk, dv
// like q, k, v; all contiguous and of one dtype (f32 or bf16), D <= 512.
// lse and delta: (B·H·Sq) fp32 scratch it fills itself.  Returns a
// cudaError_t value (0 = launched).
extern "C" int sdv_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int B, int Sq, int Sk, int H, int D, float scale, int dtype,
    void* stream) {
  if (bad_shape(B, Sq, Sk, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

// The tensor-core routes' D_i pre-pass: o, do (B, Sq, H, D) bf16, D % 8 ==
// 0, 16-byte aligned; delta fp32 (B·H, stat_ld(Sq)).
extern "C" int sdv_attention_backward_delta(const void* o, const void* dout,
                                            float* delta, int B, int Sq,
                                            int H, int D, void* stream) {
  if (bad_shape(B, Sq, 1, H, D) || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)B * Sq * H * 8;
  delta_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, B,
      Sq, H, D);
  return (int)cudaGetLastError();
}

// The fused route (bf16, D % 8 == 0, D <= 80): q, do (B, Sq, H, D); k, v
// (B, Sk, H, D); lse (the forward's) and delta fp32 (B·H, stat_ld(Sq));
// dq, dk, dv like q, k, v.  splits > 1 (only with Sk <= 128) cuts the dk/dv
// kernel's q loop over that many blocks a (b, h), whose fp32 partials go to
// `partial` (2·splits·B·H·128·DP floats, DP the padded depth).  Returns a
// cudaError_t value (0 = launched).
extern "C" int sdv_attention_backward_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    float* partial, int B, int Sq, int Sk, int H, int D, float scale,
    int splits, void* stream) {
  if (bad_shape(B, Sq, Sk, H, D) || D % 8 != 0 || D > 80 || splits < 1 ||
      (splits > 1 && (Sk > ROWS || partial == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_depth(D)) {
#define SDV_FUSED(DP)                                                       \
  case DP:                                                                  \
    return launch_fused<FusedCfg<DP>>(q, k, v, dout, lse, delta, dq, dk, dv, \
                                      partial, B, Sq, Sk, H, D, scale,      \
                                      splits, s);
    SDV_FUSED_DEPTHS(SDV_FUSED)
#undef SDV_FUSED
  }
  return (int)cudaErrorInvalidValue;
}

// One q-row chunk of the materialised route (bf16, D % 8 == 0, 80 < D <=
// 512): rows [r0, r0 + rows_p), rows_p a multiple of 128 (the chunk's rows
// rounded up; only the last chunk reaches past Sq).  P, dS: bf16 scratch
// [B·H][rows_p][SkP], SkP = Sk rounded up to 128; acc: null when the chunk
// is both first and last, else fp32 [2][B·H][SkP][DP] kept across the
// chunks.  Returns a cudaError_t value (0 = launched).
extern "C" int sdv_attention_backward_chunk(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* P, void* dS, void* dq,
    void* dk, void* dv, float* acc, int B, int Sq, int Sk, int H, int D,
    int r0, int rows_p, int SkP, float scale, int first, int last,
    void* stream) {
  const int DP = padded_depth(D);
  if (bad_shape(B, Sq, Sk, H, D) || D % 8 != 0 || DP <= 80 || r0 < 0 ||
      r0 >= Sq || rows_p < 1 || rows_p % ROWS != 0 || SkP % 128 != 0 ||
      SkP < Sk || (!(first && last) && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16 *p = static_cast<bf16*>(P), *ds = static_cast<bf16*>(dS);
  // the GEMMs' column tiles: D=160 whole; D=512 in two of 256 for dk and dv
  // (two jobs fill the card) and four of 128 for dq (one job)
  if (DP == 160)
    return launch_chunk<160, 160>(q, k, v, dout, lse, delta, p, ds, dq, dk,
                                  dv, acc, B, Sq, Sk, H, D, DP, r0, rows_p,
                                  SkP, scale, first, last, s);
  return launch_chunk<256, 128>(q, k, v, dout, lse, delta, p, ds, dq, dk, dv,
                                acc, B, Sq, Sk, H, D, DP, r0, rows_p, SkP,
                                scale, first, last, s);
}

// Whether bf16 calls take the tensor cores (on > 0) or the FMA path (on ==
// 0), read by the wrapper at each call; on < 0 only reads.  Returns the
// setting before the call.  It is process-wide: a comparison of the paths
// sets it between runs, never while one is launching.
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
#define SDV_FUSED(DP)                                                        \
  cudaFuncSetAttribute(bwd_dkdv_wgmma<FusedCfg<DP>>,                         \
                       cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                       FusedCfg<DP>::SMEM),                                  \
      cudaFuncSetAttribute(bwd_dq_wgmma<FusedCfg<DP>>,                       \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                           FusedCfg<DP>::SMEM),
      SDV_FUSED_DEPTHS(SDV_FUSED)
#undef SDV_FUSED
      cudaFuncSetAttribute(bwd_scores_wgmma,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           scores_smem()),
      cudaFuncSetAttribute(bwd_gemm_wgmma<true, 256>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           gemm_smem<256>()),
      cudaFuncSetAttribute(bwd_gemm_wgmma<false, 128>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           gemm_smem<128>()),
      cudaFuncSetAttribute(bwd_gemm_wgmma<true, 160>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           gemm_smem<160>()),
      cudaFuncSetAttribute(bwd_gemm_wgmma<false, 160>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           gemm_smem<160>()),
  };
  for (cudaError_t e : set)
    if (e != cudaSuccess) return (int)e;
  return 0;
}
