// Non-causal flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel stable_diffusion_videos_tpu/ops/flash_attention.py
// (flash_attention / _flash_kernel): softmax(q kᵀ · scale) v with an online
// softmax, fp32 running max, sum and accumulator, f32 or bf16 in, output in
// q's dtype.  q (B, Sq, H, D), k and v (B, Sk, H, D), contiguous.
//
// What bounds it on the card (bf16, the walk's shapes): the self-attentions
// at S=4096 and S=1024 by operations (4·S²·D against O(S·D) bytes), every
// cross-attention (Sk=77) and the small levels by bytes.  At D=40 the
// softmax's one exp2 per score is the tighter limit in practice: the
// special-function units do 16 a cycle an SM, so the 2.1G exponentials of
// the level-0 self-attention (B·H=128, S=4096) take about 0.6 ms, against
// 0.35 ms for its multiplies at the tensor cores' peak.
// The S×S scores never reach device memory.  Two paths, chosen by dtype
// (not on failure):
//
// * bf16: flash_wgmma_kernel, below.  Per block one producer warpgroup
//   and two or three consumer warpgroups of 64 q rows each (setmaxnreg
//   moves registers from the first to the others).  One producer thread
//   loads q once and k, v tiles into a ring of shared-memory stages with
//   TMA (cp.async.bulk.tensor) on mbarriers, so copies overlap the matrix
//   work.  The consumers run both products on wgmma.mma_async: S = q·kᵀ
//   with both operands in shared memory, then o += p·v with p from
//   registers (the S accumulator re-packed as bf16) and v read in its
//   natural [key][d] layout through the descriptor's transpose bit.  The
//   online softmax runs in registers in the log2 domain; while one
//   consumer runs it, another's wgmma keeps the tensor cores busy.
// * f32: flash_fwd_kernel on the FMA units, exact to fp32 rounding.
//
// Head sizes: TMA loads every operand in 16-column slabs (32 bytes a row,
// 32-byte swizzle), one wgmma k step each, and zero-fills columns at and
// past D.  So the depth is the least instantiated multiple of 16 that holds
// D (48, 64, 80, 160, 512), never 128 (a TPU lane artefact): D=64 (every
// head of SD 2.x and SDXL), 80 and 160 waste nothing; D=40 runs 48, a sixth
// of its q·kᵀ and p·v work on zeros.  Other head sizes up to 512 run at the
// next depth.  At D=64 a row is 128 bytes, so one 128-byte swizzled box
// could carry it whole; the four slabs keep the one layout every depth
// shares (the depth-64 tile is the depth-80 tile less one slab).  Sk=77 (every
// cross-attention): keys past Sk in the last tile are zero-filled by TMA
// and masked to -inf here (zero logits are not -inf).  Rows past Sq are
// zero-filled on load and not stored.  D=512 (the VAE mid-block, one
// head): the two consumers share the same 64 q rows; each computes q·kᵀ
// over half the depth, they add their partial scores through shared
// memory, and each accumulates half of the output columns, so q·kᵀ is
// computed once.

// cuda.h for CUtensorMap and its enums (types only; see encode_tiled)
#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 path: fp32 FMA units (the full-geometry golden check runs in fp32).
// 256 threads as a 16×16 grid.  Each thread owns 4 q rows (tr + 16r) and,
// for q·kᵀ, 4 keys (tc + 16c); for p·v, DCPT output columns (tc + 16c).  The
// 16 threads sharing a row sit in one half-warp, so row max and row sum are
// 4 shuffles.  Operands sit in shared memory as fp32, so every inner-loop
// read is a conflict-free broadcast.  Wide heads (D=512) split the output
// into 128-column chunks across blockIdx.z, each recomputing q·kᵀ.
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int KD = 32;   // depth of one q·kᵀ chunk
constexpr int NT = 256;  // threads per block (16 × 16)
constexpr int LDQ = BQ + 1;
constexpr int LDK = BK + 1;
constexpr int MAX_DC = 160;  // widest output chunk held in one block

template <int DCPT>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(KD * LDQ + KD * LDK + BK * LDQ + BK * DCPT * 16);
}

template <int DCPT>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Sq, int Sk, int H, int D, int DC, float scale_log2) {
  constexpr int DCW = DCPT * 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [KD][LDQ]  q chunk, d-major
  float* Ks = Qs + KD * LDQ;    // [KD][LDK]  k chunk, d-major
  float* Ps = Ks + KD * LDK;    // [BK][LDQ]  probabilities, key-major
  float* Vs = Ps + BK * LDQ;    // [BK][DCW]  v tile

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int dc0 = blockIdx.z * DC;
  const long long rs = (long long)H * D;  // stride between sequence positions
  const float* qb = q + (long long)b * Sq * rs + (long long)h * D;
  const float* kb = k + (long long)b * Sk * rs + (long long)h * D;
  const float* vb = v + (long long)b * Sk * rs + (long long)h * D;
  float* ob = o + (long long)b * Sq * rs + (long long)h * D;

  float acc[4][DCPT];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DCPT; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;

    for (int d0 = 0; d0 < D; d0 += KD) {
      __syncthreads();  // the previous readers of Qs/Ks/Ps/Vs are done
      for (int e = tid; e < BQ * KD; e += NT) {
        const int row = e / KD, dd = e % KD;
        const int qi = q0 + row, d = d0 + dd;
        Qs[dd * LDQ + row] =
            (qi < Sq && d < D) ? qb[(long long)qi * rs + d] : 0.f;
      }
      for (int e = tid; e < BK * KD; e += NT) {
        const int row = e / KD, dd = e % KD;
        const int kj = k0 + row, d = d0 + dd;
        Ks[dd * LDK + row] =
            (kj < Sk && d < D) ? kb[(long long)kj * rs + d] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < KD; ++dd) {
        float a[4], bk[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Qs[dd * LDQ + tr + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) bk[c] = Ks[dd * LDK + tc + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
      }
    }

    // online softmax in the log2 domain; ragged keys get -inf
    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tc + 16 * c;
        s[r][c] = kj < Sk ? s[r][c] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);  // finite: key k0 is always valid
      alpha[r] = exp2f(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = exp2f(s[r][c] - m_new);
        sum += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(tc + 16 * c) * LDQ + tr + 16 * r] = s[r][c];
    for (int e = tid; e < BK * DCW; e += NT) {
      const int j = e / DCW, col = e % DCW;
      const int kj = k0 + j, d = dc0 + col;
      Vs[j * DCW + col] =
          (kj < Sk && col < DC && d < D) ? vb[(long long)kj * rs + d] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < DCPT; ++c) acc[r][c] *= alpha[r];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4], vv[DCPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[j * LDQ + tr + 16 * r];
#pragma unroll
      for (int c = 0; c < DCPT; ++c) vv[c] = Vs[j * DCW + tc + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DCPT; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + tr + 16 * r;
    if (qi >= Sq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < DCPT; ++c) {
      const int col = tc + 16 * c;
      const int d = dc0 + col;
      if (col < DC && d < D)
        ob[(long long)qi * rs + d] = acc[r][c] * inv;
    }
  }
}

template <int DCPT>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int D, int DC, float scale_log2,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DCPT>();
  dim3 grid((Sq + BQ - 1) / BQ, B * H, (D + DC - 1) / DC);
  flash_fwd_kernel<DCPT><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, D, DC,
      scale_log2);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int D, float scale_log2,
             cudaStream_t stream) {
  const int DC = D <= MAX_DC ? D : 128;
  switch ((DC + 15) / 16) {
#define SDV_CASE(N) \
  case N:           \
    return launch<N>(q, k, v, o, B, Sq, Sk, H, D, DC, scale_log2, stream);
    SDV_CASE(1) SDV_CASE(2) SDV_CASE(3) SDV_CASE(4) SDV_CASE(5)
    SDV_CASE(6) SDV_CASE(7) SDV_CASE(8) SDV_CASE(9) SDV_CASE(10)
#undef SDV_CASE
  }
  return (int)cudaErrorInvalidValue;
}

template <int DCPT>
cudaError_t prepare_fp32() {
  return cudaFuncSetAttribute(flash_fwd_kernel<DCPT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<DCPT>());
}

// ---------------------------------------------------------------------------
// bf16 path: TMA + wgmma, warp-specialised (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;

using sdv::mbar_arrive;
using sdv::mbar_expect_tx;
using sdv::mbar_init;
using sdv::mbar_wait;
using sdv::smem_u32;

// one (16 columns × rows) box of a (D, H, S, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d),
      "r"(h), "r"(s), "r"(b) : "memory");
}

// wgmma shared-memory descriptor, 32-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 3 (B32)
__device__ __forceinline__ uint64_t desc_b32(const void* p, uint32_t lbo,
                                             uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching accumulator registers across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Tile sizes and shared-memory layout of one instantiation.  DP: head size
// rounded up to 16 (NS slabs of 16 columns); BQ q rows (64 a consumer) and
// BN keys a tile; NSTAGE k/v stages; NDWG consumers splitting the depth and
// the output columns (2 for D=512), else the consumers split the q rows.
template <int DP_, int BQ_, int BN_, int NSTAGE_, int NDWG_>
struct FlashCfg {
  static constexpr int DP = DP_, BQ = BQ_, BN = BN_, NSTAGE = NSTAGE_,
                       NDWG = NDWG_;
  static constexpr int NS = DP / 16;
  static constexpr int NQWG = BQ / 64;      // consumers along q
  static constexpr int NCWG = NQWG * NDWG;  // consumer warpgroups
  static constexpr int THREADS = (NCWG + 1) * WG_THREADS;  // + the producer
  // registers a consumer thread after setmaxnreg: what the producer's
  // warpgroup gives up (it keeps 24), in steps of 8, at most 240
  static constexpr int CREGS =
      (65536 - 24 * WG_THREADS) / (NCWG * WG_THREADS) / 8 * 8 > 240
          ? 240
          : (65536 - 24 * WG_THREADS) / (NCWG * WG_THREADS) / 8 * 8;
  static constexpr int NSW = NS / NDWG;     // slabs a consumer owns
  static constexpr int NO = DP / NDWG;      // output columns a consumer owns
  static constexpr int SLAB_Q = BQ * 16;    // elements of one q slab
  static constexpr int SLAB_KV = BN * 16;   // elements of one k or v slab
  static constexpr int Q_BYTES = NS * SLAB_Q * 2;
  static constexpr int KV_BYTES = NS * SLAB_KV * 2;  // one k (or v) tile
  static constexpr int X_BYTES = NDWG == 2 ? 2 * 64 * BN * 4 : 0;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + NSTAGE * KV_BYTES;
  static constexpr int X_OFF = V_OFF + NSTAGE * KV_BYTES;
  static constexpr int BAR_OFF = X_OFF + X_BYTES;
  // + 1024 to align the base: the swizzled tiles sit on 1024-byte bounds
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * NSTAGE) + 1024;
  static_assert(NDWG == 1 || NQWG == 1, "consumers split q or the depth");
  static_assert(NCWG == 2 || NCWG == 3, "the consumer counts measured");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                       int D, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + C::K_OFF);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + C::V_OFF);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* kfull = qbar + 1;
  uint64_t* kempty = kfull + C::NSTAGE;
  uint64_t* vfull = kempty + C::NSTAGE;
  uint64_t* vempty = vfull + C::NSTAGE;

  const int wg = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x % WG_THREADS;
  const int q0 = blockIdx.x * C::BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int nt = (Sk + C::BN - 1) / C::BN;
  // consumers with at least one q row inside Sq (with NDWG == 2 both share
  // the block's rows)
  const int active =
      C::NDWG == 2 ? 2 : min(C::NQWG, (Sq - q0 + 63) / 64);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::NSTAGE; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      mbar_init(kempty + s, 4 * active);  // lane 0 of each consumer warp
      mbar_init(vempty + s, 4 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::NCWG) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int s = 0; s < C::NS; ++s)
        tma_load(Qs + s * C::SLAB_Q, &tm_q, qbar, 16 * s, h, q0, b);
      for (int j = 0; j < nt; ++j) {
        const int st = j % C::NSTAGE, ph = (j / C::NSTAGE) & 1;
        __nv_bfloat16* kt = Ks + st * (C::NS * C::SLAB_KV);
        __nv_bfloat16* vt = Vs + st * (C::NS * C::SLAB_KV);
        mbar_wait(kempty + st, ph ^ 1);
        mbar_expect_tx(kfull + st, C::KV_BYTES);
        for (int s = 0; s < C::NS; ++s)
          tma_load(kt + s * C::SLAB_KV, &tm_k, kfull + st, 16 * s, h,
                   j * C::BN, b);
        mbar_wait(vempty + st, ph ^ 1);
        mbar_expect_tx(vfull + st, C::KV_BYTES);
        for (int s = 0; s < C::NS; ++s)
          tma_load(vt + s * C::SLAB_KV, &tm_v, vfull + st, 16 * s, h,
                   j * C::BN, b);
      }
    }
  } else if (wg < active) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CREGS));
    const int qw = wg % C::NQWG, dw = wg / C::NQWG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    constexpr int NSA = C::BN / 2;  // score registers a thread
    constexpr int NOA = C::NO / 2;  // output registers a thread
    float o_acc[NOA];
#pragma unroll
    for (int i = 0; i < NOA; ++i) o_acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    const bool ragged = Sk % C::BN != 0;

    // One tile at a time: the consumers interleave on the SM, so one's
    // softmax overlaps another's wgmma.  (Issuing the next tile's q·kᵀ
    // before this tile's p·v, FA3-style, measured slower here.)
    mbar_wait(qbar, 0);
    for (int j = 0; j < nt; ++j) {
      const int st = j % C::NSTAGE, ph = (j / C::NSTAGE) & 1;
      const __nv_bfloat16* kt = Ks + st * (C::NS * C::SLAB_KV);
      const __nv_bfloat16* vt = Vs + st * (C::NS * C::SLAB_KV);

      // S = q·kᵀ over this consumer's slabs of the depth
      float s_acc[NSA];
      mbar_wait(kfull + st, ph);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < C::NSW; ++s) {
        const int slab = dw * C::NSW + s;
        sdv::Wgmma<C::BN>::ss(
            s_acc, desc_b32(Qs + slab * C::SLAB_Q + qw * 64 * 16, 16, 256),
            desc_b32(kt + slab * C::SLAB_KV, 16, 256), s > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      if (lane == 0) mbar_arrive(kempty + st);

      if constexpr (C::NDWG == 2) {
        // add the other consumer's partial scores (same rows, other half
        // of the depth); a + b == b + a, so both hold identical sums
        float4* xch = reinterpret_cast<float4*>(smem + C::X_OFF);
        float4* mine = xch + wg * (NSA / 4) * WG_THREADS;
        const float4* other = xch + (1 - wg) * (NSA / 4) * WG_THREADS;
        named_sync(1, 2 * WG_THREADS);  // the previous tile's reads are done
#pragma unroll
        for (int i = 0; i < NSA / 4; ++i)
          mine[i * WG_THREADS + tid] =
              make_float4(s_acc[4 * i], s_acc[4 * i + 1], s_acc[4 * i + 2],
                          s_acc[4 * i + 3]);
        named_sync(2, 2 * WG_THREADS);
#pragma unroll
        for (int i = 0; i < NSA / 4; ++i) {
          const float4 x = other[i * WG_THREADS + tid];
          s_acc[4 * i] += x.x;
          s_acc[4 * i + 1] += x.y;
          s_acc[4 * i + 2] += x.z;
          s_acc[4 * i + 3] += x.w;
        }
      }

      // online softmax, log2 domain; this thread holds rows g and g + 8 of
      // its warp's 16, keys 8c + 2·t4 + {0, 1} of every 8-key group c
      if (ragged && j == nt - 1) {
#pragma unroll
        for (int i = 0; i < NSA; ++i) {
          const int key = j * C::BN + 8 * (i / 4) + 2 * t4 + (i & 1);
          if (key >= Sk) s_acc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NSA; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s_acc[i]);
      float alpha[2], mscaled[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);  // finite: key j·BN < Sk
        alpha[r] = ex2((m_run[r] - m_new) * scale_log2);
        m_run[r] = m_new;
        mscaled[r] = m_new * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < NSA; ++i) {
        const int r = (i >> 1) & 1;
        s_acc[i] = ex2(fmaf(s_acc[i], scale_log2, -mscaled[r]));
        rsum[r] += s_acc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rsum[r];
#pragma unroll
      for (int i = 0; i < NOA; ++i) o_acc[i] *= alpha[(i >> 1) & 1];

      // o += p·v: p from registers (the scores re-packed as bf16 pairs in
      // the wgmma A layout), 16 keys a step; v MN-major (columns
      // contiguous): atoms of 16 columns BN·32 bytes apart (leading
      // offset), 8-key groups 256 bytes apart (stride offset)
      uint32_t pa[C::BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s_acc[8 * kk], s_acc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
      }
      mbar_wait(vfull + st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk)
        sdv::Wgmma<C::NO>::rs(
            o_acc, pa[kk],
            desc_b32(vt + dw * C::NSW * C::SLAB_KV + kk * 16 * 16,
                     C::SLAB_KV * 2, 256));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
      if (lane == 0) mbar_arrive(vempty + st);
    }

    // normalise and store this consumer's rows and columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const long long rs = (long long)H * D;
    __nv_bfloat16* ob = o + (long long)b * Sq * rs + (long long)h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + qw * 64 + 16 * warp + g + 8 * r;
      if (qi >= Sq) continue;
      const float inv = 1.f / l_run[r];
#pragma unroll
      for (int c = 0; c < C::NO / 8; ++c) {
        const int col = dw * C::NO + 8 * c + 2 * t4;  // even; D % 8 == 0
        if (col < D)
          *reinterpret_cast<uint32_t*>(ob + (long long)qi * rs + col) =
              pack_bf16(o_acc[4 * c + 2 * r] * inv,
                        o_acc[4 * c + 2 * r + 1] * inv);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function.  It is fetched through
// the runtime's cudaGetDriverEntryPoint, so the library links nothing but
// the CUDA runtime that nvcc adds (no -lcuda).
EncodeTiled encode_tiled() {
  // fetched once, by whichever host thread calls first (a thread-safe
  // static)
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// tensor map of a (B, S, H, D) bf16 tensor as dims (D, H, S, B), loaded in
// boxes of 16 columns × rows positions (one head, one item); zero fill out
// of bounds
int encode_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
               int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The tensor-map encoder is a driver call, and needs a context current on
// the calling host thread.  A runtime call makes the device's primary
// context current, but a thread whose first kernel is this one may have made
// none (PyTorch's allocator serves tensors without a CUDA call), and the
// encoder then fails with an invalid value: measured on the card, every
// bf16 attention call of a fresh thread failed until the thread launched
// another kernel.  So the device of q is made current here first, once a
// thread and device.
int bind_device(const void* ptr) {
  thread_local int bound = -1;
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err == cudaSuccess && attr.device != bound) {
    err = cudaSetDevice(attr.device);
    if (err == cudaSuccess) bound = attr.device;
  }
  return (int)err;
}

template <class C>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int D, float scale_log2,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = bind_device(q);
  if (err == 0) err = encode_map(&tq, q, B, Sq, H, D, C::BQ);
  if (err == 0) err = encode_map(&tk, k, B, Sk, H, D, C::BN);
  if (err == 0) err = encode_map(&tv, v, B, Sk, H, D, C::BN);
  if (err != 0) return err;
  dim3 grid((Sq + C::BQ - 1) / C::BQ, B * H);
  flash_wgmma_kernel<C><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, D, scale_log2);
  return (int)cudaGetLastError();
}

// the head size rounded up to an instantiated depth (SD 1.x's heads are 40,
// 80, 160 and 512; SD 2.x's and SDXL's 64, and 512 in the VAE); 0 if above
// 512
int padded_depth(int D) {
  for (int dp : {48, 64, 80, 160, 512})
    if (D <= dp) return dp;
  return 0;
}

// the instantiations, by depth: three consumers where their registers
// allow it (measured faster than two), two at D=160 (the accumulators need
// 240 registers a thread).  D=64: 64 score, 32 output and 32 p registers a
// thread fit the three consumers' 160, and q (24 KB) with two k/v stages
// (64 KB) leaves room
#define SDV_FA_CONFIGS(X)                                            \
  X(48, 192, 128, 2, 1) X(64, 192, 128, 2, 1) X(80, 192, 128, 2, 1) \
  X(160, 128, 128, 2, 1) X(512, 64, 64, 1, 2)

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int D, float scale_log2,
                   cudaStream_t stream) {
  switch (padded_depth(D)) {
#define SDV_FA(DP, BQ, BN, NSTAGE, NDWG)                                  \
  case DP:                                                                \
    return launch_wgmma<FlashCfg<DP, BQ, BN, NSTAGE, NDWG>>(              \
        q, k, v, o, B, Sq, Sk, H, D, scale_log2, stream);
    SDV_FA_CONFIGS(SDV_FA)
#undef SDV_FA
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D), all contiguous and
// of one dtype; bf16 needs D % 8 == 0, D <= 512 and 16-byte aligned
// pointers.  Returns a cudaError_t value (0 = launched).
extern "C" int sdv_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int H, int D, float scale,
                                   int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || D < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sdv::kFloat32)
    return dispatch(q, k, v, o, B, Sq, Sk, H, D, scale_log2, s);
  if (dtype == sdv::kBFloat16 && D % 8 == 0)
    return dispatch_wgmma(q, k, v, o, B, Sq, Sk, H, D, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

// What every launch needs once, done when the library is loaded (its loader
// holds a lock): the kernels' shared-memory attributes and the driver's
// tensor-map encoder, so that no launch, from whichever host thread, sets
// them up while another launches.  Returns a cudaError_t value (0 =
// ready).
extern "C" int sdv_prepare_attention() {
  cudaError_t err = encode_tiled() == nullptr
                        ? cudaErrorSharedObjectSymbolNotFound
                        : cudaSuccess;
  const cudaError_t set[] = {
#define SDV_FA(DP, BQ, BN, NSTAGE, NDWG)                                  \
  cudaFuncSetAttribute(flash_wgmma_kernel<FlashCfg<DP, BQ, BN, NSTAGE, NDWG>>, \
                       cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                       FlashCfg<DP, BQ, BN, NSTAGE, NDWG>::SMEM),
      SDV_FA_CONFIGS(SDV_FA)
#undef SDV_FA
      prepare_fp32<1>(), prepare_fp32<2>(), prepare_fp32<3>(),
      prepare_fp32<4>(), prepare_fp32<5>(), prepare_fp32<6>(),
      prepare_fp32<7>(), prepare_fp32<8>(), prepare_fp32<9>(),
      prepare_fp32<10>()};
  for (cudaError_t e : set)
    if (err == cudaSuccess) err = e;
  return (int)err;
}

// The depth a bf16 call of head size D runs at (0: not served), so a caller
// can show which instantiation serves a shape.
extern "C" int sdv_flash_attention_depth(int D) {
  return D % 8 == 0 ? padded_depth(D) : 0;
}

// Host microseconds a bf16 call spends encoding its three tensor maps
// (mean over `reps` encodings of a map of the (B, S, H, D) bf16 tensor at
// `ptr`), for the record of host cost.
extern "C" double sdv_tensor_map_encode_us(const void* ptr, int B, int S,
                                           int H, int D, int reps) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (encode_map(&map, ptr, B, S, H, D, 128) != 0) return -1.0;
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return 3.0 * dt.count() / reps;
}

extern "C" const char* sdv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
