// Backward of GroupNorm (+ optional SiLU) for Hopper (sm_90a), NCHW, two
// launches a call.
//
// The JAX package has no Pallas backward: its trainers differentiate flax's
// nn.GroupNorm (stable_diffusion_videos_tpu/models/layers.py:96) with XLA's
// autodiff.  This is the same gradient for the port's forward kernel
// (groupnorm.cu).  With x̂ = (x − mean)·rstd per (item, group),
// y = x̂·γ[c] + β[c] and, under SiLU, out = y·σ(y):
//
//   g   = dout · σ(y)·(1 + y·(1 − σ(y)))   (dout itself without SiLU)
//   dγ  = Σ over items and pixels of g·x̂, dβ = Σ g            (per channel)
//   dx  = rstd · (g·γ − mean_group(g·γ) − x̂ · mean_group(g·γ·x̂))
//
// What bounds it on the card: bytes (a few tens of operations an element
// against x and dout read and dx written).  What stands in the way is that
// dx needs two whole-group sums, which need the group's statistics first:
// three dependent sweeps over the group.  The design follows the forward's
// (groupnorm.cu):
//
// * One thread-block cluster per (item, group), each block owning a
//   contiguous slice of the group's run of C/G·H·W elements.  Its slices of
//   x and dout move on chip by TMA bulk copies (cp.async.bulk, 8 KB chunks
//   on their own mbarriers), so each sweep after the first reads shared
//   memory, not device memory.
// * Sweep 1 takes the statistics (each 16-byte vector's mean and centred
//   sum of squares, merged with Chan's formula), merged across the cluster
//   through distributed shared memory in rank order.
// * Sweep 2 takes, per channel of the slice, Σ g·x̂ and Σ g (a block-wide
//   reduction a channel segment).  From them each block forms its share of
//   the group sums of g·γ and g·γ·x̂, merged through distributed shared
//   memory in rank order; the per-(item, channel) sums go to scratch, one
//   entry a block that holds part of the channel.
// * Sweep 3 writes dx from the on-chip copies.
// * A second, small launch (weights_kernel) sums the scratch over items
//   and blocks in a fixed order into dγ and dβ.
//
// So x and dout are read once and dx written once wherever a group fits on
// chip: up to 1 MB of x (and as much of dout) a group, every UNet group and
// the VAE up to 256² with 256 channels, in clusters of up to 16 blocks (128
// threads, or 512 where a block's slices pass 32 KB a tensor).  Sweep 2
// gives each warp its own channel segments where a slice holds one a warp
// or more (the UNet's small levels: up to 80 channels of 64 pixels a
// block), else runs every thread on each segment.  Larger groups (the VAE's 512-channel groups at 256², its
// 128- and 256-channel ones at 512²) are streamed as the forward streams
// them: clusters of 16 blocks of 512 threads, as many as fit on the card,
// each block keeping the first 96 KB of its slices of x and of dout; the
// rest of x is read three times and the rest of dout twice.  The path is
// chosen by size before the launch, never on failure.  No atomics: every
// sum runs in a fixed order, so the gradients repeat bit for bit.

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "groupnorm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using sdv::add_vector;
using sdv::block_merge;
using sdv::bulk_load;
using sdv::Moments;
using sdv::Pack;
using sdv::round_up;
using sdv::warp_merge;

constexpr int UNROLL = 4;                      // vectors in flight a thread
constexpr int ONCHIP_NT = 128;                 // threads a block, on chip
constexpr long long SLICE_TARGET = 24 << 10;   // bytes of x a block aims at
constexpr long long ONCHIP_MAX = 1 << 20;      // largest on-chip group (x)
constexpr int MAX_CLUSTER = 16;                // most blocks a cluster
constexpr int STREAM_NT = 512;                 // threads a block, streamed
constexpr long long STREAM_KEEP = 96 << 10;    // kept bytes of each of x, dy
constexpr unsigned CHUNK = 8 << 10;            // bytes of one bulk copy
constexpr int MAX_CHUNKS = STREAM_KEEP / CHUNK;  // one mbarrier each
constexpr int MAX_CPG = 512;                   // channels a group
// the per-channel partial sums a block keeps: MAX_CPG channel segments of
// 4 warps (on chip) or a few of 16 warps (streamed)
constexpr int RED_CAP = MAX_CPG * (ONCHIP_NT / 32) * 8;

__host__ __device__ constexpr int align128(int n) { return (n + 127) & ~127; }

// dynamic shared memory: γ and β of the group, the segments' partials,
// the kept copies of x and dy
__host__ __device__ constexpr int coef_bytes(int cpg) {
  return align128(2 * cpg * 4);
}
__host__ __device__ constexpr int red_bytes(int nseg, int nt) {
  return align128(nseg * (nt / 32) * 8);
}
constexpr int SMEM_CAP =
    coef_bytes(MAX_CPG) + RED_CAP + 2 * (int)STREAM_KEEP;
static_assert(SMEM_CAP <= 232448, "shared memory of one block");

// kernel launches made by sdv_groupnorm_silu_backward, for the record
long long g_launches = 0;

// scale[c] or bias[c], stored as fp32 or bf16
__device__ __forceinline__ float load_weight(const void* w, int c,
                                             int w_bf16) {
  return w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[c])
                : static_cast<const float*>(w)[c];
}

// g (the cotangent of y) and x̂ of one element
__device__ __forceinline__ void grad_y(float xv, float dv, float mean,
                                       float rstd, float gamma, float beta,
                                       int silu, float& g, float& xhat) {
  xhat = (xv - mean) * rstd;
  g = dv;
  if (silu) {
    const float y = fmaf(xhat, gamma, beta);
    // the fast reciprocal, as the forward's SiLU takes it (a full-precision
    // division measured slower on the card: sweeps 2 and 3 are bound by
    // their arithmetic where a group is on chip)
    const float sig = __fdividef(1.f, 1.f + __expf(-y));
    g *= sig * (1.f + y * (1.f - sig));
  }
}

// One cluster per (item, group) at a time; block `rank` owns elements
// [rank·slice, rank·slice + slice) of the group's run and keeps the first
// `keep` of them (of x and of dy) in shared memory.  M, slice and keep are
// multiples of VEC, and so is HW (a vector never straddles two channels).
// part: [N·G][cluster size][cpg] float2 (Σ g·x̂, Σ g) of each channel
// segment a block holds.
template <typename T, int VEC, int NT>
__global__ void __launch_bounds__(NT)
    gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const void* __restrict__ scale,
                  const void* __restrict__ bias, int w_bf16,
                  T* __restrict__ dx,
                  float2* __restrict__ part, unsigned M, unsigned HW, int cpg,
                  int G, int NG, unsigned slice, unsigned keep, int nseg_max,
                  float eps, int silu) {
  using P = Pack<T, VEC>;
  using Raw = typename P::Raw;
  constexpr bool BULK = VEC > 1;
  constexpr int NW = NT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Moments part_m;     // this block's moments, read by the cluster
  __shared__ float2 part_ab;     // its Σ g·γ and Σ g·γ·x̂, read likewise
  __shared__ float2 stat;        // mean and rstd of the group
  __shared__ float2 means;       // mean of g·γ and of g·γ·x̂ over the group
  __shared__ uint64_t bar[2 * MAX_CHUNKS];  // x's kept chunks, then dy's
  float* coef = reinterpret_cast<float*>(smem);  // γ[cpg], then β[cpg]
  float2* red = reinterpret_cast<float2*>(smem + coef_bytes(cpg));
  Raw* kx = reinterpret_cast<Raw*>(smem + coef_bytes(cpg) +
                                   red_bytes(nseg_max, NT));
  Raw* kd = kx + keep / VEC;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), cs = cluster.num_blocks();
  const unsigned start = min(rank * slice, M);
  const unsigned end = min(start + slice, M);
  const unsigned keep_end = min(start + keep, end);
  const uint32_t keep_bytes = (keep_end - start) * sizeof(T);
  const unsigned keep_vecs = (keep_end - start) / VEC;
  const unsigned nchunk = (keep_bytes + CHUNK - 1) / CHUNK;
  const int nseg = start < end ? (int)((end - 1) / HW - start / HW) + 1 : 0;
  const unsigned c_first = start / HW;
  constexpr unsigned STEP = NT * VEC;
  constexpr unsigned CV = CHUNK / sizeof(Raw);  // vectors a chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (BULK && threadIdx.x == 0) {
    for (int c = 0; c < 2 * MAX_CHUNKS; ++c) sdv::mbar_init(&bar[c], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // x and dy of the vector at element i of the run, from the kept copies or
  // from device memory
  auto load = [&](const T* g, const Raw* kept, unsigned i) -> Raw {
    return i < keep_end ? kept[(i - start) / VEC]
                        : *reinterpret_cast<const Raw*>(g + i);
  };

  int phase = 0;
  for (int ng = blockIdx.x / cs; ng < NG; ng += gridDim.x / cs) {
    const T* xg = x + (long long)ng * M;
    const T* dg = dy + (long long)ng * M;
    T* og = dx + (long long)ng * M;
    // the previous group's last sweep is done with the kept copies and the
    // coefficients
    __syncthreads();
    const int c0 = (ng % G) * cpg;
    for (int c = threadIdx.x; c < cpg; c += NT) {
      coef[c] = load_weight(scale, c0 + c, w_bf16);
      coef[cpg + c] = load_weight(bias, c0 + c, w_bf16);
    }
    if (BULK && threadIdx.x == 0) {
      for (unsigned c = 0; c < nchunk; ++c) {
        const uint32_t off = c * CHUNK, n = min(CHUNK, keep_bytes - off);
        sdv::mbar_expect_tx(&bar[c], n);
        bulk_load(reinterpret_cast<unsigned char*>(kx) + off,
                  reinterpret_cast<const unsigned char*>(xg + start) + off, n,
                  &bar[c]);
        sdv::mbar_expect_tx(&bar[MAX_CHUNKS + c], n);
        bulk_load(reinterpret_cast<unsigned char*>(kd) + off,
                  reinterpret_cast<const unsigned char*>(dg + start) + off, n,
                  &bar[MAX_CHUNKS + c]);
      }
    }

    // sweep 1: the statistics, of the streamed rest while the kept chunks
    // arrive, then of each kept chunk
    Moments v{0.f, 0.f, 0.f};
    for (unsigned i0 = (BULK ? keep_end : start) + threadIdx.x * VEC;
         i0 < end; i0 += UNROLL * STEP) {
      Raw r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i0 + u * STEP < end)
          r[u] = *reinterpret_cast<const Raw*>(xg + i0 + u * STEP);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned i = i0 + u * STEP;
        if (i < end) {
          if (!BULK && i < keep_end) kx[(i - start) / VEC] = r[u];
          float f[VEC];
          P::unpack(r[u], f);
          add_vector(v, f);
        }
      }
    }
    if (BULK) {
      for (unsigned c = 0; c < nchunk; ++c) {
        sdv::mbar_wait(&bar[c], phase);
        const unsigned k_end = min((c + 1) * CV, keep_vecs);
        for (unsigned k = c * CV + threadIdx.x; k < k_end; k += NT) {
          float f[VEC];
          P::unpack(kx[k], f);
          add_vector(v, f);
        }
      }
    }
    v = block_merge<NT>(v);
    if (threadIdx.x == 0) part_m = v;
    cluster.sync();  // every block's moments are in place
    if (threadIdx.x < 32) {  // one lane a block of the cluster, rank order
      const Moments t = warp_merge(
          threadIdx.x < cs ? *cluster.map_shared_rank(&part_m, threadIdx.x)
                           : Moments{0.f, 0.f, 0.f});
      if (threadIdx.x == 0) stat = make_float2(t.mean, rsqrtf(t.m2 / t.n + eps));
    }
    if (BULK) {
      for (unsigned c = 0; c < nchunk; ++c)
        sdv::mbar_wait(&bar[MAX_CHUNKS + c], phase);
      phase ^= 1;
    }
    __syncthreads();
    const float mean = stat.x, rstd = stat.y;

    // sweep 2: Σ g·x̂ and Σ g of each channel segment of the slice.  With
    // at least a segment a warp, each segment goes to L lanes of one warp
    // (the least power of two that holds a channel's vectors, at most 32),
    // several segments to a warp; else every thread takes each segment in
    // turn and the warps' partials are added after
    const bool by_warp = nseg >= NW;
    const unsigned vpc = HW / VEC;  // vectors a channel
    const int L = !by_warp ? 32
                  : vpc >= 32 ? 32
                  : vpc <= 1 ? 1 : 1 << (32 - __clz((int)vpc - 1));
    const int groups = NW * (32 / L);
    const int rounds = by_warp ? (nseg + groups - 1) / groups : nseg;
    const int sub = by_warp ? lane % L : threadIdx.x;
    const unsigned lanes = by_warp ? L : NT;  // threads on one segment
    for (int r = 0; r < rounds; ++r) {
      const int s = by_warp ? r * groups + warp * (32 / L) + lane / L : r;
      float sg = 0.f, sgx = 0.f;
      if (s < nseg) {
        const unsigned c = c_first + s;
        const unsigned a = max(start, c * HW), e = min(end, (c + 1) * HW);
        const float gamma = coef[c], beta = coef[cpg + c];
        const unsigned step = lanes * VEC;
        for (unsigned i0 = a + sub * VEC; i0 < e; i0 += UNROLL * step) {
          Raw rx[UNROLL], rd[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const unsigned i = i0 + u * step;
            if (i < e) {
              rx[u] = load(xg, kx, i);
              rd[u] = BULK ? load(dg, kd, i)
                           : *reinterpret_cast<const Raw*>(dg + i);
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const unsigned i = i0 + u * step;
            if (i < e) {
              if (!BULK && i < keep_end) kd[(i - start) / VEC] = rd[u];
              float fx[VEC], fd[VEC];
              P::unpack(rx[u], fx);
              P::unpack(rd[u], fd);
#pragma unroll
              for (int k = 0; k < VEC; ++k) {
                float g, xhat;
                grad_y(fx[k], fd[k], mean, rstd, gamma, beta, silu, g, xhat);
                sg += g;
                sgx = fmaf(g, xhat, sgx);
              }
            }
          }
        }
      }
      for (int off = L / 2; off > 0; off >>= 1) {
        sg += __shfl_xor_sync(0xffffffffu, sg, off);
        sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
      }
      if (s < nseg && lane % L == 0)
        red[s * NW + (by_warp ? 0 : warp)] = make_float2(sgx, sg);
    }
    __syncthreads();
    // a thread a segment: its channel's sums to scratch, and γ times them
    // (the segment's share of the group sums) in place of the first partial
    const int parts = by_warp ? 1 : NW;
    for (int s = threadIdx.x; s < nseg; s += NT) {
      float2 t = red[s * NW];
      for (int w = 1; w < parts; ++w) {
        t.x += red[s * NW + w].x;
        t.y += red[s * NW + w].y;
      }
      part[((long long)ng * cs + rank) * cpg + c_first + s] = t;
      const float gamma = coef[c_first + s];
      red[s * NW] = make_float2(gamma * t.y, gamma * t.x);
    }
    __syncthreads();
    if (warp == 0) {
      float2 t = make_float2(0.f, 0.f);
      for (int s = lane; s < nseg; s += 32) {
        t.x += red[s * NW].x;
        t.y += red[s * NW].y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        t.x += __shfl_xor_sync(0xffffffffu, t.x, off);
        t.y += __shfl_xor_sync(0xffffffffu, t.y, off);
      }
      if (lane == 0) part_ab = t;
    }
    cluster.sync();  // every block's share is in place (and `part_m` read)
    if (threadIdx.x < 32) {
      float2 t = threadIdx.x < cs ? *cluster.map_shared_rank(&part_ab,
                                                              threadIdx.x)
                                  : make_float2(0.f, 0.f);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        t.x += __shfl_xor_sync(0xffffffffu, t.x, off);
        t.y += __shfl_xor_sync(0xffffffffu, t.y, off);
      }
      if (threadIdx.x == 0) means = make_float2(t.x / M, t.y / M);
    }
    cluster.barrier_arrive();  // done reading the other blocks' shares
    __syncthreads();

    // sweep 3: dx
    const float mean_a = means.x, mean_b = means.y;
    for (unsigned i0 = start + threadIdx.x * VEC; i0 < end;
         i0 += UNROLL * STEP) {
      Raw rx[UNROLL], rd[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned i = i0 + u * STEP;
        if (i < end) {
          rx[u] = load(xg, kx, i);
          rd[u] = load(dg, kd, i);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned i = i0 + u * STEP;
        if (i < end) {
          const unsigned c = i / HW;
          const float gamma = coef[c], beta = coef[cpg + c];
          float fx[VEC], fd[VEC], out[VEC];
          P::unpack(rx[u], fx);
          P::unpack(rd[u], fd);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            float g, xhat;
            grad_y(fx[k], fd[k], mean, rstd, gamma, beta, silu, g, xhat);
            out[k] = rstd * (g * gamma - mean_a - xhat * mean_b);
          }
          *reinterpret_cast<Raw*>(og + i) = P::pack(out);
        }
      }
    }
    cluster.barrier_wait();  // `part_ab` may be rewritten, or the block exit
  }
}

// dγ and dβ of each channel (in the weights' dtype): its segments' sums
// over items, then over the blocks that hold part of it, in order
__global__ void weights_kernel(const float2* __restrict__ part,
                               void* __restrict__ dscale,
                               void* __restrict__ dbias, int w_bf16, int N,
                               int C, int G, unsigned HW, unsigned slice,
                               int cs) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int cpg = C / G, g = c / cpg, cl = c % cpg;
  const int r_lo = (int)((unsigned long long)cl * HW / slice);
  const int r_hi = min(cs - 1, (int)(((unsigned long long)cl + 1) * HW - 1) /
                                   (int)slice);
  float dg = 0.f, db = 0.f;
  for (int n = 0; n < N; ++n)
    for (int r = r_lo; r <= r_hi; ++r) {
      const float2 t = part[((long long)(n * G + g) * cs + r) * cpg + cl];
      dg += t.x;
      db += t.y;
    }
  if (w_bf16) {
    static_cast<__nv_bfloat16*>(dscale)[c] = __float2bfloat16(dg);
    static_cast<__nv_bfloat16*>(dbias)[c] = __float2bfloat16(db);
  } else {
    static_cast<float*>(dscale)[c] = dg;
    static_cast<float*>(dbias)[c] = db;
  }
}

template <typename T, int VEC, int NT>
int launch(const void* x, const void* dy, const void* scale,
           const void* bias, int w_bf16, void* dx, void* dscale, void* dbias,
           float2* part, int N, int C, int G, long long M, float eps,
           int silu, int cs, long long slice, long long keep,
           cudaStream_t stream) {
  const int NG = N * G, cpg = C / G;
  const long long HW = M / cpg;
  const int nseg_max = (int)std::min<long long>(cpg, slice / HW + 2);
  const size_t smem = (size_t)coef_bytes(cpg) + red_bytes(nseg_max, NT) +
                      2 * (size_t)keep * sizeof(T);
  if (smem > (size_t)SMEM_CAP) return (int)cudaErrorInvalidValue;
  auto kernel = gn_bwd_kernel<T, VEC, NT>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  long long clusters = NG;
  cudaError_t err;
  if (keep < slice) {
    // streamed: as many clusters as fit on the card at once, each looping
    // over groups
    cfg.gridDim = dim3((unsigned)(clusters * cs));
    int resident = 0;
    err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
    clusters = std::min<long long>(clusters, resident);
  }
  cfg.gridDim = dim3((unsigned)(clusters * cs));
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const T*>(dy), scale, bias, w_bf16,
                           static_cast<T*>(dx), part, (unsigned)M,
                           (unsigned)HW, cpg, G, NG, (unsigned)slice,
                           (unsigned)keep, nseg_max, eps, silu);
  ++g_launches;
  if (err != cudaSuccess) return (int)err;
  weights_kernel<<<(C + 127) / 128, 128, 0, stream>>>(
      part, dscale, dbias, w_bf16, N, C, G, (unsigned)HW, (unsigned)slice,
      cs);
  ++g_launches;
  return (int)cudaGetLastError();
}

// The cluster size and slice of a group of M elements of `bytes` each:
// on chip (clusters of up to 16 blocks, slices near SLICE_TARGET bytes of
// x) up to ONCHIP_MAX bytes of x, else streamed (clusters of 16 blocks,
// each keeping STREAM_KEEP bytes of its slices of x and of dy).
struct Plan {
  int cs;
  long long slice, keep;
  bool onchip;
};

Plan plan(long long M, int bytes, int vec) {
  const long long group_bytes = M * bytes;
  if (group_bytes <= ONCHIP_MAX) {
    const int cs = (int)std::min<long long>(
        MAX_CLUSTER, (group_bytes + SLICE_TARGET - 1) / SLICE_TARGET);
    const long long slice = round_up((M + cs - 1) / cs, vec);
    return {cs, slice, slice, true};
  }
  const long long slice = round_up((M + MAX_CLUSTER - 1) / MAX_CLUSTER, vec);
  return {MAX_CLUSTER, slice,
          std::min<long long>(slice, STREAM_KEEP / bytes / vec * vec), false};
}

template <typename T, int VEC>
int launch_by_size(const void* x, const void* dy, const void* scale,
                   const void* bias, int w_bf16, void* dx, void* dscale,
                   void* dbias, float2* part, int N, int C, long long HW,
                   int G, float eps, int silu, cudaStream_t stream) {
  const long long M = (long long)(C / G) * HW;
  const Plan p = plan(M, sizeof(T), VEC);
  // an on-chip slice above 32 KB a tensor leaves room for one block an SM:
  // 512 threads keep enough loads in flight
  if (p.onchip && p.slice * (long long)sizeof(T) <= (32 << 10))
    return launch<T, VEC, ONCHIP_NT>(x, dy, scale, bias, w_bf16, dx, dscale,
                                     dbias, part, N, C, G, M, eps, silu, p.cs,
                                     p.slice, p.keep, stream);
  return launch<T, VEC, STREAM_NT>(x, dy, scale, bias, w_bf16, dx, dscale,
                                   dbias, part, N, C, G, M, eps, silu, p.cs,
                                   p.slice, p.keep, stream);
}

template <typename T>
int run(const void* x, const void* dy, const void* scale, const void* bias,
        int w_bf16, void* dx, void* dscale, void* dbias, float2* part, int N, int C,
        long long HW, int G, float eps, int silu, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = HW % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  return vec ? launch_by_size<T, VEC>(x, dy, scale, bias, w_bf16, dx,
                                      dscale, dbias, part, N, C, HW, G, eps,
                                      silu, stream)
             : launch_by_size<T, 1>(x, dy, scale, bias, w_bf16, dx, dscale,
                                    dbias, part, N, C, HW, G, eps, silu,
                                    stream);
}

// the attributes every launch of one kernel takes
template <typename T, int VEC, int NT>
cudaError_t prepare() {
  auto kernel = gn_bwd_kernel<T, VEC, NT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
  return err != cudaSuccess ? err : cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

// fp32 scratch floats a call needs: two a (item, channel, block of its
// group's cluster), for the largest cluster
extern "C" long long sdv_groupnorm_backward_scratch(int N, int C,
                                                    long long HW, int G) {
  (void)HW;
  (void)G;
  return 2LL * N * C * MAX_CLUSTER;
}

// x, dy, dx: (N, C, HW) contiguous, one dtype (f32 or bf16); scale, bias:
// (C,) of dtype w_dtype (fp32 or bf16); dscale, dbias: (C,) out, of
// w_dtype; scratch: fp32 of sdv_groupnorm_backward_scratch floats.  Returns
// a cudaError_t value (0 = launched).  Two kernel launches.
extern "C" int sdv_groupnorm_silu_backward(const void* x, const void* dy,
                                           const void* scale,
                                           const void* bias, int w_dtype,
                                           void* dx, void* dscale,
                                           void* dbias, float* scratch, int N,
                                           int C, long long HW, int G,
                                           float eps, int silu, int dtype,
                                           void* stream) {
  if (N < 1 || C < 1 || HW < 1 || G < 1 || C % G != 0 || C / G > MAX_CPG ||
      (long long)N * G > 0x7fffffffLL ||
      (long long)(C / G) * HW > 0x7fffffffLL ||
      (w_dtype != sdv::kFloat32 && w_dtype != sdv::kBFloat16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w_bf16 = w_dtype == sdv::kBFloat16;
  float2* part = reinterpret_cast<float2*>(scratch);
  if (dtype == sdv::kFloat32)
    return run<float>(x, dy, scale, bias, w_bf16, dx, dscale, dbias, part, N,
                      C, HW, G, eps, silu, s);
  if (dtype == sdv::kBFloat16)
    return run<__nv_bfloat16>(x, dy, scale, bias, w_bf16, dx, dscale, dbias,
                              part, N, C, HW, G, eps, silu, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel launches the backward has made in this process (two a call).
extern "C" long long sdv_groupnorm_backward_launches() { return g_launches; }

// The kernels' attributes, set once when the library is loaded (under its
// loader's lock): the largest dynamic shared memory a launch may use and
// clusters above the portable 8 blocks.  Returns a cudaError_t value (0 =
// ready).
extern "C" int sdv_prepare_groupnorm_backward() {
  const cudaError_t set[] = {
      prepare<float, 4, ONCHIP_NT>(), prepare<float, 4, STREAM_NT>(),
      prepare<float, 1, ONCHIP_NT>(), prepare<float, 1, STREAM_NT>(),
      prepare<__nv_bfloat16, 8, ONCHIP_NT>(),
      prepare<__nv_bfloat16, 8, STREAM_NT>(),
      prepare<__nv_bfloat16, 1, ONCHIP_NT>(),
      prepare<__nv_bfloat16, 1, STREAM_NT>()};
  for (cudaError_t e : set)
    if (e != cudaSuccess) return (int)e;
  return 0;
}
