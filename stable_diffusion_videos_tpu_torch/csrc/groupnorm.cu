// GroupNorm (+ optional SiLU) for Hopper (sm_90a), NCHW, one launch a call.
//
// Replaces the TPU kernel stable_diffusion_videos_tpu/ops/groupnorm.py
// (fused_groupnorm_silu / _kernel): per (item, group) statistics in fp32,
// then (x - mean) · rstd · scale[c] + bias[c], then SiLU if asked.
//
// What bounds it on the card: bytes.  The op does a few operations per
// element, far below the card's operations-per-byte balance, so its floor is
// reading x once and writing y once.  In NCHW one (item, group) pair is one
// contiguous run of C/G·H·W elements (5K to 2M on the walk).  What stands in
// the way is the dependency inside a group: no y can be written before the
// whole group has been read.  The design, one kernel launch a call:
//
// * One thread-block cluster per group, each block owning a contiguous
//   slice of the run.  The slice moves by TMA bulk copies
//   (cp.async.bulk): 8 KB chunks into shared memory, each completing on its
//   own mbarrier, so the statistics of a chunk are taken while the next
//   ones arrive: each 16-byte vector's mean and centred sum of squares
//   exactly, merged into the thread's running (count, mean, M2) with Chan's
//   formula, then across the block.  E[x²] − mean² would cancel at 2M
//   elements a group; this does not.
// * The blocks merge their partials through distributed shared memory (one
//   lane a block reads one partial with cluster.map_shared_rank after a
//   cluster barrier), so there is no partials array in device memory and
//   no second kernel.
// * Per channel, mean, rstd, scale[c] and bias[c] fold into one multiply-add
//   (a = rstd·scale[c], b = bias[c] − mean·a) held in shared memory.  The
//   block normalises its on-chip copy in place, applies SiLU, and stores
//   each chunk with a bulk copy while it computes the next.
// * Small blocks (128 threads) and slices (near 24 KB) keep several groups
//   in flight on every SM, so one group's wait for its cluster's statistics
//   overlaps the others' copies.
//
// A group stays on chip when its bytes (in x's dtype: an fp32 group is
// twice a bf16 one) are at most 1 MB: every UNet level and the VAE up to
// 256² with 256 channels, in clusters of up to 16 blocks (the non-portable
// size Hopper allows; 8 is the portable limit).  Larger groups (the VAE
// decoder's 2 MB at 512² to 16.8 MB at 1024²) are streamed: clusters of 16
// blocks of 512 threads, each keeping the first 96 KB of its slice on chip
// and reading the rest twice.  The launch holds as many clusters as fit on
// the card at once, and each loops over groups.  The second read is left
// to fall out of L2 where it will: holding fewer clusters so that their
// streamed bytes fit L2 leaves too few SMs moving the tensor (measured on
// the card: no faster on 2-4 MB groups, 1.2-2.6x slower on 4.7-16.8 MB
// ones with two to four clusters in flight).  The path is chosen by size
// before the launch, never on failure.  A run whose rows are not 16-byte
// aligned moves element by element, kept whole on chip or streamed by the
// same rule.

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "groupnorm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using sdv::add_vector;
using sdv::block_merge;
using sdv::bulk_load;
using sdv::bulk_store;
using sdv::Moments;
using sdv::Pack;
using sdv::round_up;
using sdv::warp_merge;

// Sizes, chosen on the card (H100 SXM, phase 3 of chip_smoke.py): small
// blocks and slices keep several groups in flight on every SM, which hides
// each group's wait for its cluster's statistics.
constexpr int UNROLL = 4;                      // vectors in flight a thread
constexpr int ONCHIP_NT = 128;                 // threads a block, on chip
constexpr long long SLICE_TARGET = 24 << 10;   // on-chip slice a block
                                               // aims at
constexpr long long ONCHIP_MAX = 1 << 20;      // largest on-chip group
constexpr int MAX_CLUSTER = 16;                // most blocks a cluster
constexpr int STREAM_NT = 512;                 // threads a block, streamed
constexpr long long STREAM_KEEP = 96 << 10;    // kept bytes of a streamed slice
constexpr unsigned CHUNK = 8 << 10;            // bytes of one bulk copy
constexpr int MAX_CHUNKS = STREAM_KEEP / CHUNK;  // one mbarrier each
constexpr int MAX_CPG = 512;                   // channels a group

// scale[c] or bias[c], stored as fp32 or bf16
__device__ __forceinline__ float load_weight(const void* w, int c,
                                             int w_bf16) {
  return w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[c])
                : static_cast<const float*>(w)[c];
}

__host__ __device__ constexpr int coef_bytes(int cpg) {
  return (2 * cpg * 4 + 127) & ~127;
}

// The dynamic shared memory any launch may take: the widest group's
// coefficients and a streamed slice's kept part (an on-chip slice is at
// most ONCHIP_MAX / MAX_CLUSTER bytes and one vector, less).
constexpr int SMEM_CAP = coef_bytes(MAX_CPG) + (int)STREAM_KEEP;

// One cluster per (item, group) at a time; block `rank` of the cluster owns
// elements [rank·slice, rank·slice + slice) of the group's run and keeps the
// first `keep` of them in shared memory.  M, slice and keep are multiples of
// VEC, and so is HW (a vector never straddles two channels).  With 16-byte
// vectors (BULK) the kept part moves by TMA bulk copies, chunk by chunk,
// normalised in place and stored from where it lies.
template <typename T, int VEC, int NT>
__global__ void __launch_bounds__(NT)
    gn_silu_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                   const void* __restrict__ bias, int w_bf16,
                   T* __restrict__ y, unsigned M, unsigned HW, int cpg,
                   int G, int NG, unsigned slice, unsigned keep, float eps,
                   int silu) {
  using P = Pack<T, VEC>;
  using Raw = typename P::Raw;
  constexpr bool BULK = VEC > 1;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Moments part;  // this block's partial, read by the cluster
  __shared__ float2 stat;   // mean and rstd of the group
  __shared__ uint64_t bar[MAX_CHUNKS];  // chunk c of the kept part arrived
  float* coef = reinterpret_cast<float*>(smem);  // a[cpg], then b[cpg]
  Raw* kept = reinterpret_cast<Raw*>(smem + coef_bytes(cpg));

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), cs = cluster.num_blocks();
  const unsigned start = min(rank * slice, M);
  const unsigned end = min(start + slice, M);
  const unsigned keep_end = min(start + keep, end);
  const uint32_t keep_bytes = (keep_end - start) * sizeof(T);
  const unsigned keep_vecs = (keep_end - start) / VEC;
  const unsigned nchunk = (keep_bytes + CHUNK - 1) / CHUNK;
  constexpr unsigned STEP = NT * VEC;
  constexpr unsigned CV = CHUNK / sizeof(Raw);  // vectors a chunk
  if (BULK && threadIdx.x == 0) {
    for (int c = 0; c < MAX_CHUNKS; ++c) sdv::mbar_init(&bar[c], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // y = x·a[c] + b[c], then SiLU, for the vector at element i of the run
  auto apply = [&](Raw r, unsigned i) {
    const int c = (int)(i / HW);
    const float a = coef[c], b = coef[cpg + c];
    float f[VEC];
    P::unpack(r, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      f[e] = fmaf(f[e], a, b);
      if (silu) f[e] = __fdividef(f[e], 1.f + __expf(-f[e]));
    }
    return P::pack(f);
  };

  int phase = 0;
  for (int ng = blockIdx.x / cs; ng < NG; ng += gridDim.x / cs) {
    const T* xg = x + (long long)ng * M;
    T* yg = y + (long long)ng * M;
    // this group's scale and bias, loaded now and used after the statistics
    constexpr int WPT = (MAX_CPG + NT - 1) / NT;  // channels a thread
    const int c0 = (ng % G) * cpg;
    float sc[WPT], bi[WPT];
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int c = threadIdx.x + j * NT;
      sc[j] = c < cpg ? load_weight(scale, c0 + c, w_bf16) : 0.f;
      bi[j] = c < cpg ? load_weight(bias, c0 + c, w_bf16) : 0.f;
    }

    // pass 1: read the slice once, keep what fits, take the statistics
    // (of each chunk as soon as it has arrived)
    if (BULK && threadIdx.x == 0) {
      // the previous group's stores have read the kept copy
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      for (unsigned c = 0; c < nchunk; ++c) {
        const uint32_t off = c * CHUNK, n = min(CHUNK, keep_bytes - off);
        sdv::mbar_expect_tx(&bar[c], n);
        bulk_load(reinterpret_cast<unsigned char*>(kept) + off,
                  reinterpret_cast<const unsigned char*>(xg + start) + off, n,
                  &bar[c]);
      }
    }
    Moments v{0.f, 0.f, 0.f};
    for (unsigned i0 = (BULK ? keep_end : start) + threadIdx.x * VEC;
         i0 < end; i0 += UNROLL * STEP) {
      Raw r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned i = i0 + u * STEP;
        if (i < end) r[u] = *reinterpret_cast<const Raw*>(xg + i);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned i = i0 + u * STEP;
        if (i < end) {
          if (!BULK && i < keep_end) kept[(i - start) / VEC] = r[u];
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
          P::unpack(kept[k], f);
          add_vector(v, f);
        }
      }
      phase ^= 1;
    }
    v = block_merge<NT>(v);
    if (threadIdx.x == 0) part = v;
    cluster.sync();  // every block's partial is in place
    if (threadIdx.x < 32) {  // one lane a block of the cluster
      const Moments t = warp_merge(
          threadIdx.x < cs ? *cluster.map_shared_rank(&part, threadIdx.x)
                           : Moments{0.f, 0.f, 0.f});
      if (threadIdx.x == 0)
        stat = make_float2(t.mean, rsqrtf(t.m2 / t.n + eps));
    }
    cluster.barrier_arrive();  // done reading the other blocks' partials
    __syncthreads();
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int c = threadIdx.x + j * NT;
      if (c < cpg) {
        const float a = stat.y * sc[j];
        coef[c] = a;
        coef[cpg + c] = bi[j] - stat.x * a;
      }
    }
    __syncthreads();

    // pass 2: normalise the kept copy in place chunk by chunk, each chunk
    // stored in bulk while the next is computed; then the streamed rest
    if (BULK) {
      for (unsigned c = 0; c < nchunk; ++c) {
        const unsigned k_end = min((c + 1) * CV, keep_vecs);
        for (unsigned k = c * CV + threadIdx.x; k < k_end; k += NT)
          kept[k] = apply(kept[k], start + k * VEC);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (threadIdx.x == 0) {
          const uint32_t off = c * CHUNK;
          bulk_store(reinterpret_cast<unsigned char*>(yg + start) + off,
                     reinterpret_cast<unsigned char*>(kept) + off,
                     min(CHUNK, keep_bytes - off));
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
    for (unsigned i0 = (BULK ? keep_end : start) + threadIdx.x * VEC;
         i0 < end; i0 += UNROLL * STEP) {
      Raw r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned i = i0 + u * STEP;
        if (i < end)
          r[u] = !BULK && i < keep_end ? kept[(i - start) / VEC]
                                       : *reinterpret_cast<const Raw*>(xg + i);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned i = i0 + u * STEP;
        if (i < end) *reinterpret_cast<Raw*>(yg + i) = apply(r[u], i);
      }
    }
    cluster.barrier_wait();  // `part` may be rewritten, or the block exit
  }
  // the shared-memory copy must outlive the bulk store's reads of it
  if (BULK && threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}



template <typename T, int VEC, int NT>
int launch(const void* x, const void* scale, const void* bias, int w_bf16,
           void* y, int N, int C, int G, long long M, float eps, int silu,
           int cs, long long slice, long long keep, cudaStream_t stream) {
  const int NG = N * G;
  const int cpg = C / G;
  const long long HW = M / cpg;
  const size_t smem = (size_t)coef_bytes(cpg) + (size_t)keep * sizeof(T);
  if (smem > (size_t)SMEM_CAP) return (int)cudaErrorInvalidValue;
  auto kernel = gn_silu_kernel<T, VEC, NT>;
  cudaError_t err;
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
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), scale,
                           bias, w_bf16, static_cast<T*>(y), (unsigned)M,
                           (unsigned)HW, cpg, G, NG, (unsigned)slice,
                           (unsigned)keep, eps, silu);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The path, by the group's size in x's dtype: on chip (clusters of up to
// 16 blocks of 128 threads, slices near SLICE_TARGET) up to ONCHIP_MAX
// bytes, else streamed (clusters of 16 blocks of 512 threads, each keeping
// STREAM_KEEP bytes of its slice).
template <typename T, int VEC>
int launch_by_size(const void* x, const void* scale, const void* bias,
                   int w_bf16, void* y, int N, int C, long long HW, int G,
                   float eps, int silu, cudaStream_t stream) {
  const long long M = (long long)(C / G) * HW;
  const long long group_bytes = M * (long long)sizeof(T);
  if (group_bytes <= ONCHIP_MAX) {
    const int cs = (int)std::min<long long>(
        MAX_CLUSTER, (group_bytes + SLICE_TARGET - 1) / SLICE_TARGET);
    const long long slice = round_up((M + cs - 1) / cs, VEC);
    return launch<T, VEC, ONCHIP_NT>(x, scale, bias, w_bf16, y, N, C, G, M,
                                     eps, silu, cs, slice, slice, stream);
  }
  const long long slice = round_up((M + MAX_CLUSTER - 1) / MAX_CLUSTER, VEC);
  const long long keep =
      std::min<long long>(slice, STREAM_KEEP / sizeof(T) / VEC * VEC);
  return launch<T, VEC, STREAM_NT>(x, scale, bias, w_bf16, y, N, C, G, M,
                                   eps, silu, MAX_CLUSTER, slice, keep,
                                   stream);
}

template <typename T>
int run(const void* x, const void* scale, const void* bias, int w_bf16,
        void* y, int N, int C, long long HW, int G, float eps, int silu,
        cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = HW % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return vec ? launch_by_size<T, VEC>(x, scale, bias, w_bf16, y, N, C, HW,
                                      G, eps, silu, stream)
             : launch_by_size<T, 1>(x, scale, bias, w_bf16, y, N, C, HW, G,
                                    eps, silu, stream);
}

// the attributes every launch of one kernel takes (sdv_prepare_groupnorm)
template <typename T, int VEC, int NT>
cudaError_t prepare() {
  auto kernel = gn_silu_kernel<T, VEC, NT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
  return err != cudaSuccess ? err : cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

// The kernels' attributes, set once when the library is loaded (its loader
// holds a lock) to values every launch takes: the largest dynamic shared
// memory a launch may use and clusters above the portable 8 blocks.  A
// launch then sets nothing, so host threads launching at once never change
// an attribute under one another's launch (measured on the card: when each
// launch set its own shared-memory size, a launch from a server's second
// thread failed with an invalid argument).  Returns a cudaError_t value (0
// = ready).
extern "C" int sdv_prepare_groupnorm() {
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

// x, y: (N, C, HW) contiguous, one dtype; scale, bias: (C,) contiguous, of
// dtype w_dtype (fp32 or bf16).  Returns a cudaError_t value (0 =
// launched).  One kernel launch.
extern "C" int sdv_groupnorm_silu(const void* x, const void* scale,
                                  const void* bias, int w_dtype, void* y,
                                  int N, int C, long long HW, int G,
                                  float eps, int silu, int dtype,
                                  void* stream) {
  if (N < 1 || C < 1 || HW < 1 || G < 1 || C % G != 0 || C / G > MAX_CPG ||
      (long long)N * G > 0x7fffffffLL ||
      (long long)(C / G) * HW > 0x7fffffffLL ||
      (w_dtype != sdv::kFloat32 && w_dtype != sdv::kBFloat16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w_bf16 = w_dtype == sdv::kBFloat16;
  if (dtype == sdv::kFloat32)
    return run<float>(x, scale, bias, w_bf16, y, N, C, HW, G, eps, silu, s);
  if (dtype == sdv::kBFloat16)
    return run<__nv_bfloat16>(x, scale, bias, w_bf16, y, N, C, HW, G, eps,
                              silu, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Split-statistics GroupNorm (+ optional SiLU): the spatially sharded UNet's
// GroupNorm, whose groups span every rank's slab of the width.  Two entry
// points around an all-gather that the caller runs:
//
// * sdv_groupnorm_partials: each (item, group) run of the local slab ->
//   its Welford partial (count, mean, M2) in fp32, (N, G, 3);
// * sdv_groupnorm_apply: given the P ranks' partials (P, N, G, 3), the
//   group's statistics merged in rank order, rstd, scale[c] and bias[c]
//   folded into one multiply-add a channel, the slab normalised, with the
//   optional SiLU.
//
// What bounds both on the card: bytes (the partials pass reads the slab
// once; the apply pass reads it again and writes it once).  The groups'
// statistics cannot be finished before every rank's slab is read, which is
// why the pass is split around the collective rather than fused.  The
// slabs are small (0.3-63 MB on SD 1.x's spatial UNet at CFG batch 16, up
// to 31 MB on SDXL-base's at 1024²), and the slab a pass reads was mostly
// written just before it, so the passes run from L2 at launch latency or
// near the L2's rate; what stands in the way is the wrappers' host time
// (two to three times a small pass's device time), few runs for many SMs,
// and the apply's per-vector work.  The design:
//
// * Launch plans.  Both passes' geometry is computed once a shape by the
//   wrapper (ops/groupnorm.py, PartialsPlan / ApplyPlan, field for field
//   the structs below) from the card's SM count, and every call passes the
//   plan by pointer with the tensors' pointers and the stream: no argument
//   is converted or re-derived a call.
// * Partials, by run size.  A run of at most 4 KB goes to one warp, its
//   lanes' moments merged by shuffles, with no block barrier, and a block
//   holds as many warps as spread the runs over the card.  A longer run is
//   split over a cluster of up to 8 blocks when the runs alone would leave
//   SMs idle (SDXL's N·G = 64 runs of 20-480 KB: clusters of 5 fill 132
//   SMs), the blocks' partials merging through distributed shared memory
//   in block order 0, 1, ...; with runs enough, a block a run.  Each thread
//   keeps 4 (block) or 8 (warp) 16-byte loads in flight and merges each
//   vector's exact mean and centred sum of squares (groupnorm_common.cuh,
//   Chan's formula) into its running moments; a warp's lane holds up to 8
//   vectors of a run, and merges them into 4 chains (vector j to chain
//   j % 4) that merge in order at the end, so that neighbouring merges
//   (each a division) do not wait on one another.
// * Apply, by tiles that own (item, channel range) or (item, channel,
//   column range): the channel is fixed along a tile's row, so no vector
//   divides its index to find its channel.  Each channel's thread merges
//   its group's P partials in rank order and folds a = rstd·scale[c], b =
//   bias[c] − mean·a into shared memory once a tile, while the tile's first
//   loads are in flight; the tile is then normalised (+ SiLU) with 4 loads
//   in flight a thread.  One block a tile: the card's own scheduler keeps
//   every SM busy.
//
// Not used: TMA bulk copies into mbarrier rings, bulk stores, persistent
// grids sized by occupancy and L2 eviction hints.  That design is kept in
// tools/split_groupnorm/tma/groupnorm.cu and timed against this one by
// tools/split_groupnorm/compare.py (H100 SXM; PERF.md): over SD 1.x's 36
// bf16 split rows its device time is 1.6 times this one's for the
// partials and 1.5 times for the apply (1.4 and 1.5 over SDXL's rows),
// and it stays so with a block for every run or tile in place of the
// persistent grids: the copies and the staging through shared memory
// cost more than 16-byte vector loads on these L2-resident slabs.
//
// No atomics and a fixed merge order everywhere: a run's moments depend on
// its shape alone, and every block and rank merges the same P partials in
// the same order, so all get the same mean and rstd bit for bit.  A slab
// whose rows are not 16-byte aligned (HW not a multiple of 16 bytes, or a
// pointer off 16 bytes) moves element by element: one block a run, then
// blocks of contiguous chunks.
// ---------------------------------------------------------------------------
namespace {

constexpr int SPLIT_ELEMENT = 0;   // routes: element by element
constexpr int SPLIT_WARP = 1;      // partials: a warp a run
constexpr int SPLIT_BLOCK = 2;     // partials: a cluster of blocks a run
constexpr int SPLIT_TILE = 3;      // apply: tiles of channel rows
constexpr int SPLIT_NT = 256;      // threads a block (warp route: at most)
constexpr int SPLIT_UNROLL = 4;    // element route: elements in flight
constexpr int SPLIT_MAX_CLUSTER = 8;

// the launch plans (ops/groupnorm.py builds them; same fields, same order)
struct PartialsPlan {
  long long hw;     // elements a channel of the slab
  long long slice;  // block route: elements of a run each cluster block owns
  int n, c, g, dtype;
  int route;        // SPLIT_ELEMENT, SPLIT_WARP or SPLIT_BLOCK
  int grid, threads, cluster;
};

struct ApplyPlan {
  long long hw;
  long long tiles;  // tiles of the slab: the grid
  int n, c, g, dtype, w_dtype, parts, silu;
  float eps;
  int route;        // SPLIT_ELEMENT or SPLIT_TILE
  int rows;         // channels a tile (at most SPLIT_NT); cols == hw if > 1
  int cols;         // elements of a channel a tile
  int col_tiles;    // tiles along a channel, ceil(hw / cols)
  int chan_tiles;   // channel blocks an item, ceil(c / rows)
};

__device__ __forceinline__ void store_moments(float* part, long long run,
                                              Moments m) {
  float* o = part + 3 * run;
  o[0] = m.n;
  o[1] = m.mean;
  o[2] = m.m2;
}

// The moments of vectors k0, k0 + step, ... below n of v: DEPTH loads in
// flight, then merged, the thread's vector j into chain j % CHAINS, the
// chains merged in order.
template <int DEPTH, int CHAINS, typename T, int VEC>
__device__ __forceinline__ Moments run_moments(
    const typename Pack<T, VEC>::Raw* __restrict__ v, unsigned k0,
    unsigned n, unsigned step) {
  static_assert(DEPTH % CHAINS == 0, "whole chains");
  Moments m[CHAINS];
#pragma unroll
  for (int u = 0; u < CHAINS; ++u) m[u] = Moments{0.f, 0.f, 0.f};
  for (unsigned k = k0; k < n; k += DEPTH * step) {
    typename Pack<T, VEC>::Raw r[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u)
      if (k + u * step < n) r[u] = v[k + u * step];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      if (k + u * step < n) {
        float f[VEC];
        Pack<T, VEC>::unpack(r[u], f);
        add_vector(m[u % CHAINS], f);
      }
    }
  }
  Moments t = m[0];
#pragma unroll
  for (int u = 1; u < CHAINS; ++u) t = sdv::merge(t, m[u]);
  return t;
}

// Partials, runs of at most 4 KB: warp w of block b takes run b·W + w (and
// + gridDim.x·W, ... were the grid smaller than the runs).
template <typename T, int VEC>
__global__ void __launch_bounds__(SPLIT_NT)
    gn_partials_warp_kernel(const PartialsPlan p, const T* __restrict__ x,
                            float* __restrict__ part) {
  using Raw = typename Pack<T, VEC>::Raw;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const long long NG = (long long)p.n * p.g;
  const long long M = (long long)(p.c / p.g) * p.hw;
  const unsigned nvec = (unsigned)(M / VEC);
  for (long long r = (long long)blockIdx.x * nw + (threadIdx.x >> 5); r < NG;
       r += (long long)gridDim.x * nw) {
    const Moments m = warp_merge(run_moments<8, 4, T, VEC>(
        reinterpret_cast<const Raw*>(x + r * M), lane, nvec, 32));
    if (lane == 0) store_moments(part, r, m);
  }
}

// Partials, longer runs: cluster q of the grid takes run q; block `rank` of
// it owns elements [rank·slice, rank·slice + slice).  With CLUSTER the
// blocks' partials merge in block order on block 0, through distributed
// shared memory; without, a block is a run.
template <typename T, int VEC, bool CLUSTER>
__global__ void __launch_bounds__(SPLIT_NT, 4)
    gn_partials_block_kernel(const PartialsPlan p, const T* __restrict__ x,
                             float* __restrict__ part) {
  using Raw = typename Pack<T, VEC>::Raw;
  __shared__ Moments blk;  // this block's partial, read by block 0
  const unsigned rank = CLUSTER ? cg::this_cluster().block_rank() : 0;
  const unsigned cs = CLUSTER ? cg::this_cluster().num_blocks() : 1;
  const long long M = (long long)(p.c / p.g) * p.hw;
  const long long r = blockIdx.x / cs;
  const long long start = min((long long)rank * p.slice, M);
  const unsigned nvec = (unsigned)((min(start + p.slice, M) - start) / VEC);
  const Moments v = block_merge<SPLIT_NT>(run_moments<4, 1, T, VEC>(
      reinterpret_cast<const Raw*>(x + r * M + start), threadIdx.x, nvec,
      SPLIT_NT));
  if (!CLUSTER) {
    if (threadIdx.x == 0) store_moments(part, r, v);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) blk = v;
  cluster.sync();  // every block's partial is in place
  if (rank == 0 && threadIdx.x == 0) {
    Moments t = blk;
    for (unsigned b = 1; b < cs; ++b)
      t = sdv::merge(t, *cluster.map_shared_rank(&blk, b));
    store_moments(part, r, t);
  }
  cluster.sync();  // `blk` outlives block 0's reads of it
}

// The group statistics of partials row `ng`: the P ranks' partials merged
// in rank order, as every block and rank merges them -> (mean, rstd).
// Four ranks' partials are loaded at once, then merged.
__device__ __forceinline__ float2 group_stats(const float* __restrict__ part,
                                              int P, long long NG,
                                              long long ng, float eps) {
  const float* q = part + 3 * ng;
  Moments t{q[0], q[1], q[2]};
  for (int r0 = 1; r0 < P; r0 += 4) {
    Moments b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r0 + u < P) {
        const float* o = q + 3 * (r0 + u) * NG;
        b[u] = Moments{o[0], o[1], o[2]};
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (r0 + u < P) t = sdv::merge(t, b[u]);
  }
  return make_float2(t.mean, rsqrtf(t.m2 / t.n + eps));
}

// Apply, a block a tile: tile t is item t / (chan_tiles·col_tiles),
// channels [c0, c0 + rows), columns [j0, j0 + cols), a contiguous span.
// Vector i of the tile lies in row i / vpr: followed by increments of the
// block's stride, so no vector divides.
template <typename T, int VEC>
__global__ void __launch_bounds__(SPLIT_NT)
    gn_apply_tile_kernel(const ApplyPlan p, const T* __restrict__ x,
                         const void* __restrict__ scale,
                         const void* __restrict__ bias,
                         const float* __restrict__ part, T* __restrict__ y) {
  using Pk = Pack<T, VEC>;
  using Raw = typename Pk::Raw;
  constexpr int DEPTH = 4;
  __shared__ float coef[2 * SPLIT_NT];  // a[rows], then b at SPLIT_NT
  const long long per_item = (long long)p.chan_tiles * p.col_tiles;
  const int n = (int)(blockIdx.x / per_item);
  const long long rem = blockIdx.x - n * per_item;
  const int c0 = (int)(rem / p.col_tiles) * p.rows;
  const int rows = min(p.rows, p.c - c0);
  const long long j0 = rem % p.col_tiles * p.cols;
  const long long cols = min((long long)p.cols, p.hw - j0);
  const long long start = ((long long)n * p.c + c0) * p.hw + j0;
  const unsigned nvec = (unsigned)(rows * cols / VEC);
  const Raw* xv = reinterpret_cast<const Raw*>(x + start);
  Raw* yv = reinterpret_cast<Raw*>(y + start);
  // the first loads in flight while the coefficients are folded
  Raw r[DEPTH];
  unsigned i0 = threadIdx.x;
#pragma unroll
  for (int u = 0; u < DEPTH; ++u)
    if (i0 + u * SPLIT_NT < nvec) r[u] = xv[i0 + u * SPLIT_NT];
  if (threadIdx.x < rows) {
    const int c = c0 + threadIdx.x, w_bf16 = p.w_dtype == sdv::kBFloat16;
    const float2 st =
        group_stats(part, p.parts, (long long)p.n * p.g,
                    (long long)n * p.g + c / (p.c / p.g), p.eps);
    const float a = st.y * load_weight(scale, c, w_bf16);
    coef[threadIdx.x] = a;
    coef[SPLIT_NT + threadIdx.x] = load_weight(bias, c, w_bf16) - st.x * a;
  }
  __syncthreads();
  const unsigned vpr = (unsigned)(p.cols / VEC);
  const unsigned step_rows = SPLIT_NT / vpr, step_cols = SPLIT_NT % vpr;
  unsigned row = threadIdx.x / vpr, col = threadIdx.x % vpr;
  while (true) {
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      const unsigned i = i0 + u * SPLIT_NT;
      if (i < nvec) {
        const float a = coef[row], b = coef[SPLIT_NT + row];
        float f[VEC];
        Pk::unpack(r[u], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          f[e] = fmaf(f[e], a, b);
          if (p.silu) f[e] = __fdividef(f[e], 1.f + __expf(-f[e]));
        }
        yv[i] = Pk::pack(f);
      }
      row += step_rows;
      col += step_cols;
      if (col >= vpr) {
        col -= vpr;
        ++row;
      }
    }
    i0 += DEPTH * SPLIT_NT;
    if (i0 >= nvec) break;
#pragma unroll
    for (int u = 0; u < DEPTH; ++u)
      if (i0 + u * SPLIT_NT < nvec) r[u] = xv[i0 + u * SPLIT_NT];
  }
}

// Element by element (a slab whose rows are not 16-byte aligned): one
// block a run for the partials; blocks of contiguous chunks for the apply.
template <typename T>
__global__ void __launch_bounds__(SPLIT_NT)
    gn_partials_element_kernel(const T* __restrict__ x,
                               float* __restrict__ part, unsigned M) {
  const T* xg = x + (long long)blockIdx.x * M;
  Moments v{0.f, 0.f, 0.f};
  for (unsigned i0 = threadIdx.x; i0 < M; i0 += SPLIT_UNROLL * SPLIT_NT) {
    T r[SPLIT_UNROLL];
#pragma unroll
    for (int u = 0; u < SPLIT_UNROLL; ++u) {
      const unsigned i = i0 + u * SPLIT_NT;
      if (i < M) r[u] = xg[i];
    }
#pragma unroll
    for (int u = 0; u < SPLIT_UNROLL; ++u) {
      if (i0 + u * SPLIT_NT < M) {
        const float f[1] = {sdv::to_f32(r[u])};
        add_vector(v, f);
      }
    }
  }
  v = block_merge<SPLIT_NT>(v);
  if (threadIdx.x == 0) store_moments(part, blockIdx.x, v);
}

template <typename T>
__global__ void __launch_bounds__(SPLIT_NT)
    gn_apply_element_kernel(const T* __restrict__ x,
                            const void* __restrict__ scale,
                            const void* __restrict__ bias, int w_bf16,
                            const float* __restrict__ part, int P,
                            long long NG, T* __restrict__ y, unsigned M,
                            unsigned HW, int cpg, int G, float eps,
                            int silu) {
  const long long ng = blockIdx.y;
  const float2 st = group_stats(part, P, NG, ng, eps);
  const int c0 = (int)(ng % G) * cpg;
  const T* xg = x + ng * M;
  T* yg = y + ng * M;
  constexpr unsigned CHUNK = SPLIT_UNROLL * SPLIT_NT;
  const unsigned i0 = blockIdx.x * CHUNK + threadIdx.x;
  T r[SPLIT_UNROLL];
#pragma unroll
  for (int u = 0; u < SPLIT_UNROLL; ++u) {
    const unsigned i = i0 + u * SPLIT_NT;
    if (i < M) r[u] = xg[i];
  }
#pragma unroll
  for (int u = 0; u < SPLIT_UNROLL; ++u) {
    const unsigned i = i0 + u * SPLIT_NT;
    if (i < M) {
      const int c = c0 + (int)(i / HW);
      const float a = st.y * load_weight(scale, c, w_bf16);
      float f = fmaf(sdv::to_f32(r[u]), a,
                     load_weight(bias, c, w_bf16) - st.x * a);
      if (silu) f = __fdividef(f, 1.f + __expf(-f));
      yg[i] = sdv::from_f32<T>(f);
    }
  }
}

bool split_shape_ok(int N, int C, long long HW, int G) {
  return N >= 1 && C >= 1 && HW >= 1 && G >= 1 && C % G == 0 &&
         (long long)N * G <= 65535LL &&
         (long long)(C / G) * HW <= 0x7fffffffLL;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int run_partials(const PartialsPlan& p, const void* x, float* part,
                 cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const long long NG = (long long)p.n * p.g;
  if (p.route == SPLIT_ELEMENT || !aligned16(x)) {
    gn_partials_element_kernel<T><<<(unsigned)NG, SPLIT_NT, 0, s>>>(
        xt, part, (unsigned)((long long)(p.c / p.g) * p.hw));
    return (int)cudaGetLastError();
  }
  if (p.route == SPLIT_WARP && p.grid >= 1 && p.threads >= 32 &&
      p.threads <= SPLIT_NT && p.threads % 32 == 0) {
    gn_partials_warp_kernel<T, VEC><<<p.grid, p.threads, 0, s>>>(p, xt,
                                                                 part);
    return (int)cudaGetLastError();
  }
  if (p.route != SPLIT_BLOCK || p.threads != SPLIT_NT || p.cluster < 1 ||
      p.cluster > SPLIT_MAX_CLUSTER || p.grid != NG * p.cluster ||
      p.slice < VEC || p.slice % VEC != 0)
    return (int)cudaErrorInvalidValue;
  if (p.cluster == 1) {
    gn_partials_block_kernel<T, VEC, false><<<p.grid, SPLIT_NT, 0, s>>>(
        p, xt, part);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(SPLIT_NT);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_partials_block_kernel<T, VEC, true>, p, xt, part);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int run_apply(const ApplyPlan& p, const void* x, const void* scale,
              const void* bias, const float* part, void* y, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (p.route == SPLIT_ELEMENT || !aligned16(x) || !aligned16(y)) {
    const long long NG = (long long)p.n * p.g;
    const unsigned M = (unsigned)((long long)(p.c / p.g) * p.hw);
    constexpr unsigned CHUNK = SPLIT_UNROLL * SPLIT_NT;
    const dim3 grid((M + CHUNK - 1) / CHUNK, (unsigned)NG);
    gn_apply_element_kernel<T><<<grid, SPLIT_NT, 0, s>>>(
        static_cast<const T*>(x), scale, bias,
        p.w_dtype == sdv::kBFloat16, part, p.parts, NG, static_cast<T*>(y),
        M, (unsigned)p.hw, p.c / p.g, p.g, p.eps, p.silu);
    return (int)cudaGetLastError();
  }
  if (p.route != SPLIT_TILE || p.tiles < 1 || p.tiles > 0x7fffffffLL ||
      p.rows < 1 || p.rows > SPLIT_NT || p.cols < VEC || p.cols % VEC != 0)
    return (int)cudaErrorInvalidValue;
  gn_apply_tile_kernel<T, VEC><<<(unsigned)p.tiles, SPLIT_NT, 0, s>>>(
      p, static_cast<const T*>(x), scale, bias, part, static_cast<T*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

// sizeof(PartialsPlan) (which 0) or sizeof(ApplyPlan) (which 1): the
// wrapper's structs are checked against them when it builds a plan
extern "C" int sdv_groupnorm_split_plan_bytes(int which) {
  return which == 0 ? (int)sizeof(PartialsPlan) : (int)sizeof(ApplyPlan);
}

// plan: a PartialsPlan; x: (N, C, HW) contiguous (a rank's slab);
// partials: (N, G, 3) fp32 (count, mean, M2 of each group's run).  One
// kernel launch.  Returns a cudaError_t value (0 = launched).
extern "C" int sdv_groupnorm_partials(const void* plan, const void* x,
                                      void* partials, void* stream) {
  const PartialsPlan& p = *static_cast<const PartialsPlan*>(plan);
  if (!split_shape_ok(p.n, p.c, p.hw, p.g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (p.dtype == sdv::kFloat32) return run_partials<float>(p, x, part, s);
  if (p.dtype == sdv::kBFloat16)
    return run_partials<__nv_bfloat16>(p, x, part, s);
  return (int)cudaErrorInvalidValue;
}

// plan: an ApplyPlan; x, y: (N, C, HW) contiguous, one dtype; scale, bias:
// (C,) of the plan's w_dtype; partials: (P, N, G, 3) fp32, rank p's at p.
// One kernel launch.
extern "C" int sdv_groupnorm_apply(const void* plan, const void* x,
                                   const void* scale, const void* bias,
                                   const void* partials, void* y,
                                   void* stream) {
  const ApplyPlan& p = *static_cast<const ApplyPlan*>(plan);
  if (!split_shape_ok(p.n, p.c, p.hw, p.g) || p.parts < 1 ||
      (p.w_dtype != sdv::kFloat32 && p.w_dtype != sdv::kBFloat16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* part = static_cast<const float*>(partials);
  if (p.dtype == sdv::kFloat32)
    return run_apply<float>(p, x, scale, bias, part, y, s);
  if (p.dtype == sdv::kBFloat16)
    return run_apply<__nv_bfloat16>(p, x, scale, bias, part, y, s);
  return (int)cudaErrorInvalidValue;
}
