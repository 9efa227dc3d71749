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

namespace cg = cooperative_groups;

namespace {

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

struct Moments {
  float n, mean, m2;
};

__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float delta = b.mean - a.mean;
  const float wb = __fdividef(b.n, n);
  return {n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ Moments warp_merge(Moments v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Moments o;
    o.n = __shfl_down_sync(0xffffffffu, v.n, off);
    o.mean = __shfl_down_sync(0xffffffffu, v.mean, off);
    o.m2 = __shfl_down_sync(0xffffffffu, v.m2, off);
    v = merge(v, o);
  }
  return v;  // valid in lane 0
}

template <int NT>
__device__ Moments block_merge(Moments v) {
  __shared__ Moments warp_part[NT / 32];
  v = warp_merge(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0)
    v = warp_merge(lane < NT / 32 ? warp_part[lane] : Moments{0.f, 0.f, 0.f});
  return v;  // valid in thread 0
}

// VEC elements of T moved as one unit: a 16-byte vector, or one element
// where the run is not 16-byte aligned
template <typename T, int VEC>
struct Pack {
  using Raw = typename std::conditional<VEC == 1, T, uint4>::type;
  static_assert(sizeof(Raw) == VEC * sizeof(T), "one vector");
  __device__ static void unpack(const Raw& r, float (&f)[VEC]) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = sdv::to_f32(e[i]);
  }
  __device__ static Raw pack(const float (&f)[VEC]) {
    Raw r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = sdv::from_f32<T>(f[i]);
    return r;
  }
};

// exact mean and centred sum of squares of one vector, merged into v
template <int VEC>
__device__ __forceinline__ void add_vector(Moments& v, const float (&f)[VEC]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s += f[i];
  const float mu = s * (1.f / VEC);
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) m2 = fmaf(f[i] - mu, f[i] - mu, m2);
  v = merge(v, Moments{(float)VEC, mu, m2});
}

// Bulk copies without a tensor map (TMA): global -> shared completing on an
// mbarrier, shared -> global in a bulk group.  Sizes are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sdv::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sdv::smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst), "r"(sdv::smem_u32(src)), "r"(bytes) : "memory");
}

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


long long round_up(long long a, long long m) { return (a + m - 1) / m * m; }

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
