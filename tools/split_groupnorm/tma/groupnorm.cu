// The split-statistics GroupNorm (+ optional SiLU) on TMA bulk copies: the
// design first built for Hopper, kept beside the shipped kernels
// (stable_diffusion_videos_tpu_torch/csrc/groupnorm.cu, split section) so
// that the two can be timed against one another on the card.  It is not
// part of the port: tools/split_groupnorm/compare.py builds it alone and
// calls it through the argument-list entry points the split kernels had
// before the launch plans (the same signatures as the parent commit's),
// so that one script times the parent, this design and the shipped one.
//
// The design:
//
// * Partials.  A run of at most 4 KB goes to one warp: the warp's lane 0
//   copies whole runs by cp.async.bulk into the warp's two shared-memory
//   slots, each completing on its own mbarrier, the next run arriving
//   while the lanes take this one's moments and merge them by shuffles.
//   A longer run is streamed by a block, or split over a cluster of up to
//   8 blocks when there are fewer runs than SMs, each block's slice moving
//   by 16 KB bulk copies into a ring of 4 slots on full/empty mbarriers;
//   the blocks' partials merge through distributed shared memory in block
//   order.  The grid holds as many blocks as are resident on the card at
//   once and loops over the runs, so the next run's copies are in flight
//   while a run is merged.  The partials' copies carry an L2 evict_last
//   hint: the apply pass reads the slab again.
// * Apply.  Tiles of whole channel rows, or of one channel's columns, as
//   the shipped kernel's; a persistent grid loops over them.  Each tile's
//   coefficients a = rstd·scale[c], b = bias[c] − mean·a are folded once
//   into shared memory from the P partials merged in rank order; the tile
//   moves by 16 KB bulk copies (whole rows where a row fits) into a ring
//   of 4 slots, is normalised (+ SiLU) in place and leaves by bulk stores,
//   while the next chunks load.  Its copies carry an L2 evict_first hint.
//   (Back to back, a small slab is found in L2 whatever the hints say;
//   they can show only in a dispatch.)
//
// No atomics and fixed merge orders, as in the shipped kernels.  Rows that
// are not 16-byte aligned are refused (cudaErrorInvalidValue): the shipped
// kernels' element route covers them.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "groupnorm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using sdv::add_vector;
using sdv::Moments;
using sdv::Pack;

constexpr int NT = 256;                  // threads a block
constexpr int NW = NT / 32;              // warps a block
constexpr int STAGES = 4;                // slots of a block's ring
constexpr unsigned CHUNK = 16 << 10;     // bytes of one bulk copy
constexpr unsigned WARP_RUN = 4 << 10;   // largest run a warp takes
constexpr long long MIN_SLICE = 32 << 10;  // least bytes a cluster block
constexpr int MAX_CLUSTER = 8;
constexpr long long APPLY_TILE = 32 << 10;  // most bytes of an apply tile
constexpr int TILES_PER_SM = 4;
constexpr size_t RING_BYTES = (size_t)STAGES * CHUNK;
constexpr size_t WARP_BYTES = (size_t)NW * 2 * WARP_RUN;

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// global -> shared bulk copy completing on an mbarrier, with an L2 hint
__device__ __forceinline__ void load_hint(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  sdv::mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(sdv::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sdv::smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ float load_weight(const void* w, int c,
                                             int w_bf16) {
  return w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[c])
                : static_cast<const float*>(w)[c];
}

__device__ __forceinline__ void store_moments(float* part, long long run,
                                              Moments m) {
  float* o = part + 3 * run;
  o[0] = m.n;
  o[1] = m.mean;
  o[2] = m.m2;
}

// Partials, runs of at most WARP_RUN bytes: warp w of the grid takes runs
// w, w + warps, ...; lane 0 keeps the warp's next run in flight.
template <typename T>
__global__ void __launch_bounds__(NT)
    tma_partials_warp(const T* __restrict__ x, float* __restrict__ part,
                      long long NG, unsigned run_bytes) {
  using Raw = typename Pack<T, 16 / sizeof(T)>::Raw;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar[NW][2];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x < NW * 2)
    sdv::mbar_init(&bar[threadIdx.x >> 1][threadIdx.x & 1], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  unsigned char* slot = smem + (size_t)w * 2 * WARP_RUN;
  const long long first = (long long)blockIdx.x * NW + w;
  const long long stride = (long long)gridDim.x * NW;
  const uint64_t pol = policy_evict_last();
  const unsigned nvec = run_bytes / 16;
  const long long M = run_bytes / sizeof(T);
  if (lane == 0) {
    for (int s = 0; s < 2 && first + s * stride < NG; ++s)
      load_hint(slot + s * WARP_RUN, x + (first + s * stride) * M, run_bytes,
                &bar[w][s], pol);
  }
  int i = 0;
  for (long long r = first; r < NG; r += stride, ++i) {
    const int s = i & 1;
    sdv::mbar_wait(&bar[w][s], (i >> 1) & 1);
    const Raw* v = reinterpret_cast<const Raw*>(slot + s * WARP_RUN);
    Moments m{0.f, 0.f, 0.f};
    for (unsigned k = lane; k < nvec; k += 32) {
      float f[VEC];
      Pack<T, VEC>::unpack(v[k], f);
      add_vector(m, f);
    }
    __syncwarp();  // every lane has read the slot
    if (lane == 0 && r + 2 * stride < NG)
      load_hint(slot + s * WARP_RUN, x + (r + 2 * stride) * M, run_bytes,
                &bar[w][s], pol);
    m = sdv::warp_merge(m);
    if (lane == 0) store_moments(part, r, m);
  }
}

// Partials, longer runs: the grid's clusters (of cs blocks, 1 without
// CLUSTER) take runs q, q + clusters, ...; block `rank` of a cluster
// streams elements [rank·slice, rank·slice + slice) of each through its
// ring, thread 0 starting the copies.
template <typename T, bool CLUSTER>
__global__ void __launch_bounds__(NT)
    tma_partials_block(const T* __restrict__ x, float* __restrict__ part,
                       long long NG, long long M, long long slice) {
  using Raw = typename Pack<T, 16 / sizeof(T)>::Raw;
  constexpr int VEC = 16 / sizeof(T);
  constexpr long long CE = CHUNK / sizeof(T);  // elements a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  __shared__ Moments warp_part[NW];
  __shared__ Moments blk;  // this block's partial, read by block 0
  const unsigned rank = CLUSTER ? cg::this_cluster().block_rank() : 0;
  const unsigned cs = CLUSTER ? cg::this_cluster().num_blocks() : 1;
  const long long q0 = blockIdx.x / cs, nq = gridDim.x / cs;
  const long long start = min((long long)rank * slice, M);
  const long long len = min(start + slice, M) - start;
  const long long nc = (len + CE - 1) / CE;  // chunks a run's slice
  const long long runs = q0 < NG ? (NG - 1 - q0) / nq + 1 : 0;
  const long long total = runs * nc;
  if (threadIdx.x < STAGES) {
    sdv::mbar_init(&full[threadIdx.x], 1);
    sdv::mbar_init(&empty[threadIdx.x], NT);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const uint64_t pol = policy_evict_last();
  auto bytes_of = [&](long long j) {
    return (uint32_t)(min(CE, len - j * CE) * sizeof(T));
  };
  auto fetch = [&](long long k) {
    const long long r = q0 + (k / nc) * nq, j = k % nc;
    const int s = (int)(k % STAGES);
    load_hint(smem + (size_t)s * CHUNK, x + r * M + start + j * CE,
              bytes_of(j), &full[s], pol);
  };
  if (threadIdx.x == 0)
    for (long long k = 0; k < min((long long)STAGES, total); ++k) fetch(k);
  Moments m{0.f, 0.f, 0.f};
  for (long long k = 0; k < total; ++k) {
    const int s = (int)(k % STAGES), ph = (int)((k / STAGES) & 1);
    const long long j = k % nc;
    sdv::mbar_wait(&full[s], ph);
    const Raw* v = reinterpret_cast<const Raw*>(smem + (size_t)s * CHUNK);
    const unsigned nvec = bytes_of(j) / 16;
    for (unsigned i = threadIdx.x; i < nvec; i += NT) {
      float f[VEC];
      Pack<T, VEC>::unpack(v[i], f);
      add_vector(m, f);
    }
    sdv::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && k + STAGES < total) {
      sdv::mbar_wait(&empty[s], ph);
      fetch(k + STAGES);
    }
    if (j != nc - 1) continue;
    // the run's slice is done: merge the block, then the cluster
    Moments t = sdv::warp_merge(m);
    if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = t;
    __syncthreads();
    if (threadIdx.x < 32)
      t = sdv::warp_merge(threadIdx.x < NW ? warp_part[threadIdx.x]
                                           : Moments{0.f, 0.f, 0.f});
    const long long r = q0 + (k / nc) * nq;
    if (!CLUSTER) {
      if (threadIdx.x == 0) store_moments(part, r, t);
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0) blk = t;
      cluster.sync();  // every block's partial is in place
      if (rank == 0 && threadIdx.x == 0) {
        Moments a = blk;
        for (unsigned b = 1; b < cs; ++b)
          a = sdv::merge(a, *cluster.map_shared_rank(&blk, b));
        store_moments(part, r, a);
      }
      cluster.sync();  // `blk` outlives block 0's reads of it
    }
    __syncthreads();  // warp_part may be rewritten
    m = Moments{0.f, 0.f, 0.f};
  }
}

// the P ranks' partials of row ng merged in rank order -> (mean, rstd)
__device__ __forceinline__ float2 group_stats(const float* __restrict__ part,
                                              int P, long long NG,
                                              long long ng, float eps) {
  const float* q = part + 3 * ng;
  Moments t{q[0], q[1], q[2]};
  for (int r = 1; r < P; ++r) {
    const float* o = q + 3 * r * NG;
    t = sdv::merge(t, Moments{o[0], o[1], o[2]});
  }
  return make_float2(t.mean, rsqrtf(t.m2 / t.n + eps));
}

struct ApplyGeo {
  long long hw, tiles;
  int n, c, g, rows, cols, col_tiles, chan_tiles;
  long long chunk;  // elements a chunk: whole rows, or a piece of one row
};

// a tile's place: item, first channel, rows, first column, columns, and
// its first element
struct Tile {
  int n, c0, rows;
  long long j0, cols, start, elems, nchunks;
};

__device__ __forceinline__ Tile tile_of(const ApplyGeo& a, long long t) {
  Tile tl;
  const long long per_item = (long long)a.chan_tiles * a.col_tiles;
  tl.n = (int)(t / per_item);
  const long long rem = t - tl.n * per_item;
  tl.c0 = (int)(rem / a.col_tiles) * a.rows;
  tl.rows = min(a.rows, a.c - tl.c0);
  tl.j0 = rem % a.col_tiles * a.cols;
  tl.cols = min((long long)a.cols, a.hw - tl.j0);
  tl.start = ((long long)tl.n * a.c + tl.c0) * a.hw + tl.j0;
  tl.elems = tl.rows * tl.cols;
  tl.nchunks = (tl.elems + a.chunk - 1) / a.chunk;
  return tl;
}

// Apply: the grid's blocks take tiles b, b + gridDim.x, ...; thread 0
// keeps STAGES - 1 chunks loading ahead (across tiles) and stores each
// chunk in bulk once it is normalised in place.
template <typename T>
__global__ void __launch_bounds__(NT)
    tma_apply(const ApplyGeo a, const T* __restrict__ x,
              const void* __restrict__ scale, const void* __restrict__ bias,
              int w_bf16, const float* __restrict__ part, int P,
              T* __restrict__ y, float eps, int silu) {
  using Pk = Pack<T, 16 / sizeof(T)>;
  using Raw = typename Pk::Raw;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[STAGES];
  __shared__ float coef[2 * NT];  // a[rows], then b at NT
  if (threadIdx.x < STAGES) sdv::mbar_init(&full[threadIdx.x], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const uint64_t pol = policy_evict_first();
  const long long NG = (long long)a.n * a.g;
  // the producer's cursor (thread 0): tile and chunk of the next load
  long long pt = blockIdx.x, pj = 0, loaded = 0;
  Tile ptl = tile_of(a, pt);
  auto fetch = [&]() {
    const int s = (int)(loaded++ % STAGES);
    const long long off = pj * a.chunk;
    load_hint(smem + (size_t)s * CHUNK, x + ptl.start + off,
              (uint32_t)(min(a.chunk, ptl.elems - off) * sizeof(T)),
              &full[s], pol);
    if (++pj == ptl.nchunks) {
      pj = 0;
      pt += gridDim.x;
      if (pt < a.tiles) ptl = tile_of(a, pt);
    }
  };
  if (threadIdx.x == 0)
    for (int u = 0; u < STAGES - 1 && pt < a.tiles; ++u) fetch();
  long long k = 0;  // chunks consumed
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Tile tl = tile_of(a, t);
    // every thread is past the previous tile's last chunk (its barrier)
    float* const ca = coef;
    if (threadIdx.x < tl.rows) {
      const int c = tl.c0 + threadIdx.x;
      const float2 st = group_stats(part, P, NG,
                                    (long long)tl.n * a.g + c / (a.c / a.g),
                                    eps);
      const float av = st.y * load_weight(scale, c, w_bf16);
      ca[threadIdx.x] = av;
      ca[NT + threadIdx.x] = load_weight(bias, c, w_bf16) - st.x * av;
    }
    __syncthreads();
    const unsigned vpr = (unsigned)(tl.cols / VEC);  // vectors a row
    for (long long j = 0; j < tl.nchunks; ++j, ++k) {
      const int s = (int)(k % STAGES);
      const long long off = j * a.chunk;
      const long long elems = min(a.chunk, tl.elems - off);
      sdv::mbar_wait(&full[s], (int)((k / STAGES) & 1));
      Raw* v = reinterpret_cast<Raw*>(smem + (size_t)s * CHUNK);
      const unsigned nvec = (unsigned)(elems / VEC);
      // the chunk starts on a row (whole rows) or lies in row 0 (a piece)
      const unsigned row0 = (unsigned)(off / tl.cols);
      unsigned row = row0 + threadIdx.x / vpr, col = threadIdx.x % vpr;
      const unsigned step_rows = NT / vpr, step_cols = NT % vpr;
      for (unsigned i = threadIdx.x; i < nvec; i += NT) {
        const float av = ca[row], bv = ca[NT + row];
        float f[VEC];
        Pk::unpack(v[i], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          f[e] = fmaf(f[e], av, bv);
          if (silu) f[e] = __fdividef(f[e], 1.f + __expf(-f[e]));
        }
        v[i] = Pk::pack(f);
        row += step_rows;
        col += step_cols;
        if (col >= vpr) {
          col -= vpr;
          ++row;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // the chunk is normalised in place
      if (threadIdx.x == 0) {
        sdv::bulk_store(y + tl.start + off, v, (uint32_t)(elems * sizeof(T)));
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (pt < a.tiles) {
          // the slot of chunk k - 1, whose store has then read it
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          fetch();
        }
      }
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Built with -DSPLIT_TMA_PERSISTENT=0, each grid holds a block (a
// cluster) for every unit of work instead, so that the bulk copies can be
// timed apart from the persistent grids.
#ifndef SPLIT_TMA_PERSISTENT
#define SPLIT_TMA_PERSISTENT 1
#endif

// blocks of `kernel` the grid holds an SM: as many as are resident at
// `smem` dynamic bytes (persistent grids), or no limit
template <typename K>
long long per_sm(K kernel, size_t smem) {
  if (!SPLIT_TMA_PERSISTENT) return 1LL << 40;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, smem);
  return std::max(n, 1);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int prepare_t() {
  cudaError_t e = cudaSuccess;
  auto set = [&](const void* k, size_t bytes) {
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  };
  set((const void*)tma_partials_warp<T>, WARP_BYTES);
  set((const void*)tma_partials_block<T, false>, RING_BYTES);
  set((const void*)tma_partials_block<T, true>, RING_BYTES);
  set((const void*)tma_apply<T>, RING_BYTES);
  return (int)e;
}

template <typename T>
int run_partials(const void* xv, float* part, int N, int C, long long HW,
                 int G, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  const long long NG = (long long)N * G, M = (long long)(C / G) * HW;
  const long long run_bytes = M * (long long)sizeof(T);
  const int sms = sm_count();
  if (run_bytes <= WARP_RUN) {
    const long long blocks = std::min(
        (NG + NW - 1) / NW,
        sms * per_sm(tma_partials_warp<T>, WARP_BYTES));
    tma_partials_warp<T><<<(unsigned)blocks, NT, WARP_BYTES, s>>>(
        x, part, NG, (unsigned)run_bytes);
    return (int)cudaGetLastError();
  }
  long long cs = NG >= sms ? 1
                           : std::max(1LL, std::min<long long>(
                                               {(long long)MAX_CLUSTER,
                                                (2LL * sms + NG - 1) / NG,
                                                run_bytes / MIN_SLICE}));
  long long slice = ((M + cs - 1) / cs + VEC - 1) / VEC * VEC;
  cs = (M + slice - 1) / slice;
  const long long resident =
      sms * per_sm(tma_partials_block<T, false>, RING_BYTES);
  const long long clusters = std::max(1LL, std::min(NG, resident / cs));
  if (cs == 1) {
    tma_partials_block<T, false><<<(unsigned)clusters, NT, RING_BYTES, s>>>(
        x, part, NG, M, slice);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cs));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = RING_BYTES;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tma_partials_block<T, true>, x, part, NG, M, slice);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename T>
int run_apply(const void* x, const void* scale, const void* bias, int w_bf16,
              const float* part, int P, void* y, int N, int C, long long HW,
              int G, float eps, int silu, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const long long eb = sizeof(T), row_bytes = HW * eb;
  const int sms = sm_count();
  ApplyGeo a;
  a.hw = HW;
  a.n = N;
  a.c = C;
  a.g = G;
  if (row_bytes <= APPLY_TILE) {
    a.rows = (int)std::max(1LL, std::min<long long>(
                                    {APPLY_TILE / row_bytes, (long long)NT,
                                     (long long)C,
                                     ((long long)N * C + TILES_PER_SM * sms -
                                      1) / (TILES_PER_SM * sms)}));
    a.cols = (int)HW;
    a.col_tiles = 1;
  } else {
    a.rows = 1;
    const long long parts = (row_bytes + APPLY_TILE - 1) / APPLY_TILE;
    a.cols = (int)(((HW + parts - 1) / parts + VEC - 1) / VEC * VEC);
    a.col_tiles = (int)((HW + a.cols - 1) / a.cols);
  }
  a.chan_tiles = (C + a.rows - 1) / a.rows;
  a.tiles = (long long)N * a.chan_tiles * a.col_tiles;
  const long long ce = CHUNK / eb;
  a.chunk = a.cols * eb <= (long long)CHUNK ? ce / a.cols * a.cols : ce;
  const long long blocks = std::min(
      a.tiles, sms * per_sm(tma_apply<T>, RING_BYTES));
  tma_apply<T><<<(unsigned)blocks, NT, RING_BYTES, s>>>(
      a, static_cast<const T*>(x), scale, bias, w_bf16, part, P,
      static_cast<T*>(y), eps, silu);
  return (int)cudaGetLastError();
}

bool shape_ok(int N, int C, long long HW, int G, int elem) {
  return N >= 1 && C >= 1 && HW >= 1 && G >= 1 && C % G == 0 &&
         (HW * elem) % 16 == 0 && (long long)(C / G) * HW <= 0x7fffffffLL;
}

}  // namespace

// the kernels' shared-memory limits, set once before the first launch
extern "C" int sdv_prepare_groupnorm() {
  static const int err = [] {
    const int e = prepare_t<float>();
    return e ? e : prepare_t<__nv_bfloat16>();
  }();
  return err;
}

// x: (N, C, HW) contiguous; partials: (N, G, 3) fp32.  One launch.
extern "C" int sdv_groupnorm_partials(const void* x, void* partials, int N,
                                      int C, long long HW, int G, int dtype,
                                      void* stream) {
  const int elem = dtype == sdv::kBFloat16 ? 2 : 4;
  if ((dtype != sdv::kFloat32 && dtype != sdv::kBFloat16) ||
      !shape_ok(N, C, HW, G, elem) || !aligned16(x) ||
      sdv_prepare_groupnorm() != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (dtype == sdv::kFloat32)
    return run_partials<float>(x, part, N, C, HW, G, s);
  return run_partials<__nv_bfloat16>(x, part, N, C, HW, G, s);
}

// x, y: (N, C, HW) contiguous, one dtype; scale, bias: (C,) of w_dtype;
// partials: (P, N, G, 3) fp32, rank p's at p.  One launch.
extern "C" int sdv_groupnorm_apply(const void* x, const void* scale,
                                   const void* bias, int w_dtype,
                                   const void* partials, int P, void* y,
                                   int N, int C, long long HW, int G,
                                   float eps, int silu, int dtype,
                                   void* stream) {
  const int elem = dtype == sdv::kBFloat16 ? 2 : 4;
  if ((dtype != sdv::kFloat32 && dtype != sdv::kBFloat16) ||
      (w_dtype != sdv::kFloat32 && w_dtype != sdv::kBFloat16) || P < 1 ||
      !shape_ok(N, C, HW, G, elem) || !aligned16(x) ||
      !aligned16(y) || sdv_prepare_groupnorm() != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w_bf16 = w_dtype == sdv::kBFloat16;
  const float* part = static_cast<const float*>(partials);
  if (dtype == sdv::kFloat32)
    return run_apply<float>(x, scale, bias, w_bf16, part, P, y, N, C, HW, G,
                            eps, silu, s);
  return run_apply<__nv_bfloat16>(x, scale, bias, w_bf16, part, P, y, N, C,
                                  HW, G, eps, silu, s);
}
