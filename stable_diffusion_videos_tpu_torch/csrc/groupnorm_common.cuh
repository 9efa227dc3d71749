// Helpers shared by the GroupNorm kernels (groupnorm.cu, the forward, and
// groupnorm_backward.cu): Welford/Chan moments merged across a warp and a
// block, 16-byte vectors of the activation type, and TMA bulk copies (no
// tensor map) between device and shared memory.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace sdv {

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

inline long long round_up(long long a, long long m) { return (a + m - 1) / m * m; }

}  // namespace sdv
