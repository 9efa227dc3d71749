// Backward of GroupNorm (+ optional SiLU) for Hopper (sm_90a), NCHW.
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
// What bounds it: bytes (a few tens of operations an element against x and
// dout read and dx written).  The group's statistics are recomputed in fp32,
// as the forward takes them.  Each channel of each item is cut into parts of
// at most 4096 pixels, one block a part, so a batch-1 VAE group of 4 × 512²
// pixels still spreads over 256 blocks:
//
//   1. stats_kernel: a part's count, mean and centred sum of squares;
//   2. merge_kernel: a thread an (item, group) merges its parts in a fixed
//      order (Chan's formula) into mean and rstd;
//   3. reduce_kernel: a part's Σ g·x̂ and Σ g (per channel, so they serve
//      dγ/dβ and, times γ[c], the group sums at once);
//   4. sums_kernel: the group sums of g·γ and g·γ·x̂, and dγ, dβ summed over
//      items and parts;
//   5. dx_kernel: dx.
//
// No atomics: every sum is taken in a fixed order, so the gradients are the
// same bit for bit from run to run.  x is read three times and dout twice;
// fusing the passes is later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kPart = 4096;  // pixels of one block's part

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  return total;
}

struct Part {
  long long base, begin, end;  // run offset of (n, c); pixel range
};

__device__ __forceinline__ Part part_of(int C, long long HW) {
  const int p = blockIdx.x, c = blockIdx.y, n = blockIdx.z;
  Part r;
  r.base = ((long long)n * C + c) * HW;
  r.begin = p * kPart;
  r.end = min(HW, r.begin + kPart);
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int C,
                 long long HW, int P) {
  __shared__ float red[kThreads / 32];
  const Part pt = part_of(C, HW);
  const float cnt = (float)(pt.end - pt.begin);
  float s = 0.f;
  for (long long e = pt.begin + threadIdx.x; e < pt.end; e += kThreads)
    s += sdv::to_f32(x[pt.base + e]);
  const float mean = block_sum(s, red) / cnt;
  float m2 = 0.f;
  for (long long e = pt.begin + threadIdx.x; e < pt.end; e += kThreads) {
    const float d = sdv::to_f32(x[pt.base + e]) - mean;
    m2 += d * d;
  }
  m2 = block_sum(m2, red);
  if (threadIdx.x == 0) {
    const long long part = ((long long)blockIdx.z * C + blockIdx.y) * P;
    float* out = stats + (part + blockIdx.x) * 3;
    out[0] = cnt, out[1] = mean, out[2] = m2;
  }
}

// mean and rstd of each (item, group), from its channels' parts in order
__global__ void merge_kernel(const float* __restrict__ stats,
                             float* __restrict__ group_stats, int N, int C,
                             int G, int P, float eps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N * G) return;
  const int n = t / G, g = t % G, cpg = C / G;
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  for (int c = g * cpg; c < (g + 1) * cpg; ++c)
    for (int p = 0; p < P; ++p) {
      const float* s = stats + (((long long)n * C + c) * P + p) * 3;
      const float nb = s[0], tot = cnt + nb, delta = s[1] - mean;
      mean += delta * (nb / tot);
      m2 += s[2] + delta * delta * (cnt * nb / tot);
      cnt = tot;
    }
  group_stats[2 * t] = mean;
  group_stats[2 * t + 1] = rsqrtf(m2 / cnt + eps);
}

// g (the cotangent of y) and x̂ of one element
template <typename T>
__device__ __forceinline__ void grad_y(const T* x, const T* dy, long long i,
                                       float mean, float rstd, float gamma,
                                       float beta, int silu, float& g,
                                       float& xhat) {
  xhat = (sdv::to_f32(x[i]) - mean) * rstd;
  g = sdv::to_f32(dy[i]);
  if (silu) {
    const float y = fmaf(xhat, gamma, beta);
    const float sig = 1.f / (1.f + __expf(-y));
    g *= sig * (1.f + y * (1.f - sig));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ group_stats,
                  float* __restrict__ parts, int C, long long HW, int G,
                  int P, int silu) {
  __shared__ float red[kThreads / 32];
  const Part pt = part_of(C, HW);
  const int c = blockIdx.y, n = blockIdx.z;
  const int ng = n * G + c / (C / G);
  const float mean = group_stats[2 * ng], rstd = group_stats[2 * ng + 1];
  const float gamma = scale[c], beta = bias[c];
  float sg = 0.f, sgx = 0.f;
  for (long long e = pt.begin + threadIdx.x; e < pt.end; e += kThreads) {
    float g, xhat;
    grad_y(x, dy, pt.base + e, mean, rstd, gamma, beta, silu, g, xhat);
    sg += g;
    sgx += g * xhat;
  }
  sg = block_sum(sg, red);
  sgx = block_sum(sgx, red);
  if (threadIdx.x == 0) {
    float* out = parts + (((long long)n * C + c) * P + blockIdx.x) * 2;
    out[0] = sgx, out[1] = sg;
  }
}

// threads t < N·G: the group sums of g·γ and g·γ·x̂; threads t < C: dγ and
// dβ of channel t over items and parts
__global__ void sums_kernel(const float* __restrict__ parts,
                            const float* __restrict__ scale,
                            float* __restrict__ group_sums,
                            float* __restrict__ dscale,
                            float* __restrict__ dbias, int N, int C, int G,
                            int P) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < N * G) {
    const int n = t / G, g = t % G, cpg = C / G;
    float a = 0.f, b = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      float sg = 0.f, sgx = 0.f;
      for (int p = 0; p < P; ++p) {
        const float* s = parts + (((long long)n * C + c) * P + p) * 2;
        sgx += s[0];
        sg += s[1];
      }
      a += scale[c] * sg;
      b += scale[c] * sgx;
    }
    group_sums[2 * t] = a;
    group_sums[2 * t + 1] = b;
  }
  if (t < C) {
    float dg = 0.f, db = 0.f;
    for (int n = 0; n < N; ++n)
      for (int p = 0; p < P; ++p) {
        const float* s = parts + (((long long)n * C + t) * P + p) * 2;
        dg += s[0];
        db += s[1];
      }
    dscale[t] = dg;
    dbias[t] = db;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ scale, const float* __restrict__ bias,
              const float* __restrict__ group_stats,
              const float* __restrict__ group_sums, T* __restrict__ dx, int C,
              long long HW, int G, int silu) {
  const Part pt = part_of(C, HW);
  const int c = blockIdx.y, n = blockIdx.z;
  const int ng = n * G + c / (C / G);
  const float mean = group_stats[2 * ng], rstd = group_stats[2 * ng + 1];
  const float inv_m = 1.f / (float)((long long)(C / G) * HW);
  const float mean_a = group_sums[2 * ng] * inv_m;
  const float mean_b = group_sums[2 * ng + 1] * inv_m;
  const float gamma = scale[c], beta = bias[c];
  for (long long e = pt.begin + threadIdx.x; e < pt.end; e += kThreads) {
    float g, xhat;
    grad_y(x, dy, pt.base + e, mean, rstd, gamma, beta, silu, g, xhat);
    dx[pt.base + e] =
        sdv::from_f32<T>(rstd * (g * gamma - mean_a - xhat * mean_b));
  }
}

long long num_parts(long long HW) { return (HW + kPart - 1) / kPart; }

template <typename T>
int run(const void* x, const void* dy, const float* scale, const float* bias,
        void* dx, float* dscale, float* dbias, float* scratch, int N, int C,
        long long HW, int G, float eps, int silu, cudaStream_t stream) {
  const int P = (int)num_parts(HW);
  float* stats = scratch;                              // N·C·P·3
  float* parts = stats + (long long)N * C * P * 3;     // N·C·P·2
  float* group_stats = parts + (long long)N * C * P * 2;  // N·G·2
  float* group_sums = group_stats + (long long)N * G * 2;  // N·G·2
  const T* tx = static_cast<const T*>(x);
  const T* tdy = static_cast<const T*>(dy);
  const dim3 grid(P, C, N);
  stats_kernel<T><<<grid, kThreads, 0, stream>>>(tx, stats, C, HW, P);
  const int ng = N * G, wide = ng > C ? ng : C;
  merge_kernel<<<(ng + 127) / 128, 128, 0, stream>>>(stats, group_stats, N, C,
                                                     G, P, eps);
  reduce_kernel<T><<<grid, kThreads, 0, stream>>>(
      tx, tdy, scale, bias, group_stats, parts, C, HW, G, P, silu);
  sums_kernel<<<(wide + 127) / 128, 128, 0, stream>>>(
      parts, scale, group_sums, dscale, dbias, N, C, G, P);
  dx_kernel<T><<<grid, kThreads, 0, stream>>>(
      tx, tdy, scale, bias, group_stats, group_sums, static_cast<T*>(dx), C,
      HW, G, silu);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 scratch floats a call needs
extern "C" long long sdv_groupnorm_backward_scratch(int N, int C,
                                                    long long HW, int G) {
  return (long long)N * C * num_parts(HW) * 5 + (long long)N * G * 4;
}

// x, dy, dx: (N, C, HW) contiguous, one dtype (f32 or bf16); scale, bias:
// (C,) fp32; dscale, dbias: (C,) fp32 out; scratch: fp32 of
// sdv_groupnorm_backward_scratch floats.  Returns a cudaError_t value (0 =
// launched).  Five kernel launches.
extern "C" int sdv_groupnorm_silu_backward(const void* x, const void* dy,
                                           const float* scale,
                                           const float* bias, void* dx,
                                           float* dscale, float* dbias,
                                           float* scratch, int N, int C,
                                           long long HW, int G, float eps,
                                           int silu, int dtype,
                                           void* stream) {
  if (N < 1 || C < 1 || HW < 1 || G < 1 || C % G != 0 || C > 65535 ||
      N > 65535 || num_parts(HW) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sdv::kFloat32)
    return run<float>(x, dy, scale, bias, dx, dscale, dbias, scratch, N, C,
                      HW, G, eps, silu, s);
  if (dtype == sdv::kBFloat16)
    return run<__nv_bfloat16>(x, dy, scale, bias, dx, dscale, dbias, scratch,
                              N, C, HW, G, eps, silu, s);
  return (int)cudaErrorInvalidValue;
}
