// Tensor-map (TMA) helpers shared by the attention kernels
// (flash_attention.cu, attention_backward.cu): the device-side tiled loads
// and the host-side encoding of the maps they read.
//
// cuTensorMapEncodeTiled is a driver-API function.  It is fetched through
// the runtime's cudaGetDriverEntryPoint, so the library links nothing but
// the CUDA runtime that nvcc adds (no -lcuda).  Every bf16 tile is loaded
// in boxes 16 columns (32 bytes) wide under the 32-byte swizzle, the layout
// every wgmma descriptor of these kernels reads (desc_b32 in wgmma.cuh).
#pragma once

// cuda.h for CUtensorMap and its enums (types only; see encode_tiled)
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace sdv {

// one box of a 2-, 3- or 4-dimensional tensor map into shared memory,
// completing on an mbarrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// fetched once, by whichever host thread calls first (a thread-safe static)
inline EncodeTiled encode_tiled() {
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

// a tensor map of `rank` dimensions (dims[0] contiguous; strides in bytes
// of dims 1..rank-1), zero fill out of bounds
inline int encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
                  const void* ptr, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box,
                  CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, type, (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides,
         box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a (B, S, H, D) bf16 tensor as dims (D, H, S, B), loaded in boxes of 16
// columns × rows positions (one head, one item)
inline int encode_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                      int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)rows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides,
                box, CU_TENSOR_MAP_SWIZZLE_32B);
}

// `mats` row-major bf16 matrices of rows × cols (row stride `ld`
// elements, a multiple of 8) as dims (cols, rows, mats), in boxes of 16
// columns × box_rows rows
inline int encode_matrices(CUtensorMap* map, const void* ptr, int cols,
                           int ld, int rows, int mats, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2,
                                 (cuuint64_t)ld * rows * 2};
  const cuuint32_t box[3] = {16, (cuuint32_t)box_rows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides,
                box, CU_TENSOR_MAP_SWIZZLE_32B);
}

// `rows` fp32 vectors of n values (row stride `ld` values, a multiple of
// 4) as dims (n, rows), in boxes of `box` values of one row, unswizzled
inline int encode_rows_f32(CUtensorMap* map, const float* ptr, int n, int ld,
                           int rows, int box) {
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t boxd[2] = {(cuuint32_t)box, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, dims, strides,
                boxd, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The tensor-map encoder is a driver call, and needs a context current on
// the calling host thread.  A runtime call makes the device's primary
// context current, but a thread whose first kernel is one of these may have
// made none (PyTorch's allocator serves tensors without a CUDA call), and
// the encoder then fails with an invalid value: measured on the card, every
// bf16 attention call of a fresh thread failed until the thread launched
// another kernel.  So the device of `ptr` is made current here first, once
// a thread and device.
inline int bind_device(const void* ptr) {
  thread_local int bound = -1;
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err == cudaSuccess && attr.device != bound) {
    err = cudaSetDevice(attr.device);
    if (err == cudaSuccess) bound = attr.device;
  }
  return (int)err;
}

// row stride (fp32 values) of the per-row statistics of the attention
// backward (the forward's log-sum-exp, D_i): Sq rounded up to 4, so every
// row starts on 16 bytes, as a tensor map's strides must
__host__ __device__ inline int stat_ld(int Sq) { return (Sq + 3) & ~3; }

}  // namespace sdv
