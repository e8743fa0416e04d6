// Device helpers shared by the port's LSTM kernels (lstm_fused.cu, lstm_train.cu).
//
// One definition of the casts and of the cell's sigmoid for every kernel, and
// the column dot product of K4's reverse walk (the recurrence K1/K2/K3/K5/K6
// share computes its product in lstm_cluster.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Round through the compute dtype T and back (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Dot product of a staged f32 row (smem) with column j of a (rows, g4) matrix.
template <typename T>
__device__ __forceinline__ float dot_col(const float* __restrict__ row,
                                         const T* __restrict__ w, int rows,
                                         int g4, int j) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < rows; ++k) {
    acc = fmaf(row[k], to_f32<T>(w[(size_t)k * g4 + j]), acc);
  }
  return acc;
}

// Threads per recurrence block: one per gate column, at most 1024.
inline int gate_threads(int hidden) {
  int threads = ((4 * hidden + 31) / 32) * 32;
  return threads > 1024 ? 1024 : threads;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
