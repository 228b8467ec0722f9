// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Element types: float (f32) and __nv_bfloat16 (bf16). Every kernel loads
// its inputs into f32, accumulates in f32 and rounds once on store, the
// way the TPU kernels do (preferred_element_type=f32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wfl {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Exact (erf) GELU in f32, as torch ``F.gelu`` without approximation.
__device__ __forceinline__ float gelu_f(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel into dynamic shared memory above 48 KB, then launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace wfl

extern "C" const char* wfl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
