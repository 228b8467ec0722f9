// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Element types: float (f32) and __nv_bfloat16 (bf16). Every kernel loads
// its inputs into f32, accumulates in f32 and rounds once on store, the
// way the TPU kernels do (preferred_element_type=f32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// K6: attention-probability dropout, the hash of
// wfl_asr_tpu/ops/pallas/dropout_mask.py:uniform24 (:65) and keep_mask_f32
// (:88), bit for bit. The JAX code hashes in int32 with its arithmetic
// shifts masked, which is uint32 arithmetic with logical shifts; here all of
// it is uint32 (signed overflow would be undefined). ``seed`` points at one
// int32 on the device (null: no dropout); the threshold and the f32 scale
// are computed on the host (dropout_mask.keep_threshold, keep_scale).
struct Dropout {
  const int* seed;
  int thr;       // keep iff u24 >= thr
  float scale;   // float32(1 / (1 - rate))
};

constexpr uint32_t kDropCQ = 0x9E3779B1u, kDropCK = 0x85EBCA77u,
                   kDropCB = 0x27D4EB2Fu, kDropCH = 0x165667B1u,
                   kDropM1 = 0x7FEB352Du, kDropM2 = 0x846CA68Bu;

// seed + b·C_B + h·C_H: the part of the pre-mix a (b, h) block shares
__device__ __forceinline__ uint32_t drop_base(const Dropout& d, int b, int h) {
  return static_cast<uint32_t>(*d.seed) + static_cast<uint32_t>(b) * kDropCB
       + static_cast<uint32_t>(h) * kDropCH;
}

// 0 or scale for absolute query q and key k
__device__ __forceinline__ float drop_keep(const Dropout& d, uint32_t base,
                                           int q, int k) {
  uint32_t u = static_cast<uint32_t>(q) * kDropCQ
             + static_cast<uint32_t>(k) * kDropCK + base;
  u ^= u >> 13;
  u *= kDropM1;
  u ^= u >> 17;
  u *= kDropM2;
  u ^= u >> 16;
  return (u & 0xFFFFFFu) >= static_cast<uint32_t>(d.thr) ? d.scale : 0.f;
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
