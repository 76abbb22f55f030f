// Shared helpers for the lm2a_tpu_torch CUDA kernels (plain C interface,
// loaded with ctypes; no PyTorch headers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as JAX's astype(bfloat16)
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 consecutive values -> fp32 registers (16-byte aligned source)
__device__ __forceinline__ void load16(const bf16* p, float* v) {
  uint4 u[2];
  u[0] = reinterpret_cast<const uint4*>(p)[0];
  u[1] = reinterpret_cast<const uint4*>(p)[1];
  const bf16* h = reinterpret_cast<const bf16*>(u);
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ void load16(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q + 0] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// 8 consecutive values -> fp32 registers (16-byte aligned bf16, 32-byte fp32)
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
