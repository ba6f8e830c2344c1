// Device helpers shared by the decode-step kernels (whole_decode.cu,
// fused_step.cu): dtype conversions, the storage-type rounding that mirrors
// the Pallas casts, the sigmoid, and the read of a batch-row vector kept in
// shared memory as [k][TB] f32.

#pragma once

#include <cuda_bf16.h>

namespace recnet {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// f32 value rounded to the storage type, kept in f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// the N (4 or 8) row values at p, 16-byte aligned: one column of a
// [k][TB] shared-memory matrix, or half of it
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float v[N]) {
  static_assert(N == 4 || N == 8, "rows are read 4 or 8 at a time");
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  if constexpr (N == 8) {
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

}  // namespace recnet
