// Helpers shared by the port's CUDA kernels: element types, 16-byte vector
// loads converted to fp32, and the C entry point that names a CUDA error.
//
// Every kernel library is built from one .cu file by nvcc into its own shared
// object with a plain C interface (deepspeed_tpu_torch/ops/_build.py), so
// each .cu that includes this header gets its own copy of ds_error_string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ds {

// dtype codes passed from Python (ops/cuda/*.py: _DTYPE_CODE)
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// the finite "minus infinity" the reference kernels mask with
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Elements of T in one 16-byte load.
template <typename T> struct Vec16 {
  static constexpr int n = 16 / sizeof(T);
};

// Load 16 bytes at p (16-byte aligned) and widen them to fp32 in out[0..n).
template <typename T> __device__ __forceinline__ void load16(const T* p, float* out);

template <> __device__ __forceinline__ void load16<float>(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}

template <> __device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                  float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: the low half is the lower element
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <> __device__ __forceinline__ void load16<__half>(const __half* p, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] & 0xffffu)));
    out[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace ds

extern "C" const char* ds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
