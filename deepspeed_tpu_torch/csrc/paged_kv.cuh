// The paged KV pool's layouts, shared by the paged attention kernels
// (paged_decode_attention.cu, B4; paged_verify_attention.cu, B5): the
// kv_mode codes and the int8 / nibble-packed int4 element decoders.
//
// An int4 byte j of a K/V row holds dim j in its low nibble and dim j + Dh/2
// in its high one (ops/cuda/int8_matmul.py pack_int4), sign-extended by
// xor-sub. Each library is built from one .cu file, so the unnamed namespace
// gives each its own copy.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// pool layouts; the values are the kv_mode codes passed from Python
enum KvMode : int { kDense = 0, kInt4 = 4, kInt8 = 8 };

__device__ __forceinline__ int byte_at(unsigned w, int j) {  // sign-extended byte j of w
  return static_cast<int>(w << (24 - 8 * j)) >> 24;
}

__device__ __forceinline__ int low_nibble(int b) { return ((b & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int high_nibble(int b) { return (((b >> 4) & 0xF) ^ 8) - 8; }

// Load 16 int8 values at p (16-byte aligned) as sign-extended ints.
__device__ __forceinline__ void load16_s8(const int8_t* p, int* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * i + j] = byte_at(w[i], j);
}

}  // namespace
