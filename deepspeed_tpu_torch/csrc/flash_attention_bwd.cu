// Flash-attention backward's delta pass for Hopper (sm_90a) on the CUDA
// cores, every dtype; plain C interface.
//
// Replaces the TPU kernel _bwd_delta_kernel of
// deepspeed_tpu/ops/pallas/flash_attention.py (_bwd, the pallas_call at
// :277): delta = rowsum(dO * O) in fp32, [B*H, T], which the dq and dk/dv
// passes read (csrc/flash_attention_bwd_tf32.cu for fp32 inputs, on the
// tensor cores as 3xTF32; csrc/flash_attention_bwd_tc.cu for bf16 / fp16).
//
// Work split: one block (4 warps) per (b*h, 64-row tile); a warp reduces one
// row at a time with shuffles. o and dO are read through their strides (the
// last dimension contiguous).
//
// What bounds it on the H100: it reads o and dO once and writes delta (at
// the GPT-2-125M training shape B8, T512, H12, D64 in bf16 ~12.6 MB, 3.8 us
// at 3.35 TB/s; two flops an element are nothing beside): byte-bound, and a
// reduction this small needs no tensor cores.

#include "common.cuh"

namespace {

constexpr int kTile = 64;  // rows a block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int H, int T_,
                       long long o_sb, long long o_st, long long o_sh,
                       long long d_sb, long long d_st, long long d_sh) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* ob = o + b * o_sb + h * o_sh;
  const T* db = dout + b * d_sb + h * d_sh;
  for (int i = warp; i < kTile; i += kWarps) {
    const int t = blockIdx.y * kTile + i;
    if (t >= T_) break;  // uniform across the warp
    float acc = 0.f;
#pragma unroll
    for (int dd = 0; dd < D / 32; ++dd) {
      const int d = lane + 32 * dd;
      acc = fmaf(ds::to_float(ob[t * o_st + d]), ds::to_float(db[t * d_st + d]), acc);
    }
    acc = ds::warp_sum(acc);
    if (lane == 0) delta[(long long)bh * T_ + t] = acc;
  }
}

struct Args {
  const void *o, *dout;
  float* delta;
  int B, H, T;
  long long o_sb, o_st, o_sh, d_sb, d_st, d_sh;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_delta(const Args& a) {
  const dim3 grid(a.B * a.H, (a.T + kTile - 1) / kTile);
  flash_bwd_delta_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.H, a.T,
      a.o_sb, a.o_st, a.o_sh, a.d_sb, a.d_st, a.d_sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const Args& a) {
  if (D == 64) return launch_delta<T, 64>(a);
  if (D == 96) return launch_delta<T, 96>(a);
  if (D == 128) return launch_delta<T, 128>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// delta = rowsum(dO * O) (the counterpart of _bwd_delta_kernel): o and dO
// [B, T, H, D] given by element strides (batch, seq, head; the last dimension
// contiguous), dtype 0 (fp32), 1 (bf16) or 2 (fp16), D 64, 96 or 128; delta
// [B*H, T] fp32 contiguous. Launches one kernel on `stream` and returns the
// CUDA error code of the launch (0 on success).
extern "C" int ds_flash_attention_bwd_delta(const void* o, const void* dout, float* delta,
                                            int B, int H, int T, int D, int dtype,
                                            long long o_sb, long long o_st, long long o_sh,
                                            long long d_sb, long long d_st, long long d_sh,
                                            void* stream) {
  const Args a{o, dout, delta, B, H, T, o_sb, o_st, o_sh, d_sb, d_st, d_sh,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case ds::kF32: return dispatch_dim<float>(D, a);
    case ds::kBF16: return dispatch_dim<__nv_bfloat16>(D, a);
    case ds::kF16: return dispatch_dim<__half>(D, a);
    default: return cudaErrorInvalidValue;
  }
}
