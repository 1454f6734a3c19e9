// Dequant-fused matrix product over the quantized-wire format (B8) for
// Hopper (sm_90a), plain C interface:
//
//   out[M, F] = x[M, D] @ (q * scale + zero_point)[:, :F]
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/dequant_matmul.py:_kernel
// (dequant_matmul) for the shapes the tensor-core kernel
// (dequant_matmul_tc.cu) does not take: D off 64-row steps, and scale blocks
// off 64-column steps, which comm/quantized.py effective_block gives to rows
// shorter than the block or a user's zero_quantize_block_size sets (no
// preset's head has one at the default of 256) (dequant_matmul.py
// dqm_route). q is the uint8 [D, Fp] 8-bit payload of
// comm/quantized.py quantize_blockwise; scale and zero_point are fp32
// [D, nb], one affine pair per `block = Fp / nb` columns of a row (any block
// size: each column resolves its own block). F <= Fp is the unpadded width:
// columns at F and beyond are neither computed nor written. x (fp32, bf16 or
// fp16, row stride ldx) is read as fp32, the products accumulate in fp32
// (the reference's preferred_element_type), and the output is rounded once
// to x's dtype. Each weight is dequantized exactly as dequantize_blockwise
// does it, a rounded multiply then a rounded add (no fused multiply-add), so
// the kernel's weights are the plain version's bit for bit.
//
// What bounds it on the H100: operations. At the GPT-2-125M LM head's shape
// at B8 x T512 (x [4096, 768] fp32, q [768, 50432],
// F 50304), the product is 3.17e11 flops, 4.7 ms at the fp32 FMA peak of
// 67 TFLOP/s, while its bytes (mostly the 824 MB fp32 output) take 0.25 ms
// at 3.35 TB/s. The reference computes an fp32 product, which TF32 or a
// single bf16 pass would change; the tensor-core kernel keeps it with three
// bf16 passes and takes that shape (about 4.7x faster on the H100, PERF.md),
// and every shape with whole 64-column blocks at any number of rows, so this
// kernel serves the ragged ones.
//
// Design, right and simple first: a block of 256 threads owns a 128 x 128
// output tile and walks D in steps of 16. Each step stages a [128, 16] tile
// of x (transposed, fp32) and a [16, 128] tile of the weight, dequantized
// as it is staged, in shared memory; every thread then accumulates an 8 x 8
// register tile (rows ty*4.. and 64+ty*4.., columns tx*4.. and 64+tx*4..,
// read as float4) with fp32 FMAs. Ragged M, D and F tiles load zeros. The
// sum over D runs in one order inside one block, with no atomics and no
// split: a result is bitwise repeatable.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBM = 128;  // rows of x per block
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 16;   // D per shared-memory step
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dequant_matmul_kernel(const T* __restrict__ x, long long ldx, const uint8_t* __restrict__ q,
                      const float* __restrict__ scale, const float* __restrict__ zero_point,
                      T* __restrict__ out, int M, int D, int Fp, int nb, int F) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int block = Fp / nb;

  // x tile loads: row a_r, D offsets a_k .. a_k + 7 of each step
  const int a_r = tid / 2, a_k = (tid % 2) * 8;
  const bool a_row_ok = m0 + a_r < M;
  const T* x_row = x + (long long)(a_row_ok ? m0 + a_r : 0) * ldx;
  // weight tile loads: step row b_k, columns b_n .. b_n + 7, the same every
  // step, so each column's block index is resolved once (-1: past F)
  const int b_k = tid / 16, b_n = (tid % 16) * 8;
  int bcol[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + b_n + j;
    bcol[j] = n < F ? n / block : -1;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + a_k + i;
      As[a_k + i][a_r] = (a_row_ok && k < D) ? ds::to_float(x_row[k]) : 0.0f;
    }
    {
      const int k = k0 + b_k;
      const bool k_ok = k < D;
      const uint8_t* q_row = q + (long long)(k_ok ? k : 0) * Fp + n0 + b_n;
      const float* s_row = scale + (long long)(k_ok ? k : 0) * nb;
      const float* z_row = zero_point + (long long)(k_ok ? k : 0) * nb;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float w = 0.0f;
        if (k_ok && bcol[j] >= 0)
          w = __fadd_rn(__fmul_rn(static_cast<float>(q_row[j]), s_row[bcol[j]]),
                        z_row[bcol[j]]);
        Bs[b_k][b_n + j] = w;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
    T* o_row = out + (long long)m * F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < F) o_row[n] = ds::from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, long long ldx, const void* q, const void* scale,
                   const void* zero_point, void* out, int M, int D, int Fp, int nb, int F,
                   cudaStream_t stream) {
  const dim3 grid((F + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dequant_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<const float*>(zero_point),
      static_cast<T*>(out), M, D, Fp, nb, F);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success); the wrapper raises on anything else.
extern "C" int ds_dequant_matmul(const void* x, long long ldx, const void* q, const void* scale,
                                 const void* zero_point, void* out, int M, int D, int Fp, int nb,
                                 int F, int dtype, void* stream) {
  if (M <= 0 || F <= 0) return 0;
  if (nb <= 0 || Fp % nb != 0 || F > Fp) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ds::kF32:
      return static_cast<int>(launch<float>(x, ldx, q, scale, zero_point, out, M, D, Fp, nb, F, s));
    case ds::kBF16:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, ldx, q, scale, zero_point, out, M, D, Fp, nb, F, s));
    case ds::kF16:
      return static_cast<int>(launch<__half>(x, ldx, q, scale, zero_point, out, M, D, Fp, nb, F, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
