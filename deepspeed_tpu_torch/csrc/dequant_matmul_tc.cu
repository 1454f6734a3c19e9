// Dequant-fused matrix product over the quantized-wire format (B8) on
// Hopper's tensor cores (sm_90a, wgmma), with the fp32 function kept; plain
// C interface:
//
//   out[M, F] = x[M, D] @ (q * scale + zero_point)[:, :F]
//
// Replaces, for the shapes dequant_matmul.py dqm_route sends here (M >= 64,
// D % 64 == 0, a scale block that is a multiple of 256 columns: the LM head
// of every preset at any training batch), the TPU kernel
// deepspeed_tpu/ops/pallas/dequant_matmul.py:_kernel (pallas_call :86).
// Other shapes keep the CUDA-core kernel of csrc/dequant_matmul.cu. q is the
// uint8 [D, Fp] payload of comm/quantized.py quantize_blockwise with fp32
// [D, nb] scales and zero-points, one pair per block = Fp / nb columns of a
// row; x (fp32, bf16 or fp16) is read as fp32, the sum is an fp32-accurate
// product, the output is rounded once to x's dtype.
//
// The fp32 function on 16-bit tensor cores. A block's 256 output columns lie
// in one scale block b, so with s_k = scale[k, b], z_k = zero_point[k, b]
// and v = x s rounded once in fp32:
//
//   out[m, n] = sum_k v[m, k] (q[k, n] - 128)  +  sum_k (x[m, k] z_k + 128 v[m, k]).
//
// q - 128 is an integer in [-128, 127], exact in bf16; centring it keeps the
// tensor cores' accumulators near the output's size (q itself would make
// them about three times larger, and their fp32 additions truncate). v is
// cut into three bf16 parts by truncation: hi = the top 16 bits of v, mid =
// those of v - hi, lo = v - hi - mid; each difference is exact and lo keeps
// at most 8 significant bits, so hi + mid + lo = v exactly. Three wgmmas
// against the one exact q tile sum v (q - 128) in fp32 accumulators. The
// second sum, a rank-one side product per block, runs in fp32 on the CUDA
// cores as the x tile is converted, and is added in the epilogue. The plain
// version rounds each weight w = q s + z to fp32 first and this kernel does
// not: its weights are not the plain version's bit for bit, and both are
// fp32-accurate products of the same function. Against the float64 product
// over the unrounded weights, at the LM head's shape on the H100
// (chip_smoke.py phase 2, scripts/decode_split_bench.py): this kernel
// within 3.8e-6 of the largest output (8.7e-6 with q uncentred), the plain
// fp32 version, cuBLAS fp32 and the CUDA-core kernel within 1.4e-6. The
// tensor cores' fp32 accumulation, not the split, sets the difference: the
// same arithmetic in IEEE fp32 (dequant_matmul_split_ref) lies as close as
// the plain version.
//
// Work split: a block owns 128 rows of x (two warpgroups of 64) and 256
// output columns, and walks D in 64-deep steps. Each step's raw tiles (x in
// its dtype, the q bytes, the step's 64 scales and zero-points of block b)
// come into one shared stage by 16-byte cp.async copies; every thread then
// converts its share into one of two buffers: x's three parts as K-major
// [128][64] bf16 tiles and q widened to an MN-major [64][256] bf16 tile
// (a byte permute puts each byte under the exponent of 2^23, one
// subtraction removes it), all 128-byte swizzled (csrc/tc_tile.cuh). A
// warpgroup's step is 24 wgmma m64n128k16 (4 k16 x 3 parts x 2 column
// halves); they run while both warpgroups convert the next step into the
// other buffer and the stage is refilled with the step after it. The sum
// over D runs in one order inside one block, with no atomics: a result is
// bitwise repeatable.
//
// What bounds it on the H100: operations. At the main-path shape (the
// GPT-2-125M LM head at B8 x T512: x [4096, 768] fp32, q [768, 50432], F
// 50304) the function is 3.17e11 flops; three bf16 passes are 9.5e11 at the
// dense bf16 peak of 989 TFLOP/s, 0.96 ms (one fp32 pass on the CUDA cores
// would be 4.7 ms at 67 TFLOP/s), against 0.25 ms for its bytes (mostly the
// 824 MB fp32 output) at 3.35 TB/s. The conversions (about 9 instructions an
// element of x per 256 columns, 3 a byte of q per 128 rows) and the shared
// memory the wgmmas read run beside the products; a block's first stage and
// its epilogue do not, one block fitting an SM.

#include <stdint.h>

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

using namespace ds::tc;

constexpr int kBM = 128;     // rows of x a block owns: two warpgroups of 64
constexpr int kWgRows = 64;  // rows of one wgmma m64
constexpr int kBN = 256;     // output columns a block owns, inside one scale block
constexpr int kBK = 64;      // rows of D a step consumes
constexpr int kThreads = 256;
constexpr int kParts = 3;  // hi, mid, lo of x s

// Shared layout (bytes from a 1024-aligned base): two buffers of converted
// tiles (x's three parts [128][64] bf16, K-major; q [64][256] bf16, MN-major,
// four 64-column panels), then the stage of raw tiles (x [128][64] in T,
// q [64][256] bytes, the step's 64 scales, then its 64 zero-points).
template <typename T> struct Layout {
  static constexpr int a_tile = kBM * kBK * 2;
  static constexpr int b_tile = kBK * kBN * 2;
  static constexpr int buf = kParts * a_tile + b_tile;
  static constexpr int raw_row = kBK * static_cast<int>(sizeof(T));  // bytes of a raw x row
  static constexpr int raw_x = 2 * buf;
  static constexpr int raw_q = raw_x + kBM * raw_row;
  static constexpr int raw_s = raw_q + kBK * kBN;
  static constexpr int bytes = raw_s + 2 * kBK * 4;
  static_assert(a_tile % 1024 == 0 && buf % 1024 == 0, "swizzled tiles sit on 1024 bytes");
};

// Row (within one wgmma's 64 rows) and column (within its 128) of
// accumulator entry i of wgmma m64n128 for this thread (warp w of its
// warpgroup, lane l).
__device__ __forceinline__ int acc_row(int w, int l, int i) {
  return 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int l, int i) {
  return 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
}

// Bytes u and u + 1 of `word` (unsigned) less 128 as a packed bf16 pair
// (byte u in the low half): 0x4B0000bb is 2^23 + b, the subtraction leaves
// b - 128 exactly, and an integer in [-128, 127] is its float's top 16 bits.
__device__ __forceinline__ uint32_t widen_pair(uint32_t word, int u) {
  const float f0 = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | u)) - 8388736.0f;
  const float f1 =
      __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | (u + 1))) - 8388736.0f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// hi, mid, lo bf16 pairs of two fp32 values (a in the low halves), each the
// top 16 bits of what the parts before it leave: hi + mid + lo == a exactly.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);
  const float ra = a - __uint_as_float(ua & 0xffff0000u);
  const float rb = b - __uint_as_float(ub & 0xffff0000u);
  const uint32_t va = __float_as_uint(ra), vb = __float_as_uint(rb);
  mid = __byte_perm(va, vb, 0x7632);
  const float sa = ra - __uint_as_float(va & 0xffff0000u);
  const float sb = rb - __uint_as_float(vb & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(sa), __float_as_uint(sb), 0x7632);
}

// Elements 8c .. 8c + 7 of a raw x row as fp32. fp32 rows are 256 bytes:
// lane c of a quarter-warp reads half (c / 4) % 2 of its 32 bytes first, so
// the eight lanes' 16-byte reads cover the 32 banks once.
template <typename T>
__device__ __forceinline__ void read_x8(const unsigned char* row, int c, float (&x)[8]) {
  if constexpr (sizeof(T) == 4) {
    const int h = (c >> 2) & 1;
    const float4 a = *reinterpret_cast<const float4*>(row + 32 * c + 16 * h);
    const float4 b = *reinterpret_cast<const float4*>(row + 32 * c + 16 * (1 - h));
    const float4 lo4 = h ? b : a, hi4 = h ? a : b;
    x[0] = lo4.x; x[1] = lo4.y; x[2] = lo4.z; x[3] = lo4.w;
    x[4] = hi4.x; x[5] = hi4.y; x[6] = hi4.z; x[7] = hi4.w;
  } else {
    ds::load16<T>(reinterpret_cast<const T*>(row + 16 * c), x);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float a,
                                                                  float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<__nv_bfloat16>(a, b);
}
template <> __device__ __forceinline__ void store2<__half>(__half* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<__half>(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dequant_matmul_tc_kernel(const T* __restrict__ x, long long ldx, const uint8_t* __restrict__ q,
                         const float* __restrict__ scale, const float* __restrict__ zero_point,
                         T* __restrict__ out, int M, int D, int Fp, int nb, int F) {
  using L = Layout<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float sxz[kBM];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;
  const unsigned char* const base_ptr = smem_raw + (base - raw_u32);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wg_warp = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int blk = n0 / (Fp / nb);  // the scale block of all of the block's columns
  const int n_steps = D / kBK;

  // step k's raw tiles into the stage: rows of x past M zero-filled
  auto load_raw = [&](int k) {
    const int k0 = k * kBK;
    constexpr int xc = L::raw_row / 16;  // 16-byte chunks of a raw x row
    for (int idx = tid; idx < kBM * xc; idx += kThreads) {
      const int r = idx / xc, c = idx % xc;
      const bool in = m0 + r < M;
      const T* src = x + (long long)(in ? m0 + r : 0) * ldx + k0 + c * (16 / sizeof(T));
      cp_async16(base + L::raw_x + r * L::raw_row + c * 16, src, in);
    }
    constexpr int qc = kBN / 16;
    for (int idx = tid; idx < kBK * qc; idx += kThreads) {
      const int r = idx / qc, c = idx % qc;
      cp_async16(base + L::raw_q + r * kBN + c * 16, q + (long long)(k0 + r) * Fp + n0 + c * 16,
                 true);
    }
    if (tid < 2 * kBK) {
      const float* src = (tid < kBK ? scale : zero_point) + (long long)(k0 + tid % kBK) * nb + blk;
      cp_async4(base + L::raw_s + 4 * tid, src, true);
    }
  };

  // the stage -> buffer `bf`: v = x s as three parts (and the side sums of
  // this thread's rows), q - 128 widened; then the proxy fence that makes
  // the tiles visible to wgmma
  const int cx = tid & 7, rx = tid >> 3;  // x: chunk cx (k 8 cx ..) of rows rx + 32 j
  float xz[4] = {0.f, 0.f, 0.f, 0.f};
  auto convert = [&](int bf) {
    const float* rs = reinterpret_cast<const float*>(base_ptr + L::raw_s);
    const uint32_t abuf = base + bf * L::buf, bbuf = abuf + kParts * L::a_tile;
    float sv[8], zv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      sv[u] = rs[8 * cx + u];
      zv[u] = rs[kBK + 8 * cx + u];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rx + 32 * j;
      float xv[8], v[8];
      read_x8<T>(base_ptr + L::raw_x + r * L::raw_row, cx, xv);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] = __fmul_rn(xv[u], sv[u]);
        xz[j] = fmaf(xv[u], zv[u], fmaf(128.0f, v[u], xz[j]));
      }
      uint32_t hi[4], mid[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) split3(v[2 * u], v[2 * u + 1], hi[u], mid[u], lo[u]);
      const uint32_t off = tile_offset<kBM>(r, cx);
      st_shared16(abuf + off, make_uint4(hi[0], hi[1], hi[2], hi[3]));
      st_shared16(abuf + L::a_tile + off, make_uint4(mid[0], mid[1], mid[2], mid[3]));
      st_shared16(abuf + 2 * L::a_tile + off, make_uint4(lo[0], lo[1], lo[2], lo[3]));
    }
    // q: 8 bytes (row kr, columns 8 cc ..) a read, 8 reads a thread
#pragma unroll
    for (int j = 0; j < kBK * kBN / 8 / kThreads; ++j) {
      const int idx = tid + kThreads * j, kr = idx >> 5, cc = idx & 31;
      const uint2 w = *reinterpret_cast<const uint2*>(base_ptr + L::raw_q + kr * kBN + 8 * cc);
      st_shared16(bbuf + tile_offset<kBK>(kr, cc),
                  make_uint4(widen_pair(w.x, 0), widen_pair(w.x, 2), widen_pair(w.y, 0),
                             widen_pair(w.y, 2)));
    }
    fence_proxy_async();
  };

  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

  // this warpgroup's products of buffer bf: its 64 rows x 256 columns
  auto mma = [&](int bf) {
    const uint32_t abuf = base + bf * L::buf, bbuf = abuf + kParts * L::a_tile;
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db0 = desc_mnmajor<kBK>(bbuf, 0, kk), db1 = desc_mnmajor<kBK>(bbuf, 2, kk);
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const uint64_t da = desc_kmajor<kBM>(abuf + p * L::a_tile + wg * kWgRows * kRowBytes, kk);
        wgmma_ss_mn128<__nv_bfloat16>(acc[0], da, db0);
        wgmma_ss_mn128<__nv_bfloat16>(acc[1], da, db1);
      }
    }
    wgmma_commit();
  };

  load_raw(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  convert(0);
  __syncthreads();  // buffer 0 is complete, the stage free
  if (n_steps > 1) load_raw(1);
  cp_async_commit();

  for (int k = 0; k < n_steps; ++k) {
    mma(k & 1);
    if (k + 1 < n_steps) {
      cp_async_wait<0>();
      __syncthreads();  // step k + 1's raw tiles have landed, for every thread
      convert((k + 1) & 1);
      __syncthreads();  // the stage is free
      if (k + 2 < n_steps) load_raw(k + 2);
      cp_async_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    __syncthreads();  // buffer (k + 1) & 1 is complete; buffer k & 1 is free
  }

  // the side sums of a row: its eight lanes (tid & 7) in a fixed tree
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v = xz[j];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    if (cx == 0) sxz[rx + 32 * j] = v;
  }
  __syncthreads();

  const bool pairs = (F & 1) == 0;  // two adjacent columns in one aligned store
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int rl = wg * kWgRows + acc_row(wg_warp, lane, i);
      const int row = m0 + rl, col = n0 + 128 * h + acc_col(lane, i);
      if (row >= M || col >= F) continue;
      const float add = sxz[rl];
      const float v0 = acc[h][i] + add, v1 = acc[h][i + 1] + add;
      T* dst = out + (long long)row * F + col;
      if (pairs && col + 1 < F) {
        store2<T>(dst, v0, v1);
      } else {
        dst[0] = ds::from_float<T>(v0);
        if (col + 1 < F) dst[1] = ds::from_float<T>(v1);
      }
    }
}

template <typename T>
cudaError_t launch(const void* x, long long ldx, const void* q, const float* scale,
                   const float* zero_point, void* out, int M, int D, int Fp, int nb, int F,
                   cudaStream_t stream) {
  constexpr int smem = Layout<T>::bytes + 1024;  // + the 1024-byte alignment
  static bool attr_set = false;  // once per instance: the attribute call costs host time
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((F + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dequant_matmul_tc_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const uint8_t*>(q), scale, zero_point,
      static_cast<T*>(out), M, D, Fp, nb, F);
  return cudaGetLastError();
}

}  // namespace

// x [M, D] with row stride ldx (elements; last dimension contiguous, rows
// 16-byte aligned) in `dtype`; q uint8 [D, Fp] contiguous and 16-byte
// aligned; scale / zero_point fp32 [D, nb] contiguous; out [M, F]
// contiguous in x's dtype. The layouts taken: D % 64 == 0, Fp % nb == 0 with
// a block Fp / nb that is a multiple of 256, F <= Fp. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int ds_dequant_matmul_tc(const void* x, long long ldx, const void* q,
                                    const float* scale, const float* zero_point, void* out,
                                    int M, int D, int Fp, int nb, int F, int dtype,
                                    void* stream) {
  if (M <= 0 || F <= 0) return 0;
  const int elt = dtype == ds::kF32 ? 4 : 2;
  const bool layout = D > 0 && D % kBK == 0 && nb > 0 && Fp % nb == 0 &&
                      (Fp / nb) % kBN == 0 && F <= Fp;
  const bool aligned = (ldx * elt) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (!layout || !aligned) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ds::kF32:
      return static_cast<int>(
          launch<float>(x, ldx, q, scale, zero_point, out, M, D, Fp, nb, F, s));
    case ds::kBF16:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, ldx, q, scale, zero_point, out, M, D, Fp, nb, F, s));
    case ds::kF16:
      return static_cast<int>(
          launch<__half>(x, ldx, q, scale, zero_point, out, M, D, Fp, nb, F, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
