// Dequant-fused matrix product over the quantized-wire format (B8) on
// Hopper's tensor cores (sm_90a, wgmma), with the fp32 function kept; plain
// C interface:
//
//   out[M, F] = x[M, D] @ (q * scale + zero_point)[:, :F]
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/dequant_matmul.py:_kernel
// (pallas_call :86) for every 8-bit payload quantize_blockwise gives
// (dequant_matmul.py dqm_route), at any number of rows, any D and any even
// scale block: the LM head of every preset at every batch, with the default
// block of 256 and with every block a user may set as
// zero_quantize_block_size or that comm/quantized.py effective_block gives
// short rows. An odd block (no quantizer gives one) is refused. q is the uint8 [D, Fp] payload
// of comm/quantized.py quantize_blockwise with fp32 [D, nb] scales and
// zero-points, one pair per block = Fp / nb columns of a row; x (fp32, bf16
// or fp16) is read as fp32, the sum is an fp32-accurate product, the output
// is rounded once to x's dtype.
//
// The fp32 function on 16-bit tensor cores. The columns a warpgroup owns lie
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
// Promotion (PROMO, fp32 x past D 1024: dequant_matmul.py dqm_promotes). The
// wgmma accumulators' additions truncate, so an error of each addition's
// last bit, biased toward zero, grows with the number of additions into one
// accumulator: summed over all of D it reached 2.29e-5 of the largest output
// at gpt-neox-20b's D 6144 (over the 1e-5 bar of an fp32-accurate product).
// A PROMO instance adds its accumulators into IEEE fp32 sums every kPromote
// steps (256 rows of D) and starts them again from zero, so a truncating
// accumulator never holds more than 256 rows: dequant_matmul_trunc_ref, a
// CPU model of truncated accumulation per k16 step, puts the error at
// ~1.3e-6 of the largest output at any D, where one accumulator over D 6144
// gives 1.9-3.0e-5 (the card: 2.29e-5). The sums take a second set of
// accumulator registers, so PROMO instances exist for the tilings of at
// most 64 accumulator entries a thread (not 128 rows x 256 columns, which
// holds 255 registers already: dqm_tile takes 128 columns there), for fp32
// x only (bf16 / fp16 outputs round far above the accumulators' error).
//
// Work split: a block is two warpgroups and walks D in 64-deep steps. Each
// warpgroup owns 64 rows of x and WN output columns inside one scale block,
// and reads its own A set: three parts of v = x s for its rows and its
// block. Two tilings (RW, the warpgroups stacked along rows, 2 or 1):
//   RW 2 (more than 64 rows): a block owns 128 rows and BN columns, BN = 256,
//        128 or 64, the largest that divides the scale block (one block b for
//        the whole tile; sets 0 and 1 are the two row halves);
//   RW 1 (at most 64 rows, where a second row half would be empty): a block
//        owns 64 rows and BN = 256 or 128 columns, warpgroup w the column
//        half w (sets 0 and 1 are the same rows times the scales of each
//        half's block, which may differ: a block of 128 or 64 columns).
// A block of 64 or 128 columns thus shrinks the tile to the block (RW 2) or
// gives each warpgroup its own block (RW 1) instead of converting x once per
// sub-panel of a 256-column tile: three parts of two 128-row sets take 96 KB
// a buffer, which with the double buffer, the q tiles and the raw stage
// exceeds the 227 KB of shared memory. Each step's raw tiles come into a
// ring of shared stages (as many as fit, up to three): x in its dtype and
// the q bytes by TMA (one thread starts both; rows of x past M arrive as
// zeros), the step's 64 scales and zero-points of each set's block by
// 4-byte cp.async copies. (Moving x and q from 16-byte cp.async copies,
// some 3000 a step at 128 rows, to TMA took 11% off the LM head's product
// on the H100: 2.268 -> 2.024 ms, scripts/quant_tc_bench.py. A step still
// takes about twice its products' time, ~3.5 us against 1.7.) Every thread then
// converts its share into one of two buffers: the A sets' three parts as
// K-major [128][64] bf16 tiles (set s is rows 64 s ..; at RW 1 rows past M
// are not converted, their outputs never being stored) and q widened to an
// MN-major [64][BN] bf16 tile (a byte permute puts each byte under the
// exponent of 2^23, one subtraction removes it), all 128-byte swizzled
// (csrc/tc_tile.cuh). A warpgroup's step is 12 wgmma per 128 of its columns
// (4 k16 x 3 parts; m64n128k16, or m64n64k16 for WN = 64); they run while
// both warpgroups convert the next step into the other buffer, and its
// stage is refilled with the step `stages` further on. The sum over D runs
// in one order inside one block, with no atomics: a result is bitwise
// repeatable.
// The wrapper picks the tiling from the shapes (dequant_matmul.py dqm_tile,
// whose docstring gives the measurements behind it).
//
// Blocks off 64-column panels (96, 250, 8, ...). The kernel walks virtual
// columns in which each scale block is padded to Bp, the next multiple of
// 64 columns: every tile above then lies in whole virtual blocks, and a
// warpgroup's columns in one. A tile's q bytes come as one TMA box starting
// at the real column of its first virtual column, rounded down to 16 bytes
// (a box's start must be 16-byte aligned: blocks of a multiple of 16, such
// as 96, start aligned); the conversion reads each virtual column's byte
// from its real place in the box, the few past the box's end (at most 14 a
// row) from global memory, and writes zeros for the padding (block to Bp),
// whose outputs are never stored; the epilogue stores each virtual column
// at its real column. Each warpgroup's columns lie in one virtual block, so
// the real place of a column is its set's base plus its offset, with no
// division past the prologue. The padded path is its own instance (PAD), so
// a block of a multiple of 64 runs the aligned code alone. A payload row
// stride off 16 bytes (which TMA cannot take) is copied to a padded stride
// by the wrapper. The products over the padding are the cost: a third
// more at a block of 96, 2% at 250, and at blocks under 64 each block
// takes a whole panel (8x the products at a block of 8). A block of a
// multiple of 64 takes the aligned path as before.
//
// D off 64-row steps: the last step runs past D. TMA fills the rows of x's
// and q's boxes past D with zeros, the scales and zero-points past D are
// copied as zeros, and the bytes read from global memory past a q box stop
// at D, so the rows past D add nothing.
//
// What bounds it on the H100: at many rows, operations. At the main-path
// shape (the GPT-2-125M LM head at B8 x T512: x [4096, 768] fp32, q [768,
// 50432], F 50304) the function is 3.17e11 flops; three bf16 passes are
// 9.5e11 at the dense bf16 peak of 989 TFLOP/s, 0.96 ms (one fp32 pass on
// the CUDA cores would be 4.7 ms at 67 TFLOP/s), against 0.25 ms for its
// bytes (mostly the 824 MB fp32 output) at 3.35 TB/s. The conversions
// (about 9 instructions an element of x per tile of columns, 3 a byte of q
// per tile of rows) and the shared memory the wgmmas read run beside the
// products; a block's first stage and its epilogue do not, one block
// fitting an SM. At a few rows (a short fine-tuning batch: 32 rows), bytes:
// the 38.7 MB payload, 0.0116 ms at 3.35 TB/s, read once as the grid's
// column tiles stream it.

#include <stdint.h>

#include <type_traits>

#include <cuda.h>

#include "common.cuh"
#include "tc_tile.cuh"
#include "tma_map.cuh"

namespace {

using namespace ds::tc;

constexpr int kWgRows = 64;  // rows of one wgmma m64
constexpr int kBK = 64;      // rows of D a step consumes
constexpr int kThreads = 256;
constexpr int kParts = 3;    // hi, mid, lo of x s
constexpr int kSets = 2;     // A sets, one per warpgroup
constexpr int kPairs = kSets * kWgRows;  // (set, row) pairs converted a step
constexpr int kPromote = 4;  // PROMO: steps of D between promotions of the accumulators

// Shared layout (bytes from a 1024-aligned base): two buffers of converted
// tiles (for each part, both sets' [64][64] bf16 rows, K-major: one [128][64]
// tile; q [64][BN] bf16, MN-major, BN / 64 panels), then a ring of `stages`
// stages of raw tiles (x [64 RW][64] in T and q [64][BN] bytes by TMA, then
// for each set the step's 64 scales and 64 zero-points: one set for RW 2,
// whose sets share a block), then one mbarrier a stage. The ring takes as
// many stages as fit, up to three. The side sums of the epilogue reuse the
// first stage.
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may opt in to
template <typename T, int RW, int BN> struct Layout {
  static constexpr int rows = RW * kWgRows;  // rows of x a block owns
  static constexpr int a_tile = kPairs * kBK * 2;
  static constexpr int b_tile = kBK * BN * 2;
  static constexpr int buf = kParts * a_tile + b_tile;
  static constexpr int raw_row = kBK * static_cast<int>(sizeof(T));  // bytes of a raw x row
  static constexpr int scale_sets = RW == 2 ? 1 : kSets;
  static constexpr int raw_x = 0;  // offsets inside a stage
  static constexpr int raw_q = raw_x + rows * raw_row;
  static constexpr int raw_s = raw_q + kBK * BN;
  static constexpr int stage = (raw_s + scale_sets * 2 * kBK * 4 + 127) / 128 * 128;
  static constexpr int raw = 2 * buf;  // the first stage
  static constexpr int fit = (kSmemMax - 1024 - raw - 8 * 3) / stage;
  static constexpr int stages = fit < 3 ? fit : 3;
  static constexpr int bars = raw + stages * stage;
  static constexpr int bytes = bars + 8 * stages;
  static_assert(a_tile % 1024 == 0 && buf % 1024 == 0, "swizzled tiles sit on 1024 bytes");
  static_assert(stages >= 1 && kPairs * 4 <= stage, "a stage fits; the side sums fit in one");
};

// Row (within one wgmma's 64 rows) and column (within its 128, or 64) of
// accumulator entry i of wgmma m64n128 (m64n64) for this thread (warp w of
// its warpgroup, lane l).
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

// Elements 8c .. 8c + 7 of a raw x row as fp32 (fp32 rows: read_row8_f32's
// bank-conflict-free order).
template <typename T>
__device__ __forceinline__ void read_x8(const unsigned char* row, int c, float (&x)[8]) {
  if constexpr (sizeof(T) == 4) {
    read_row8_f32(row, c, x);
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

// One k16 step of a warpgroup's columns: wgmma m64n128k16 for a 64-entry
// accumulator, m64n64k16 for a 32-entry one.
template <int N>
__device__ __forceinline__ void mma_step(float (&d)[N], uint64_t da, uint64_t db) {
  if constexpr (N == 64) {
    wgmma_ss_mn128<__nv_bfloat16>(d, da, db);
  } else {
    wgmma_ss_mn64<__nv_bfloat16>(d, da, db);
  }
}

// RW: warpgroups stacked along rows (2: 128 rows x BN columns, one scale
// block; 1: 64 rows x BN columns, warpgroup w the column half w)
// PAD: the scale block is off 64-column panels (padded to bp columns)
// PROMO: the accumulators are added into fp32 sums every kPromote steps
template <typename T, int RW, int BN, bool PAD, bool PROMO>
__global__ void __launch_bounds__(kThreads, 1)
dequant_matmul_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmq,
                         const uint8_t* __restrict__ qg, long long ldq,
                         const float* __restrict__ scale, const float* __restrict__ zero_point,
                         T* __restrict__ out, int M, int D, int Fp, int nb, int F) {
  using L = Layout<T, RW, BN>;
  constexpr int kWN = BN * RW / 2;                  // output columns of a warpgroup
  constexpr int kSub = kWN >= 128 ? kWN / 128 : 1;  // wgmmas a k16 step and part
  constexpr int kAcc = kWN >= 128 ? 64 : 32;        // accumulator entries of one
  static_assert(!PROMO || kSub * kAcc <= 64, "the sums fit beside the accumulators");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw_u32);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wg_warp = warp & 3;
  // n0: the tile's first virtual column (blocks padded to bp columns)
  const int block = Fp / nb, bp = PAD ? (block + 63) / 64 * 64 : block;
  const int m0 = blockIdx.y * L::rows, n0 = blockIdx.x * BN;
  // the scale block of each set (RW 2, the tile's; RW 1, each column
  // half's) and its first column's offset in the block
  const int blk[kSets] = {n0 / bp, (n0 + (RW == 1 ? kWN : 0)) / bp};
  const int obase[kSets] = {n0 % bp, (n0 + (RW == 1 ? kWN : 0)) % bp};
  // where the tile's q box starts: its first real column, rounded down to
  // 16 bytes
  const int qa = PAD ? (blk[0] * block + obase[0]) & ~15 : n0;
  const int rows_in = min(L::rows, M - m0);  // rows of x that exist
  const int n_steps = (D + kBK - 1) / kBK;  // the last may run past D

  // one mbarrier a ring stage: its TMA tiles have landed
  const uint32_t bar0 = base + L::bars;
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tmx)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tmq)) : "memory");
#pragma unroll
    for (int k = 0; k < L::stages; ++k) mbar_init(bar0 + 8 * k, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // step k's raw tiles into stage k % stages: x and q by TMA (one thread;
  // rows of x past M and rows past D arrive as zeros), the scales and
  // zero-points by 4-byte cp.async copies (a row of them need not be 16-byte
  // aligned for TMA; zeros past D)
  auto load_raw = [&](int k) {
    const int k0 = k * kBK, slot = k % L::stages;
    const uint32_t st = base + L::raw + slot * L::stage;
    if (tid == 0) {
      mbar_expect_tx(bar0 + 8 * slot, L::rows * L::raw_row + kBK * BN);
      tma_load_2d(st + L::raw_x, &tmx, bar0 + 8 * slot, k0, m0);
      tma_load_2d(st + L::raw_q, &tmq, bar0 + 8 * slot, qa, k0);
    }
    if (tid < L::scale_sets * 2 * kBK) {  // set, then scales / zero-points, then row
      const int set = tid / (2 * kBK), kr = tid % kBK;
      const bool in = k0 + kr < D;
      const float* src = ((tid / kBK) & 1 ? zero_point : scale) +
                         (in ? (long long)(k0 + kr) * nb + blk[set] : 0);
      cp_async4(st + L::raw_s + 4 * tid, src, in);
    }
  };
  // step k's raw tiles have landed (the caller's barrier makes them
  // visible to every thread)
  auto wait_raw = [&](int k) {
    cp_async_wait<L::stages - 1>();
    mbar_wait(bar0 + 8 * (k % L::stages), (k / L::stages) & 1);
  };

  // stage k % stages -> buffer k % 2: v = x s as three parts for each set
  // (and the side sums of this thread's pairs), q - 128 widened; then the
  // proxy fence that makes the tiles visible to wgmma. Pair p = 64 set +
  // row; a thread converts chunk cx (k 8 cx ..) of pairs rx + 32 j.
  const int cx = tid & 7, rx = tid >> 3;
  float xz[4] = {0.f, 0.f, 0.f, 0.f};
  auto convert = [&](int k) {
    const int k0 = k * kBK;
    const unsigned char* st = base_ptr + L::raw + (k % L::stages) * L::stage;
    const float* rs = reinterpret_cast<const float*>(st + L::raw_s);
    const uint32_t abuf = base + (k & 1) * L::buf, bbuf = abuf + kParts * L::a_tile;
    float sv[L::scale_sets][8], zv[L::scale_sets][8];
#pragma unroll
    for (int t = 0; t < L::scale_sets; ++t)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        sv[t][u] = rs[t * 2 * kBK + 8 * cx + u];
        zv[t][u] = rs[t * 2 * kBK + kBK + 8 * cx + u];
      }
    // RW 2: raw rows rx + 32 j (j < 4) are pairs rx + 32 j; RW 1: raw rows
    // rx + 32 j (j < 2) are pairs rx + 32 j (set 0) and 64 + rx + 32 j (set 1)
#pragma unroll
    for (int j = 0; j < 4 / kSets * RW; ++j) {
      const int r = rx + 32 * j;
      if (RW == 1 && r >= rows_in) continue;  // past M: its outputs are not stored
      float xv[8];
      read_x8<T>(st + L::raw_x + r * L::raw_row, cx, xv);
#pragma unroll
      for (int t = 0; t < L::scale_sets; ++t) {
        const int jx = j + 2 * t;  // the pair: rx + 32 jx
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          v[u] = __fmul_rn(xv[u], sv[t][u]);
          xz[jx] = fmaf(xv[u], zv[t][u], fmaf(128.0f, v[u], xz[jx]));
        }
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) split3(v[2 * u], v[2 * u + 1], hi[u], mid[u], lo[u]);
        const uint32_t off = tile_offset<kPairs>(rx + 32 * jx, cx);
        st_shared16(abuf + off, make_uint4(hi[0], hi[1], hi[2], hi[3]));
        st_shared16(abuf + L::a_tile + off, make_uint4(mid[0], mid[1], mid[2], mid[3]));
        st_shared16(abuf + 2 * L::a_tile + off, make_uint4(lo[0], lo[1], lo[2], lo[3]));
      }
    }
    // q: 8 bytes (row kr, virtual columns 8 cc ..) a read; padded blocks
    // read them from their real place, pairs past the block as zeros
    constexpr int qr = BN / 8;  // reads a row
#pragma unroll
    for (int j = 0; j < kBK * qr / kThreads; ++j) {
      const int idx = tid + kThreads * j, kr = idx / qr, cc = idx % qr;
      const unsigned char* row = st + L::raw_q + kr * BN;
      uint4 v;
      if constexpr (!PAD) {
        const uint2 w = *reinterpret_cast<const uint2*>(row + 8 * cc);
        v = make_uint4(widen_pair(w.x, 0), widen_pair(w.x, 2), widen_pair(w.y, 0),
                       widen_pair(w.y, 2));
      } else {
        // the chunk lies in its set's virtual block; its real bytes start at
        // an even offset of the box (blocks are even); pairs past the box
        // come from global memory (none past the payload or past D: those
        // columns' outputs are not stored, those rows add nothing)
        const int set = RW == 1 && 8 * cc >= kWN ? 1 : 0;
        const int local = 8 * cc - set * kWN, off = obase[set] + local;
        const int src = blk[set] * block + off - qa;
        uint32_t h[4];
        if (off + 8 <= block && src % 8 == 0 && src + 8 <= BN) {
          // a whole chunk of the block at an aligned place of the box (every
          // chunk at blocks of a multiple of 16, such as 96): one read
          const uint2 w = *reinterpret_cast<const uint2*>(row + src);
          h[0] = widen_pair(w.x, 0);
          h[1] = widen_pair(w.x, 2);
          h[2] = widen_pair(w.y, 0);
          h[3] = widen_pair(w.y, 2);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            h[e] = 0u;  // bf16 zeros
            const int c = src + 2 * e;
            if (off + 2 * e < block) {
              uint32_t pair = 0u;
              if (c < BN) {
                pair = *reinterpret_cast<const uint16_t*>(row + c);
              } else if (qa + c < Fp && k0 + kr < D) {
                pair = __ldg(reinterpret_cast<const unsigned short*>(
                    qg + (long long)(k0 + kr) * ldq + qa + c));
              }
              h[e] = widen_pair(pair, 0);
            }
          }
        }
        v = make_uint4(h[0], h[1], h[2], h[3]);
      }
      st_shared16(bbuf + tile_offset<kBK>(kr, cc), v);
    }
    fence_proxy_async();
  };

  float acc[kSub][kAcc];
  float sum[PROMO ? kSub : 1][PROMO ? kAcc : 1];  // PROMO: the promoted sums
#pragma unroll
  for (int h = 0; h < kSub; ++h)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[h][i] = 0.f;
  if constexpr (PROMO) {
#pragma unroll
    for (int h = 0; h < kSub; ++h)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) sum[h][i] = 0.f;
  }

  // this warpgroup's products of buffer bf: its set's 64 rows x its kWN
  // columns (B panels from p0)
  const int p0 = RW == 1 ? wg * (kWN / 64) : 0;
  auto mma = [&](int bf) {
    const uint32_t abuf = base + bf * L::buf + wg * kWgRows * kRowBytes;
    const uint32_t bbuf = base + bf * L::buf + kParts * L::a_tile;
#pragma unroll
    for (int h = 0; h < kSub; ++h) fence_regs(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const uint64_t da = desc_kmajor<kPairs>(abuf + p * L::a_tile, kk);
#pragma unroll
        for (int h = 0; h < kSub; ++h)
          mma_step(acc[h], da, desc_mnmajor<kBK>(bbuf, p0 + 2 * h, kk));
      }
    }
    wgmma_commit();
  };

  // the first `stages` steps' copies; then each step's products run while
  // the next step is converted and the copies `stages` steps ahead land
#pragma unroll
  for (int k = 0; k < L::stages; ++k) {
    if (k < n_steps) load_raw(k);
    cp_async_commit();
  }
  wait_raw(0);
  __syncthreads();
  convert(0);
  __syncthreads();  // buffer 0 is complete, stage 0 free
  if (L::stages < n_steps) load_raw(L::stages);
  cp_async_commit();

  for (int k = 0; k < n_steps; ++k) {
    mma(k & 1);
    if (k + 1 < n_steps) {
      wait_raw(k + 1);
      __syncthreads();  // step k + 1's raw tiles have landed, for every thread
      convert(k + 1);
      __syncthreads();  // its stage is free
      if (k + 1 + L::stages < n_steps) load_raw(k + 1 + L::stages);
      cp_async_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kSub; ++h) fence_regs(acc[h]);
    if constexpr (PROMO) {  // every kPromote steps, and after the last
      if ((k + 1) % kPromote == 0 || k + 1 == n_steps) {
#pragma unroll
        for (int h = 0; h < kSub; ++h)
#pragma unroll
          for (int i = 0; i < kAcc; ++i) {
            sum[h][i] += acc[h][i];
            acc[h][i] = 0.f;
          }
      }
    }
    __syncthreads();  // buffer (k + 1) & 1 is complete; buffer k & 1 is free
  }
  if constexpr (PROMO) {  // the epilogue reads the sums from acc
#pragma unroll
    for (int h = 0; h < kSub; ++h)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[h][i] = sum[h][i];
  }

  // the side sums of a pair: its eight lanes (tid & 7) in a fixed tree,
  // into the first stage (every copy has landed and been read)
  float* const sxz = reinterpret_cast<float*>(base_ptr + L::raw);
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
  const int row0 = m0 + (RW == 2 ? wg * kWgRows : 0), col0 = n0 + (RW == 1 ? wg * kWN : 0);
#pragma unroll
  for (int h = 0; h < kSub; ++h)
#pragma unroll
    for (int i = 0; i < kAcc; i += 2) {
      const int rl = acc_row(wg_warp, lane, i);
      int col = col0 + 128 * h + acc_col(lane, i);  // virtual; even
      if constexpr (PAD) {  // a pair past its block is padding; else its real column
        const int set = RW == 1 ? wg : 0;
        const int off = obase[set] + 128 * h + acc_col(lane, i);
        col = off < block ? blk[set] * block + off : F;
      }
      const int row = row0 + rl;
      if (row >= M || col >= F) continue;
      const float add = sxz[wg * kWgRows + rl];  // the warpgroup's set, row rl
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

template <typename T> constexpr CUtensorMapDataType kMapType =
    sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
    : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

template <typename T, int RW, int BN, bool PAD, bool PROMO>
cudaError_t launch_pad(const void* x, long long ldx, const void* q, long long ldq,
                       const float* scale, const float* zero_point, void* out, int M, int D,
                       int Fp, int nb, int F, cudaStream_t stream) {
  using L = Layout<T, RW, BN>;
  constexpr int smem = L::bytes + 1024;  // + the 1024-byte alignment
  CUtensorMap tmx, tmq;
  if (!ds::tma::make_map(&tmx, kMapType<T>, x, M, D, ldx * sizeof(T), L::rows, kBK,
                         CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !ds::tma::make_map(&tmq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, D, Fp, ldq, kBK, BN,
                         CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static ds::SmemOptIn opt;  // once per device and instance
  if (const cudaError_t err = opt.set(dequant_matmul_tc_kernel<T, RW, BN, PAD, PROMO>, smem))
    return err;
  // the virtual columns up to the last real one (blocks padded to bp)
  const int block = Fp / nb, bp = (block + 63) / 64 * 64;
  const long long vf = (long long)(F - 1) / block * bp + (F - 1) % block + 1;
  const dim3 grid(static_cast<unsigned>((vf + BN - 1) / BN), (M + L::rows - 1) / L::rows);
  dequant_matmul_tc_kernel<T, RW, BN, PAD, PROMO><<<grid, kThreads, smem, stream>>>(
      tmx, tmq, static_cast<const uint8_t*>(q), ldq, scale, zero_point, static_cast<T*>(out),
      M, D, Fp, nb, F);
  return cudaGetLastError();
}

template <typename T, int RW, int BN, bool PROMO>
cudaError_t launch(const void* x, long long ldx, const void* q, long long ldq,
                   const float* scale, const float* zero_point, void* out, int M, int D, int Fp,
                   int nb, int F, cudaStream_t stream) {
  if ((Fp / nb) % 64 == 0)
    return launch_pad<T, RW, BN, false, PROMO>(x, ldx, q, ldq, scale, zero_point, out, M, D,
                                               Fp, nb, F, stream);
  return launch_pad<T, RW, BN, true, PROMO>(x, ldx, q, ldq, scale, zero_point, out, M, D, Fp,
                                            nb, F, stream);
}

// PROMO: every tiling but 128 rows x 256 columns (too many registers)
template <typename T, bool PROMO>
cudaError_t dispatch_tile(int rw, int cols, const void* x, long long ldx, const void* q,
                          long long ldq, const float* scale, const float* zero_point, void* out,
                          int M, int D, int Fp, int nb, int F, cudaStream_t s) {
  if constexpr (!PROMO) {
    if (rw == 2 && cols == 256)
      return launch<T, 2, 256, false>(x, ldx, q, ldq, scale, zero_point, out, M, D, Fp, nb, F,
                                      s);
  }
  if (rw == 2 && cols == 128)
    return launch<T, 2, 128, PROMO>(x, ldx, q, ldq, scale, zero_point, out, M, D, Fp, nb, F, s);
  if (rw == 2 && cols == 64)
    return launch<T, 2, 64, PROMO>(x, ldx, q, ldq, scale, zero_point, out, M, D, Fp, nb, F, s);
  if (rw == 1 && cols == 256)
    return launch<T, 1, 256, PROMO>(x, ldx, q, ldq, scale, zero_point, out, M, D, Fp, nb, F, s);
  if (rw == 1 && cols == 128)
    return launch<T, 1, 128, PROMO>(x, ldx, q, ldq, scale, zero_point, out, M, D, Fp, nb, F, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M, D] with row stride ldx (elements; last dimension contiguous, rows
// 16-byte aligned) in `dtype`; q uint8 [D, Fp] with row stride ldq (bytes, a
// multiple of 16; 16-byte aligned); scale / zero_point fp32 [D, nb]
// contiguous; out [M, F]
// contiguous in x's dtype. The tiling: `row_wgs` (2: 128 rows x `cols` 256,
// 128 or 64 columns a block; 1: 64 rows x `cols` 256 or 128, a warpgroup
// each column half). The layouts taken: any D, Fp % nb == 0 with an even
// block Fp / nb, F <= Fp, and the columns of a warpgroup inside one
// virtual block (the block rounded up to a multiple of 64, a multiple of
// `cols` for row_wgs 2, of cols / 2 for 1). `promote` 1 (fp32 x, any tiling
// but row_wgs 2 x cols 256) adds the accumulators into fp32 sums every 256
// rows of D. Returns the CUDA error code of the launch (0 on success).
extern "C" int ds_dequant_matmul_tc(const void* x, long long ldx, const void* q,
                                    long long ldq, const float* scale, const float* zero_point,
                                    void* out, int M, int D, int Fp, int nb, int F, int dtype,
                                    int row_wgs, int cols, int promote, void* stream) {
  if (M <= 0 || F <= 0) return 0;
  const int elt = dtype == ds::kF32 ? 4 : 2;
  const int wn = row_wgs == 2 ? cols : cols / 2;  // columns of a warpgroup
  const int block = nb > 0 ? Fp / nb : 0, bp = (block + 63) / 64 * 64;
  const bool layout = D > 0 && nb > 0 && Fp % nb == 0 && block > 0 && block % 2 == 0 &&
                      wn >= 64 && bp % wn == 0 && F <= Fp;
  const bool aligned = (ldx * elt) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0 && ldq % 16 == 0 && ldq >= Fp;
  if (!layout || !aligned) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (promote && dtype != ds::kF32) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case ds::kF32:
      return static_cast<int>(
          promote ? dispatch_tile<float, true>(row_wgs, cols, x, ldx, q, ldq, scale, zero_point,
                                               out, M, D, Fp, nb, F, s)
                  : dispatch_tile<float, false>(row_wgs, cols, x, ldx, q, ldq, scale,
                                                zero_point, out, M, D, Fp, nb, F, s));
    case ds::kBF16:
      return static_cast<int>(dispatch_tile<__nv_bfloat16, false>(row_wgs, cols, x, ldx, q,
                                                                  ldq, scale, zero_point, out,
                                                                  M, D, Fp, nb, F, s));
    case ds::kF16:
      return static_cast<int>(dispatch_tile<__half, false>(row_wgs, cols, x, ldx, q, ldq, scale,
                                                           zero_point, out, M, D, Fp, nb, F,
                                                           s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
