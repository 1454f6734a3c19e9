// Quantized-weight matrix products on Hopper's tensor cores (sm_90a, wgmma),
// for x in fp32, bf16 or fp16 at prefill and verify row counts; plain C
// interface.
//
// Replaces, for x with more rows than a decode step, the TPU kernels of
// deepspeed_tpu/ops/pallas/int8_matmul.py: _kernel (B6, int8, the
// pallas_call at :101) and _kernel4 (B7, nibble-packed int4, :201). Decode
// rows take csrc/int8_matmul_decode.cu, and the layouts neither takes the
// CUDA-core kernel of csrc/int8_matmul.cu (ops/cuda/int8_matmul.py qmm_route
// picks). Same
// function: out = x @ W with W[d, f] = float(q[d, f]) * s[(d F + f) /
// group] in fp32, x widened to fp32, fp32 sums, one rounding to x's dtype.
// For B7, byte j of a packed row holds column j in its low nibble and column
// j + F/2 in its high nibble.
//
// The fp32 function on 16-bit tensor cores, for bf16 / fp16 x
// (qmatmul_tc_kernel). x is exact in its dtype and so
// is q, but w = q s (the plain version's fp32 product) is not: w enters as hi
// = T(w) and lo = T(w - hi), two wgmmas against the same x tile, which keep
// w to ~2^-16 relative in bf16 where one cast keeps 2^-8. fp16's normal
// range ends at 2^-14, so at GPT-2's weight magnitudes (~1e-2) its lo half
// would be subnormal: fp16 multiplies the weights of each 64-column panel by
// 2^e, the power of two that puts 128 (int4: 8) times the panel's largest
// scale over the block's chunk of D in [2^14, 2^15), and the fp32 sums by
// 2^-e before they leave the block; both are exact.
//
// For fp32 x (qmatmul_tc_f32_kernel) the weight's integers are the exact
// operand instead: each 64-column panel lies in one group (group % 64 ==
// 0), so for each 64-deep step v = x s_p (x times the panel's scales of
// those rows of D) is rounded once in fp32 and cut into three bf16 parts by
// truncation (tc_tile.cuh split3: hi + mid + lo == v exactly), and three
// wgmmas sum v q = x (q s_p) in fp32 accumulators against the int8 / int4
// values, exact in bf16. The plain version rounds w = q s to fp32 per
// weight, this kernel x s per (row, panel): both are fp32-accurate products
// of the same function (on the H100 within 2.3e-6 of the largest entry of
// the float64 product at every projection shape of GPT-2-125M and
// gpt2-350m, scripts/quant_tc_bench.py). Keeping the weight as the B
// operand instead (w's three parts against x's three parts) would take
// about six passes where this takes three. Every thread converts (x's rows
// once for both panels, then the weight bytes; rows of x past M are not
// converted, their outputs never being stored), then warpgroup p runs panel
// p's products (12 wgmma m64n64k16 per 64 rows a step) while the TMA copies
// of the next steps land in a ring of 2 (128 rows) or 3 (64 rows) stages;
// the conversion and the products of one step do not overlap (the A tiles
// take 96 KB at 128 rows, no room for a second buffer). The split along D
// in a cluster and its reduction are the 16-bit kernel's. The wgmma
// accumulators' additions truncate, and the error grows with the additions
// into one accumulator (csrc/dequant_matmul_tc.cu, "Promotion"): every
// kPromote steps (256 rows of D) the accumulators are added into IEEE fp32
// sums and start again from zero, so gpt-neox-20b's mlp_down (D 24576, a
// chunk of 12288 rows a block at 64 rows of x) keeps the error of a 256-row
// sum.
//
// Work split (both kernels): a block owns a tile of 128 rows of x (64 when M <= 64), two
// 64-column output panels and one chunk of D. int8: columns [128 b, 128 b +
// 128). int4: packed columns [64 b, 64 b + 64), whose low nibbles are output
// columns [64 b, 64 b + 64) and whose high nibbles [F/2 + 64 b, ...): each
// packed byte is read once and feeds both panels, as in _kernel4. It is two
// warpgroups. The producer copies the chunk's 64-deep steps into a 4-stage
// ring by TMA, two steps ahead: x's 16-bit tile (K-major and 128-byte
// swizzled: the A operand as it lands) and the raw weight bytes. Each
// warpgroup widens half of a step's bytes (dequant_word's byte permute)
// times their scales into one of two pairs of 128-byte-swizzled 16-bit
// tiles (hi, lo; MN-major B). The consumer runs the step's products, 8
// wgmma m64n128k16 per 64 rows (4 k16 x hi / lo), and widens its half of
// the next step while they run; named barriers hand each B pair over and
// back. Each weight byte is read and widened once per 128 rows of x. The
// blocks of one output tile along D form a thread block cluster (up to 8)
// and add their partial sums through distributed shared memory in rank
// order: one launch, no atomics, a result is bitwise repeatable.
//
// What bounds it on the H100: at M = 256 a GPT-2-125M projection is 0.3-1.2
// GFLOP of the function, issued twice (hi and lo) on the tensor cores: 0.6-
// 2.4 us at 989 TFLOP/s (fp32 x: three times, 0.9-3.7 us), against 0.2-0.7
// us for its weight bytes at 3.35 TB/s. So the products bound it, and the
// widening (about 6 instructions a weight, M / 128 times a weight) runs
// beside them; fp32 x's conversion (about 9 instructions an element of x
// per panel) does not. At the row counts of
// prefill chunks and verify windows (40-128) and at narrow matrices the grid
// is small (6-24 output tiles), so the split along D fills the card. The
// tiles come by TMA because 16-byte cp.async copies are throttled per SM (a
// producer issuing them spent most of a step doing so, clock64 stamps on the
// H100); the scales come straight from global memory because a row of them
// need not be 16-byte aligned for TMA. A widening spread over more warps and
// persistent blocks are later work.

#include <stdint.h>

#include <type_traits>

#include <cooperative_groups.h>
#include <cuda.h>

#include "common.cuh"
#include "tc_tile.cuh"
#include "tma_map.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ds::tc;

constexpr int kWgRows = 64;       // rows of x one wgmma m64 covers
constexpr int kStep = 64;         // rows of D a step consumes
constexpr int kStages = 4;        // ring depth: loads run two steps ahead of the widening
constexpr int kThreads = 256;     // the producer warpgroup, then the consumer warpgroup
constexpr int kMaxCluster = 8;    // blocks along D in one cluster (the portable maximum)
constexpr int kCols = 2 * kPanelCols;  // output columns of a block
// the epilogue's partial sums [rows][128] fp32 are kRedStride floats a row
// apart: a float2 store of an accumulator then touches each bank at most
// twice (128 would put the 8 rows of a warp's store on the same banks)
constexpr int kRedStride = kCols + 8;
// named barriers (0 is __syncthreads): B pair b is full (the producer
// arrives, the consumer waits) or empty (the other way round)
constexpr int kFullBar = 1, kEmptyBar = 3;

// Shared layout (bytes from a 1024-aligned base): the ring of kStages stages
// (x's swizzled [128][64] tile, the raw weight bytes [64][128 or 64]), then
// two pairs of B tiles [64][128] (hi, lo). The epilogue's partial sums
// [128][kRedStride] fp32 reuse the ring.
struct Layout {
  static constexpr int x = 0;
  static constexpr int q = x + 2 * kWgRows * kStep * 2;
  static constexpr int stage = q + kStep * kCols;
  static constexpr int b_tile = kStep * kCols * 2;  // one of hi, lo
  static constexpr int b_pair = 2 * b_tile;
  static constexpr int b = kStages * stage;
  static constexpr int bytes = b + 2 * b_pair;
  static_assert(stage % 1024 == 0 && b_tile % 1024 == 0, "swizzled tiles sit on 1024 bytes");
  static_assert(2 * kWgRows * kRedStride * 4 <= b, "the partial sums fit in the ring");
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Row (within one wgmma's 64 rows) and column (within the block's 128) of
// accumulator entry i of wgmma m64n128 for this thread (warp w of its
// warpgroup, lane l); entries 32 p .. 32 p + 31 lie in panel p.
__device__ __forceinline__ int acc_row(int w, int l, int i) {
  return 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int l, int i) {
  return 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
}

// 8 weights of one B row as hi = T(w) and lo = T(w - hi), into 16-byte chunk
// `chunk` of row `r` of the hi and lo tiles.
template <typename T>
__device__ __forceinline__ void store_split(uint32_t hi_tile, uint32_t lo_tile, int r, int chunk,
                                            const float (&w)[8]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = pack2<T>(w[2 * j], w[2 * j + 1]);
    const float2 f = unpack2<T>(h[j]);
    l[j] = pack2<T>(w[2 * j] - f.x, w[2 * j + 1] - f.y);
  }
  const uint32_t off = tile_offset<kStep>(r, chunk);
  st_shared16(hi_tile + off, make_uint4(h[0], h[1], h[2], h[3]));
  st_shared16(lo_tile + off, make_uint4(l[0], l[1], l[2], l[3]));
}

// Four adjacent outputs from fp32 sums: T's packed pairs, or fp32 itself.
template <typename T> __device__ __forceinline__ void store4(T* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack2<T>(v.x, v.y), pack2<T>(v.z, v.w));
}
template <> __device__ __forceinline__ void store4<float>(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

// The cluster's sum of one output tile: each block has written its sums
// over its chunk of D to `red` ([kRows][kRedStride] fp32 in its shared
// memory, panel p's columns at 64 p); each block adds its share of the tile
// over the cluster's chunks, in rank order, and stores it. 4 sums a thread
// at a time, two at once, every rank's value requested before the first is
// added (distributed shared memory is slow to answer).
template <typename T, int kRows>
__device__ __forceinline__ void cluster_sum_store(cg::cluster_group& cluster, const float* red,
                                                  T* out, int M, int F, int m0,
                                                  const int (&col)[2], const bool (&live)[2]) {
  cluster.sync();
  const int cs = gridDim.z, rank = blockIdx.z, tid = threadIdx.x;
  const int stride = 4 * cs * kThreads;
  for (int e0 = 4 * (rank * kThreads + tid); e0 < kRows * kCols; e0 += 2 * stride) {
    float4 t[2][kMaxCluster];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * stride, at = e / kCols * kRedStride + e % kCols;
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < cs && e < kRows * kCols)
          t[u][k] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(const_cast<float*>(red) + at, k));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * stride, r = e / kCols, c = e % kCols, p = c / kPanelCols;
      if (e >= kRows * kCols || m0 + r >= M || !(p ? live[1] : live[0])) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k >= cs) break;
        v.x += t[u][k].x;
        v.y += t[u][k].y;
        v.z += t[u][k].z;
        v.w += t[u][k].w;
      }
      store4<T>(out + (long long)(m0 + r) * F + (p ? col[1] : col[0]) + c % kPanelCols, v);
    }
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

// HALVES: 64-row halves of x a block owns (1 for M <= 64, else 2)
// tmx: x [M, D] in boxes of [64 HALVES rows][64 columns], 128-byte swizzled;
// tmq: the weight bytes [D, F or F / 2] in boxes of [64 rows][128 or 64 bytes]
template <typename T, int BITS, int HALVES>
__global__ void __launch_bounds__(kThreads)
qmatmul_tc_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmq,
                  const float* __restrict__ s, T* __restrict__ out, int M, int D, int F,
                  int group, int chunk) {
  constexpr bool kScaled = std::is_same<T, __half>::value;
  constexpr int kRows = HALVES * kWgRows;                     // rows of x a block owns
  constexpr int kRowBytes = BITS == 8 ? kCols : kPanelCols;  // raw bytes of a block's row
  constexpr float kQMax = BITS == 8 ? 128.f : 8.f;           // largest |q|
  constexpr int kWg = 128;                                    // threads of a warpgroup
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw_u32);

  // one cluster spans grid z (the D chunks), so its rank is blockIdx.z
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = gridDim.z, rank = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wg_tid = tid & (kWg - 1), wg_warp = warp & 3;
  const int m0 = blockIdx.y * kRows;
  const int qc0 = blockIdx.x * kRowBytes;  // the block's first weight byte of a row
  // the first output column of each panel; an int8 block's second panel may
  // lie past F (F % 128 == 64): its bytes and scales load as zeros, no store
  const int col[2] = {qc0, BITS == 8 ? qc0 + kPanelCols : F / 2 + qc0};
  const bool live[2] = {col[0] < F, col[1] < F};
  const int gpr = F / group;  // groups per row
  const int nsp = group >= kPanelCols ? 1 : kPanelCols / group;  // groups per panel row
  const int d0 = rank * chunk;
  const int n = max(0, min(chunk, D - d0)) / kStep;  // this block's steps

  // one mbarrier a ring slot: the slot's TMA tiles have landed
  __shared__ __align__(8) uint64_t tma_bar[kStages];
  const uint32_t bar0 = smem_u32(&tma_bar[0]);
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tmx)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tmq)) : "memory");
#pragma unroll
    for (int k = 0; k < kStages; ++k) mbar_init(bar0 + 8 * k, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // fp16: each panel's power of two from its largest scale over the chunk
  float up[2] = {1.f, 1.f}, down[2] = {1.f, 1.f};
  if constexpr (kScaled) {
    __shared__ float red_max[2][kThreads / 32];
    float mx[2] = {0.f, 0.f};
    for (int i = tid; i < n * kStep * nsp; i += kThreads) {
      const long long g = (long long)(d0 + i / nsp) * gpr + i % nsp;
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (live[p]) mx[p] = fmaxf(mx[p], fabsf(s[g + col[p] / group]));
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      mx[p] = ds::warp_max(mx[p]);
      if (lane == 0) red_max[p][warp] = mx[p];
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float m = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, red_max[p][w]);
      const int e = m > 0.f ? max(-126, min(126, 14 - ilogbf(kQMax * m))) : 0;
      up[p] = pow2(e);
      down[p] = pow2(-e);
    }
  }

  float acc[HALVES][64];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

  // The widening: each warpgroup widens half of a step's 64 weight rows
  // (warpgroup 0 rows 0-31, warpgroup 1 rows 32-63). A thread keeps one
  // column position (per_row divides 128), so its scales are kHalf values a
  // step, read from global memory (a row of scales need not be 16-byte
  // aligned for TMA) before the step's tiles are waited for.
  constexpr int per_row = kRowBytes / 8;                // 8-byte reads of a raw row
  constexpr int kHalf = kStep / 2 * per_row / kWg;      // reads a thread makes a step
  constexpr int kScales = BITS == 8 ? kHalf : 2 * kHalf;
  const int c = wg_tid % per_row;
  const int r0 = wg * kStep / 2 + wg_tid / per_row;  // the thread's first weight row
  // int8: the thread's 16-byte chunk of its panel's row; int4: chunk c of both
  const int cc = BITS == 8 ? c & 7 : c;
  const int g = group >= kPanelCols ? 0 : 8 * cc / group;  // group within the panel row
  const int sbase[2] = {col[0] / group + g, col[1] / group + g};

  // step k's scales of this thread's reads (times fp16's 2^e), 0 for a
  // panel past F
  auto load_scales = [&](int k, float (&sc)[kScales]) {
    const long long row = d0 + k * kStep + r0;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const long long at = (row + j * (kWg / per_row)) * gpr;
      if constexpr (BITS == 8) {
        const int p = c >> 3;
        sc[j] = (p ? live[1] : live[0])
                    ? __ldg(s + at + (p ? sbase[1] : sbase[0])) * (p ? up[1] : up[0])
                    : 0.f;
      } else {
#pragma unroll
        for (int p = 0; p < 2; ++p)
          sc[2 * j + p] = live[p] ? __ldg(s + at + sbase[p]) * up[p] : 0.f;
      }
    }
  };

  // this thread's reads of step k into B pair k % 2, then the proxy fence
  // that makes them visible to wgmma
  auto widen = [&](int k, const float (&sc)[kScales]) {
    const unsigned char* st = base_ptr + (k % kStages) * Layout::stage;
    const uint32_t hi = base + Layout::b + (k & 1) * Layout::b_pair, lo = hi + Layout::b_tile;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int r = r0 + j * (kWg / per_row);
      const uint2 raw = *reinterpret_cast<const uint2*>(st + Layout::q + r * kRowBytes + 8 * c);
      float w[2][BITS == 4 ? 2 : 1][4];
      ds::dequant_word<BITS>(raw.x, w[0]);
      ds::dequant_word<BITS>(raw.y, w[1]);
#pragma unroll
      for (int p = 0; p < (BITS == 8 ? 1 : 2); ++p) {  // int4: low nibbles -> panel 0
        const float f = BITS == 8 ? sc[j] : sc[2 * j + p];
        float v[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = w[0][p][u] * f;
          v[4 + u] = w[1][p][u] * f;
        }
        store_split<T>(hi, lo, r, BITS == 8 ? c : p * 8 + c, v);
      }
    }
    fence_proxy_async();
  };

  auto wait_tiles = [&](int k) { mbar_wait(bar0 + 8 * (k % kStages), (k / kStages) & 1); };
  float sc[kScales];
  if (wg == 0) {
    // producer: starts the TMA copies of step k + 2 into the ring (one
    // thread; rows of x past M and bytes past a row arrive as zeros) and
    // widens its half of step k once the consumer is done with step k - 2
    auto load_stage = [&](int k) {
      const int slot = k % kStages;
      const uint32_t st = base + slot * Layout::stage, bar = bar0 + 8 * slot;
      const int d = d0 + k * kStep;
      mbar_expect_tx(bar, kRows * kStep * 2 + kStep * kRowBytes);
      tma_load_2d(st + Layout::x, &tmx, bar, d, m0);
      tma_load_2d(st + Layout::q, &tmq, bar, qc0, d);
    };
    if (wg_tid == 0)
      for (int k = 0; k < min(n, 2); ++k) load_stage(k);
    for (int k = 0; k < n; ++k) {
      // the consumer is done with step k - 2: its B pair and ring slot are free
      if (k >= 2) bar_sync(kEmptyBar + (k & 1), kThreads);
      if (wg_tid == 0 && k + 2 < n) load_stage(k + 2);
      load_scales(k, sc);
      wait_tiles(k);
      widen(k, sc);
      bar_arrive(kFullBar + (k & 1), kThreads);
    }
    // the consumer's arrivals of its last two steps
    for (int k = max(n - 2, 0); k < n; ++k) bar_sync(kEmptyBar + (k & 1), kThreads);
  } else {
    // consumer: step k's products, 8 wgmma m64n128k16 a 64-row half (4 k16
    // x hi / lo), run while it widens its half of step k + 1
    if (n > 0) {
      load_scales(0, sc);
      wait_tiles(0);
      widen(0, sc);
    }
    for (int k = 0; k < n; ++k) {
      if (k + 1 < n) load_scales(k + 1, sc);
      bar_sync(kFullBar + (k & 1), kThreads);  // the producer's half of step k
      const uint32_t sx = base + (k % kStages) * Layout::stage + Layout::x;
      const uint32_t hi = base + Layout::b + (k & 1) * Layout::b_pair, lo = hi + Layout::b_tile;
#pragma unroll
      for (int h = 0; h < HALVES; ++h) fence_regs(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          const uint64_t da = desc_kmajor<kRows>(sx + h * kWgRows * 128, kk);
          wgmma_ss_mn128<T>(acc[h], da, desc_mnmajor<kStep>(hi, 0, kk));
          wgmma_ss_mn128<T>(acc[h], da, desc_mnmajor<kStep>(lo, 0, kk));
        }
      }
      wgmma_commit();
      if (k + 1 < n) {  // B pair (k + 1) % 2 was step k - 1's, whose products are done
        wait_tiles(k + 1);
        widen(k + 1, sc);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < HALVES; ++h) fence_regs(acc[h]);
      bar_arrive(kEmptyBar + (k & 1), kThreads);
    }
  }

  if (cs == 1) {  // no split along D: straight from the consumer's accumulators
    if (wg == 0) return;
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int p = i / 32, row = m0 + h * kWgRows + acc_row(wg_warp, lane, i);
        if (!live[p] || row >= M) continue;
        *reinterpret_cast<uint32_t*>(out + (long long)row * F + col[p] + acc_col(lane, i) -
                                     p * kPanelCols) =
            pack2<T>(acc[h][i] * down[p], acc[h][i + 1] * down[p]);
      }
    return;
  }

  // publish this block's sums over its chunk (fp16's scale undone, exactly)
  // to the cluster, then each block adds its share of the tile over the
  // cluster's chunks, in rank order
  __syncthreads();  // the ring is free: every copy has landed and been read
  float* red = reinterpret_cast<float*>(base_ptr);  // [kRows][kRedStride]
  if (wg == 1) {
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int i = 0; i < 64; i += 2)
        *reinterpret_cast<float2*>(red + (h * kWgRows + acc_row(wg_warp, lane, i)) * kRedStride +
                                   acc_col(lane, i)) =
            make_float2(acc[h][i] * down[i / 32], acc[h][i + 1] * down[i / 32]);
  }
  cluster_sum_store<T, kRows>(cluster, red, out, M, F, m0, col, live);
}

// ----------------------------------------------------------------- fp32 x
// The ring of the fp32 kernel: each stage holds x's raw fp32 tile [rows][64]
// (TMA, unswizzled: the threads read it to convert it) and the weight bytes;
// then the A tiles (for each of the block's two 64-column panels, the three
// bf16 parts of v = x s, K-major [rows][64] each) and one B tile (the exact
// integers, MN-major [64][128], both panels). Three stages at 64 rows, two
// at 128 (the A tiles take 96 KB there). The partial sums of the cluster's
// reduction reuse the ring.
constexpr int kParts = 3;  // hi, mid, lo of x s
constexpr int kPromote = 4;  // steps of D between promotions of the fp32 accumulators
template <int BITS, int HALVES> struct LayoutF32 {
  static constexpr int rows = HALVES * kWgRows;
  static constexpr int row_bytes = BITS == 8 ? kCols : kPanelCols;  // weight bytes of a row
  static constexpr int stages = HALVES == 2 ? 2 : 3;
  static constexpr int q = rows * kStep * 4;  // after x's raw tile
  static constexpr int stage = (q + kStep * row_bytes + 1023) / 1024 * 1024;
  static constexpr int a_tile = rows * kStep * 2;  // one part of one panel
  static constexpr int a = stages * stage;        // panel p, part j at a + (3 p + j) a_tile
  static constexpr int b = a + 2 * kParts * a_tile;
  static constexpr int bytes = b + kStep * kCols * 2;
  static_assert(rows * kRedStride * 4 <= a, "the partial sums fit in the ring");
};

// A step's weight bytes as exact bf16 integers into the B tile: int8 row r's
// 128 bytes are columns 0-127 (two panels); int4 row r's 64 packed bytes give
// panel 0 (low nibbles) and panel 1 (high nibbles). An integer of at most 8
// bits is its float's top 16 bits.
template <int BITS>
__device__ __forceinline__ void widen_exact(const unsigned char* raw, uint32_t btile, int tid) {
  constexpr int row_bytes = BITS == 8 ? kCols : kPanelCols;
  constexpr int per_row = row_bytes / 8;
#pragma unroll
  for (int j = 0; j < kStep * per_row / kThreads; ++j) {
    const int idx = tid + kThreads * j, r = idx / per_row, c = idx % per_row;
    const uint2 w8 = *reinterpret_cast<const uint2*>(raw + r * row_bytes + 8 * c);
    float w[2][BITS == 4 ? 2 : 1][4];
    ds::dequant_word<BITS>(w8.x, w[0]);
    ds::dequant_word<BITS>(w8.y, w[1]);
#pragma unroll
    for (int p = 0; p < (BITS == 8 ? 1 : 2); ++p) {
      uint32_t h[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        h[u] = __byte_perm(__float_as_uint(w[u >> 1][p][2 * (u & 1)]),
                           __float_as_uint(w[u >> 1][p][2 * (u & 1) + 1]), 0x7632);
      st_shared16(btile + tile_offset<kStep>(r, BITS == 8 ? c : p * 8 + c),
                  make_uint4(h[0], h[1], h[2], h[3]));
    }
  }
}

// fp32 x: for each 64-column panel p (inside one group: group % 64 == 0),
// v = x s_p rounded once in fp32 and cut into three exact bf16 parts
// (split3), against the weight's exact integers; three wgmmas sum
// v q = x (q s_p) in fp32 accumulators. Every thread converts (x's rows
// once, for both panels; the weight bytes), then warpgroup p runs panel p's
// products (12 wgmma m64n64k16 per 64 rows a step) while the ring's next
// copies land. Rows of x past M are not converted: their outputs are never
// stored.
// tmx: x [M, D] fp32 in boxes of [64 HALVES rows][64 columns], unswizzled;
// tmq: as qmatmul_tc_kernel's
template <int BITS, int HALVES>
__global__ void __launch_bounds__(kThreads, 1)
qmatmul_tc_f32_kernel(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmq, const float* __restrict__ s,
                      float* __restrict__ out, int M, int D, int F, int group, int chunk) {
  using L = LayoutF32<BITS, HALVES>;
  constexpr int kRows = L::rows;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw_u32);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = gridDim.z, rank = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wg_warp = warp & 3;
  const int m0 = blockIdx.y * kRows, rows_in = min(kRows, M - m0);
  const int qc0 = blockIdx.x * L::row_bytes;
  const int col[2] = {qc0, BITS == 8 ? qc0 + kPanelCols : F / 2 + qc0};
  const bool live[2] = {col[0] < F, col[1] < F};
  const int gpr = F / group;                              // groups per row
  const int gidx[2] = {col[0] / group, col[1] / group};  // each panel's group
  const int d0 = rank * chunk;
  const int n = max(0, min(chunk, D - d0)) / kStep;  // this block's steps

  __shared__ __align__(8) uint64_t tma_bar[L::stages];
  const uint32_t bar0 = smem_u32(&tma_bar[0]);
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tmx)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tmq)) : "memory");
#pragma unroll
    for (int k = 0; k < L::stages; ++k) mbar_init(bar0 + 8 * k, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // step k's tiles into ring slot k % stages (one thread; rows of x past M
  // and columns past a row arrive as zeros)
  auto load_stage = [&](int k) {
    const int slot = k % L::stages;
    const uint32_t st = base + slot * L::stage, bar = bar0 + 8 * slot;
    const int d = d0 + k * kStep;
    mbar_expect_tx(bar, kRows * kStep * 4 + kStep * L::row_bytes);
    tma_load_2d(st, &tmx, bar, d, m0);
    tma_load_2d(st + L::q, &tmq, bar, qc0, d);
  };
  if (tid == 0)
    for (int k = 0; k < min(n, L::stages); ++k) load_stage(k);

  float acc[HALVES][32], sum[HALVES][32];  // sum: the promoted accumulators
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = sum[h][i] = 0.f;

  const int cx = tid & 7, rx = tid >> 3;  // x: chunk cx (k 8 cx ..) of rows rx + 32 j
  for (int k = 0; k < n; ++k) {
    // the step's scales of this thread's 8 rows of D for each panel (0 past
    // F), read before the tiles are waited for
    float sc[2][8];
    const long long drow = d0 + k * kStep + 8 * cx;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int u = 0; u < 8; ++u)
        sc[p][u] = (p ? live[1] : live[0]) ? __ldg(s + (drow + u) * gpr + (p ? gidx[1] : gidx[0]))
                                           : 0.f;
    mbar_wait(bar0 + 8 * (k % L::stages), (k / L::stages) & 1);
    const unsigned char* st = base_ptr + (k % L::stages) * L::stage;
#pragma unroll
    for (int j = 0; j < 2 * HALVES; ++j) {
      const int r = rx + 32 * j;
      if (r >= rows_in) continue;
      float xv[8];
      read_row8_f32(st + r * kStep * 4, cx, xv);
      const uint32_t off = tile_offset<kRows>(r, cx);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __fmul_rn(xv[u], sc[p][u]);
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) split3(v[2 * u], v[2 * u + 1], hi[u], mid[u], lo[u]);
        const uint32_t at = base + L::a + 3 * p * L::a_tile + off;
        st_shared16(at, make_uint4(hi[0], hi[1], hi[2], hi[3]));
        st_shared16(at + L::a_tile, make_uint4(mid[0], mid[1], mid[2], mid[3]));
        st_shared16(at + 2 * L::a_tile, make_uint4(lo[0], lo[1], lo[2], lo[3]));
      }
    }
    widen_exact<BITS>(st + L::q, base + L::b, tid);
    fence_proxy_async();
    __syncthreads();  // A and B are complete; ring slot k % stages is free
    if (tid == 0 && k + L::stages < n) load_stage(k + L::stages);
    if (wg ? live[1] : live[0]) {  // warpgroup wg: panel wg's products
#pragma unroll
      for (int h = 0; h < HALVES; ++h) fence_regs(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        const uint64_t db = desc_mnmajor<kStep>(base + L::b, wg, kk);
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int p = 0; p < kParts; ++p)
            wgmma_ss_mn64<__nv_bfloat16>(
                acc[h],
                desc_kmajor<kRows>(base + L::a + (3 * wg + p) * L::a_tile + h * kWgRows * kRowBytes,
                                   kk),
                db);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < HALVES; ++h) fence_regs(acc[h]);
      if ((k + 1) % kPromote == 0 || k + 1 == n) {  // promote, and after the last step
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            sum[h][i] += acc[h][i];
            acc[h][i] = 0.f;
          }
      }
    }
    __syncthreads();  // A and B are free for the next step
  }
#pragma unroll
  for (int h = 0; h < HALVES; ++h)  // the epilogue reads the sums from acc
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = sum[h][i];

  if (cs == 1) {  // no split along D: straight from the accumulators
    if (!(wg ? live[1] : live[0])) return;
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = m0 + h * kWgRows + acc_row(wg_warp, lane, i);
        if (row >= M) continue;
        *reinterpret_cast<float2*>(out + (long long)row * F + (wg ? col[1] : col[0]) +
                                   acc_col(lane, i)) = make_float2(acc[h][i], acc[h][i + 1]);
      }
    return;
  }
  // every copy has landed and been read (the loop's last barrier): the ring
  // holds the partial sums, warpgroup p's at panel p's columns
  float* red = reinterpret_cast<float*>(base_ptr);  // [kRows][kRedStride]
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<float2*>(red + (h * kWgRows + acc_row(wg_warp, lane, i)) * kRedStride +
                                 wg * kPanelCols + acc_col(lane, i)) =
          make_float2(acc[h][i], acc[h][i + 1]);
  cluster_sum_store<float, kRows>(cluster, red, out, M, F, m0, col, live);
}

template <typename T, int BITS, int HALVES>
cudaError_t launch(const void* x, long long ldx, const void* q, const float* s, void* out,
                   int M, int D, int F, int group, int chunk, int cluster, cudaStream_t stream) {
  constexpr size_t smem = Layout::bytes + 1024;  // + the 1024-byte alignment
  constexpr int kRowBytes = BITS == 8 ? kCols : kPanelCols;
  const long long Fq = BITS == 8 ? F : F / 2;
  CUtensorMap tmx, tmq;
  if (!ds::tma::make_map(&tmx, std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                x, M, D, 2 * ldx, HALVES * kWgRows, kStep, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !ds::tma::make_map(&tmq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, D, Fq, Fq, kStep, kRowBytes,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qmatmul_tc_kernel<T, BITS, HALVES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int rows = HALVES * kWgRows;
  cudaLaunchConfig_t config = {};
  // int8: 128 output columns a block; int4: 64 packed columns (128 outputs)
  config.gridDim = dim3((F + kCols - 1) / kCols, (M + rows - 1) / rows, cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, qmatmul_tc_kernel<T, BITS, HALVES>, tmx, tmq, s,
                           static_cast<T*>(out), M, D, F, group, chunk);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BITS, int HALVES>
cudaError_t launch_f32(const void* x, long long ldx, const void* q, const float* s, void* out,
                       int M, int D, int F, int group, int chunk, int cluster,
                       cudaStream_t stream) {
  using L = LayoutF32<BITS, HALVES>;
  constexpr size_t smem = L::bytes + 1024;  // + the 1024-byte alignment
  const long long Fq = BITS == 8 ? F : F / 2;
  CUtensorMap tmx, tmq;
  if (!ds::tma::make_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, M, D, 4 * ldx, L::rows, kStep,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !ds::tma::make_map(&tmq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, D, Fq, Fq, kStep, L::row_bytes,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qmatmul_tc_f32_kernel<BITS, HALVES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((F + kCols - 1) / kCols, (M + L::rows - 1) / L::rows, cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, qmatmul_tc_f32_kernel<BITS, HALVES>, tmx, tmq, s,
                           static_cast<float*>(out), M, D, F, group, chunk);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// x's dtype T (float: the fp32 kernel), then the rows' tile
template <typename T, int BITS>
cudaError_t dispatch_rows(const void* x, long long ldx, const void* q, const float* s,
                          void* out, int M, int D, int F, int group, int chunk, int cluster,
                          cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    if (M <= kWgRows)
      return launch_f32<BITS, 1>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, st);
    return launch_f32<BITS, 2>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, st);
  } else {
    if (M <= kWgRows)
      return launch<T, BITS, 1>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, st);
    return launch<T, BITS, 2>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, st);
  }
}

template <typename T>
cudaError_t dispatch_bits(int bits, const void* x, long long ldx, const void* q, const float* s,
                          void* out, int M, int D, int F, int group, int chunk, int cluster,
                          cudaStream_t st) {
  if (bits == 8)
    return dispatch_rows<T, 8>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, st);
  if (bits == 4)
    return dispatch_rows<T, 4>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M, D] with row stride ldx (elements; last dimension contiguous, rows
// 16-byte aligned) in `dtype` 0 (fp32), 1 (bf16) or 2 (fp16); q int8 [D, F]
// (bits 8) or packed [D, F / 2] (bits 4), contiguous and 16-byte aligned; s
// fp32 [D * F / group]; out [M, F] contiguous in x's dtype. The layouts
// taken: D % 64 == 0, F % group == 0, group >= 8 with group % 64 == 0 or 64
// % group == 0 (no 64-column panel crosses a group; fp32: group % 64 == 0,
// one group a panel), F % 64 == 0 (int8) or F % 128 == 0 (int4). D is cut
// into `cluster` chunks of `chunk` rows (a multiple of 64; the last may be
// shorter or empty). Returns the CUDA error code of the launch (0 on
// success).
extern "C" int ds_quant_matmul_tc(const void* x, long long ldx, const void* q, const float* s,
                                  void* out, int M, int D, int F, int group, int chunk,
                                  int cluster, int bits, int dtype, void* stream) {
  const int elt = dtype == ds::kF32 ? 4 : 2;
  const bool layout = D % kStep == 0 && group >= 8 && F % group == 0 &&
                      (group % kPanelCols == 0 ||
                       (kPanelCols % group == 0 && dtype != ds::kF32)) &&
                      F % (bits == 4 ? 2 * kPanelCols : kPanelCols) == 0;
  const bool aligned = (ldx * elt) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (M < 1 || D < 1 || F < 1 || !layout || !aligned || chunk < kStep || chunk % kStep != 0 ||
      cluster < 1 || cluster > kMaxCluster || (long long)chunk * cluster < D)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ds::kF32:
      return dispatch_bits<float>(bits, x, ldx, q, s, out, M, D, F, group, chunk, cluster, st);
    case ds::kBF16:
      return dispatch_bits<__nv_bfloat16>(bits, x, ldx, q, s, out, M, D, F, group, chunk,
                                          cluster, st);
    case ds::kF16:
      return dispatch_bits<__half>(bits, x, ldx, q, s, out, M, D, F, group, chunk, cluster, st);
    default:
      return cudaErrorInvalidValue;
  }
}
