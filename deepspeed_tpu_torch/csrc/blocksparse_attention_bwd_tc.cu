// Blocksparse-attention backward on Hopper's tensor cores (sm_90a, wgmma),
// for bf16 and fp16 inputs at every block (16, 32, 64, 128); plain C
// interface.
//
// Replaces, for 16-bit inputs, the TPU kernels _bwd_dq_kernel and
// _bwd_dkv_kernel of deepspeed_tpu/ops/pallas/blocksparse_attention.py (_bwd,
// the pallas_calls at :215 and :239). fp32 inputs take the 3xTF32 kernels of
// csrc/blocksparse_attention_bwd_tf32.cu (ops/cuda/blocksparse_attention.py
// bs_route). The function is the reference's: from the forward's saved fp32
// logsumexp (lse [B*H, T]), over the (q-block, k-block) pairs of the layout
// only,
//   P  = exp(scale * q k^T - lse)      (0 where the layout or causal mask hides a key)
//   dV = P^T dO,   dS = P * (dO v^T - delta) * scale,   delta = rowsum(dO * O)
//   dQ = dS k,     dK = dS^T q
// with causal meaning key <= query (T == S), fp32 accumulators cast to the
// input dtype at the end.
//
// Numerics, as the tensor-core flash backward (csrc/flash_attention_bwd_tc.cu,
// which this file follows tile for tile) keeps the reference's fp32 function
// from 16-bit operands: q k^T and dO v^T take the operands as they come
// (exact products, fp32 sums; the scale multiplies the fp32 sum); P and dS
// are fp32 in registers and enter dV, dK and dQ as hi / lo halves of the
// input dtype (hi = T(x), lo = T(x - hi), each product issued on both: ~2^-16
// relative for bf16, ~2^-22 for fp16, where one cast keeps 2^-8 / 2^-11).
// fp16 first multiplies each row of P and dS by a running power of two that
// puts the row's largest entry so far in [2^14, 2^15) (tc_tile.cuh
// scale_rows; a row's accumulator is multiplied down when its scale falls,
// and divided by the scale at the end, all exact), so small gradients keep
// their bits above fp16's subnormal range. dQ's dS rows are queries, dV's
// P^T and dK's dS^T rows are keys.
//
// The layout reaches the kernels as the host-built tile tables of
// ops/cuda/blocksparse_attention.py (tile_tables), at the kernels' own
// granularity of 64 tokens whatever the block: for each (head, 64-query
// tile) the ascending 64-key tiles that hold an active block x block
// sub-block, each with its bit mask of active sub-blocks (bit r g + c for
// query sub-block r and key sub-block c, g = 64 / block: 16 bits at a block
// of 16, 4 at 32; blocks of 64 and 128 are whole tiles), the transposed
// table for dk/dv (the same bits), and the work orders [H * nT] (the (head,
// tile) pairs sorted by their count, largest first: work_order). Blocks of
// 16 and 32 run their own instances (MASK), which zero P (and so dS) where a
// score's sub-block bit is clear, where the causal diagonal is masked and
// the same way: a hidden entry is exactly 0, so fp16's running row scale is
// unmoved by it. Blocks of 64 and 128 run the instances without the test.
// The products over the clear sub-blocks of a visited tile are the small
// blocks' cost (the visited share: chip_smoke.py phase 2 prints it).
//
// Work split: two passes, no atomics. Every output element is written by one
// block in a fixed order, so two runs give bitwise-equal gradients.
// - dq: one block of one warpgroup (128 threads) per (b, head, 64-row q tile),
//   in `order` (the longest lists first). It stages its q and dO tiles
//   once, computes delta = rowsum(dO * O) of its rows from o and dO in
//   global memory while they land (each row's four lanes sum a quarter of
//   the columns and combine by two shuffles), writes it as fp32 [B*H, T] for
//   the dk/dv pass (launched after it on the same stream, so the passes must
//   run in that order: there is no delta launch of its own), and streams the
//   64-key k/v tiles of its list through a ring of kStages cp.async stages,
//   the next tile's rows taken from the table as its copy is issued. For
//   each tile: S = q k^T and dP = dO v^T (wgmma m64n64k16, K-major), P and
//   dS in registers, then dQ += dS_hi k + dS_lo k with k read MN-major from
//   the same tile.
// - dkv: one block per (b, head, 64-key k tile), of D / 64 warpgroups, in
//   `order` (at the sparse GPT's Fixed layout a global k-block has ~29
//   active q-blocks, a local one 1-4). It stages k and v once and streams the
//   64-row q tiles of its list with their dO tile and lse / delta rows. With
//   keys as the M dimension, S^T = k q^T and dP^T = v dO^T leave P^T and dS^T
//   in accumulator registers, which feed dV += P^T_hi dO + P^T_lo dO and
//   dK += dS^T_hi q + dS^T_lo q (q and dO read MN-major). At D 96 / 128 the
//   two warpgroups each compute the whole S^T and dP^T and their own 64
//   columns of dK and dV. A k tile with no active q tile runs no tile and
//   writes zeros.
// Under `causal` a tile wholly on the hidden side of the diagonal (a k tile
// above the q tile's last row) has P exactly 0: the ascending lists put such
// tiles at the tail of a q tile's list and at the head of a k tile's, and
// both are cut off before the loop; only a tile on the diagonal is masked.
// A T off 64-row tiles (blocks of 16 / 32) leaves rows past T in the last
// tile: they are zero-filled, their sub-block bits are clear, and they are
// neither read from lse / delta nor stored.
// Inputs are read through their strides (last dimension contiguous, rows
// 16-byte aligned: the views of the fused qkv projection need no copy);
// dq/dk/dv are written contiguous [B, T, H, D].
//
// What bounds it on the H100: at the sparse GPT-2-125M training shape (B2,
// T4096, H12, D64, the Fixed layout: ~69M visible pairs) the backward needs 5
// products over the visible pairs, 44 GFLOP, 0.045 ms at 989 TFLOP/s, and
// moves q, k, v, o, dO, dq, dk, dv, lse and delta once, ~100 MB, 0.030 ms at
// 3.35 TB/s: operation-bound. The two passes issue 10 products' worth of
// wgmma over every visited tile (q k^T and dO v^T in both passes, the three
// output products twice for hi / lo), and each block is one or two
// warpgroups waiting on their own copies and products, as the flash
// backward's: latency, not the tensor rate, bounds this first tensor-core
// design.

#include <type_traits>

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

using namespace ds::tc;

// fp16 operands take the running row scale of tc_tile.cuh (scale_rows)
// before their hi/lo split; bf16 has fp32's exponent range and needs none
template <typename T>
constexpr bool kScaled = std::is_same<T, __half>::value;

// dst += A B for one k step: A the hi/lo halves of the fp32 accumulator x
// (times the rows' scales sc); B MN-major in shared memory.
template <typename T>
__device__ __forceinline__ void mma_acc_a(float (&dst)[32], const float (&x)[32], int kk,
                                          const float (&sc)[2], uint64_t db) {
  uint32_t hi[4], lo[4];
  acc_to_a<T>(x, kk, hi, lo, sc);
  wgmma_rs_mn<T>(dst, hi, db);
  wgmma_rs_mn<T>(dst, lo, db);
}

constexpr int kTile = 64;     // rows of a q tile and of a k tile
constexpr int kStages = 2;    // ring depth of the streamed tiles
constexpr int kWgThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct TileBytes {
  static constexpr int value = kTile * kPadded<D> * 2;  // one [64][D] 16-bit tile, whole panels
};

// Shared layout of the dq kernel (bytes from a 1024-aligned base): q, dO,
// then kStages x (k, v).
template <int D> struct DqLayout {
  static constexpr int tile = TileBytes<D>::value;
  static constexpr int q = 0;
  static constexpr int dout = q + tile;
  static constexpr int ring = dout + tile;
  static constexpr int stage = 2 * tile;  // k then v
  static constexpr int bytes = ring + kStages * stage;
};

// Shared layout of the dkv kernel: k, v, then kStages x (q, dO), then
// kStages x (lse, delta) rows.
template <int D> struct DkvLayout {
  static constexpr int tile = TileBytes<D>::value;
  static constexpr int k = 0;
  static constexpr int v = k + tile;
  static constexpr int ring = v + tile;
  static constexpr int stage = 2 * tile;  // q then dO
  static constexpr int rows = ring + kStages * stage;
  static constexpr int row_stage = 2 * kTile * 4;  // lse then delta, fp32
  static constexpr int bytes = rows + kStages * row_stage;
};

__device__ __forceinline__ uint32_t aligned_smem_base(unsigned char* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

// Row (within the 64-row tile) and column of accumulator entry i for this
// thread (warp w of its warpgroup, lane l).
__device__ __forceinline__ int acc_row(int w, int l, int i) {
  return 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int l, int i) {
  return 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
}

// rowsum(dO * O) of row `t` over the quarter of its D columns that lane % 4
// holds, summed over the row's four lanes (two shuffles: all four get the
// same value).
template <typename T, int D>
__device__ __forceinline__ float row_delta(const T* orow, const T* drow, int lane) {
  constexpr int per = D / 4;  // 16, 24 or 32 columns: whole 16-byte chunks
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < per; c += 8) {
    float x[8], y[8];
    ds::load16<T>(orow + (lane & 3) * per + c, x);
    ds::load16<T>(drow + (lane & 3) * per + c, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) sum = fmaf(x[j], y[j], sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  return sum + __shfl_xor_sync(0xffffffffu, sum, 2);
}

// MASK: blocks of 16 / 32 (tiles of several blocks, each entry tested
// against its sub-block's bit); blocks of 64 / 128 have whole tiles
template <typename T, int D, bool MASK>
__global__ void __launch_bounds__(kWgThreads)
blocksparse_bwd_dq_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, const int* __restrict__ tidx,
    const int* __restrict__ tcnt, const int* __restrict__ tmask, const int* __restrict__ order,
    int H, int T_, int block, int A, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long o_sb, long long o_st, long long o_sh, long long d_sb,
    long long d_st, long long d_sh, float scale, int causal) {
  using L = DqLayout<D>;
  constexpr int DP = kPadded<D>;         // whole 64-column panels (D 96: 128)
  constexpr int NP = DP / kPanelCols;    // output panels of 64 columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t sQ = base + L::q, sO = base + L::dout;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nT = (T_ + kTile - 1) / kTile;
  const int item = order[blockIdx.y];  // h * nT + q tile, the longest lists first
  const int h = item / nT;
  const int b = blockIdx.x, bh = b * H + h;
  const int q0 = (item % nT) * kTile;
  const int shift = __ffs(block) - 1, g = kTile >> shift;  // MASK: log2(block), blocks a side

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const T* db = dout + b * d_sb + h * d_sh;

  // tile t of the list: 64-key tile idx[t], its sub-blocks' bits msk[t]
  const int* idx = tidx + static_cast<long long>(item) * A;
  const int* msk = tmask + static_cast<long long>(item) * A;
  auto key0 = [&](int t) { return __ldg(idx + t) * kTile; };
  int n_k_tiles = tcnt[item];
  if (causal)  // the ascending list's tail lies wholly above the q tile's last row
    while (n_k_tiles > 0 && key0(n_k_tiles - 1) > q0 + kTile - 1) --n_k_tiles;

  // prologue: q and dO with the first k/v tiles, one commit group per stage
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s == 0) {
      load_tile_async<T, kTile, D, DP>(sQ, q + b * q_sb + h * q_sh, q_st, q0, T_, tid,
                                       kWgThreads);
      load_tile_async<T, kTile, D, DP>(sO, db, d_st, q0, T_, tid, kWgThreads);
    }
    if (s < n_k_tiles) {
      const uint32_t st = base + L::ring + s * L::stage;
      const int k0 = key0(s);
      load_tile_async<T, kTile, D, DP>(st, kb, k_st, k0, T_, tid, kWgThreads);
      load_tile_async<T, kTile, D, DP>(st + L::tile, vb, v_st, k0, T_, tid, kWgThreads);
    }
    cp_async_commit();
  }

  // this thread's two rows: delta (computed here, stored for the dk/dv pass)
  // and lse (log2 domain); a row past T (every lane of the warp shuffles,
  // so it reads row T - 1) gets 0 for both and stores nothing
  float lse2[2], dlt[2];
  const T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + 16 * warp + (lane >> 2) + 8 * r, tr = min(t, T_ - 1);
    const float d = row_delta<T, D>(ob + tr * o_st, db + tr * d_st, lane);
    dlt[r] = t < T_ ? d : 0.f;
    if (t < T_ && (lane & 3) == 0) delta[(long long)bh * T_ + t] = d;
    lse2[r] = t < T_ ? lse[(long long)bh * T_ + t] * kLog2e : 0.f;
  }
  const float scale2 = scale * kLog2e;

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  int e_ds[2] = {kNoScale, kNoScale};  // fp16: dS's running scale of this thread's rows

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int pf = kt + kStages - 1;  // refill the stage consumed last iteration
    if (pf < n_k_tiles) {
      const uint32_t st = base + L::ring + (pf % kStages) * L::stage;
      const int k0 = key0(pf);
      load_tile_async<T, kTile, D, DP>(st, kb, k_st, k0, T_, tid, kWgThreads);
      load_tile_async<T, kTile, D, DP>(st + L::tile, vb, v_st, k0, T_, tid, kWgThreads);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile kt (and q, dO) have landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t sK = base + L::ring + (kt % kStages) * L::stage;
    const uint32_t sV = sK + L::tile;
    const int k0 = key0(kt);
    const uint32_t bits = MASK ? static_cast<uint32_t>(__ldg(msk + kt)) : 0u;

    // S = q k^T, dP = dO v^T
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<T>(s, desc_kmajor<kTile>(sQ, ks), desc_kmajor<kTile>(sK, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<T>(dp, desc_kmajor<kTile>(sO, ks), desc_kmajor<kTile>(sV, ks), ks > 0);
    wgmma_commit();

    // P = exp(scale * S - lse) into s while dO v^T runs
    wgmma_wait<1>();
    fence_regs(s);
    const bool masked = MASK || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = exp2f(fmaf(s[i], scale2, -lse2[(i >> 1) & 1]));
      const int r = acc_row(warp, lane, i), c = acc_col(lane, i);
      if (masked && !visible<MASK>(q0 + r, k0 + c, causal, bits, r, c, shift, g)) p = 0.f;
      s[i] = p;
    }
    // dS = P * (dP - delta) * scale into s
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = s[i] * (dp[i] - dlt[(i >> 1) & 1]) * scale;
    float sc[2] = {1.f, 1.f};  // dS's row scale in the split (fp16 only)
    if constexpr (kScaled<T>) {  // and dQ's sums so far brought to it
      float f[2];
      scale_rows(s, e_ds, sc, f);
#pragma unroll
      for (int p = 0; p < NP; ++p) rescale_rows(acc[p], f);
    }

    // dQ += dS_hi k + dS_lo k (A from registers, k MN-major)
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        mma_acc_a<T>(acc[p], s, kk, sc, desc_mnmajor<kTile>(sK, p, kk));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  const float undo[2] = {unscale(e_ds[0]), unscale(e_ds[1])};  // 1 for bf16
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      if (p * kPanelCols + acc_col(lane, i) >= D) continue;  // D 96's zero columns
      const int t = q0 + acc_row(warp, lane, i);
      if (t >= T_) continue;
      T* row = dq + (((long long)b * T_ + t) * H + h) * D;
      const float u = undo[(i >> 1) & 1];
      *reinterpret_cast<uint32_t*>(row + p * kPanelCols + acc_col(lane, i)) =
          pack2<T>(acc[p][i] * u, acc[p][i + 1] * u);
    }
}

template <typename T, int D, bool MASK>
__global__ void __launch_bounds__(kWgThreads * (kPadded<D> / kPanelCols))
blocksparse_bwd_dkv_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ tidx,
    const int* __restrict__ tcnt, const int* __restrict__ tmask, const int* __restrict__ order,
    int H, int T_, int block, int A, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long d_sb, long long d_st, long long d_sh, float scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int DP = kPadded<D>;       // whole 64-column panels (D 96: 128)
  constexpr int NWG = DP / kPanelCols;  // warpgroups, one 64-column panel of dK / dV each
  constexpr int NT = kWgThreads * NWG;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t sK = base + L::k, sV = base + L::v;
  const float* rows_f = reinterpret_cast<const float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                                       L::rows);

  const int tid = threadIdx.x, wg = tid / kWgThreads;
  const int warp = (tid % kWgThreads) >> 5, lane = tid & 31;
  const int nT = (T_ + kTile - 1) / kTile;
  const int item = order[blockIdx.y];  // h * nT + k tile, the longest lists first
  const int h = item / nT;
  const int b = blockIdx.x, bh = b * H + h;
  const int k0 = (item % nT) * kTile;
  const int shift = __ffs(block) - 1, g = kTile >> shift;  // MASK: log2(block), blocks a side

  const T* qb = q + b * q_sb + h * q_sh;
  const T* db = dout + b * d_sb + h * d_sh;
  const float* lb = lse + (long long)bh * T_;
  const float* deb = delta + (long long)bh * T_;

  // tile t of the list: 64-query tile idx[t], its sub-blocks' bits msk[t]
  const int* idx = tidx + static_cast<long long>(item) * A;
  const int* msk = tmask + static_cast<long long>(item) * A;
  auto query0 = [&](int t) { return __ldg(idx + t) * kTile; };
  const int n_tiles = tcnt[item];
  int first = 0;
  if (causal)  // the ascending list's head lies wholly before the k tile's first key
    while (first < n_tiles && query0(first) + kTile - 1 < k0) ++first;
  const int n = n_tiles - first;

  auto load_q_tile = [&](int it) {
    const int s = it % kStages, q0 = query0(first + it);
    const uint32_t st = base + L::ring + s * L::stage;
    load_tile_async<T, kTile, D, DP>(st, qb, q_st, q0, T_, tid, NT);
    load_tile_async<T, kTile, D, DP>(st + L::tile, db, d_st, q0, T_, tid, NT);
    const uint32_t rs = base + L::rows + s * L::row_stage;
    load_row_async(rs, lb, q0, T_, kTile, tid, NT);
    load_row_async(rs + kTile * 4, deb, q0, T_, kTile, tid, NT);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s == 0) {
      load_tile_async<T, kTile, D, DP>(sK, k + b * k_sb + h * k_sh, k_st, k0, T_, tid, NT);
      load_tile_async<T, kTile, D, DP>(sV, v + b * v_sb + h * v_sh, v_st, k0, T_, tid, NT);
    }
    if (s < n) load_q_tile(s);
    cp_async_commit();
  }

  const float scale2 = scale * kLog2e;
  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  // fp16: the running scales of P^T's and dS^T's rows (this thread's keys)
  int e_p[2] = {kNoScale, kNoScale}, e_ds[2] = {kNoScale, kNoScale};

  for (int it = 0; it < n; ++it) {
    if (it + kStages - 1 < n) load_q_tile(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    fence_proxy_async();
    __syncthreads();

    const int s_idx = it % kStages;
    const uint32_t sQ = base + L::ring + s_idx * L::stage;
    const uint32_t sO = sQ + L::tile;
    const float* sL = rows_f + s_idx * (L::row_stage / 4);
    const float* sD = sL + kTile;
    const int q0 = query0(first + it);
    const uint32_t bits = MASK ? static_cast<uint32_t>(__ldg(msk + first + it)) : 0u;

    // S^T = k q^T, dP^T = v dO^T (keys are M, queries N)
    float st[32], dpt[32];
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<T>(st, desc_kmajor<kTile>(sK, ks), desc_kmajor<kTile>(sQ, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<T>(dpt, desc_kmajor<kTile>(sV, ks), desc_kmajor<kTile>(sO, ks), ks > 0);
    wgmma_commit();

    // P^T into st while v dO^T runs
    wgmma_wait<1>();
    fence_regs(st);
    const bool masked = MASK || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = acc_row(warp, lane, i), c = acc_col(lane, i);
      float p = exp2f(fmaf(st[i], scale2, -sL[c] * kLog2e));
      if (masked && !visible<MASK>(q0 + c, k0 + r, causal, bits, c, r, shift, g)) p = 0.f;
      st[i] = p;
    }
    float sc_p[2] = {1.f, 1.f};  // P^T's row scale in the split (fp16 only)
    if constexpr (kScaled<T>) {
      float f[2];
      scale_rows(st, e_p, sc_p, f);
      rescale_rows(acc_v, f);
    }

    // dV += P^T_hi dO + P^T_lo dO on this warpgroup's 64 columns (dO read
    // MN-major), issued before dS^T so the two overlap
    fence_regs(acc_v);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      mma_acc_a<T>(acc_v, st, kk, sc_p, desc_mnmajor<kTile>(sO, wg, kk));
    wgmma_commit();

    // dS^T = P^T * (dP^T - delta) * scale into dpt (v dO^T is done once
    // only the dV group may still run)
    wgmma_wait<1>();
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) dpt[i] = st[i] * (dpt[i] - sD[acc_col(lane, i)]) * scale;
    float sc_ds[2] = {1.f, 1.f};  // dS^T's row scale in the split (fp16 only)
    if constexpr (kScaled<T>) {
      float f[2];
      scale_rows(dpt, e_ds, sc_ds, f);
      rescale_rows(acc_k, f);
    }

    // dK += dS^T_hi q + dS^T_lo q (q read MN-major)
    fence_regs(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      mma_acc_a<T>(acc_k, dpt, kk, sc_ds, desc_mnmajor<kTile>(sQ, wg, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_k);
    fence_regs(acc_v);
    __syncthreads();
  }
  cp_async_wait<0>();

  const float k_undo[2] = {unscale(e_ds[0]), unscale(e_ds[1])};  // 1 for bf16
  const float v_undo[2] = {unscale(e_p[0]), unscale(e_p[1])};
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    if (wg * kPanelCols + acc_col(lane, i) >= D) continue;  // D 96's zero columns
    const int key = k0 + acc_row(warp, lane, i);
    if (key >= T_) continue;
    const long long off = (((long long)b * T_ + key) * H + h) * D + wg * kPanelCols +
                          acc_col(lane, i);
    const int r = (i >> 1) & 1;
    *reinterpret_cast<uint32_t*>(dk + off) =
        pack2<T>(acc_k[i] * k_undo[r], acc_k[i + 1] * k_undo[r]);
    *reinterpret_cast<uint32_t*>(dv + off) =
        pack2<T>(acc_v[i] * v_undo[r], acc_v[i + 1] * v_undo[r]);
  }
}

struct Strides {
  long long b, t, h;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  const int *idx, *cnt, *mask, *order;
  int B, H, T, block, A;
  Strides qs, ks, vs, os, dos;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, bool MASK>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = DqLayout<D>::bytes + 1024;
  cudaError_t err = set_smem(blocksparse_bwd_dq_tc_kernel<T, D, MASK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, a.H * ((a.T + kTile - 1) / kTile));  // every (head, q tile), in `order`
  blocksparse_bwd_dq_tc_kernel<T, D, MASK><<<grid, kWgThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.dq), a.idx, a.cnt, a.mask, a.order, a.H, a.T, a.block, a.A,
      a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b, a.vs.t, a.vs.h,
      a.os.b, a.os.t, a.os.h, a.dos.b, a.dos.t, a.dos.h, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D, bool MASK>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = DkvLayout<D>::bytes + 1024;
  cudaError_t err = set_smem(blocksparse_bwd_dkv_tc_kernel<T, D, MASK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, a.H * ((a.T + kTile - 1) / kTile));  // every (head, k tile), in `order`
  blocksparse_bwd_dkv_tc_kernel<T, D, MASK><<<grid, kWgThreads * (kPadded<D> / kPanelCols),
                                              smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.idx, a.cnt, a.mask, a.order, a.H, a.T, a.block, a.A,
      a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b, a.vs.t, a.vs.h,
      a.dos.b, a.dos.t, a.dos.h, a.scale, a.causal);
  return cudaGetLastError();
}

enum Pass { kDq = 0, kDkv = 1 };

template <typename T, bool MASK>
cudaError_t dispatch_dim(int D, int pass, const Args& a) {
  if (D == 64) return pass == kDq ? launch_dq<T, 64, MASK>(a) : launch_dkv<T, 64, MASK>(a);
  if (D == 96) return pass == kDq ? launch_dq<T, 96, MASK>(a) : launch_dkv<T, 96, MASK>(a);
  if (D == 128) return pass == kDq ? launch_dq<T, 128, MASK>(a) : launch_dkv<T, 128, MASK>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_block(int D, int pass, const Args& a) {
  if (a.block == 16 || a.block == 32) return dispatch_dim<T, true>(D, pass, a);
  if ((a.block == 64 || a.block == 128) && a.T % kTile == 0)
    return dispatch_dim<T, false>(D, pass, a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int dtype, int D, int pass, const Args& a) {
  switch (dtype) {  // fp32 runs the 3xTF32 kernels of blocksparse_attention_bwd_tf32.cu
    case ds::kBF16: return dispatch_block<__nv_bfloat16>(D, pass, a);
    case ds::kF16: return dispatch_block<__half>(D, pass, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns the CUDA error
// code of the launch (0 on success). q/k/v/o/dO [B, T, H, D] are given by
// element strides (batch, seq, head; the last dimension contiguous, rows
// 16-byte aligned); lse and delta [B*H, T] fp32; the tile tables int32
// contiguous on the device (nT = ceil(T / 64) tiles a side: idx and mask [H,
// nT, A], cnt [H, nT], order [H * nT]); dtype 1 (bf16) or 2 (fp16), D 64, 96
// or 128, block 16, 32, 64 or 128 (T a multiple of it).

// dq with delta (the counterpart of _bwd_dq_kernel) on the tensor cores,
// over each q tile's list of k tiles; writes dq [B, T, H, D] contiguous and
// delta.
extern "C" int ds_blocksparse_attention_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, const int* tidx, const int* tcnt,
    const int* tmask, const int* order, int B, int H, int T, int D, int dtype, int block, int A,
    long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, long long d_sb, long long d_st, long long d_sh,
    float scale, int causal, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.idx = tidx;
  a.cnt = tcnt;
  a.mask = tmask;
  a.order = order;
  a.B = B;
  a.H = H;
  a.T = T;
  a.block = block;
  a.A = A;
  a.qs = {q_sb, q_st, q_sh};
  a.ks = {k_sb, k_st, k_sh};
  a.vs = {v_sb, v_st, v_sh};
  a.os = {o_sb, o_st, o_sh};
  a.dos = {d_sb, d_st, d_sh};
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, kDq, a);
}

// dk and dv (the counterpart of _bwd_dkv_kernel) on the tensor cores, after
// the dq pass on the same stream (it reads that pass's delta), over each k
// tile's list of q tiles; writes dk and dv [B, T, H, D] contiguous.
extern "C" int ds_blocksparse_attention_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv, const int* tidx, const int* tcnt,
    const int* tmask, const int* order, int B, int H, int T, int D, int dtype, int block, int A,
    long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long d_sb,
    long long d_st, long long d_sh, float scale, int causal, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = const_cast<float*>(delta);
  a.dk = dk;
  a.dv = dv;
  a.idx = tidx;
  a.cnt = tcnt;
  a.mask = tmask;
  a.order = order;
  a.B = B;
  a.H = H;
  a.T = T;
  a.block = block;
  a.A = A;
  a.qs = {q_sb, q_st, q_sh};
  a.ks = {k_sb, k_st, k_sh};
  a.vs = {v_sb, v_st, v_sh};
  a.dos = {d_sb, d_st, d_sh};
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, kDkv, a);
}
