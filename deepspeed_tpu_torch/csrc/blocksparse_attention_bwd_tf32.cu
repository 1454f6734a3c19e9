// Blocksparse-attention backward on Hopper's tensor cores (sm_90a) for fp32
// inputs, as 3xTF32: the dq and dk/dv passes, at every block (16, 32, 64,
// 128); plain C interface.
//
// Replaces, for fp32 inputs, the TPU kernels _bwd_dq_kernel and
// _bwd_dkv_kernel of deepspeed_tpu/ops/pallas/blocksparse_attention.py (_bwd,
// the pallas_calls at :215 and :239); bf16 and fp16 inputs take
// csrc/blocksparse_attention_bwd_tc.cu. The function is the reference's:
// from the forward's saved fp32 logsumexp (lse [B*H, T]), over the
// (q-block, k-block) pairs of the layout only,
//   P  = exp(scale * q k^T - lse)      (0 where the layout or causal mask hides a key)
//   dV = P^T dO,   dS = P * (dO v^T - delta) * scale,   delta = rowsum(dO * O)
//   dQ = dS k,     dK = dS^T q
// with causal meaning key <= query (T == S) and fp32 accumulators.
//
// The kernels are the 3xTF32 flash backward's (csrc/flash_attention_bwd_tf32.cu,
// copied and given the layout's tile lists as their source of tiles: a
// template policy shared by both files is still to come): every product in
// 3xTF32 (csrc/tc_tile.cuh, section tf32), ~2^-21 of each term dropped where
// one TF32 pass keeps ~2^-11. q k^T is the fp32 product times the scale, as
// the 3xTF32 forward that wrote lse (csrc/blocksparse_attention_fwd_tf32.cu)
// scores it. The products whose operands are both K-major run on wgmma
// m64nNk8 SS over split tiles: q k^T and dO v^T (dq), k q^T and
// v dO^T (dk/dv); the three whose B would be MN-major (dS k, P^T dO, dS^T q)
// on mma.sync m16n8k8 tf32 (HMMA), A from the accumulator as it lies, B
// gathered per thread from the same split tiles.
//
// The layout reaches the kernels as the tile tables of
// ops/cuda/blocksparse_attention.py (tile_tables), as it reaches
// blocksparse_attention_bwd_tc.cu: for each (head, 64-query tile) the
// ascending 64-key tiles holding an active sub-block, each with its bit mask
// (bit r g + c: query sub-block r, key sub-block c, g = 64 / block), the
// transposed table for dk/dv, and the work orders (longest lists first).
// Blocks of 16 and 32 run their own instances (MASK), which zero P (and so
// dS) where a score's sub-block bit is clear, as they mask the causal
// diagonal; blocks of 64 and 128 run the instances without the test. The
// streamed tiles are narrower than a table's tile at D 64 and 128 (32 rows:
// the shared memory of two big + small pairs), so a table entry is streamed
// as two halves, and a half whose keys (dq) or queries (dk/dv) hold no
// active sub-block is skipped: at a block of 32 the waste of a 32-token
// table, without a second table.
//
// Work split: two passes, no atomics. Every output element is written by one
// block in a fixed order, so two runs give bitwise-equal gradients.
// - dq: one block of one warpgroup (128 threads) per (b, head, 64-row q
//   tile), in `order`. It computes delta = rowsum(dO * O) of its rows from o
//   and dO in global memory while its tiles land and writes it for the dk/dv
//   pass (launched after it on the same stream: there is no delta launch).
//   The big and small parts of its q and dO tiles stay, and the BN-key k/v
//   tiles of its list stream through one set of four tiles: once dO v^T is
//   done the next raw k and v are copied (cp.async, zero-filled past T) into
//   v's two tiles while dQ += dS k runs; then k is split into k's tiles and v
//   in place.
// - dkv: one block per (b, head, 64-row k tile), keys as the M dimension: k
//   and v (big and small) stay, the BM-query q/dO tiles of its list stream
//   the same way, with their lse and delta rows double-buffered. S^T = k q^T
//   and dP^T = v dO^T leave P^T and dS^T in accumulator registers.
// Under `causal` a streamed tile wholly on the hidden side of the diagonal
// is skipped (the lists are ascending: the tail of a q tile's, the head of a
// k tile's). A T off 64-row tiles (blocks of 16 / 32) leaves rows past T in
// the last tile: zero-filled, their bits clear, never read from lse / delta,
// never stored.
// Tiles by head dim (fp32, big + small, panels of 32 columns), as the flash
// kernels': D 64 streams 32-row tiles (96 KB a block), D 96 64-row ones (192
// KB), D 128 32-row ones (192 KB).
// Inputs are read through their strides (last dimension contiguous, rows
// 16-byte aligned: the views of the fused qkv projection need no copy);
// dq/dk/dv are written contiguous [B, T, H, D].
//
// What bounds it on the H100: at phase 10a's sparse GPT-2-125M training
// shape (B2, T1024, H12, D64, the Fixed layout of 128: ~7.9M visible pairs)
// dq does 3 products over the visible pairs (3.0 GFLOP) and dk/dv 4 (4.0
// GFLOP), three TF32 passes each: 0.018 and 0.025 ms at 495 TFLOP/s, against
// ~0.011 ms for the bytes each pass moves once at 3.35 TB/s:
// operation-bound. The two passes recompute q k^T and dO v^T (7 products
// where 5 are needed) to keep atomics out, and each block waits on its own
// copies, splits and products, so latency, not the tensor rate, bounds this
// first design, as it bounds the flash kernels it copies.

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

using namespace ds::tc;

constexpr int kTile = 64;  // the tables' tile; rows of the resident tiles
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// rows of a streamed tile (k/v in dq, q/dO in dk/dv) by head dim
template <int D> constexpr int kStream = D == 96 ? 64 : 32;

// Shared layout of both passes (bytes from a 1024-aligned base): the big and
// small parts of the two resident [64][D] tiles (a, b), then of the two
// streamed [R][D] tiles (c, d), then (dk/dv) two buffers of R lse and R delta.
template <int D> struct Layout {
  static constexpr int R = kStream<D>;
  static constexpr int rtile = kTile * D * 4, stile = R * D * 4;
  static constexpr int a = 0, a_small = rtile, b = 2 * rtile, b_small = 3 * rtile;
  static constexpr int c = 4 * rtile, c_small = c + stile;
  static constexpr int d = c + 2 * stile, d_small = c + 3 * stile;
  static constexpr int rows = c + 4 * stile;
  static constexpr int row_stage = 2 * R * 4;  // lse then delta, fp32
  static constexpr int bytes = rows + 2 * row_stage;
};

__device__ __forceinline__ int acc_row(int w, int l, int i) {
  return 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int l, int i) {
  return 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
}

// Write a warp's 16 rows of a [64][D] mma_acc_tf32x3 accumulator to rows
// r0 + ... of a contiguous [B, n, H, D] fp32 output (rows at or past n are
// skipped).
template <int NT>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[NT][4], int b, int h,
                                           int H, int n, int r0, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + 16 * warp + (lane >> 2) + 8 * r;
    if (t < n) store_acc_tf32(out + (((long long)b * n + t) * H + h) * NT * 8, acc, r, 1.f, lane);
  }
}

// rowsum(dO * O) of one row over the quarter of its D columns that lane % 4
// holds, summed over the row's four lanes (two shuffles: all four get the
// same value).
template <int D>
__device__ __forceinline__ float row_delta(const float* orow, const float* drow, int lane) {
  constexpr int per = D / 4;  // 16, 24 or 32 columns: whole 16-byte chunks
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < per; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(orow + (lane & 3) * per + c);
    const float4 y = *reinterpret_cast<const float4*>(drow + (lane & 3) * per + c);
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
    sum = fmaf(x.z, y.z, sum);
    sum = fmaf(x.w, y.w, sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  return sum + __shfl_xor_sync(0xffffffffu, sum, 2);
}

// MASK: blocks of 16 / 32 (tiles of several blocks, each entry tested
// against its sub-block's bit); blocks of 64 / 128 have whole tiles
template <int D, bool MASK>
__global__ void __launch_bounds__(kThreads)
blocksparse_bwd_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, const int* __restrict__ tidx,
    const int* __restrict__ tcnt, const int* __restrict__ tmask, const int* __restrict__ order,
    int H, int T_, int block, int A, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long o_sb, long long o_st, long long o_sh, long long d_sb,
    long long d_st, long long d_sh, float scale, int causal) {
  using L = Layout<D>;
  constexpr int BN = L::R;            // keys a streamed tile
  constexpr int SUBS = kTile / BN;    // streamed tiles a table entry
  constexpr int NT = D / 8;           // n tiles of dQ
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  // resident q (a) and dO (b); streamed k (c) and v (d)
  const uint32_t sQ = base + L::a, sQs = base + L::a_small;
  const uint32_t sO = base + L::b, sOs = base + L::b_small;
  const uint32_t sK = base + L::c, sKs = base + L::c_small;
  const uint32_t sV = base + L::d, sVs = base + L::d_small;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nT = (T_ + kTile - 1) / kTile;
  const int item = order[blockIdx.y];  // h * nT + q tile, the longest lists first
  const int h = item / nT;
  const int b = blockIdx.x, bh = b * H + h;
  const int q0 = (item % nT) * kTile;
  const int shift = __ffs(block) - 1, g = kTile >> shift;  // MASK: log2(block), blocks a side

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* db = dout + b * d_sb + h * d_sh;
  const float* ob = o + b * o_sb + h * o_sh;

  // streamed tile t: keys [BN (t % SUBS), + BN) of the list's entry t / SUBS
  const int* idx = tidx + static_cast<long long>(item) * A;
  const int* msk = tmask + static_cast<long long>(item) * A;
  const int n_sub = tcnt[item] * SUBS;
  auto key0 = [&](int t) { return __ldg(idx + t / SUBS) * kTile + (t % SUBS) * BN; };
  // visited unless causal hides it whole or (MASK) none of its keys'
  // sub-blocks is active
  auto live = [&](int t) {
    if (causal && key0(t) > q0 + kTile - 1) return false;
    if constexpr (MASK && SUBS > 1) {
      const int c = (t % SUBS) * BN;
      return any_bits(static_cast<uint32_t>(__ldg(msk + t / SUBS)), g, c >> shift,
                      (c + BN - 1) >> shift, true);
    }
    return true;
  };
  auto next_live = [&](int t) {
    while (t < n_sub && !live(t)) ++t;
    return t;
  };

  // raw k and v of tile t into v's two tiles, the first to fall free
  auto load_kv = [&](int t) {
    load_tile_async<float, BN, D>(sV, kb, k_st, key0(t), T_, tid, kThreads);
    load_tile_async<float, BN, D>(sVs, vb, v_st, key0(t), T_, tid, kThreads);
  };
  // k from v's big tile into k's tiles, then v in place; published to wgmma
  auto split_kv = [&]() {
    split_tile_tf32(sV, sK, sKs, L::stile, tid, kThreads);
    __syncthreads();
    split_tile_tf32(sVs, sV, sVs, L::stile, tid, kThreads);
    fence_proxy_async();
    __syncthreads();
  };

  int cur = next_live(0);
  load_tile_async<float, kTile, D>(sQ, q + b * q_sb + h * q_sh, q_st, q0, T_, tid, kThreads);
  load_tile_async<float, kTile, D>(sO, db, d_st, q0, T_, tid, kThreads);
  if (cur < n_sub) load_kv(cur);
  cp_async_commit();

  // this thread's two rows: delta (computed here, stored for the dk/dv pass)
  // and lse (log2 domain); a row past T (every lane of the warp shuffles,
  // so it reads row T - 1) gets 0 for both and stores nothing
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + 16 * warp + (lane >> 2) + 8 * r, tr = min(t, T_ - 1);
    const float d = row_delta<D>(ob + tr * o_st, db + tr * d_st, lane);
    dlt[r] = t < T_ ? d : 0.f;
    if (t < T_ && (lane & 3) == 0) delta[(long long)bh * T_ + t] = d;
    lse2[r] = t < T_ ? lse[(long long)bh * T_ + t] * kLog2e : 0.f;
  }
  const float scale2 = scale * kLog2e;

  cp_async_wait<0>();
  __syncthreads();
  split_tile_tf32(sQ, sQ, sQs, L::rtile, tid, kThreads);
  split_tile_tf32(sO, sO, sOs, L::rtile, tid, kThreads);
  if (cur < n_sub) split_kv();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  while (cur < n_sub) {
    const int k0 = key0(cur), kc0 = (cur % SUBS) * BN;  // kc0: k0's offset in its tile
    const uint32_t bits = MASK ? static_cast<uint32_t>(__ldg(msk + cur / SUBS)) : 0u;

    // S = q k^T, dP = dO v^T
    float s[BN / 2], dp[BN / 2];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wgmma_tf32x3<BN, kTile, BN>(s, sQ, sQs, sK, sKs, D / 8);
    wgmma_commit();
    wgmma_tf32x3<BN, kTile, BN>(dp, sO, sOs, sV, sVs, D / 8);
    wgmma_commit();

    // P = exp(scale * S - lse) into s while dO v^T runs
    wgmma_wait<1>();
    fence_regs(s);
    const bool masked = MASK || (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float p = exp2f(fmaf(s[i], scale2, -lse2[(i >> 1) & 1]));
      const int r = acc_row(warp, lane, i), c = acc_col(lane, i);
      if (masked && !visible<MASK>(q0 + r, k0 + c, causal, bits, r, kc0 + c, shift, g)) p = 0.f;
      s[i] = p;
    }
    // dS = P * (dP - delta) * scale into s
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = s[i] * (dp[i] - dlt[(i >> 1) & 1]) * scale;

    __syncthreads();  // every warp's products have read v's tiles
    const int nxt = next_live(cur + 1);
    if (nxt < n_sub) load_kv(nxt);
    cp_async_commit();

    // dQ += dS k (mma.sync, dS from registers, k gathered from its tiles)
    mma_acc_tf32x3<BN>(acc, s, smem + L::c, smem + L::c_small, BN / 8, lane);

    if (nxt < n_sub) {
      cp_async_wait<0>();
      __syncthreads();  // the next raw tiles have landed; every warp is done with k
      split_kv();
    }
    cur = nxt;
  }
  store_rows(dq, acc, b, h, H, T_, q0, warp, lane);
}

template <int D, bool MASK>
__global__ void __launch_bounds__(kThreads)
blocksparse_bwd_dkv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    const int* __restrict__ tidx, const int* __restrict__ tcnt, const int* __restrict__ tmask,
    const int* __restrict__ order, int H, int T_, int block, int A, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long d_sb, long long d_st,
    long long d_sh, float scale, int causal) {
  using L = Layout<D>;
  constexpr int BM = L::R;            // queries a streamed tile
  constexpr int SUBS = kTile / BM;    // streamed tiles a table entry
  constexpr int NT = D / 8;           // n tiles of dK and dV
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  // resident k (a) and v (b); streamed q (c) and dO (d)
  const uint32_t sK = base + L::a, sKs = base + L::a_small;
  const uint32_t sV = base + L::b, sVs = base + L::b_small;
  const uint32_t sQ = base + L::c, sQs = base + L::c_small;
  const uint32_t sO = base + L::d, sOs = base + L::d_small;
  const float* rows_f = reinterpret_cast<const float*>(smem + L::rows);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nT = (T_ + kTile - 1) / kTile;
  const int item = order[blockIdx.y];  // h * nT + k tile, the longest lists first
  const int h = item / nT;
  const int b = blockIdx.x, bh = b * H + h;
  const int k0 = (item % nT) * kTile;
  const int shift = __ffs(block) - 1, g = kTile >> shift;  // MASK: log2(block), blocks a side

  const float* qb = q + b * q_sb + h * q_sh;
  const float* db = dout + b * d_sb + h * d_sh;
  const float* lb = lse + (long long)bh * T_;
  const float* deb = delta + (long long)bh * T_;

  // streamed tile t: queries [BM (t % SUBS), + BM) of the list's entry t / SUBS
  const int* idx = tidx + static_cast<long long>(item) * A;
  const int* msk = tmask + static_cast<long long>(item) * A;
  const int n_sub = tcnt[item] * SUBS;
  auto query0 = [&](int t) { return __ldg(idx + t / SUBS) * kTile + (t % SUBS) * BM; };
  // visited unless causal hides it whole or (MASK) none of its queries'
  // sub-blocks is active
  auto live = [&](int t) {
    if (causal && query0(t) + BM - 1 < k0) return false;
    if constexpr (MASK && SUBS > 1) {
      const int c = (t % SUBS) * BM;
      return any_bits(static_cast<uint32_t>(__ldg(msk + t / SUBS)), g, c >> shift,
                      (c + BM - 1) >> shift, false);
    }
    return true;
  };
  auto next_live = [&](int t) {
    while (t < n_sub && !live(t)) ++t;
    return t;
  };

  // raw q and dO of tile t into dO's two tiles, the first to fall free, and
  // its lse and delta rows into row buffer `buf`
  auto load_qo = [&](int t, int buf) {
    const int q0 = query0(t);
    load_tile_async<float, BM, D>(sO, qb, q_st, q0, T_, tid, kThreads);
    load_tile_async<float, BM, D>(sOs, db, d_st, q0, T_, tid, kThreads);
    const uint32_t rs = base + L::rows + buf * L::row_stage;
    load_row_async(rs, lb, q0, T_, BM, tid, kThreads);
    load_row_async(rs + BM * 4, deb, q0, T_, BM, tid, kThreads);
  };
  // q from dO's big tile into q's tiles, then dO in place; published to wgmma
  auto split_qo = [&]() {
    split_tile_tf32(sO, sQ, sQs, L::stile, tid, kThreads);
    __syncthreads();
    split_tile_tf32(sOs, sO, sOs, L::stile, tid, kThreads);
    fence_proxy_async();
    __syncthreads();
  };

  int cur = next_live(0);
  load_tile_async<float, kTile, D>(sK, k + b * k_sb + h * k_sh, k_st, k0, T_, tid, kThreads);
  load_tile_async<float, kTile, D>(sV, v + b * v_sb + h * v_sh, v_st, k0, T_, tid, kThreads);
  if (cur < n_sub) load_qo(cur, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile_tf32(sK, sK, sKs, L::rtile, tid, kThreads);
  split_tile_tf32(sV, sV, sVs, L::rtile, tid, kThreads);
  if (cur < n_sub) split_qo();

  const float scale2 = scale * kLog2e;
  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  for (int it = 0; cur < n_sub; ++it) {
    const float* sL = rows_f + (it & 1) * (L::row_stage / 4);
    const float* sD = sL + BM;
    const int q0 = query0(cur), qc0 = (cur % SUBS) * BM;  // qc0: q0's offset in its tile
    const uint32_t bits = MASK ? static_cast<uint32_t>(__ldg(msk + cur / SUBS)) : 0u;

    // S^T = k q^T, dP^T = v dO^T (keys are M, queries N)
    float st[BM / 2], dpt[BM / 2];
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    wgmma_tf32x3<BM, kTile, BM>(st, sK, sKs, sQ, sQs, D / 8);
    wgmma_commit();
    wgmma_tf32x3<BM, kTile, BM>(dpt, sV, sVs, sO, sOs, D / 8);
    wgmma_commit();

    // P^T into st while v dO^T runs
    wgmma_wait<1>();
    fence_regs(st);
    const bool masked = MASK || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int r = acc_row(warp, lane, i), c = acc_col(lane, i);
      float p = exp2f(fmaf(st[i], scale2, -sL[c] * kLog2e));
      if (masked && !visible<MASK>(q0 + c, k0 + r, causal, bits, qc0 + c, r, shift, g)) p = 0.f;
      st[i] = p;
    }
    // dS^T = P^T * (dP^T - delta) * scale into dpt
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) dpt[i] = st[i] * (dpt[i] - sD[acc_col(lane, i)]) * scale;

    // dV += P^T dO (mma.sync, dO gathered from its tiles)
    mma_acc_tf32x3<BM>(acc_v, st, smem + L::d, smem + L::d_small, BM / 8, lane);

    __syncthreads();  // every warp is done with dO's tiles
    const int nxt = next_live(cur + 1);
    if (nxt < n_sub) load_qo(nxt, (it + 1) & 1);
    cp_async_commit();

    // dK += dS^T q (mma.sync, q gathered from its tiles)
    mma_acc_tf32x3<BM>(acc_k, dpt, smem + L::c, smem + L::c_small, BM / 8, lane);

    if (nxt < n_sub) {
      cp_async_wait<0>();
      __syncthreads();  // the next raw tiles have landed; every warp is done with q
      split_qo();
    }
    cur = nxt;
  }
  store_rows(dk, acc_k, b, h, H, T_, k0, warp, lane);
  store_rows(dv, acc_v, b, h, H, T_, k0, warp, lane);
}

struct Strides {
  long long b, t, h;
};

struct Args {
  const float *q, *k, *v, *o, *dout, *lse;
  float *delta, *dq, *dk, *dv;
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

template <int D, bool MASK>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = Layout<D>::bytes + 1024;  // + the 1024-byte alignment
  cudaError_t err = set_smem(blocksparse_bwd_dq_tf32_kernel<D, MASK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, a.H * ((a.T + kTile - 1) / kTile));  // every (head, q tile), in `order`
  blocksparse_bwd_dq_tf32_kernel<D, MASK><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.o, a.dout, a.lse, a.delta, a.dq, a.idx, a.cnt, a.mask, a.order, a.H,
      a.T, a.block, a.A, a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b, a.vs.t, a.vs.h,
      a.os.b, a.os.t, a.os.h, a.dos.b, a.dos.t, a.dos.h, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D, bool MASK>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = Layout<D>::bytes + 1024;
  cudaError_t err = set_smem(blocksparse_bwd_dkv_tf32_kernel<D, MASK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, a.H * ((a.T + kTile - 1) / kTile));  // every (head, k tile), in `order`
  blocksparse_bwd_dkv_tf32_kernel<D, MASK><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.idx, a.cnt, a.mask, a.order, a.H,
      a.T, a.block, a.A, a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b, a.vs.t, a.vs.h,
      a.dos.b, a.dos.t, a.dos.h, a.scale, a.causal);
  return cudaGetLastError();
}

enum Pass { kDq = 0, kDkv = 1 };

template <bool MASK>
cudaError_t dispatch_dim(int D, int pass, const Args& a) {
  if (D == 64) return pass == kDq ? launch_dq<64, MASK>(a) : launch_dkv<64, MASK>(a);
  if (D == 96) return pass == kDq ? launch_dq<96, MASK>(a) : launch_dkv<96, MASK>(a);
  if (D == 128) return pass == kDq ? launch_dq<128, MASK>(a) : launch_dkv<128, MASK>(a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int dtype, int D, int pass, const Args& a) {
  if (dtype != ds::kF32) return cudaErrorInvalidValue;  // 16-bit: blocksparse_attention_bwd_tc.cu
  if (a.block == 16 || a.block == 32) return dispatch_dim<true>(D, pass, a);
  if ((a.block == 64 || a.block == 128) && a.T % kTile == 0) return dispatch_dim<false>(D, pass, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns the CUDA error
// code of the launch (0 on success). q/k/v/o/dO [B, T, H, D] fp32 (dtype 0)
// are given by element strides (batch, seq, head; the last dimension
// contiguous, rows 16-byte aligned); lse and delta [B*H, T] fp32; the tile
// tables int32 contiguous on the device (nT = ceil(T / 64) tiles a side: idx
// and mask [H, nT, A], cnt [H, nT], order [H * nT]); D 64, 96 or 128, block
// 16, 32, 64 or 128 (T a multiple of it).

// dq with delta (the counterpart of _bwd_dq_kernel), over each q tile's list
// of k tiles; writes dq [B, T, H, D] contiguous and delta.
extern "C" int ds_blocksparse_attention_bwd_dq_tf32(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, const int* tidx, const int* tcnt,
    const int* tmask, const int* order, int B, int H, int T, int D, int dtype, int block, int A,
    long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, long long d_sb, long long d_st, long long d_sh,
    float scale, int causal, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<float*>(dq);
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

// dk and dv (the counterpart of _bwd_dkv_kernel), after the dq pass on the
// same stream (it reads that pass's delta), over each k tile's list of q
// tiles; writes dk and dv [B, T, H, D] contiguous.
extern "C" int ds_blocksparse_attention_bwd_dkv_tf32(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv, const int* tidx, const int* tcnt,
    const int* tmask, const int* order, int B, int H, int T, int D, int dtype, int block, int A,
    long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long d_sb,
    long long d_st, long long d_sh, float scale, int causal, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = lse;
  a.delta = const_cast<float*>(delta);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
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
