// Blocksparse-attention forward on Hopper's tensor cores (sm_90a) for fp32
// inputs, as 3xTF32, at every block (16, 32, 64, 128); plain C interface.
//
// Replaces, for fp32 inputs, the TPU kernel _fwd_kernel of
// deepspeed_tpu/ops/pallas/blocksparse_attention.py (_fwd, the pallas_call at
// :186); bf16 and fp16 inputs take csrc/blocksparse_attention_fwd_tc.cu. The
// function is the reference's: for each (batch, head), o = softmax(scale
// q k^T + mask) v where the mask keeps the (q-block, k-block) pairs of a
// static [H, T/block, T/block] layout and, under `causal`, keys at or before
// the query (T == S, aligned top-left); an fp32 online softmax; a row with no
// visible key gives o = 0 and lse = -1e30 (l == 0 -> l_safe = 1); the fp32
// logsumexp stored as [B*H, T] for the backward.
//
// The kernel is the 3xTF32 flash forward's (csrc/flash_attention_fwd_tf32.cu,
// copied and given the layout's tile lists as its source of tiles, as
// csrc/blocksparse_attention_bwd_tf32.cu copies the flash backward: a template
// policy shared by the files is still to come): each product in 3xTF32
// (csrc/tc_tile.cuh, section tf32), ~2^-21 of each term dropped where one TF32
// pass keeps ~2^-11. q k^T is the fp32 product times the scale, as the
// 3xTF32 backward scores it, so the two passes score alike. S = q k^T runs on
// wgmma m64nNk8 tf32 SS over the split q and k tiles (both K-major); P V on
// mma.sync m16n8k8 tf32 (HMMA), P's A fragments taken from the score
// accumulator as they lie (acc_to_a_tf32) and V's B fragments gathered per
// thread from the split V tiles (b_offset_tf32).
//
// The layout reaches the kernel as the tile tables of
// ops/cuda/blocksparse_attention.py (tile_tables), the ones the backward's dq
// pass walks: for each (head, 64-query tile) the ascending 64-key tiles
// holding an active sub-block, each with its bit mask (bit r g + c: query
// sub-block r, key sub-block c, g = 64 / block), and the work order (longest
// lists first). Blocks of 16 and 32 run their own instances (MASK), which
// hide an entry whose sub-block bit is clear where they mask the causal
// diagonal: it scores kNegInf, moves no running maximum, and its P is set to
// exactly 0 from the test (a row whose earlier tiles hid all its keys has its
// maximum still at kNegInf, where exp2(s - m) would be 1); its l stays 0 until
// its first visible key, whose rescale exp2(kNegInf - m) is 0, and a row that
// no listed tile shows writes o = 0 and lse = -1e30. Blocks of 64 and 128 run
// the instances without the test.
//
// Work split: one block of one warpgroup (128 threads) per (b, head, 64-row q
// tile), in `order`. The big and small parts of its q tile stay in shared
// memory; the BN-key k/v tiles of its list stream through one set of four
// tiles (big and small k and v), no ring: once S = q k^T is done, the next
// tile's raw k and v are copied (cp.async, zero-filled past T) into k's two
// tiles while the softmax and P V run; then v is split into v's tiles and k
// in place. Tiles by head dim and instance (fp32, big + small, panels of 32
// columns): BN 64 at D 64 (96 KB a block) and D 128 (192 KB) for whole
// tiles, as B1's forward; BN 32 at D 96 (96 KB, where B1 measured 64 slower)
// and for MASK (64 / 96 / 128 KB at D 64 / 96 / 128), where a table entry is
// streamed as two 32-key halves and a half whose keys hold no active
// sub-block is skipped: at blocks of 16 / 32 the saving a 32-token table
// would give. Under `causal` a streamed tile wholly above the q tile's last
// row is skipped (the tail of the ascending list); only tiles that straddle
// the diagonal are masked. A T off 64-row tiles (blocks of 16 / 32) leaves
// rows past T in the last tile: zero-filled, their bits clear, never stored.
// Inputs are read through their strides (last dimension contiguous, rows
// 16-byte aligned: the q/k/v views of the fused qkv projection need no copy);
// o is written contiguous [B, T, H, D].
//
// What bounds it on the H100: at phase 10a's sparse GPT-2-125M shape (B2,
// T1024, H12, D64, the Fixed layout of 128: ~7.9M visible pairs) it does 2
// products over the visible pairs, 2.0 GFLOP, three TF32 passes of each:
// 0.0123 ms at 495 TFLOP/s (0.030 ms for one fp32 pass on the CUDA cores'
// 67); it moves q, k, v, o and lse once, 6.4 MB, 0.0019 ms at 3.35 TB/s:
// operation-bound. It issues the products over every visited tile (the
// diagonal's hidden half, and at blocks of 16 / 32 the clear sub-blocks of a
// visited half), and the block waits on its own copies, splits and products
// (no producer warp), as the flash forward it copies does: that latency
// chain and the per-thread B loads of P V bound this design.

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

using namespace ds::tc;

constexpr int kTile = 64;  // the tables' tile; rows of the q tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// keys of a streamed k/v tile, see the header
template <int D, bool MASK> constexpr int kKeys = (MASK || D == 96) ? 32 : 64;

// Shared layout (bytes from a 1024-aligned base): the big and small parts of
// q ([64][D] fp32 tiles of D / 32 swizzled panels), then of k and v ([BN][D]).
template <int D, int BN> struct FwdLayout {
  static constexpr int qtile = kTile * D * 4, ktile = BN * D * 4;
  static constexpr int q = 0, q_small = qtile;
  static constexpr int k = 2 * qtile, k_small = k + ktile;
  static constexpr int v = k + 2 * ktile, v_small = k + 3 * ktile;
  static constexpr int bytes = k + 4 * ktile;
};

__device__ __forceinline__ int acc_row(int w, int l, int i) {
  return 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int l, int i) {
  return 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
}

// MASK: blocks of 16 / 32 (tiles of several blocks, each entry tested
// against its sub-block's bit); blocks of 64 / 128 have whole tiles
template <int D, bool MASK>
__global__ void __launch_bounds__(kThreads)
blocksparse_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, const int* __restrict__ tidx,
    const int* __restrict__ tcnt, const int* __restrict__ tmask, const int* __restrict__ order,
    int H, int T_, int block, int A, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, float scale, int causal) {
  constexpr int BN = kKeys<D, MASK>;  // keys a streamed tile
  constexpr int SUBS = kTile / BN;    // streamed tiles a table entry
  constexpr int NT = D / 8;           // n tiles of P V
  using L = FwdLayout<D, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base + L::q, sQs = base + L::q_small;
  const uint32_t sK = base + L::k, sKs = base + L::k_small;
  const uint32_t sV = base + L::v, sVs = base + L::v_small;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nT = (T_ + kTile - 1) / kTile;
  const int item = order[blockIdx.y];  // h * nT + q tile, the longest lists first
  const int h = item / nT;
  const int b = blockIdx.x, bh = b * H + h;
  const int q0 = (item % nT) * kTile;
  const int shift = __ffs(block) - 1, g = kTile >> shift;  // MASK: log2(block), blocks a side

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

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

  // raw k and v of tile t into k's two tiles, the first to fall free
  auto load_kv = [&](int t) {
    load_tile_async<float, BN, D>(sK, kb, k_st, key0(t), T_, tid, kThreads);
    load_tile_async<float, BN, D>(sKs, vb, v_st, key0(t), T_, tid, kThreads);
  };
  // v from k's small tile into v's tiles, then k in place; published to wgmma
  auto split_kv = [&]() {
    split_tile_tf32(sKs, sV, sVs, L::ktile, tid, kThreads);
    __syncthreads();
    split_tile_tf32(sK, sK, sKs, L::ktile, tid, kThreads);
    fence_proxy_async();
    __syncthreads();
  };

  int cur = next_live(0);
  load_tile_async<float, kTile, D>(sQ, q + b * q_sb + h * q_sh, q_st, q0, T_, tid, kThreads);
  if (cur < n_sub) load_kv(cur);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile_tf32(sQ, sQ, sQs, L::qtile, tid, kThreads);
  if (cur < n_sub) split_kv();  // publishes q's split too

  // scores in the log2 domain: t = S scale log2(e); this thread's two rows'
  // running max m2 and its share of their sums l
  const float score2 = scale * kLog2e;
  float m2[2] = {ds::kNegInf, ds::kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  while (cur < n_sub) {
    const int k0 = key0(cur), kc0 = (cur % SUBS) * BN;  // kc0: k0's offset in its tile
    const uint32_t bits = MASK ? static_cast<uint32_t>(__ldg(msk + cur / SUBS)) : 0u;

    // S = q k^T
    float s[BN / 2];
    fence_regs(s);
    wgmma_fence();
    wgmma_tf32x3<BN, kTile, BN>(s, sQ, sQs, sK, sKs, D / 8);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    __syncthreads();  // every warp's products have read k's tiles
    const int nxt = next_live(cur + 1);
    if (nxt < n_sub) load_kv(nxt);
    cp_async_commit();

    // the online softmax of this thread's two rows (entries i with
    // (i >> 1) & 1 == r lie on row r); a tile on the diagonal and (MASK)
    // every tile hide keys: they score kNegInf and their P is set to 0, so a
    // row that has seen no visible key keeps l = 0
    const bool masked = MASK || (causal && k0 + BN - 1 > q0);
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float t = s[i] * score2;
      const int r = acc_row(warp, lane, i), c = acc_col(lane, i);
      if (masked && !visible<MASK>(q0 + r, k0 + c, causal, bits, r, kc0 + c, shift, g))
        t = ds::kNegInf;
      s[i] = t;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], t);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m2[r] - mx[r]);
      m2[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(s[i] - m2[r]);
      if (masked && s[i] == ds::kNegInf) p = 0.f;
      l[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] *= alpha[c >> 1];

    // O += P V (mma.sync, P from registers, V gathered from its tiles)
    mma_acc_tf32x3<BN>(acc, s, smem + L::v, smem + L::v_small, BN / 8, lane);

    if (nxt < n_sub) {
      cp_async_wait<0>();
      __syncthreads();  // the next raw tiles have landed; every warp is done with v
      split_kv();
    }
    cur = nxt;
  }

  // each row's l over its four lanes; o = acc / l_safe, lse = m + log(l_safe)
  // in natural-log units (kNegInf where no key was seen)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    inv[r] = 1.f / l_safe;
    const int t = q0 + 16 * warp + (lane >> 2) + 8 * r;
    if ((lane & 3) == 0 && t < T_) {
      const float m = m2[r] == ds::kNegInf ? ds::kNegInf : m2[r] * kLn2;
      lse[(long long)bh * T_ + t] = m + logf(l_safe);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + 16 * warp + (lane >> 2) + 8 * r;
    if (t < T_) store_acc_tf32(o + (((long long)b * T_ + t) * H + h) * D, acc, r, inv[r], lane);
  }
}

struct Args {
  const float *q, *k, *v;
  float *o, *lse;
  const int *idx, *cnt, *mask, *order;
  int B, H, T, block, A;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D, bool MASK>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = FwdLayout<D, kKeys<D, MASK>>::bytes + 1024;  // + the alignment
  cudaError_t err = cudaFuncSetAttribute(blocksparse_fwd_tf32_kernel<D, MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, a.H * ((a.T + kTile - 1) / kTile));  // every (head, q tile), in `order`
  blocksparse_fwd_tf32_kernel<D, MASK><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.o, a.lse, a.idx, a.cnt, a.mask, a.order, a.H, a.T, a.block, a.A,
      a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <bool MASK>
cudaError_t dispatch_dim(int D, const Args& a) {
  if (D == 64) return launch<64, MASK>(a);
  if (D == 96) return launch<96, MASK>(a);
  if (D == 128) return launch<128, MASK>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q/k/v [B, T, H, D] fp32 (dtype 0) given by element strides (batch, seq,
// head; the last dimension contiguous, rows 16-byte aligned); o [B, T, H, D]
// contiguous fp32; lse [B*H, T] fp32; the tile tables int32 contiguous on the
// device (nT = ceil(T / 64) tiles a side: idx and mask [H, nT, A], cnt [H,
// nT], order [H * nT]). D 64, 96 or 128, block 16, 32, 64 or 128 (T a
// multiple of it). Returns the CUDA error code of the launch (0 on success).
extern "C" int ds_blocksparse_attention_fwd_tf32(const void* q, const void* k, const void* v,
                                                 void* o, float* lse, const int* tidx,
                                                 const int* tcnt, const int* tmask,
                                                 const int* order, int B, int H, int T, int D,
                                                 int dtype, int block, int A,
                                                 long long q_sb, long long q_st, long long q_sh,
                                                 long long k_sb, long long k_st, long long k_sh,
                                                 long long v_sb, long long v_st, long long v_sh,
                                                 float scale, int causal, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(o), lse, tidx, tcnt, tmask,
               order, B, H, T, block, A, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
               scale, causal, static_cast<cudaStream_t>(stream)};
  if (dtype != ds::kF32) return cudaErrorInvalidValue;  // 16-bit: blocksparse_attention_fwd_tc.cu
  if (block == 16 || block == 32) return dispatch_dim<true>(D, a);
  if ((block == 64 || block == 128) && T % kTile == 0) return dispatch_dim<false>(D, a);
  return cudaErrorInvalidValue;
}
