// Blocksparse-attention forward on Hopper's tensor cores (sm_90a, wgmma), for
// bf16 and fp16 inputs at every block (16, 32, 64, 128); plain C interface.
//
// Replaces, for 16-bit inputs, the TPU kernel _fwd_kernel of
// deepspeed_tpu/ops/pallas/blocksparse_attention.py (_fwd, the pallas_call at
// :186). fp32 inputs take the 3xTF32 kernel of
// csrc/blocksparse_attention_fwd_tf32.cu (ops/cuda/blocksparse_attention.py
// bs_route). The function is the reference's: for each (batch, head),
// o = softmax(scale q k^T + mask) v where the mask keeps the (q-block,
// k-block) pairs of a static [H, T/block, T/block] layout and, under
// `causal`, keys at or before the query (T == S, aligned top-left); an fp32
// online softmax; a row with no visible key gives o = 0 and lse = -1e30 (l
// == 0 -> l_safe = 1, as the plain version); o cast to the input dtype and
// the fp32 logsumexp stored as [B*H, T].
//
// Numerics, as the tensor-core flash forward (csrc/flash_attention_fwd_tc.cu)
// keeps the reference's fp32 function from 16-bit operands. S = q k^T takes
// the operands as they come (their products are exact in fp32, wgmma sums them
// in fp32); the scale multiplies the fp32 sum. The reference scales q in fp32
// first: at D 64 the scale is 1/8 and the two are equal, at D 96 / 128 they
// differ by one fp32 rounding of the score, far below the 16-bit output's
// rounding. P is fp32 in registers and enters P V as hi + lo halves of the
// input dtype (two RS wgmmas against the same V), ~2^-16 relative for bf16
// and ~2^-22 for fp16, where one cast keeps 2^-8 / 2^-11. fp16 holds P times
// 2^14 (P <= 1 after the running maximum), riding in exp2's argument, so its
// lo half stays above fp16's subnormal range; l sums the same scaled P, so
// only lse subtracts 14 ln 2.
//
// The layout reaches the kernel as the host-built tile tables of
// ops/cuda/blocksparse_attention.py (tile_tables), the ones the backward's dq
// pass walks: for each (head, 64-query tile) the ascending 64-key tiles that
// hold an active block x block sub-block, each with its bit mask of active
// sub-blocks (bit r g + c for query sub-block r and key sub-block c, g = 64 /
// block: 16 bits at a block of 16, 4 at 32; blocks of 64 and 128 are whole
// tiles), and `order` [H * nT], the (head, q tile) pairs sorted by their
// count, largest first (work_order). Blocks of 16 and 32 run their own
// instances (MASK), which hide an entry whose sub-block bit is clear where
// the causal diagonal is tested: it scores kNegInf, so it moves no running
// maximum, and its P is set to exactly 0 from the test, not left to exp's
// underflow (a row whose earlier tiles hid all its keys still has its maximum
// at kNegInf, where exp2(s - m) would be 1). Its l stays 0 until its first
// visible key, whose rescale exp2(kNegInf - m) is 0; a row that no listed
// tile shows (an empty block row) ends with l = 0 and writes o = 0 and lse =
// -1e30. Blocks of 64 and 128 run the instances without the test, over the
// same tiles in the same order as the block lists they expand.
//
// Work split: one block of one warpgroup (128 threads) per (b, head, 64-row q
// tile), in `order`, so the tiles with the longest lists start first and the
// short ones fill the tail (at the sparse GPT-2-125M's Fixed layout a late q
// tile's list is ~8x a local one's). A q tile stages its q tile once and
// streams the 64-key k/v tiles of its list through a ring of kStages shared
// stages filled by 16-byte cp.async copies into csrc/tc_tile.cuh's swizzled
// panels, the next tile's rows taken from the table as its copy is issued, one
// stage ahead. The list is ascending, so under `causal` the tiles wholly
// above the q tile's last row are its tail: they are cut off before the loop
// (their P is exactly 0 in the reference), and only a tile that straddles the
// diagonal is masked. For each tile: S = q k^T (wgmma m64n64k16, q and k
// K-major), the online-softmax update of the thread's two rows in registers,
// the O accumulator times the rows' alpha, then O += P V with P's A fragments
// taken from the score accumulator and V read MN-major from its tile. D 96
// runs as the padded 128-column panel (kPadded). A T off 64-row tiles (blocks
// of 16 / 32) leaves rows past T in the last tile: they are zero-filled,
// their sub-block bits are clear, and nothing is stored past T. Head h = the
// pair's head picks the table, so per-head layouts work; q/k/v are read
// through their strides (last dimension contiguous, rows 16-byte aligned: the
// views of the fused qkv projection need no copy); o is written contiguous
// [B, T, H, D].
//
// What bounds it on the H100: at the sparse GPT-2-125M training shape (B2,
// T4096, H12, D64, the Fixed layout of 4 local and 1 global block of 128,
// unidirectional: 192 of the 528 causal blocks active, ~69M visible pairs)
// it needs 2 products over the visible pairs, 17.7 GFLOP, 0.018 ms at 989
// TFLOP/s, and moves q, k, v, o and lse once, 50 MB, 0.015 ms at 3.35 TB/s:
// operation-bound. It issues 3 products' worth of wgmma (S, P_hi V, P_lo V)
// over every visited tile (the diagonal tiles' hidden half included, and at
// blocks of 16 / 32 the clear sub-blocks of a tile), and each block is one
// warpgroup waiting on its own copies and products, as the flash forward
// does: latency, not bytes or the tensor rate, bounds this design.

#include <type_traits>

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

using namespace ds::tc;

constexpr int kTile = 64;     // rows of a q tile and of a k/v tile
constexpr int kStages = 2;    // ring depth of the streamed k/v tiles
constexpr int kWgThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// fp16's P is held times 2^14, see the header
template <typename T>
constexpr int kPExp = std::is_same<T, __half>::value ? 14 : 0;

// Shared layout (bytes from a 1024-aligned base): q, then kStages x (k, v).
template <int D> struct FwdLayout {
  static constexpr int tile = kTile * kPadded<D> * 2;  // one [64][D] 16-bit tile, whole panels
  static constexpr int q = 0;
  static constexpr int ring = q + tile;
  static constexpr int stage = 2 * tile;  // k then v
  static constexpr int bytes = ring + kStages * stage;
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

// MASK: blocks of 16 / 32 (tiles of several blocks, each entry tested
// against its sub-block's bit); blocks of 64 / 128 have whole tiles
template <typename T, int D, bool MASK>
__global__ void __launch_bounds__(kWgThreads)
blocksparse_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ tidx,
    const int* __restrict__ tcnt, const int* __restrict__ tmask, const int* __restrict__ order,
    int H, int T_, int block, int A, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, float scale, int causal) {
  using L = FwdLayout<D>;
  constexpr int DP = kPadded<D>;         // whole 64-column panels (D 96: 128)
  constexpr int NP = DP / kPanelCols;    // output panels of 64 columns
  constexpr float kPOffset = static_cast<float>(kPExp<T>);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t sQ = base + L::q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nT = (T_ + kTile - 1) / kTile;
  const int item = order[blockIdx.y];  // h * nT + q tile, the longest lists first
  const int h = item / nT;
  const int b = blockIdx.x, bh = b * H + h;
  const int q0 = (item % nT) * kTile;
  const int shift = __ffs(block) - 1, g = kTile >> shift;  // MASK: log2(block), blocks a side

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  // tile t of the list: 64-key tile idx[t], its sub-blocks' bits msk[t]
  const int* idx = tidx + static_cast<long long>(item) * A;
  const int* msk = tmask + static_cast<long long>(item) * A;
  auto key0 = [&](int t) { return __ldg(idx + t) * kTile; };
  int n_k_tiles = tcnt[item];
  if (causal)  // the ascending list's tail lies wholly above the q tile's last row
    while (n_k_tiles > 0 && key0(n_k_tiles - 1) > q0 + kTile - 1) --n_k_tiles;

  // prologue: q with the first k/v tiles, one commit group per stage
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s == 0) load_tile_async<T, kTile, D, DP>(sQ, qb, q_st, q0, T_, tid, kWgThreads);
    if (s < n_k_tiles) {
      const uint32_t st = base + L::ring + s * L::stage;
      const int k0 = key0(s);
      load_tile_async<T, kTile, D, DP>(st, kb, k_st, k0, T_, tid, kWgThreads);
      load_tile_async<T, kTile, D, DP>(st + L::tile, vb, v_st, k0, T_, tid, kWgThreads);
    }
    cp_async_commit();
  }

  // scores in the log2 domain: t = S scale log2(e); this thread's two rows'
  // running max m2 (log2 domain) and its share of their sums l
  const float score2 = scale * kLog2e;
  float m2[2] = {ds::kNegInf, ds::kNegInf}, l[2] = {0.f, 0.f};
  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int pf = kt + kStages - 1;  // refill the stage consumed last iteration
    if (pf < n_k_tiles) {
      const uint32_t st = base + L::ring + (pf % kStages) * L::stage;
      const int k0 = key0(pf);
      load_tile_async<T, kTile, D, DP>(st, kb, k_st, k0, T_, tid, kWgThreads);
      load_tile_async<T, kTile, D, DP>(st + L::tile, vb, v_st, k0, T_, tid, kWgThreads);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile kt (and q) have landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t sK = base + L::ring + (kt % kStages) * L::stage;
    const uint32_t sV = sK + L::tile;
    const int k0 = key0(kt);
    const uint32_t bits = MASK ? static_cast<uint32_t>(__ldg(msk + kt)) : 0u;

    // S = q k^T
    float s[32];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<T>(s, desc_kmajor<kTile>(sQ, ks), desc_kmajor<kTile>(sK, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // the online softmax of this thread's two rows (entries i with
    // (i >> 1) & 1 == r lie on row r); a tile on the diagonal and (MASK)
    // every tile hide keys: they score kNegInf and their P is set to 0, so a
    // row that has seen no visible key keeps l = 0
    const bool masked = MASK || (causal && k0 + kTile - 1 > q0);
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float t = s[i] * score2;
      const int r = acc_row(warp, lane, i), c = acc_col(lane, i);
      if (masked && !visible<MASK>(q0 + r, k0 + c, causal, bits, r, c, shift, g)) t = ds::kNegInf;
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
    // P (times 2^kPOffset for fp16) into s
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(s[i] - (m2[r] - kPOffset));
      if (masked && s[i] == ds::kNegInf) p = 0.f;
      l[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i >> 1) & 1];

    // O += P_hi V + P_lo V (A from registers, V MN-major)
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      const float one[2] = {1.f, 1.f};
      acc_to_a<T>(s, kk, hi, lo, one);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        wgmma_rs_mn<T>(acc[p], hi, desc_mnmajor<kTile>(sV, p, kk));
        wgmma_rs_mn<T>(acc[p], lo, desc_mnmajor<kTile>(sV, p, kk));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // each row's l over its four lanes; o = acc / l_safe (fp16's 2^14 cancels),
  // lse = m + log(l_safe) in natural-log units (kNegInf where no key was seen)
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
      lse[(long long)bh * T_ + t] = m + logf(l_safe) - kPOffset * kLn2;
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      if (p * kPanelCols + acc_col(lane, i) >= D) continue;  // D 96's zero columns
      const int t = q0 + acc_row(warp, lane, i);
      if (t >= T_) continue;
      T* row = o + (((long long)b * T_ + t) * H + h) * D;
      const float u = inv[(i >> 1) & 1];
      *reinterpret_cast<uint32_t*>(row + p * kPanelCols + acc_col(lane, i)) =
          pack2<T>(acc[p][i] * u, acc[p][i + 1] * u);
    }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const int *idx, *cnt, *mask, *order;
  int B, H, T, block, A;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, bool MASK>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = FwdLayout<D>::bytes + 1024;  // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(blocksparse_fwd_tc_kernel<T, D, MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, a.H * ((a.T + kTile - 1) / kTile));  // every (head, q tile), in `order`
  blocksparse_fwd_tc_kernel<T, D, MASK><<<grid, kWgThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.idx, a.cnt, a.mask, a.order, a.H, a.T, a.block, a.A,
      a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, bool MASK>
cudaError_t dispatch_dim(int D, const Args& a) {
  if (D == 64) return launch<T, 64, MASK>(a);
  if (D == 96) return launch<T, 96, MASK>(a);
  if (D == 128) return launch<T, 128, MASK>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_block(int D, const Args& a) {
  if (a.block == 16 || a.block == 32) return dispatch_dim<T, true>(D, a);
  if ((a.block == 64 || a.block == 128) && a.T % kTile == 0) return dispatch_dim<T, false>(D, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q/k/v [B, T, H, D] given by element strides (batch, seq, head; the last
// dimension contiguous, rows 16-byte aligned); o [B, T, H, D] contiguous in
// the input dtype; lse [B*H, T] fp32; the tile tables int32 contiguous on the
// device (nT = ceil(T / 64) tiles a side: idx and mask [H, nT, A], cnt [H,
// nT], order [H * nT]). dtype is 1 (bf16) or 2 (fp16), D 64, 96 or 128,
// block 16, 32, 64 or 128 (T a multiple of it). Returns the CUDA error code
// of the launch (0 on success).
extern "C" int ds_blocksparse_attention_fwd_tc(const void* q, const void* k, const void* v,
                                               void* o, float* lse, const int* tidx,
                                               const int* tcnt, const int* tmask,
                                               const int* order, int B, int H, int T, int D,
                                               int dtype, int block, int A,
                                               long long q_sb, long long q_st, long long q_sh,
                                               long long k_sb, long long k_st, long long k_sh,
                                               long long v_sb, long long v_st, long long v_sh,
                                               float scale, int causal, void* stream) {
  const Args a{q, k, v, o, lse, tidx, tcnt, tmask, order, B, H, T, block, A,
               q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
               scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {  // fp32 runs the 3xTF32 kernel of blocksparse_attention_fwd_tf32.cu
    case ds::kBF16: return dispatch_block<__nv_bfloat16>(D, a);
    case ds::kF16: return dispatch_block<__half>(D, a);
    default: return cudaErrorInvalidValue;
  }
}
