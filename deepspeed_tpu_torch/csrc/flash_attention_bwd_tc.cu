// Flash-attention backward on Hopper's tensor cores (sm_90a, wgmma), for
// bf16 and fp16 inputs; plain C interface.
//
// Replaces, for 16-bit inputs, the TPU kernels _bwd_dq_kernel and
// _bwd_dkv_kernel of deepspeed_tpu/ops/pallas/flash_attention.py (_bwd, the
// pallas_calls at :291 and :309). fp32 inputs keep the CUDA-core kernels of
// csrc/flash_attention_bwd.cu, and so does delta = rowsum(dO * O), which
// both passes read. The function is that of the reference's default mode
// (stochastic_mode=False, every operand widened to fp32):
//   P  = exp(scale * q k^T - lse)          (0 where the causal mask hides a key)
//   dV = P^T dO,   dS = P * (dO v^T - delta) * scale,   dQ = dS k,   dK = dS^T q
// with the causal mask aligned bottom-right (query row t sits at position
// t + S - T), fp32 accumulators cast to the input dtype at the end.
//
// Numerics. q k^T and dO v^T take the 16-bit operands as they come: their
// products are exact in fp32 and wgmma sums them in fp32, so only the order
// of the sum differs from the plain version. P and dS are fp32 in
// registers; they enter dV, dK and dQ as a hi/lo pair (hi = T(x),
// lo = T(x - hi), each product issued on both), which keeps x to ~2^-16
// relative for bf16 where a single cast (the reference's stochastic_mode,
// not ported) keeps 2^-8. fp16 keeps ~2^-22 against 2^-11, but only above
// its subnormal range (2^-14 for hi, which puts lo there for every |x| below
// ~2^-3): P of long rows and the dS of small gradients would lose most of
// their bits. So fp16 first multiplies each row of P and dS by a running
// power of two that puts the row's largest entry so far in [2^14, 2^15)
// as it splits them (scale_rows, acc_to_a; when a later tile raises the
// row's largest, the row's fp32 accumulator is multiplied down by the same
// power of two) and divides the accumulator by it at the end; all exact. dQ's dS rows are queries,
// dV's P^T and dK's dS^T rows are keys. The score scale multiplies the fp32 accumulator
// (the forward, csrc/flash_attention_fwd.cu, scales q in fp32 before its
// product): at D 64 the scale is 1/8 and both are exact, at D 128 P differs
// from the forward's by about one fp32 rounding of the score.
//
// Work split: two passes, no atomics. Every output element is written by one
// block in a fixed order, so two runs give bitwise-equal gradients. (One
// pass would accumulate dq across k tiles: with atomics the sum order
// changes from run to run; without, it needs a partial-dq scratch whose
// traffic costs more than the two products the dq pass recomputes.)
// - dq: one block of one warpgroup (128 threads) per (b*h, 64-row q tile),
//   heavy causal tiles first. It stages its q and dO tiles once and streams
//   64-row k/v tiles through a ring of kStages shared-memory stages filled
//   by 16-byte cp.async copies (zero-filled past S). For each k/v tile:
//   S = q k^T and dP = dO v^T (wgmma m64n64k16, both operands K-major from
//   shared memory), P and dS in registers, then dQ += dS_hi k + dS_lo k with
//   the A operand taken straight from the accumulator registers and k read
//   MN-major from the same shared tile. Causal runs stop at the last visible
//   k tile; tiles that straddle the diagonal or the ragged edge are masked.
// - dkv: one block per (b*h, 64-row k tile), of D / 64 warpgroups. It stages
//   k and v once and streams the q tiles that see them (with their dO tile
//   and lse / delta rows) through the ring. With keys as the M dimension,
//   S^T = k q^T and dP^T = v dO^T leave P^T and dS^T in accumulator
//   registers, which feed dV += P^T_hi dO + P^T_lo dO and
//   dK += dS^T_hi q + dS^T_lo q as A fragments. At D 128 the two 64 x 128
//   fp32 accumulators do not fit one warpgroup beside the score tiles, so
//   the two warpgroups split D: each computes the whole S^T and dP^T (K = D)
//   and its own 64 columns of dK and dV.
// Inputs are read through their strides (last dimension contiguous, rows
// 16-byte aligned: the q/k/v views of the fused qkv projection need no
// copy); dq/dk/dv are written contiguous [B, T|S, H, D].
//
// Inside a tile the products are issued as separate commit groups, so the
// exponentials of P run while dO v^T is still on the tensor cores, and (in
// dkv) dS^T is computed while the dV products run.
//
// What bounds it on the H100: at the GPT-2-125M training shape (B8, T=S=512,
// H12, D64, causal) the whole backward needs 5 products over the visible
// pairs, ~8 GFLOP, and moves q, k, v, o, dO, dq, dk, dv, lse and delta once,
// ~50 MB in bf16: ~15 us of bytes at 3.35 TB/s, ~8 us of operations at 989
// TFLOP/s, so byte-bound. The two passes issue 10 products' worth of wgmma
// (q k^T and dO v^T in both passes, the three output products twice for
// hi/lo), the exponentials and masks run on the CUDA cores, and each block
// is one or two warpgroups that wait on their own copies and products (no
// producer warp, no overlap of one tile's softmax with the next tile's
// products, 2-3 blocks an SM at 134-217 registers a thread): latency, not
// bytes, bounds this first tensor-core design.

#include <type_traits>

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

using namespace ds::tc;

// fp16 operands take the running row scale of tc_tile.cuh (scale_rows)
// before their hi/lo split; bf16 has fp32's exponent range and needs none
template <typename T> constexpr bool kScaled = std::is_same<T, __half>::value;

constexpr int kTile = 64;     // rows of a q tile and of a k tile
constexpr int kStages = 2;    // ring depth of the streamed tiles
constexpr int kWgThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct TileBytes {
  static constexpr int value = kTile * D * 2;  // one [64][D] 16-bit tile
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

// 1024-byte aligned base of the dynamic shared memory (the launch asks for
// 1024 bytes more than the layout needs).
__device__ __forceinline__ uint32_t aligned_smem_base(unsigned char* smem) {
  const uint32_t base = smem_u32(smem);
  return (base + 1023u) & ~1023u;
}

// Row (within the 64-row tile) and column of accumulator entry i for this
// thread (warp w of its warpgroup, lane l).
__device__ __forceinline__ int acc_row(int w, int l, int i) {
  return 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int l, int i) {
  return 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads)
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq, int H, int T_, int S,
                       long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       long long d_sb, long long d_st, long long d_sh,
                       float scale, int causal) {
  using L = DqLayout<D>;
  constexpr int NP = D / kPanelCols;  // output panels of 64 columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t sQ = base + L::q, sO = base + L::dout;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int n_q_tiles = (T_ + kTile - 1) / kTile;
  const int q0 = (n_q_tiles - 1 - static_cast<int>(blockIdx.y)) * kTile;  // the longest causal rows first
  const int q_offset = S - T_;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  int n_k_tiles = (S + kTile - 1) / kTile;
  if (causal) {
    const int last_key = q_offset + min(q0 + kTile, T_) - 1;
    n_k_tiles = last_key < 0 ? 0 : min(n_k_tiles, last_key / kTile + 1);
  }

  // prologue: q and dO with the first k/v tiles, one commit group per stage
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s == 0) {
      load_tile_async<T, kTile, D>(sQ, q + b * q_sb + h * q_sh, q_st, q0, T_, tid, kWgThreads);
      load_tile_async<T, kTile, D>(sO, dout + b * d_sb + h * d_sh, d_st, q0, T_, tid,
                                   kWgThreads);
    }
    if (s < n_k_tiles) {
      const uint32_t st = base + L::ring + s * L::stage;
      load_tile_async<T, kTile, D>(st, kb, k_st, s * kTile, S, tid, kWgThreads);
      load_tile_async<T, kTile, D>(st + L::tile, vb, v_st, s * kTile, S, tid, kWgThreads);
    }
    cp_async_commit();
  }

  // this thread's two rows: their lse (log2 domain) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + 16 * warp + (lane >> 2) + 8 * r;
    lse2[r] = t < T_ ? lse[(long long)bh * T_ + t] * kLog2e : 0.f;
    dlt[r] = t < T_ ? delta[(long long)bh * T_ + t] : 0.f;
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
      load_tile_async<T, kTile, D>(st, kb, k_st, pf * kTile, S, tid, kWgThreads);
      load_tile_async<T, kTile, D>(st + L::tile, vb, v_st, pf * kTile, S, tid, kWgThreads);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile kt (and q, dO) have landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t sK = base + L::ring + (kt % kStages) * L::stage;
    const uint32_t sV = sK + L::tile;
    const int k0 = kt * kTile;

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
    const bool masked = k0 + kTile > S || q0 + kTile > T_ ||
                        (causal && k0 + kTile - 1 > q_offset + q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = exp2f(fmaf(s[i], scale2, -lse2[(i >> 1) & 1]));
      if (masked) {
        const int t = q0 + acc_row(warp, lane, i), key = k0 + acc_col(lane, i);
        const bool visible = t < T_ && key < S && !(causal && key > q_offset + t);
        p = visible ? p : 0.f;
      }
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
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      acc_to_a<T>(s, kk, hi, lo, sc);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        wgmma_rs_mn<T>(acc[p], hi, desc_mnmajor<kTile>(sK, p, kk));
        wgmma_rs_mn<T>(acc[p], lo, desc_mnmajor<kTile>(sK, p, kk));
      }
    }
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
      const int t = q0 + acc_row(warp, lane, i);
      if (t >= T_) continue;
      T* row = dq + (((long long)b * T_ + t) * H + h) * D;
      const float u = undo[(i >> 1) & 1];
      *reinterpret_cast<uint32_t*>(row + p * kPanelCols + acc_col(lane, i)) =
          pack2<T>(acc[p][i] * u, acc[p][i + 1] * u);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads * (D / kPanelCols))
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, int H, int T_, int S,
                        long long q_sb, long long q_st, long long q_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        long long d_sb, long long d_st, long long d_sh,
                        float scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int NWG = D / kPanelCols;  // warpgroups, one 64-column panel of dK / dV each
  constexpr int NT = kWgThreads * NWG;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t sK = base + L::k, sV = base + L::v;
  const float* rows_f = reinterpret_cast<const float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                                       L::rows);

  const int tid = threadIdx.x, wg = tid / kWgThreads;
  const int warp = (tid % kWgThreads) >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  const int q_offset = S - T_;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* db = dout + b * d_sb + h * d_sh;
  const float* lb = lse + (long long)bh * T_;
  const float* deb = delta + (long long)bh * T_;

  const int n_q_tiles = (T_ + kTile - 1) / kTile;
  int first = 0;
  if (causal) {  // the first query that sees key k0 is t = k0 - q_offset
    const int t0 = k0 - q_offset;
    first = t0 <= 0 ? 0 : t0 / kTile;
  }
  const int n = max(0, n_q_tiles - first);

  auto load_q_tile = [&](int it) {
    const int s = it % kStages, q0 = (first + it) * kTile;
    const uint32_t st = base + L::ring + s * L::stage;
    load_tile_async<T, kTile, D>(st, qb, q_st, q0, T_, tid, NT);
    load_tile_async<T, kTile, D>(st + L::tile, db, d_st, q0, T_, tid, NT);
    const uint32_t rs = base + L::rows + s * L::row_stage;
    load_row_async(rs, lb, q0, T_, kTile, tid, NT);
    load_row_async(rs + kTile * 4, deb, q0, T_, kTile, tid, NT);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s == 0) {
      load_tile_async<T, kTile, D>(sK, k + b * k_sb + h * k_sh, k_st, k0, S, tid, NT);
      load_tile_async<T, kTile, D>(sV, v + b * v_sb + h * v_sh, v_st, k0, S, tid, NT);
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
    const int q0 = (first + it) * kTile;

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
    const bool masked = k0 + kTile > S || q0 + kTile > T_ ||
                        (causal && k0 + kTile - 1 > q_offset + q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(lane, i);
      float p = exp2f(fmaf(st[i], scale2, -sL[c] * kLog2e));
      if (masked) {
        const int key = k0 + acc_row(warp, lane, i), t = q0 + c;
        const bool visible = t < T_ && key < S && !(causal && key > q_offset + t);
        p = visible ? p : 0.f;
      }
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
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      acc_to_a<T>(st, kk, hi, lo, sc_p);
      wgmma_rs_mn<T>(acc_v, hi, desc_mnmajor<kTile>(sO, wg, kk));
      wgmma_rs_mn<T>(acc_v, lo, desc_mnmajor<kTile>(sO, wg, kk));
    }
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
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t hi[4], lo[4];
      acc_to_a<T>(dpt, kk, hi, lo, sc_ds);
      wgmma_rs_mn<T>(acc_k, hi, desc_mnmajor<kTile>(sQ, wg, kk));
      wgmma_rs_mn<T>(acc_k, lo, desc_mnmajor<kTile>(sQ, wg, kk));
    }
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
    const int key = k0 + acc_row(warp, lane, i);
    if (key >= S) continue;
    const long long off = (((long long)b * S + key) * H + h) * D + wg * kPanelCols +
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
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, T, S;
  Strides qs, ks, vs, dos;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = DqLayout<D>::bytes + 1024;
  cudaError_t err = set_smem(flash_bwd_dq_tc_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.T + kTile - 1) / kTile);
  flash_bwd_dq_tc_kernel<T, D><<<grid, kWgThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.T, a.S,
      a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b, a.vs.t, a.vs.h,
      a.dos.b, a.dos.t, a.dos.h, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = DkvLayout<D>::bytes + 1024;
  cudaError_t err = set_smem(flash_bwd_dkv_tc_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kTile - 1) / kTile);
  flash_bwd_dkv_tc_kernel<T, D><<<grid, kWgThreads * (D / kPanelCols), smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.T, a.S,
      a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b, a.vs.t, a.vs.h,
      a.dos.b, a.dos.t, a.dos.h, a.scale, a.causal);
  return cudaGetLastError();
}

enum Pass { kDq = 0, kDkv = 1 };

template <typename T>
cudaError_t dispatch_dim(int D, int pass, const Args& a) {
  if (D == 64) return pass == kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
  if (D == 128) return pass == kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int dtype, int D, int pass, const Args& a) {
  switch (dtype) {  // fp32 runs the CUDA-core kernels of flash_attention_bwd.cu
    case ds::kBF16: return dispatch_dim<__nv_bfloat16>(D, pass, a);
    case ds::kF16: return dispatch_dim<__half>(D, pass, a);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, int B, int H, int T, int S,
               long long q_sb, long long q_st, long long q_sh,
               long long k_sb, long long k_st, long long k_sh,
               long long v_sb, long long v_st, long long v_sh,
               long long d_sb, long long d_st, long long d_sh,
               float scale, int causal, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.B = B;
  a.H = H;
  a.T = T;
  a.S = S;
  a.qs = {q_sb, q_st, q_sh};
  a.ks = {k_sb, k_st, k_sh};
  a.vs = {v_sb, v_st, v_sh};
  a.dos = {d_sb, d_st, d_sh};
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns the CUDA error
// code of the launch (0 on success). The arguments are those of
// ds_flash_attention_bwd_dq / _dkv in flash_attention_bwd.cu; dtype is 1
// (bf16) or 2 (fp16), D 64 or 128.

// dq (the counterpart of _bwd_dq_kernel) on the tensor cores.
extern "C" int ds_flash_attention_bwd_dq_tc(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* delta, void* dq, int B, int H, int T,
                                            int S, int D, int dtype,
                                            long long q_sb, long long q_st, long long q_sh,
                                            long long k_sb, long long k_st, long long k_sh,
                                            long long v_sb, long long v_st, long long v_sh,
                                            long long d_sb, long long d_st, long long d_sh,
                                            float scale, int causal, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, B, H, T, S, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                     v_sb, v_st, v_sh, d_sb, d_st, d_sh, scale, causal, stream);
  a.dq = dq;
  return dispatch(dtype, D, kDq, a);
}

// dk and dv (the counterpart of _bwd_dkv_kernel) on the tensor cores.
extern "C" int ds_flash_attention_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, void* dk, void* dv, int B,
                                             int H, int T, int S, int D, int dtype,
                                             long long q_sb, long long q_st, long long q_sh,
                                             long long k_sb, long long k_st, long long k_sh,
                                             long long v_sb, long long v_st, long long v_sh,
                                             long long d_sb, long long d_st, long long d_sh,
                                             float scale, int causal, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, B, H, T, S, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                     v_sb, v_st, v_sh, d_sb, d_st, d_sh, scale, causal, stream);
  a.dk = dk;
  a.dv = dv;
  return dispatch(dtype, D, kDkv, a);
}
