// Flash-attention forward on Hopper's tensor cores (sm_90a) for fp32 inputs,
// as 3xTF32; plain C interface.
//
// Replaces, for fp32 inputs, the TPU kernel _fwd_kernel of
// deepspeed_tpu/ops/pallas/flash_attention.py (_fwd, the pallas_call at :129);
// bf16 and fp16 inputs take csrc/flash_attention_fwd_tc.cu. For each (batch,
// head): o = softmax(scale q k^T + causal mask) v with the mask aligned
// bottom-right (query row t sits at position t + S - T), an fp32 online
// softmax, l == 0 -> l_safe = 1, and the fp32 logsumexp of every row stored
// as [B*H, T] for the backward. stochastic_mode is the same function for fp32
// inputs.
//
// Numerics: the reference's fp32 function. Each product a b is taken as
// 3xTF32 (csrc/tc_tile.cuh, section tf32): big = tf32(x), small = tf32(x -
// big), a b = small_a big_b + big_a small_b + big_a big_b, each pass summed
// in fp32; what is dropped (small_a small_b and the rounding of small) is
// ~2^-21 of each term, where one TF32 pass keeps ~2^-11. The scale multiplies
// the fp32 sum of q k^T, as the backward (flash_attention_bwd_tf32.cu) does,
// so the two score q k^T alike.
//
// The K-major rule. For tf32, wgmma reads both shared-memory operands
// K-major only. S = q k^T is K-major in both (q and k rows are M and N, D is
// K): wgmma m64n64k8 SS over the split q and k tiles, 3 x D/8 instructions.
// P V would need V^T: instead it runs on mma.sync m16n8k8 tf32 (HMMA), P's
// A fragments taken from the score accumulator as they lie (acc_to_a_tf32:
// k index t of a step stands for key 2t, t + 4 for key 2t + 1) and V's B
// fragments gathered per thread from the split V tiles in the same key order
// (b_offset_tf32, conflict-free through the swizzle). No tile is transposed.
//
// Work split: one block of one warpgroup (128 threads) per (b*h, 64-row q
// tile), heavy causal tiles first, streaming BN-key k/v tiles. Shared memory
// holds the big and small parts of q ([64][D] fp32) and of k and v ([BN][D]):
// D 64 with BN 64 and D 96 with BN 32 take 96 KB, two blocks an SM; D 128
// with BN 64 192 KB, one block (BN 32 would still leave one; at D 96 BN 64,
// 144 KB and one block, measured 15% slower). One set of k/v
// tiles, no ring: once S = q k^T is done, the next tile's raw k and v are
// copied (cp.async, zero-filled past S) into k's two tiles while the softmax
// and P V run; then v is split into v's tiles and k in place. Causal runs stop
// at the last visible k tile; only tiles that straddle the diagonal or the
// ragged edge are masked. Inputs are read through their strides (last
// dimension contiguous, rows 16-byte aligned: the q/k/v views of the fused
// qkv projection need no copy); o is written contiguous [B, T, H, D].
//
// What bounds it on the H100: at the GPT-2-125M scoring shape (B4, T=S=512,
// H12, D64, causal) it needs 2 products over the visible pairs, 1.61 GFLOP,
// three TF32 passes of each: 9.8 us at 495 TFLOP/s (24.1 us for one fp32 pass
// on the CUDA cores' 67); it moves q, k, v, o and lse once, 25.2 MB, 7.5 us at
// 3.35 TB/s: operation-bound. The block waits on its own copies, splits and
// products (no producer warp), so this first design is bound by that latency
// chain and by the per-thread B loads of P V.

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

using namespace ds::tc;

constexpr int kTile = 64;  // rows of a q tile
constexpr int kThreads = 128;
// keys of a streamed k/v tile by head dim (two blocks an SM at D 64 and 96)
template <int D> constexpr int kKeys = D == 96 ? 32 : 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared layout (bytes from a 1024-aligned base): the big and small parts of
// q ([64][D] fp32 tiles of D / 32 swizzled panels), then of k and v ([BN][D]).
template <int D> struct FwdLayout {
  static constexpr int BN = kKeys<D>;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int H, int T_, int S,
                      long long q_sb, long long q_st, long long q_sh,
                      long long k_sb, long long k_st, long long k_sh,
                      long long v_sb, long long v_st, long long v_sh,
                      float scale, int causal) {
  using L = FwdLayout<D>;
  constexpr int BN = L::BN;   // keys a k/v tile
  constexpr int NT = D / 8;   // n tiles of P V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base + L::q, sQs = base + L::q_small;
  const uint32_t sK = base + L::k, sKs = base + L::k_small;
  const uint32_t sV = base + L::v, sVs = base + L::v_small;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int n_q_tiles = (T_ + kTile - 1) / kTile;
  const int q0 = (n_q_tiles - 1 - static_cast<int>(blockIdx.y)) * kTile;  // longest rows first
  const int q_offset = S - T_;

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  int n_k_tiles = (S + BN - 1) / BN;
  if (causal) {
    const int last_key = q_offset + min(q0 + kTile, T_) - 1;
    n_k_tiles = last_key < 0 ? 0 : min(n_k_tiles, last_key / BN + 1);
  }

  // raw k and v of tile kt into k's two tiles, the first to fall free
  auto load_kv = [&](int kt) {
    load_tile_async<float, BN, D>(sK, kb, k_st, kt * BN, S, tid, kThreads);
    load_tile_async<float, BN, D>(sKs, vb, v_st, kt * BN, S, tid, kThreads);
  };
  // v from k's small tile into v's tiles, then k in place; published to wgmma
  auto split_kv = [&]() {
    split_tile_tf32(sKs, sV, sVs, L::ktile, tid, kThreads);
    __syncthreads();
    split_tile_tf32(sK, sK, sKs, L::ktile, tid, kThreads);
    fence_proxy_async();
    __syncthreads();
  };

  load_tile_async<float, kTile, D>(sQ, q + b * q_sb + h * q_sh, q_st, q0, T_, tid, kThreads);
  if (n_k_tiles > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile_tf32(sQ, sQ, sQs, L::qtile, tid, kThreads);
  if (n_k_tiles > 0) split_kv();  // publishes q's split too

  // scores in the log2 domain: t = S scale log2(e); this thread's two rows'
  // running max m2 and its share of their sums l
  const float score2 = scale * kLog2e;
  float m2[2] = {ds::kNegInf, ds::kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * BN;

    // S = q k^T
    float s[BN / 2];
    fence_regs(s);
    wgmma_fence();
    wgmma_tf32x3<BN, kTile, BN>(s, sQ, sQs, sK, sKs, D / 8);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    __syncthreads();  // every warp's products have read k's tiles
    const bool next = kt + 1 < n_k_tiles;
    if (next) load_kv(kt + 1);
    cp_async_commit();

    // the online softmax of this thread's two rows (entries i with
    // (i >> 1) & 1 == r lie on row r); hidden keys score kNegInf, as the
    // reference masks them
    const bool masked = k0 + BN > S || q0 + kTile > T_ ||
                        (causal && k0 + BN - 1 > q_offset + q0);
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float t = s[i] * score2;
      if (masked) {
        const int row = q0 + acc_row(warp, lane, i), key = k0 + acc_col(lane, i);
        const bool visible = row < T_ && key < S && !(causal && key > q_offset + row);
        t = visible ? t : ds::kNegInf;
      }
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
      const float p = exp2f(s[i] - m2[r]);
      l[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] *= alpha[c >> 1];

    // O += P V (mma.sync, P from registers, V gathered from its tiles)
    mma_acc_tf32x3<BN>(acc, s, smem + L::v, smem + L::v_small, BN / 8, lane);

    if (next) {
      cp_async_wait<0>();
      __syncthreads();  // the next raw tiles have landed; every warp is done with v
      split_kv();
    }
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
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, T, S;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = FwdLayout<D>::bytes + 1024;  // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.T + kTile - 1) / kTile);
  flash_fwd_tf32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.H, a.T, a.S,
      a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh, a.scale,
      a.causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, T, H, D], k/v [B, S, H, D] fp32 (dtype 0) given by element strides
// (batch, seq, head; the last dimension contiguous, rows 16-byte aligned);
// o [B, T, H, D] contiguous fp32; lse [B*H, T] fp32. D 64, 96 or 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ds_flash_attention_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                                           float* lse, int B, int H, int T, int S, int D,
                                           int dtype,
                                           long long q_sb, long long q_st, long long q_sh,
                                           long long k_sb, long long k_st, long long k_sh,
                                           long long v_sb, long long v_st, long long v_sh,
                                           float scale, int causal, void* stream) {
  const Args a{q, k, v, o, lse, B, H, T, S, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
               v_sb, v_st, v_sh, scale, causal, static_cast<cudaStream_t>(stream)};
  if (dtype != ds::kF32) return cudaErrorInvalidValue;  // 16-bit: flash_attention_fwd_tc.cu
  if (D == 64) return launch<64>(a);
  if (D == 96) return launch<96>(a);
  if (D == 128) return launch<128>(a);
  return cudaErrorInvalidValue;
}
