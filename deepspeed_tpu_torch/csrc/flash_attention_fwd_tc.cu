// Flash-attention forward on Hopper's tensor cores (sm_90a, wgmma), for bf16
// and fp16 inputs; plain C interface.
//
// Replaces, for 16-bit inputs, the TPU kernel _fwd_kernel of
// deepspeed_tpu/ops/pallas/flash_attention.py (_fwd, the pallas_call at :129).
// fp32 inputs take the 3xTF32 kernel of csrc/flash_attention_fwd_tf32.cu.
// For each (batch, head): o = softmax(scale q k^T + causal mask) v with the mask
// aligned bottom-right (query row t sits at position t + S - T), an fp32
// online softmax, l == 0 -> l_safe = 1, o cast to the input dtype and the
// fp32 logsumexp of every row stored as [B*H, T] for the backward.
//
// Two functions, one template flag (kSingle), as the reference has them:
// - the default (stochastic_mode=False, _fwd_kernel with every operand
//   widened to fp32). S = q k^T takes the 16-bit operands as they come:
//   their products are exact in fp32 and wgmma sums them in fp32; the scale
//   multiplies the fp32 sum (the reference scales q in fp32 first: at D 64
//   the scale is 1/8 and the two are equal, at D 128 they differ by about
//   one fp32 rounding of the score). P is fp32 in registers and enters P V
//   as hi + lo halves of the input dtype (hi = T(P), lo = T(P - hi), two RS
//   wgmmas against the same V), which keeps P to ~2^-16 relative for bf16
//   and ~2^-22 for fp16, where one cast keeps 2^-8 / 2^-11. fp16's lo half is
//   subnormal below 2^-14, so fp16 holds P times 2^14 (P <= 1 after the
//   running maximum is subtracted, so P 2^14 <= 2^14 < 65504): the power of
//   two rides in the exponent of exp2, l sums the same scaled P, so o = acc /
//   l needs no undo and only lse subtracts 14 ln 2. No running row scale is
//   needed (B2's scale_rows): each row's largest P is 1.
// - stochastic_mode (the reference's lo = the input dtype): q~ =
//   T(fp32(q) scale) is rounded to the input dtype, staged through registers;
//   S = q~ k^T is summed in fp32 unscaled; P is cast once to the input dtype
//   for P V (one RS wgmma); l sums the fp32 P.
//
// Work split: one block of one warpgroup (128 threads) per (b*h, 64-row q
// tile), heavy causal tiles first. The block stages its q tile once and
// streams 64-row k/v tiles through a ring of kStages shared-memory stages
// filled by 16-byte cp.async copies (zero-filled past S), 128-byte swizzled
// panels of csrc/tc_tile.cuh. For each k/v tile: S = q k^T (wgmma m64n64k16,
// q and k K-major), the online-softmax update of the thread's two rows in
// registers (row maxima over the four lanes of a row by two shuffles; l kept
// per thread and summed over the lanes at the end), the O accumulator
// multiplied by the rows' alpha, then O += P V with P's A fragments taken
// straight from the score accumulator and V read MN-major from its tile. At
// D 128 O is two 64 x 64 accumulators, one per N panel. Causal runs stop at
// the last visible k tile; only tiles that straddle the diagonal or the
// ragged edge are masked. Inputs are read through their strides (last
// dimension contiguous, rows 16-byte aligned: the q/k/v views of the fused
// qkv projection need no copy); o is written contiguous [B, T, H, D].
//
// What bounds it on the H100: at the GPT-2-125M training shape (B8, T=S=512,
// H12, D64, causal) it needs 2 products over the visible pairs (~1.6 GFLOP,
// ~1.6 us at 989 TFLOP/s) and moves q, k, v, o and lse once (~25 MB in bf16,
// ~7.5 us at 3.35 TB/s): byte-bound; at B2 x T4096 the products (~52 GFLOP,
// ~52 us) outweigh the bytes (~25 us). The default function issues 3
// products' worth of wgmma (S, P_hi V, P_lo V), the single cast 2. Each
// block is one warpgroup waiting on its own copies and products (no producer
// warp, no overlap of one tile's softmax with the next tile's products), so
// this first tensor-core design is bound by that latency chain, not by
// bytes or the tensor rate; TMA and warp specialisation are left to a later
// redesign.

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

// fp16's P (default function) is held times 2^14, see the header
template <typename T, bool kSingle>
constexpr int kPExp = (std::is_same<T, __half>::value && !kSingle) ? 14 : 0;

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

// stochastic_mode's q~ = T(fp32(q) scale) for rows [r0, r0 + 64) of one head
// into the swizzled tile at `dst` through registers (rows at or past `n`
// are zero): every load of the thread is in flight before its first store.
// The writers fence for the async proxy before the barrier that publishes
// the tile.
template <typename T, int D>
__device__ __forceinline__ void load_q_scaled(uint32_t dst, const T* src, long long stride, int r0,
                                              int n, float scale, int tid) {
  constexpr int chunks = D / 8;  // 16 bytes = 8 elements
  constexpr int per_thread = kTile * chunks / kWgThreads;
  uint4 raw[per_thread];
#pragma unroll
  for (int j = 0; j < per_thread; ++j) {
    const int idx = tid + j * kWgThreads, r = idx / chunks, c = idx % chunks;
    raw[j] = r0 + r < n
                 ? *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < per_thread; ++j) {
    const int idx = tid + j * kWgThreads, r = idx / chunks, c = idx % chunks;
    float x[8];
    ds::load16<T>(reinterpret_cast<const T*>(&raw[j]), x);
    const uint4 out = make_uint4(pack2<T>(x[0] * scale, x[1] * scale),
                                 pack2<T>(x[2] * scale, x[3] * scale),
                                 pack2<T>(x[4] * scale, x[5] * scale),
                                 pack2<T>(x[6] * scale, x[7] * scale));
    st_shared16(dst + tile_offset<kTile>(r, c), out);
  }
}

template <typename T, int D, bool kSingle>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, float* __restrict__ lse, int H, int T_, int S,
                    long long q_sb, long long q_st, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    float scale, int causal) {
  using L = FwdLayout<D>;
  constexpr int DP = kPadded<D>;         // whole 64-column panels (D 96: 128)
  constexpr int NP = DP / kPanelCols;    // output panels of 64 columns
  constexpr float kPOffset = static_cast<float>(kPExp<T, kSingle>);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t sQ = base + L::q;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int n_q_tiles = (T_ + kTile - 1) / kTile;
  const int q0 = (n_q_tiles - 1 - static_cast<int>(blockIdx.y)) * kTile;  // longest rows first
  const int q_offset = S - T_;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  int n_k_tiles = (S + kTile - 1) / kTile;
  if (causal) {
    const int last_key = q_offset + min(q0 + kTile, T_) - 1;
    n_k_tiles = last_key < 0 ? 0 : min(n_k_tiles, last_key / kTile + 1);
  }

  // prologue: q with the first k/v tiles, one commit group per stage
  if constexpr (kSingle) load_q_scaled<T, D>(sQ, qb, q_st, q0, T_, scale, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (!kSingle && s == 0) load_tile_async<T, kTile, D, DP>(sQ, qb, q_st, q0, T_, tid, kWgThreads);
    if (s < n_k_tiles) {
      const uint32_t st = base + L::ring + s * L::stage;
      load_tile_async<T, kTile, D, DP>(st, kb, k_st, s * kTile, S, tid, kWgThreads);
      load_tile_async<T, kTile, D, DP>(st + L::tile, vb, v_st, s * kTile, S, tid, kWgThreads);
    }
    cp_async_commit();
  }

  // scores in the log2 domain: t = S scale log2(e) (q~ carries the scale in
  // stochastic_mode); this thread's two rows' running max m2 (log2 domain)
  // and its share of their sums l
  const float score2 = (kSingle ? 1.f : scale) * kLog2e;
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
      load_tile_async<T, kTile, D, DP>(st, kb, k_st, pf * kTile, S, tid, kWgThreads);
      load_tile_async<T, kTile, D, DP>(st + L::tile, vb, v_st, pf * kTile, S, tid, kWgThreads);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile kt (and q) have landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t sK = base + L::ring + (kt % kStages) * L::stage;
    const uint32_t sV = sK + L::tile;
    const int k0 = kt * kTile;

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
    // (i >> 1) & 1 == r lie on row r); hidden keys score kNegInf, as the
    // reference masks them
    const bool masked = k0 + kTile > S || q0 + kTile > T_ ||
                        (causal && k0 + kTile - 1 > q_offset + q0);
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
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
    // P (times 2^kPOffset for fp16's default function) into s
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(s[i] - (m2[r] - kPOffset));
      l[r] += p;
      s[i] = p;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i >> 1) & 1];

    // O += P_hi V + P_lo V, or T(P) V (A from registers, V MN-major)
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if constexpr (kSingle) {
        uint32_t a[4];
        acc_to_a_single<T>(s, kk, a);
#pragma unroll
        for (int p = 0; p < NP; ++p) wgmma_rs_mn<T>(acc[p], a, desc_mnmajor<kTile>(sV, p, kk));
      } else {
        uint32_t hi[4], lo[4];
        const float one[2] = {1.f, 1.f};
        acc_to_a<T>(s, kk, hi, lo, one);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          wgmma_rs_mn<T>(acc[p], hi, desc_mnmajor<kTile>(sV, p, kk));
          wgmma_rs_mn<T>(acc[p], lo, desc_mnmajor<kTile>(sV, p, kk));
        }
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
      const int t = q0 + acc_row(warp, lane, i);
      if (t >= T_ || p * kPanelCols + acc_col(lane, i) >= D) continue;  // D 96's zero columns
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
  int B, H, T, S;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, bool kSingle>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = FwdLayout<D>::bytes + 1024;  // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<T, D, kSingle>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.T + kTile - 1) / kTile);
  flash_fwd_tc_kernel<T, D, kSingle><<<grid, kWgThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.H, a.T, a.S, a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh,
      a.v_sb, a.v_st, a.v_sh, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, bool kSingle>
cudaError_t dispatch_dim(int D, const Args& a) {
  if (D == 64) return launch<T, 64, kSingle>(a);
  if (D == 96) return launch<T, 96, kSingle>(a);
  if (D == 128) return launch<T, 128, kSingle>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_mode(int single, int D, const Args& a) {
  return single ? dispatch_dim<T, true>(D, a) : dispatch_dim<T, false>(D, a);
}

}  // namespace

// q [B, T, H, D], k/v [B, S, H, D] given by element strides (batch, seq, head;
// the last dimension contiguous, rows 16-byte aligned); o [B, T, H, D]
// contiguous in the input dtype; lse [B*H, T] fp32. dtype is 1 (bf16) or 2
// (fp16), D 64, 96 or 128; `single` 1 selects stochastic_mode's single-cast
// function. Returns the CUDA error code of the launch (0 on success).
extern "C" int ds_flash_attention_fwd_tc(const void* q, const void* k, const void* v, void* o,
                                         float* lse, int B, int H, int T, int S, int D, int dtype,
                                         long long q_sb, long long q_st, long long q_sh,
                                         long long k_sb, long long k_st, long long k_sh,
                                         long long v_sb, long long v_st, long long v_sh,
                                         float scale, int causal, int single, void* stream) {
  const Args a{q, k, v, o, lse, B, H, T, S, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
               v_sb, v_st, v_sh, scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {  // fp32 runs the 3xTF32 kernel of flash_attention_fwd_tf32.cu
    case ds::kBF16: return dispatch_mode<__nv_bfloat16>(single, D, a);
    case ds::kF16: return dispatch_mode<__half>(single, D, a);
    default: return cudaErrorInvalidValue;
  }
}
