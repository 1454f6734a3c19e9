// Flash-attention backward on Hopper's tensor cores (sm_90a) for fp32
// inputs, as 3xTF32: the dq and dk/dv passes; plain C interface.
//
// Replaces, for fp32 inputs, the TPU kernels _bwd_dq_kernel and
// _bwd_dkv_kernel of deepspeed_tpu/ops/pallas/flash_attention.py (_bwd, the
// pallas_calls at :291 and :309); bf16 and fp16 inputs take
// csrc/flash_attention_bwd_tc.cu, and delta = rowsum(dO * O), which both
// passes read, stays the CUDA-core kernel of csrc/flash_attention_bwd.cu.
// The function is the reference's:
//   P  = exp(scale * q k^T - lse)          (0 where the causal mask hides a key)
//   dV = P^T dO,   dS = P * (dO v^T - delta) * scale,   dQ = dS k,   dK = dS^T q
// with the causal mask aligned bottom-right (query row t sits at position
// t + S - T) and fp32 accumulators. stochastic_mode is the same function for
// fp32 inputs.
//
// Numerics: every product in 3xTF32 (csrc/tc_tile.cuh, section tf32), ~2^-21
// of each term dropped where one TF32 pass keeps ~2^-11. q k^T is scored as
// the forward (flash_attention_fwd_tf32.cu) scores it: the same three passes
// over the same split tiles, the scale on the fp32 sum, so P matches the
// forward's lse to float tolerance (the dk/dv pass takes k q^T, the same
// terms summed in another order).
//
// The K-major rule. The products whose operands are both K-major run on
// wgmma m64nNk8 SS over split tiles: q k^T and dO v^T (dq), k q^T and v dO^T
// (dk/dv). The three whose B would be MN-major (dS k, P^T dO, dS^T q) run on
// mma.sync m16n8k8 tf32 (HMMA): A from the accumulator as it lies
// (acc_to_a_tf32), B gathered per thread from the same split tiles
// (b_offset_tf32). No tile is transposed, none is held twice.
//
// Work split: two passes, no atomics. Every output element is written by one
// block in a fixed order, so two runs give bitwise-equal gradients.
// - dq: one block of one warpgroup (128 threads) per (b*h, 64-row q tile),
//   heavy causal tiles first; the big and small parts of its q and dO tiles
//   stay, and BN-key k/v tiles stream through one set of four tiles: once
//   dO v^T is done the next raw k and v are copied (cp.async, zero-filled past
//   S) into v's two tiles while dQ += dS k runs; then k is split into k's
//   tiles and v in place. Causal runs stop at the last visible k tile.
// - dkv: one block per (b*h, 64-row k tile), keys as the M dimension: k and v
//   (big and small) stay, BM-query q/dO tiles stream the same way (the next
//   raw q and dO into dO's tiles once dV += P^T dO is done, while dK += dS^T q
//   runs), with their lse and delta rows double-buffered. S^T = k q^T and
//   dP^T = v dO^T leave P^T and dS^T in accumulator registers.
// Tiles by head dim (fp32, big + small, panels of 32 columns): D 64 streams
// 32-row tiles (96 KB a block, two blocks an SM; 64-row ones, 128 KB and one
// block, measured 13% slower), D 96 64-row ones (192 KB, one block; 32-row
// ones, 144 KB and still one block, measured slower), D 128 32-row ones (192
// KB; 64 would need 256 KB).
// Inputs are read through their strides (last dimension contiguous, rows
// 16-byte aligned: the q/k/v views of the fused qkv projection need no copy);
// dq/dk/dv are written contiguous [B, T|S, H, D].
//
// What bounds it on the H100: at the GPT-2-125M training shape (B8, T=S=512,
// H12, D64, causal) dq does 3 products over the visible pairs (4.84 GFLOP)
// and dk/dv 4 (6.45 GFLOP), three TF32 passes each: 29.3 us and 39.1 us at 495
// TFLOP/s (72.3 / 96.3 us for one fp32 pass on the CUDA cores); the bytes
// each pass moves once (q, k, v, dO, lse, delta and its gradients: 63 / 76
// MB) take 18.9 / 22.7 us: operation-bound. The two passes recompute q k^T
// and dO v^T (7 products where 5 are needed) to keep atomics out. Each block
// waits on its own copies, splits and products, so latency, not the tensor
// rate, bounds this first design; the dk/dv pass at D 96 and 128 also spills
// (255 registers: two D-wide fp32 accumulators beside the score tiles).

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

using namespace ds::tc;

constexpr int kTile = 64;  // rows of the resident tiles (q in dq, k in dk/dv)
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int T_, int S,
                         long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh,
                         long long d_sb, long long d_st, long long d_sh,
                         float scale, int causal) {
  using L = Layout<D>;
  constexpr int BN = L::R;    // keys a streamed tile
  constexpr int NT = D / 8;   // n tiles of dQ
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  // resident q (a) and dO (b); streamed k (c) and v (d)
  const uint32_t sQ = base + L::a, sQs = base + L::a_small;
  const uint32_t sO = base + L::b, sOs = base + L::b_small;
  const uint32_t sK = base + L::c, sKs = base + L::c_small;
  const uint32_t sV = base + L::d, sVs = base + L::d_small;

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

  // raw k and v of tile kt into v's two tiles, the first to fall free
  auto load_kv = [&](int kt) {
    load_tile_async<float, BN, D>(sV, kb, k_st, kt * BN, S, tid, kThreads);
    load_tile_async<float, BN, D>(sVs, vb, v_st, kt * BN, S, tid, kThreads);
  };
  // k from v's big tile into k's tiles, then v in place; published to wgmma
  auto split_kv = [&]() {
    split_tile_tf32(sV, sK, sKs, L::stile, tid, kThreads);
    __syncthreads();
    split_tile_tf32(sVs, sV, sVs, L::stile, tid, kThreads);
    fence_proxy_async();
    __syncthreads();
  };

  load_tile_async<float, kTile, D>(sQ, q + b * q_sb + h * q_sh, q_st, q0, T_, tid, kThreads);
  load_tile_async<float, kTile, D>(sO, dout + b * d_sb + h * d_sh, d_st, q0, T_, tid, kThreads);
  if (n_k_tiles > 0) load_kv(0);
  cp_async_commit();

  // this thread's two rows: their lse (log2 domain) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + 16 * warp + (lane >> 2) + 8 * r;
    lse2[r] = t < T_ ? lse[(long long)bh * T_ + t] * kLog2e : 0.f;
    dlt[r] = t < T_ ? delta[(long long)bh * T_ + t] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  cp_async_wait<0>();
  __syncthreads();
  split_tile_tf32(sQ, sQ, sQs, L::rtile, tid, kThreads);
  split_tile_tf32(sO, sO, sOs, L::rtile, tid, kThreads);
  if (n_k_tiles > 0) split_kv();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * BN;

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
    const bool masked = k0 + BN > S || q0 + kTile > T_ ||
                        (causal && k0 + BN - 1 > q_offset + q0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
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
    for (int i = 0; i < BN / 2; ++i) s[i] = s[i] * (dp[i] - dlt[(i >> 1) & 1]) * scale;

    __syncthreads();  // every warp's products have read v's tiles
    const bool next = kt + 1 < n_k_tiles;
    if (next) load_kv(kt + 1);
    cp_async_commit();

    // dQ += dS k (mma.sync, dS from registers, k gathered from its tiles)
    mma_acc_tf32x3<BN>(acc, s, smem + L::c, smem + L::c_small, BN / 8, lane);

    if (next) {
      cp_async_wait<0>();
      __syncthreads();  // the next raw tiles have landed; every warp is done with k
      split_kv();
    }
  }
  store_rows(dq, acc, b, h, H, T_, q0, warp, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int T_, int S,
                          long long q_sb, long long q_st, long long q_sh,
                          long long k_sb, long long k_st, long long k_sh,
                          long long v_sb, long long v_st, long long v_sh,
                          long long d_sb, long long d_st, long long d_sh,
                          float scale, int causal) {
  using L = Layout<D>;
  constexpr int BM = L::R;    // queries a streamed tile
  constexpr int NT = D / 8;   // n tiles of dK and dV
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
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;  // blockIdx.y 0 sees the most query tiles
  const int q_offset = S - T_;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* db = dout + b * d_sb + h * d_sh;
  const float* lb = lse + (long long)bh * T_;
  const float* deb = delta + (long long)bh * T_;

  const int n_q_tiles = (T_ + BM - 1) / BM;
  int first = 0;
  if (causal) {  // the first query that sees key k0 is t = k0 - q_offset
    const int t0 = k0 - q_offset;
    first = t0 <= 0 ? 0 : t0 / BM;
  }
  const int n = max(0, n_q_tiles - first);

  // raw q and dO of tile it into dO's two tiles, the first to fall free, and
  // its lse and delta rows into row buffer it % 2
  auto load_qo = [&](int it) {
    const int q0 = (first + it) * BM;
    load_tile_async<float, BM, D>(sO, qb, q_st, q0, T_, tid, kThreads);
    load_tile_async<float, BM, D>(sOs, db, d_st, q0, T_, tid, kThreads);
    const uint32_t rs = base + L::rows + (it & 1) * L::row_stage;
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

  load_tile_async<float, kTile, D>(sK, k + b * k_sb + h * k_sh, k_st, k0, S, tid, kThreads);
  load_tile_async<float, kTile, D>(sV, v + b * v_sb + h * v_sh, v_st, k0, S, tid, kThreads);
  if (n > 0) load_qo(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile_tf32(sK, sK, sKs, L::rtile, tid, kThreads);
  split_tile_tf32(sV, sV, sVs, L::rtile, tid, kThreads);
  if (n > 0) split_qo();

  const float scale2 = scale * kLog2e;
  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  for (int it = 0; it < n; ++it) {
    const float* sL = rows_f + (it & 1) * (L::row_stage / 4);
    const float* sD = sL + BM;
    const int q0 = (first + it) * BM;

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
    const bool masked = k0 + kTile > S || q0 + BM > T_ ||
                        (causal && k0 + kTile - 1 > q_offset + q0);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int c = acc_col(lane, i);
      float p = exp2f(fmaf(st[i], scale2, -sL[c] * kLog2e));
      if (masked) {
        const int key = k0 + acc_row(warp, lane, i), t = q0 + c;
        const bool visible = t < T_ && key < S && !(causal && key > q_offset + t);
        p = visible ? p : 0.f;
      }
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
    const bool next = it + 1 < n;
    if (next) load_qo(it + 1);
    cp_async_commit();

    // dK += dS^T q (mma.sync, q gathered from its tiles)
    mma_acc_tf32x3<BM>(acc_k, dpt, smem + L::c, smem + L::c_small, BM / 8, lane);

    if (next) {
      cp_async_wait<0>();
      __syncthreads();  // the next raw tiles have landed; every warp is done with q
      split_qo();
    }
  }
  store_rows(dk, acc_k, b, h, H, S, k0, warp, lane);
  store_rows(dv, acc_v, b, h, H, S, k0, warp, lane);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, T, S;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = Layout<D>::bytes + 1024;  // + the 1024-byte alignment
  cudaError_t err = set_smem(flash_bwd_dq_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.T + kTile - 1) / kTile);
  flash_bwd_dq_tf32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), a.H, a.T, a.S, a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh,
      a.v_sb, a.v_st, a.v_sh, a.d_sb, a.d_st, a.d_sh, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = Layout<D>::bytes + 1024;
  cudaError_t err = set_smem(flash_bwd_dkv_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kTile - 1) / kTile);
  flash_bwd_dkv_tf32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.T, a.S,
      a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh,
      a.d_sb, a.d_st, a.d_sh, a.scale, a.causal);
  return cudaGetLastError();
}

enum Pass { kDq = 0, kDkv = 1 };

cudaError_t dispatch(int dtype, int D, int pass, const Args& a) {
  if (dtype != ds::kF32) return cudaErrorInvalidValue;  // 16-bit: flash_attention_bwd_tc.cu
  if (D == 64) return pass == kDq ? launch_dq<64>(a) : launch_dkv<64>(a);
  if (D == 96) return pass == kDq ? launch_dq<96>(a) : launch_dkv<96>(a);
  if (D == 128) return pass == kDq ? launch_dq<128>(a) : launch_dkv<128>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns the CUDA error
// code of the launch (0 on success). q/dO are [B, T, H, D] and k/v
// [B, S, H, D] fp32 (dtype 0), given by element strides (batch, seq, head;
// the last dimension contiguous, rows 16-byte aligned); lse and delta are
// [B*H, T] fp32 contiguous; dq [B, T, H, D] and dk/dv [B, S, H, D] are
// written contiguous. D 64, 96 or 128.

// dq (the counterpart of _bwd_dq_kernel).
extern "C" int ds_flash_attention_bwd_dq_tf32(const void* q, const void* k, const void* v,
                                              const void* dout, const float* lse,
                                              const float* delta, void* dq, int B, int H, int T,
                                              int S, int D, int dtype,
                                              long long q_sb, long long q_st, long long q_sh,
                                              long long k_sb, long long k_st, long long k_sh,
                                              long long v_sb, long long v_st, long long v_sh,
                                              long long d_sb, long long d_st, long long d_sh,
                                              float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, T, S,
               q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, kDq, a);
}

// dk and dv (the counterpart of _bwd_dkv_kernel).
extern "C" int ds_flash_attention_bwd_dkv_tf32(const void* q, const void* k, const void* v,
                                               const void* dout, const float* lse,
                                               const float* delta, void* dk, void* dv, int B,
                                               int H, int T, int S, int D, int dtype,
                                               long long q_sb, long long q_st, long long q_sh,
                                               long long k_sb, long long k_st, long long k_sh,
                                               long long v_sb, long long v_st, long long v_sh,
                                               long long d_sb, long long d_st, long long d_sh,
                                               float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, T, S,
               q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, kDkv, a);
}
