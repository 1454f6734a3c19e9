// Blocksparse-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/blocksparse_attention.py
// _bwd: _bwd_dq_kernel and _bwd_dkv_kernel. Same function: from the saved
// fp32 logsumexp of the forward (csrc/blocksparse_attention_fwd.cu, lse
// [B*H, T]), over the (q-block, k-block) pairs of the layout only,
//   P  = exp(scale * q k^T - lse)      (0 where the layout or causal mask hides a key)
//   dV = P^T dO
//   dS = P * (dO v^T - delta) * scale,   delta = rowsum(dO * O)
//   dQ = dS k,   dK = dS^T q
// with causal meaning key <= query (T == S), fp32 accumulators cast to the
// input dtype at the end.
//
// delta: the Pallas passes recompute rowsum(dO * O) on every visit of a
// q-block. Here the dq pass computes it once per row, before its loop, and
// writes it as fp32 [B*H, T]; the dk/dv pass, launched after it on the same
// stream, reads it. So there is no delta launch of its own, and the two
// passes must run in that order. This changes the summation order only.
//
// Work split, two kernels and no atomics (every output element is written by
// one block in a fixed order, so two runs give bitwise-equal gradients), with
// tiles of TILE = min(block, 64) rows (a block of 128 is two tiles) and 4
// warps a block:
// - dq: one block per (b*h, q tile), over the kcnt[h, qi] active k-blocks
//   of kidx [H, nQ, A]. It stages its q tile (scaled, as the forward does, so
//   the scores are bitwise the forward's) and dO tile, computes delta, then
//   loops over TILE-key tiles. Each warp owns TILE/4 query rows: lane j
//   scores key j (and j+32) and its dO v^T entry, writes dS into a per-warp
//   shared strip, and accumulates output dimensions j, j+32, ... of dS k.
// - dkv: one block per (b*h, k tile), over the qcnt[h, ki] active q-blocks
//   of the transposed table qidx [H, nK, Aq]. It stages its k and v rows once
//   and loops over TILE-query tiles: each warp owns TILE/4 keys, lane j
//   scores query j (and j+32), writes P and dS into per-warp strips, and
//   accumulates dimensions j, j+32, ... of P^T dO and dS^T q.
// Under `causal` both skip the tiles wholly on the hidden side of the
// diagonal (k above the q tile's last row; q before the k tile's first key):
// their P is exactly 0 in the reference. Padding table entries are never
// read. Inputs are read through their strides (last dimension contiguous,
// rows 16-byte aligned), so the q/k/v views of the fused qkv projection
// need no copy; dq/dk/dv are written contiguous [B, T, H, D].
//
// Numerics: every operand is widened to fp32 and the products accumulate in
// fp32 on the CUDA cores (no tensor cores).
//
// Which inputs it serves (ops/cuda/blocksparse_attention.py bs_route): fp32
// at every block, and bf16 / fp16 at blocks of 16 and 32; bf16 / fp16 at
// blocks of 64 and 128 run csrc/blocksparse_attention_bwd_tc.cu, and this
// file has no 16-bit instance of its 64-row tile.
//
// What bounds it on the H100: at the sparse GPT-2-125M's fp32 shape (B2,
// T1024, H12, D64, the Fixed layout of 4 local and 1 global block of 128,
// unidirectional) the backward needs 5 products x 2*D flops for each of the
// about 7.9M visible pairs, 5.0 GFLOP: 0.075 ms in fp32 on the CUDA cores
// (67 TFLOP/s, data sheet). This kernel recomputes q k^T and dO v^T in both
// passes (7 products instead of 5) and reads its operands through shared
// memory, so it is bound by FMA issue and shared-memory bandwidth. A 3xTF32
// design on the tensor cores, as the fp32 flash kernels have, is queued
// (ROADMAP.md).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// shared layout of the dq kernel (floats)
template <int D, int TILE> struct DqLayout {
  static constexpr int kRows = TILE / kWarps;
  static constexpr int kStride = D + 4;                  // padded rows read lane-per-row
  static constexpr int q = 0;                            // [TILE][D], scaled
  static constexpr int dout = q + TILE * D;              // [TILE][D]
  static constexpr int k = dout + TILE * D;              // [TILE][kStride]
  static constexpr int v = k + TILE * kStride;           // [TILE][kStride]
  static constexpr int dS = v + TILE * kStride;          // [kWarps][kRows][TILE]
  static constexpr int lse = dS + kWarps * kRows * TILE;  // [TILE]
  static constexpr int delta = lse + TILE;               // [TILE]
  static constexpr int floats = delta + TILE;
  static constexpr size_t bytes = floats * sizeof(float);
};

// shared layout of the dkv kernel (floats)
template <int D, int TILE> struct DkvLayout {
  static constexpr int kRows = TILE / kWarps;
  static constexpr int kStride = D + 4;
  static constexpr int k = 0;                            // [TILE][D]
  static constexpr int v = k + TILE * D;                 // [TILE][D]
  static constexpr int q = v + TILE * D;                 // [TILE][kStride], scaled
  static constexpr int dout = q + TILE * kStride;        // [TILE][kStride]
  static constexpr int p = dout + TILE * kStride;        // [kWarps][kRows][TILE]
  static constexpr int dS = p + kWarps * kRows * TILE;   // [kWarps][kRows][TILE]
  static constexpr int lse = dS + kWarps * kRows * TILE;  // [TILE]
  static constexpr int delta = lse + TILE;               // [TILE]
  static constexpr int floats = delta + TILE;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Copy rows [r0, r0 + TILE) of one head (row stride `st` elements) into a
// shared fp32 tile with row stride `dst_stride`, scaled.
template <typename T, int D, int TILE>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* src,
                                          long long st, int r0, float scale) {
  constexpr int V = ds::Vec16<T>::n;
  constexpr int chunks = D / V;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < TILE * chunks; c += kThreads) {
    const int r = c / chunks, d = (c % chunks) * V;
    float x[V];
    ds::load16<T>(src + (long long)(r0 + r) * st + d, x);
    float* out = dst + r * dst_stride + d;
#pragma unroll
    for (int u = 0; u < V; u += 4)
      *reinterpret_cast<float4*>(out + u) =
          make_float4(x[u] * scale, x[u + 1] * scale, x[u + 2] * scale, x[u + 3] * scale);
  }
}

// Copy rows [r0, r0 + TILE) of a [B*H, T] fp32 row vector into shared memory.
template <int TILE>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0) {
  for (int i = threadIdx.x; i < TILE; i += kThreads) dst[i] = src[r0 + i];
}

// x . a over four dimensions, accumulated in the order the forward kernel uses
__device__ __forceinline__ float dot4(float4 x, float4 a, float s) {
  return fmaf(x.x, a.x, fmaf(x.y, a.y, fmaf(x.z, a.z, fmaf(x.w, a.w, s))));
}

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads)
blocksparse_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ delta, T* __restrict__ dq,
                          const int* __restrict__ kidx, const int* __restrict__ kcnt,
                          int H, int T_, int block, int A,
                          long long q_sb, long long q_st, long long q_sh,
                          long long k_sb, long long k_st, long long k_sh,
                          long long v_sb, long long v_st, long long v_sh,
                          long long o_sb, long long o_st, long long o_sh,
                          long long d_sb, long long d_st, long long d_sh,
                          float scale, int causal) {
  using L = DqLayout<D, TILE>;
  constexpr int kRows = L::kRows;
  constexpr int DL = D / 32;             // output dimensions per lane
  constexpr int NJ = TILE > 32 ? 2 : 1;  // keys per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem + L::q;
  float* sO = smem + L::dout;
  float* sK = smem + L::k;
  float* sV = smem + L::v;
  float* sL = smem + L::lse;
  float* sD = smem + L::delta;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * TILE;
  const int qi = q0 / block;
  const int nQ = T_ / block;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * kRows;
  float* sDS = smem + L::dS + warp * kRows * TILE;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  load_tile<T, D, TILE>(sQ, D, q + b * q_sb + h * q_sh, q_st, q0, scale);
  load_tile<T, D, TILE>(sO, D, dout + b * d_sb + h * d_sh, d_st, q0, 1.f);
  load_rows<TILE>(sL, lse + (long long)bh * T_, q0);

  // delta = rowsum(dO * O) of this warp's rows, once, for this pass and dk/dv
  const T* ob = o + b * o_sb + h * o_sh;
  const T* db = dout + b * d_sb + h * d_sh;
#pragma unroll 1
  for (int i = 0; i < kRows; ++i) {
    const int t = row0 + i;
    float acc = 0.f;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) {
      const int d = lane + 32 * dd;
      acc = fmaf(ds::to_float(ob[t * o_st + d]), ds::to_float(db[t * d_st + d]), acc);
    }
    acc = ds::warp_sum(acc);
    if (lane == 0) {
      sD[warp * kRows + i] = acc;
      delta[(long long)bh * T_ + t] = acc;
    }
  }

  float acc[kRows][DL];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[i][dd] = 0.f;

  const int cnt = kcnt[h * nQ + qi];
  const int* idx = kidx + (long long)(h * nQ + qi) * A;
  const int subs = block / TILE;
  for (int a = 0; a < cnt; ++a) {
    const int ki = idx[a];
    for (int sub = 0; sub < subs; ++sub) {
      const int k0 = ki * block + sub * TILE;
      if (causal && k0 > q0 + TILE - 1) continue;  // wholly above the tile's last row
      __syncthreads();  // the previous tile is consumed (and the q-side tiles are written)
      load_tile<T, D, TILE>(sK, L::kStride, kb, k_st, k0, 1.f);
      load_tile<T, D, TILE>(sV, L::kStride, vb, v_st, k0, 1.f);
      __syncthreads();

      // scores and dO v^T of this warp's rows against key lane (and lane + 32)
      float s[kRows][NJ], dp[kRows][NJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
      const float *k_row[NJ], *v_row[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = min(lane + 32 * j, TILE - 1);
        k_row[j] = sK + c * L::kStride;
        v_row[j] = sV + c * L::kStride;
      }
      const float* qw = sQ + warp * kRows * D;
      const float* ow = sO + warp * kRows * D;
#pragma unroll 1
      for (int d = 0; d < D; d += 4) {
        float4 kk[NJ], vv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          kk[j] = *reinterpret_cast<const float4*>(k_row[j] + d);
          vv[j] = *reinterpret_cast<const float4*>(v_row[j] + d);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(qw + i * D + d);
          const float4 y = *reinterpret_cast<const float4*>(ow + i * D + d);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            s[i][j] = dot4(x, kk[j], s[i][j]);
            dp[i][j] = dot4(y, vv[j], dp[i][j]);
          }
        }
      }

      // dS = P * (dO v^T - delta) * scale into this warp's strip
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = warp * kRows + i, t = q0 + r;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = lane + 32 * j;
          if (c >= TILE) continue;
          const bool visible = !(causal && k0 + c > t);
          const float p = visible ? expf(s[i][j] - sL[r]) : 0.f;
          sDS[i * TILE + c] = p * (dp[i][j] - sD[r]) * scale;
        }
      }
      __syncwarp();

      // acc += dS k: lane owns output dimensions lane + 32 * dd
#pragma unroll 1
      for (int j = 0; j < TILE; j += 4) {
        float kk[4][DL];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int dd = 0; dd < DL; ++dd) kk[u][dd] = sK[(j + u) * L::kStride + lane + 32 * dd];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 g = *reinterpret_cast<const float4*>(sDS + i * TILE + j);
#pragma unroll
          for (int dd = 0; dd < DL; ++dd)
            acc[i][dd] = fmaf(g.x, kk[0][dd], fmaf(g.y, kk[1][dd],
                         fmaf(g.z, kk[2][dd], fmaf(g.w, kk[3][dd], acc[i][dd]))));
        }
      }
      __syncwarp();  // sDS is rewritten by the next tile
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = row0 + i;
    T* row = dq + (((long long)b * T_ + t) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) row[lane + 32 * dd] = ds::from_float<T>(acc[i][dd]);
  }
}

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads)
blocksparse_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv,
                           const int* __restrict__ qidx, const int* __restrict__ qcnt,
                           int H, int T_, int block, int Aq,
                           long long q_sb, long long q_st, long long q_sh,
                           long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh,
                           long long d_sb, long long d_st, long long d_sh,
                           float scale, int causal) {
  using L = DkvLayout<D, TILE>;
  constexpr int kRows = L::kRows;
  constexpr int DL = D / 32;
  constexpr int NJ = TILE > 32 ? 2 : 1;  // queries per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sK = smem + L::k;
  float* sV = smem + L::v;
  float* sQ = smem + L::q;
  float* sO = smem + L::dout;
  float* sL = smem + L::lse;
  float* sD = smem + L::delta;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * TILE;
  const int ki = k0 / block;
  const int nK = T_ / block;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = k0 + warp * kRows;  // this warp's first key
  float* sP = smem + L::p + warp * kRows * TILE;
  float* sDS = smem + L::dS + warp * kRows * TILE;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* db = dout + b * d_sb + h * d_sh;
  const float* lb = lse + (long long)bh * T_;
  const float* deb = delta + (long long)bh * T_;
  load_tile<T, D, TILE>(sK, D, k + b * k_sb + h * k_sh, k_st, k0, 1.f);
  load_tile<T, D, TILE>(sV, D, v + b * v_sb + h * v_sh, v_st, k0, 1.f);

  float acc_k[kRows][DL], acc_v[kRows][DL];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc_k[i][dd] = acc_v[i][dd] = 0.f;

  const int cnt = qcnt[h * nK + ki];
  const int* idx = qidx + (long long)(h * nK + ki) * Aq;
  const int subs = block / TILE;
  for (int a = 0; a < cnt; ++a) {
    const int qi = idx[a];
    for (int sub = 0; sub < subs; ++sub) {
      const int q0 = qi * block + sub * TILE;
      if (causal && q0 + TILE - 1 < k0) continue;  // every query before the tile's first key
      __syncthreads();  // the previous tile is consumed (and sK/sV are written on the first pass)
      load_tile<T, D, TILE>(sQ, L::kStride, qb, q_st, q0, scale);
      load_tile<T, D, TILE>(sO, L::kStride, db, d_st, q0, 1.f);
      load_rows<TILE>(sL, lb, q0);
      load_rows<TILE>(sD, deb, q0);
      __syncthreads();

      // scores and v . dO of this warp's keys against query lane (and lane + 32)
      float s[kRows][NJ], dp[kRows][NJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
      const float *q_row[NJ], *o_row[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = min(lane + 32 * j, TILE - 1);
        q_row[j] = sQ + c * L::kStride;
        o_row[j] = sO + c * L::kStride;
      }
      const float* kw = sK + warp * kRows * D;
      const float* vw = sV + warp * kRows * D;
#pragma unroll 1
      for (int d = 0; d < D; d += 4) {
        float4 qq[NJ], oo[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          qq[j] = *reinterpret_cast<const float4*>(q_row[j] + d);
          oo[j] = *reinterpret_cast<const float4*>(o_row[j] + d);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(kw + i * D + d);
          const float4 y = *reinterpret_cast<const float4*>(vw + i * D + d);
          // q first, as the forward multiplies: fmaf is exact in its product,
          // so the score is the forward's bit for bit
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            s[i][j] = dot4(qq[j], x, s[i][j]);
            dp[i][j] = dot4(oo[j], y, dp[i][j]);
          }
        }
      }

      // P and P * (dO v^T - delta) into this warp's strips (the scale rides
      // the scaled q tile that multiplies dS below)
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int key = key0 + i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = lane + 32 * j;
          if (c >= TILE) continue;
          const bool visible = !(causal && key > q0 + c);
          const float p = visible ? expf(s[i][j] - sL[c]) : 0.f;
          sP[i * TILE + c] = p;
          sDS[i * TILE + c] = p * (dp[i][j] - sD[c]);
        }
      }
      __syncwarp();

      // acc_v += P^T dO, acc_k += dS^T (scale q): lane owns dimensions lane + 32 * dd
#pragma unroll 1
      for (int j = 0; j < TILE; j += 4) {
        float oo[4][DL], qq[4][DL];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int dd = 0; dd < DL; ++dd) {
            oo[u][dd] = sO[(j + u) * L::kStride + lane + 32 * dd];
            qq[u][dd] = sQ[(j + u) * L::kStride + lane + 32 * dd];
          }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 p = *reinterpret_cast<const float4*>(sP + i * TILE + j);
          const float4 g = *reinterpret_cast<const float4*>(sDS + i * TILE + j);
#pragma unroll
          for (int dd = 0; dd < DL; ++dd) {
            acc_v[i][dd] = fmaf(p.x, oo[0][dd], fmaf(p.y, oo[1][dd],
                           fmaf(p.z, oo[2][dd], fmaf(p.w, oo[3][dd], acc_v[i][dd]))));
            acc_k[i][dd] = fmaf(g.x, qq[0][dd], fmaf(g.y, qq[1][dd],
                           fmaf(g.z, qq[2][dd], fmaf(g.w, qq[3][dd], acc_k[i][dd]))));
          }
        }
      }
      __syncwarp();  // the strips are rewritten by the next tile
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = key0 + i;
    const long long off = (((long long)b * T_ + key) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) {
      dk[off + lane + 32 * dd] = ds::from_float<T>(acc_k[i][dd]);
      dv[off + lane + 32 * dd] = ds::from_float<T>(acc_v[i][dd]);
    }
  }
}

// Strides of one [B, T, H, D] operand: batch, row, head (elements).
struct Strides {
  long long b, t, h;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  const int *idx, *cnt;  // kidx/kcnt for dq, qidx/qcnt for dk/dv
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

template <typename T, int D, int TILE>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = DqLayout<D, TILE>::bytes;
  cudaError_t err = set_smem(blocksparse_bwd_dq_kernel<T, D, TILE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, a.T / TILE);
  blocksparse_bwd_dq_kernel<T, D, TILE><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.dq), a.idx, a.cnt, a.H, a.T, a.block, a.A,
      a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b, a.vs.t, a.vs.h,
      a.os.b, a.os.t, a.os.h, a.dos.b, a.dos.t, a.dos.h, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D, int TILE>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = DkvLayout<D, TILE>::bytes;
  cudaError_t err = set_smem(blocksparse_bwd_dkv_kernel<T, D, TILE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, a.T / TILE);
  blocksparse_bwd_dkv_kernel<T, D, TILE><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.idx, a.cnt, a.H, a.T, a.block, a.A,
      a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b, a.vs.t, a.vs.h,
      a.dos.b, a.dos.t, a.dos.h, a.scale, a.causal);
  return cudaGetLastError();
}

enum Pass { kDq = 0, kDkv = 1 };

template <typename T, int D, int TILE>
cudaError_t run_pass(int pass, const Args& a) {
  switch (pass) {
    case kDq: return launch_dq<T, D, TILE>(a);
    case kDkv: return launch_dkv<T, D, TILE>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t dispatch_tile(int pass, const Args& a) {
  switch (a.block) {
    case 16: return run_pass<T, D, 16>(pass, a);
    case 32: return run_pass<T, D, 32>(pass, a);
    case 64:
    case 128:  // bf16 / fp16 at these blocks run the tensor-core kernel (the _tc file)
      if constexpr (std::is_same<T, float>::value) return run_pass<T, D, 64>(pass, a);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int D, int pass, const Args& a) {
  if (D == 64) return dispatch_tile<T, 64>(pass, a);
  if (D == 96) return dispatch_tile<T, 96>(pass, a);
  if (D == 128) return dispatch_tile<T, 128>(pass, a);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int dtype, int D, int pass, const Args& a) {
  switch (dtype) {
    case ds::kF32: return dispatch_dim<float>(D, pass, a);
    case ds::kBF16: return dispatch_dim<__nv_bfloat16>(D, pass, a);
    case ds::kF16: return dispatch_dim<__half>(D, pass, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns the CUDA error
// code of the launch (0 on success). q/k/v/o/dO are [B, T, H, D], given by
// element strides (batch, seq, head; the last dimension contiguous, rows
// 16-byte aligned); lse and delta are [B*H, T] fp32 contiguous; dq and dk/dv
// [B, T, H, D] are contiguous in the input dtype; the tables are int32
// contiguous on the device. T is a multiple of `block` (16, 32, 64 or 128).

// dq and delta (the counterpart of _bwd_dq_kernel); kidx [H, T/block, A],
// kcnt [H, T/block].
extern "C" int ds_blocksparse_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, const int* kidx, const int* kcnt,
    int B, int H, int T, int D, int dtype, int block, int A,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    long long d_sb, long long d_st, long long d_sh,
    float scale, int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = delta; a.dq = dq;
  a.idx = kidx; a.cnt = kcnt;
  a.B = B; a.H = H; a.T = T; a.block = block; a.A = A;
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

// dk and dv (the counterpart of _bwd_dkv_kernel), from the delta the dq pass
// wrote; qidx [H, T/block, Aq], qcnt [H, T/block].
extern "C" int ds_blocksparse_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, const int* qidx, const int* qcnt,
    int B, int H, int T, int D, int dtype, int block, int Aq,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long d_sb, long long d_st, long long d_sh,
    float scale, int causal, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = lse; a.delta = const_cast<float*>(delta);
  a.dk = dk; a.dv = dv;
  a.idx = qidx; a.cnt = qcnt;
  a.B = B; a.H = H; a.T = T; a.block = block; a.A = Aq;
  a.qs = {q_sb, q_st, q_sh};
  a.ks = {k_sb, k_st, k_sh};
  a.vs = {v_sb, v_st, v_sh};
  a.dos = {d_sb, d_st, d_sh};
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, kDkv, a);
}
