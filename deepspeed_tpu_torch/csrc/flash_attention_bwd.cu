// Flash-attention backward for Hopper (sm_90a) on the CUDA cores, plain C
// interface.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py
// _bwd: _bwd_delta_kernel (delta = rowsum(dO * O), every dtype), and
// _bwd_dq_kernel and _bwd_dkv_kernel for fp32 inputs (bf16 and fp16 take
// the tensor-core kernels of csrc/flash_attention_bwd_tc.cu). Same function:
// from the saved fp32 logsumexp of the forward (lse [B*H, T]),
//   P  = exp(scale * q k^T - lse)          (0 where the causal mask hides a key)
//   dV = P^T dO
//   dS = P * (dO v^T - delta) * scale
//   dQ = dS k,   dK = dS^T q
// with the causal mask aligned bottom-right (query row t sits at absolute
// position t + S - T), fp32 accumulators cast to the input dtype at the end.
//
// Work split, three kernels and no atomics (every output element is written
// by one block in a fixed order, so two runs give bitwise-equal gradients):
// - delta: one block (4 warps) per (b*h, 64-row q tile); a warp reduces one
//   row at a time with shuffles.
// - dq: one block per (b*h, 64-row q tile). It stages its q tile (scaled, as
//   the forward does, so the scores are bitwise the forward's) and dO tile,
//   then loops over 64-row k/v tiles. Each warp owns 16 query rows: lane j
//   scores keys j and j+32 and their dO v^T entries, writes dS into a
//   per-warp shared strip, and accumulates output dimensions j, j+32, ... of
//   dS k in registers. Causal runs stop at the tile's last visible key.
// - dkv: one block per (b*h, 64-row k tile). It stages its k and v rows once
//   and loops over the q tiles that can see them (causal runs start at the
//   first query that sees the tile's first key). Each warp owns 16 keys:
//   lane j scores queries j and j+32, writes P and dS into per-warp strips,
//   and accumulates dimensions j, j+32, ... of P^T dO and dS^T q.
// Inputs are read through their strides (last dimension contiguous, rows
// 16-byte aligned), so the q/k/v views of the fused qkv projection need no
// copy; dq/dk/dv are written contiguous [B, T|S, H, D].
//
// Numerics are the reference's fp32 function (stochastic_mode is the same
// function for fp32 inputs): the products accumulate in fp32 on the CUDA
// cores.
//
// What bounds it on the H100: at the GPT-2-125M training shape (B8, T=S=512,
// H12, D64, causal) the backward does 5 products x 2*D flops for the
// T(T+1)/2 visible pairs of each (b, h) -- about 5 GFLOP -- and moves q, k,
// v, o, dO, lse, delta, dq, dk and dv once, about 50 MB in fp32. Without
// tensor cores (67 TFLOP/s fp32) that is operation-bound at ~75 us. The
// kernels do fp32 FMA work on the CUDA cores, recompute q k^T and dO v^T in
// both the dq and the dkv pass (7 products instead of 5), and read their
// operands through shared memory, so they are bound by FMA issue and
// shared-memory bandwidth. The tensor cores' route for fp32 (3xTF32) is left
// to a later redesign.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 64;              // rows of a q tile and of a k tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;  // rows per warp

// shared layout of the dq kernel (floats)
template <int D> struct DqLayout {
  static constexpr int kStride = D + 4;                  // padded rows read lane-per-row
  static constexpr int q = 0;                            // [kTile][D], scaled
  static constexpr int dout = q + kTile * D;             // [kTile][D]
  static constexpr int k = dout + kTile * D;             // [kTile][kStride]
  static constexpr int v = k + kTile * kStride;          // [kTile][kStride]
  static constexpr int dS = v + kTile * kStride;         // [kWarps][kRows][kTile]
  static constexpr int lse = dS + kWarps * kRows * kTile;  // [kTile]
  static constexpr int delta = lse + kTile;              // [kTile]
  static constexpr int floats = delta + kTile;
  static constexpr size_t bytes = floats * sizeof(float);
};

// shared layout of the dkv kernel (floats)
template <int D> struct DkvLayout {
  static constexpr int kStride = D + 4;
  static constexpr int k = 0;                            // [kTile][D]
  static constexpr int v = k + kTile * D;                // [kTile][D]
  static constexpr int q = v + kTile * D;                // [kTile][kStride], scaled
  static constexpr int dout = q + kTile * kStride;       // [kTile][kStride]
  static constexpr int p = dout + kTile * kStride;       // [kWarps][kRows][kTile]
  static constexpr int dS = p + kWarps * kRows * kTile;  // [kWarps][kRows][kTile]
  static constexpr int lse = dS + kWarps * kRows * kTile;  // [kTile]
  static constexpr int delta = lse + kTile;              // [kTile]
  static constexpr int floats = delta + kTile;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Copy rows [r0, r0 + kTile) of one head (row stride `st` elements) into a
// shared fp32 tile with row stride `dst_stride`, scaled; rows at or past `n`
// are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* src,
                                          long long st, int r0, int n, float scale) {
  constexpr int V = ds::Vec16<T>::n;
  constexpr int chunks = D / V;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * chunks; c += kThreads) {
    const int r = c / chunks, d = (c % chunks) * V;
    float x[V];
    if (r0 + r < n) {
      ds::load16<T>(src + (long long)(r0 + r) * st + d, x);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) x[u] = 0.f;
    }
    float* out = dst + r * dst_stride + d;
#pragma unroll
    for (int u = 0; u < V; u += 4)
      *reinterpret_cast<float4*>(out + u) =
          make_float4(x[u] * scale, x[u + 1] * scale, x[u + 2] * scale, x[u + 3] * scale);
  }
}

// Copy rows [r0, r0 + kTile) of a [B*H, T] fp32 row vector into shared
// memory; rows at or past `n` are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) dst[i] = r0 + i < n ? src[r0 + i] : 0.f;
}

// x . a over four dimensions, accumulated in the order the forward kernel uses
__device__ __forceinline__ float dot4(float4 x, float4 a, float s) {
  return fmaf(x.x, a.x, fmaf(x.y, a.y, fmaf(x.z, a.z, fmaf(x.w, a.w, s))));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int H, int T_,
                       long long o_sb, long long o_st, long long o_sh,
                       long long d_sb, long long d_st, long long d_sh) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* ob = o + b * o_sb + h * o_sh;
  const T* db = dout + b * d_sb + h * d_sh;
  for (int i = warp; i < kTile; i += kWarps) {
    const int t = blockIdx.y * kTile + i;
    if (t >= T_) break;  // uniform across the warp
    float acc = 0.f;
#pragma unroll
    for (int dd = 0; dd < D / 32; ++dd) {
      const int d = lane + 32 * dd;
      acc = fmaf(ds::to_float(ob[t * o_st + d]), ds::to_float(db[t * d_st + d]), acc);
    }
    acc = ds::warp_sum(acc);
    if (lane == 0) delta[(long long)bh * T_ + t] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H, int T_, int S,
                    long long q_sb, long long q_st, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    long long d_sb, long long d_st, long long d_sh,
                    float scale, int causal) {
  using L = DqLayout<D>;
  constexpr int DL = D / 32;  // output dimensions per lane
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
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_offset = S - T_;  // bottom-right causal alignment
  const int row0 = q0 + warp * kRows;
  float* sDS = smem + L::dS + warp * kRows * kTile;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  load_tile<T, D>(sQ, D, q + b * q_sb + h * q_sh, q_st, q0, T_, scale);
  load_tile<T, D>(sO, D, dout + b * d_sb + h * d_sh, d_st, q0, T_, 1.f);
  load_rows(sL, lse + (long long)bh * T_, q0, T_);
  load_rows(sD, delta + (long long)bh * T_, q0, T_);

  float acc[kRows][DL];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[i][dd] = 0.f;

  int num_k_tiles = (S + kTile - 1) / kTile;
  if (causal) {
    // the tile's last real row sees keys up to q_offset + that row
    const int last_key = q_offset + min(q0 + kTile, T_) - 1;
    num_k_tiles = last_key < 0 ? 0 : min(num_k_tiles, last_key / kTile + 1);
  }

  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile is consumed (and sQ/sO are written on the first pass)
    load_tile<T, D>(sK, L::kStride, kb, k_st, k0, S, 1.f);
    load_tile<T, D>(sV, L::kStride, vb, v_st, k0, S, 1.f);
    __syncthreads();

    // scores and dO v^T of this warp's rows against keys lane and lane + 32
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    const float* k_lo = sK + lane * L::kStride;
    const float* k_hi = sK + (lane + 32) * L::kStride;
    const float* v_lo = sV + lane * L::kStride;
    const float* v_hi = sV + (lane + 32) * L::kStride;
    const float* qw = sQ + warp * kRows * D;
    const float* ow = sO + warp * kRows * D;
#pragma unroll 1
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(k_lo + d);
      const float4 c = *reinterpret_cast<const float4*>(k_hi + d);
      const float4 e = *reinterpret_cast<const float4*>(v_lo + d);
      const float4 f = *reinterpret_cast<const float4*>(v_hi + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(qw + i * D + d);
        const float4 y = *reinterpret_cast<const float4*>(ow + i * D + d);
        s[i][0] = dot4(x, a, s[i][0]);
        s[i][1] = dot4(x, c, s[i][1]);
        dp[i][0] = dot4(y, e, dp[i][0]);
        dp[i][1] = dot4(y, f, dp[i][1]);
      }
    }

    // dS = P * (dO v^T - delta) * scale into this warp's strip
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp * kRows + i, t = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + lane + 32 * j;
        const bool visible = t < T_ && key < S && !(causal && key > q_offset + t);
        const float p = visible ? expf(s[i][j] - sL[r]) : 0.f;
        sDS[i * kTile + lane + 32 * j] = p * (dp[i][j] - sD[r]) * scale;
      }
    }
    __syncwarp();

    // acc += dS k: lane owns output dimensions lane + 32 * dd
#pragma unroll 1
    for (int j = 0; j < kTile; j += 4) {
      float kk[4][DL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) kk[u][dd] = sK[(j + u) * L::kStride + lane + 32 * dd];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 g = *reinterpret_cast<const float4*>(sDS + i * kTile + j);
#pragma unroll
        for (int dd = 0; dd < DL; ++dd)
          acc[i][dd] = fmaf(g.x, kk[0][dd], fmaf(g.y, kk[1][dd],
                       fmaf(g.z, kk[2][dd], fmaf(g.w, kk[3][dd], acc[i][dd]))));
      }
    }
    __syncwarp();  // sDS is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = row0 + i;
    if (t >= T_) continue;
    T* row = dq + (((long long)b * T_ + t) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) row[lane + 32 * dd] = ds::from_float<T>(acc[i][dd]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int T_, int S,
                     long long q_sb, long long q_st, long long q_sh,
                     long long k_sb, long long k_st, long long k_sh,
                     long long v_sb, long long v_st, long long v_sh,
                     long long d_sb, long long d_st, long long d_sh,
                     float scale, int causal) {
  using L = DkvLayout<D>;
  constexpr int DL = D / 32;
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
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_offset = S - T_;
  const int key0 = k0 + warp * kRows;  // this warp's first key
  float* sP = smem + L::p + warp * kRows * kTile;
  float* sDS = smem + L::dS + warp * kRows * kTile;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* db = dout + b * d_sb + h * d_sh;
  const float* lb = lse + (long long)bh * T_;
  const float* deb = delta + (long long)bh * T_;
  load_tile<T, D>(sK, D, k + b * k_sb + h * k_sh, k_st, k0, S, 1.f);
  load_tile<T, D>(sV, D, v + b * v_sb + h * v_sh, v_st, k0, S, 1.f);

  float acc_k[kRows][DL], acc_v[kRows][DL];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc_k[i][dd] = acc_v[i][dd] = 0.f;

  const int num_q_tiles = (T_ + kTile - 1) / kTile;
  int first = 0;
  if (causal) {
    // the first query that sees key k0 is t = k0 - q_offset
    const int t0 = k0 - q_offset;
    first = t0 <= 0 ? 0 : t0 / kTile;
  }

  for (int qt = first; qt < num_q_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile is consumed (and sK/sV are written on the first pass)
    load_tile<T, D>(sQ, L::kStride, qb, q_st, q0, T_, scale);
    load_tile<T, D>(sO, L::kStride, db, d_st, q0, T_, 1.f);
    load_rows(sL, lb, q0, T_);
    load_rows(sD, deb, q0, T_);
    __syncthreads();

    // scores and v . dO of this warp's keys against queries lane and lane + 32
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    const float* q_lo = sQ + lane * L::kStride;
    const float* q_hi = sQ + (lane + 32) * L::kStride;
    const float* o_lo = sO + lane * L::kStride;
    const float* o_hi = sO + (lane + 32) * L::kStride;
    const float* kw = sK + warp * kRows * D;
    const float* vw = sV + warp * kRows * D;
#pragma unroll 1
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(q_lo + d);
      const float4 c = *reinterpret_cast<const float4*>(q_hi + d);
      const float4 e = *reinterpret_cast<const float4*>(o_lo + d);
      const float4 f = *reinterpret_cast<const float4*>(o_hi + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(kw + i * D + d);
        const float4 y = *reinterpret_cast<const float4*>(vw + i * D + d);
        // q first, as the forward multiplies: fmaf is exact in its product,
        // so the score is the forward's bit for bit
        s[i][0] = dot4(a, x, s[i][0]);
        s[i][1] = dot4(c, x, s[i][1]);
        dp[i][0] = dot4(e, y, dp[i][0]);
        dp[i][1] = dot4(f, y, dp[i][1]);
      }
    }

    // P and P * (dO v^T - delta) into this warp's strips (the scale rides
    // the scaled q tile that multiplies dS below)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int key = key0 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, t = q0 + c;
        const bool visible = t < T_ && key < S && !(causal && key > q_offset + t);
        const float p = visible ? expf(s[i][j] - sL[c]) : 0.f;
        sP[i * kTile + c] = p;
        sDS[i * kTile + c] = p * (dp[i][j] - sD[c]);
      }
    }
    __syncwarp();

    // acc_v += P^T dO, acc_k += dS^T (scale q): lane owns dimensions lane + 32 * dd
#pragma unroll 1
    for (int j = 0; j < kTile; j += 4) {
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
        const float4 p = *reinterpret_cast<const float4*>(sP + i * kTile + j);
        const float4 g = *reinterpret_cast<const float4*>(sDS + i * kTile + j);
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

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = key0 + i;
    if (key >= S) continue;
    const long long off = (((long long)b * S + key) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) {
      dk[off + lane + 32 * dd] = ds::from_float<T>(acc_k[i][dd]);
      dv[off + lane + 32 * dd] = ds::from_float<T>(acc_v[i][dd]);
    }
  }
}

// Strides of one [B, rows, H, D] operand: batch, row, head (elements).
struct Strides {
  long long b, t, h;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, T, S;
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

template <typename T, int D>
cudaError_t launch_delta(const Args& a) {
  const dim3 grid(a.B * a.H, (a.T + kTile - 1) / kTile);
  flash_bwd_delta_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.H, a.T,
      a.os.b, a.os.t, a.os.h, a.dos.b, a.dos.t, a.dos.h);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = DqLayout<D>::bytes;
  cudaError_t err = set_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.T + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.T, a.S,
      a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b, a.vs.t, a.vs.h,
      a.dos.b, a.dos.t, a.dos.h, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = DkvLayout<D>::bytes;
  cudaError_t err = set_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.T, a.S,
      a.qs.b, a.qs.t, a.qs.h, a.ks.b, a.ks.t, a.ks.h, a.vs.b, a.vs.t, a.vs.h,
      a.dos.b, a.dos.t, a.dos.h, a.scale, a.causal);
  return cudaGetLastError();
}

enum Pass { kDelta = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
cudaError_t run_pass(int pass, const Args& a) {
  if (pass == kDelta) return launch_delta<T, D>(a);
  if constexpr (std::is_same<T, float>::value) {  // 16-bit: flash_attention_bwd_tc.cu
    if (pass == kDq) return launch_dq<T, D>(a);
    if (pass == kDkv) return launch_dkv<T, D>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dim(int D, int pass, const Args& a) {
  if (D == 64) return run_pass<T, 64>(pass, a);
  if (D == 96) return run_pass<T, 96>(pass, a);
  if (D == 128) return run_pass<T, 128>(pass, a);
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
// code of the launch (0 on success). q/o/dO are [B, T, H, D] and k/v
// [B, S, H, D], given by element strides (batch, seq, head; the last
// dimension contiguous, rows 16-byte aligned); lse and delta are [B*H, T]
// fp32 contiguous; dq [B, T, H, D] and dk/dv [B, S, H, D] are contiguous in
// the input dtype.

// delta = rowsum(dO * O) (the counterpart of _bwd_delta_kernel).
extern "C" int ds_flash_attention_bwd_delta(const void* o, const void* dout, float* delta,
                                            int B, int H, int T, int D, int dtype,
                                            long long o_sb, long long o_st, long long o_sh,
                                            long long d_sb, long long d_st, long long d_sh,
                                            void* stream) {
  Args a{};
  a.o = o;
  a.dout = dout;
  a.delta = delta;
  a.B = B;
  a.H = H;
  a.T = T;
  a.os = {o_sb, o_st, o_sh};
  a.dos = {d_sb, d_st, d_sh};
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, kDelta, a);
}

// dq (the counterpart of _bwd_dq_kernel), fp32 inputs.
extern "C" int ds_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse, const float* delta,
                                         void* dq, int B, int H, int T, int S, int D, int dtype,
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
  a.delta = const_cast<float*>(delta);
  a.dq = dq;
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
  return dispatch(dtype, D, kDq, a);
}

// dk and dv (the counterpart of _bwd_dkv_kernel), fp32 inputs.
extern "C" int ds_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse, const float* delta,
                                          void* dk, void* dv, int B, int H, int T, int S, int D,
                                          int dtype,
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
  a.delta = const_cast<float*>(delta);
  a.dk = dk;
  a.dv = dv;
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
  return dispatch(dtype, D, kDkv, a);
}
