// Blocksparse-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/blocksparse_attention.py:
// _fwd / _fwd_kernel (the forward of blocksparse_attention). Same function:
// for each (batch, head), o = softmax(scale * q k^T + mask) v where the mask
// keeps only the (q-block, k-block) pairs of a static [H, T/block, T/block]
// layout and, under `causal`, keys at or before the query (T == S, aligned
// top-left as in the reference); fp32 online-softmax state, l == 0 -> l_safe
// = 1 (a row with no active block gives o = 0 and lse = -1e30), and the fp32
// logsumexp of every row stored as [B*H, T] for the backward pass. The
// reference's 128-lane broadcast of lse is a TPU layout detail, not kept.
//
// The layout reaches the kernel as the host-built index tables of
// ops/cuda/blocksparse_attention.py layout_tables: kidx [H, nQ, A] (the
// active k-blocks of each q-block, ascending) and kcnt [H, nQ]. Padding
// entries past kcnt are never read. Head h = bh % H picks the table, so
// layouts that differ per head work.
//
// Work split: one thread block (4 warps) per (b*h, q tile) with a q tile of
// TILE = min(block, 64) rows (a block of 128 is two tiles), looping over the
// kcnt active k-blocks of its q-block and, inside each, over TILE-key tiles
// staged in shared memory as fp32. Each warp owns TILE/4 query rows and keeps
// their (m, l, acc) state in registers: lane j scores keys j (and j+32 when
// TILE is 64), the row max and sum come from warp shuffles, the
// probabilities go through a per-warp shared-memory strip, and lane j
// accumulates output dimensions j, j+32, ... of P V. Under `causal` a k tile
// wholly above the q tile's last row is skipped: every such score is masked
// to -1e30 in the reference and adds exactly 0 there (the k-blocks are
// ascending, the diagonal block is always active, so a row's max is finite
// before any such tile), which is B1's causal skip applied to the layout.
// Inputs are read through their strides (last dimension contiguous), so the
// q/k/v views of the fused qkv projection need no copy.
//
// Numerics: every operand is widened to fp32 and both products accumulate in
// fp32 on the CUDA cores (no tensor cores).
//
// Which inputs it serves (ops/cuda/blocksparse_attention.py bs_route): fp32
// at every block, and bf16 / fp16 at blocks of 16 and 32; bf16 / fp16 at
// blocks of 64 and 128 run csrc/blocksparse_attention_fwd_tc.cu, and this
// file has no 16-bit instance of its 64-row tile.
//
// What bounds it on the H100: at the sparse GPT-2-125M's fp32 shape (B2,
// T1024, H12, D64, Fixed layout of 4 local and 1 global block of 128,
// unidirectional: 24 of a head's 36 causal blocks active) about 7.9M visible
// (query, key) pairs; two products of 2*D flops each is 2.0 GFLOP, 0.030 ms
// in fp32 on the CUDA cores (67 TFLOP/s, data sheet). This
// kernel does the fp32 arithmetic with one lane a key and reads q and each
// k/v tile through shared memory, so it is bound by fp32 FMA issue and
// shared-memory bandwidth. A 3xTF32 design on the tensor cores, as the fp32
// flash kernels have, is queued (ROADMAP.md).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int D, int TILE> struct Layout {
  static constexpr int kRows = TILE / kWarps;          // query rows per warp
  static constexpr int kStride = D + 4;  // padded k rows: lane-per-key float4 reads hit distinct banks
  static constexpr int q = 0;                          // [TILE][D], pre-scaled
  static constexpr int k = q + TILE * D;               // [TILE][kStride]
  static constexpr int v = k + TILE * kStride;         // [TILE][D]
  static constexpr int p = v + TILE * D;               // [kWarps][kRows][TILE]
  static constexpr int floats = p + kWarps * kRows * TILE;
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

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads)
blocksparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, float* __restrict__ lse,
                       const int* __restrict__ kidx, const int* __restrict__ kcnt,
                       int H, int T_, int block, int A,
                       long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       float scale, int causal) {
  using L = Layout<D, TILE>;
  constexpr int kRows = L::kRows;
  constexpr int DL = D / 32;              // output dimensions per lane
  constexpr int NJ = TILE > 32 ? 2 : 1;   // keys per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem + L::q;
  float* sK = smem + L::k;
  float* sV = smem + L::v;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * TILE;
  const int qi = q0 / block;
  const int nQ = T_ / block;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * kRows;
  float* sP = smem + L::p + warp * kRows * TILE;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  load_tile<T, D, TILE>(sQ, D, q + b * q_sb + h * q_sh, q_st, q0, scale);

  float m[kRows], l[kRows], acc[kRows][DL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = ds::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[i][dd] = 0.f;
  }

  const int cnt = kcnt[h * nQ + qi];
  const int* idx = kidx + (long long)(h * nQ + qi) * A;
  const int subs = block / TILE;
  for (int a = 0; a < cnt; ++a) {
    const int ki = idx[a];
    for (int sub = 0; sub < subs; ++sub) {
      const int k0 = ki * block + sub * TILE;
      if (causal && k0 > q0 + TILE - 1) continue;  // wholly above the tile's last row
      __syncthreads();  // the previous tile is consumed (and sQ is written on the first pass)
      load_tile<T, D, TILE>(sK, L::kStride, kb, k_st, k0, 1.f);
      load_tile<T, D, TILE>(sV, D, vb, v_st, k0, 1.f);
      __syncthreads();

      // scores of this warp's rows against keys lane (and lane + 32)
      float s[kRows][NJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
      const float* k_row[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) k_row[j] = sK + min(lane + 32 * j, TILE - 1) * L::kStride;
      const float* qw = sQ + warp * kRows * D;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 kk[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) kk[j] = *reinterpret_cast<const float4*>(k_row[j] + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(qw + i * D + d);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            s[i][j] = fmaf(x.x, kk[j].x, fmaf(x.y, kk[j].y,
                      fmaf(x.z, kk[j].z, fmaf(x.w, kk[j].w, s[i][j]))));
        }
      }

      // mask, then the online-softmax update of each row
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = row0 + i;
        bool vis[NJ];
        float mx = ds::kNegInf;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = lane + 32 * j;
          vis[j] = c < TILE && !(causal && k0 + c > t);
          if (!vis[j]) s[i][j] = ds::kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_new = fmaxf(m[i], ds::warp_max(mx));
        const float alpha = expf(m[i] - m_new);
        float p[NJ], psum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          p[j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;
          psum += p[j];
        }
        l[i] = alpha * l[i] + ds::warp_sum(psum);
        m[i] = m_new;
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) acc[i][dd] *= alpha;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (lane + 32 * j < TILE) sP[i * TILE + lane + 32 * j] = p[j];
      }
      __syncwarp();

      // acc += P V: lane owns output dimensions lane + 32 * dd
#pragma unroll 1
      for (int j = 0; j < TILE; j += 4) {
        float vv[4][DL];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int dd = 0; dd < DL; ++dd) vv[u][dd] = sV[(j + u) * D + lane + 32 * dd];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 pp = *reinterpret_cast<const float4*>(sP + i * TILE + j);
#pragma unroll
          for (int dd = 0; dd < DL; ++dd)
            acc[i][dd] = fmaf(pp.x, vv[0][dd], fmaf(pp.y, vv[1][dd],
                         fmaf(pp.z, vv[2][dd], fmaf(pp.w, vv[3][dd], acc[i][dd]))));
        }
      }
      __syncwarp();  // sP is rewritten by the next tile
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = row0 + i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (((long long)b * T_ + t) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) orow[lane + 32 * dd] = ds::from_float<T>(acc[i][dd] / l_safe);
    if (lane == 0) lse[(long long)bh * T_ + t] = m[i] + logf(l_safe);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const int *kidx, *kcnt;
  int B, H, T, block, A;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, int TILE>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = Layout<D, TILE>::bytes;
  cudaError_t err = cudaFuncSetAttribute(blocksparse_fwd_kernel<T, D, TILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, a.T / TILE);
  blocksparse_fwd_kernel<T, D, TILE><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.kidx, a.kcnt, a.H, a.T, a.block, a.A,
      a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_tile(const Args& a) {
  switch (a.block) {
    case 16: return launch<T, D, 16>(a);
    case 32: return launch<T, D, 32>(a);
    case 64:
    case 128:  // bf16 / fp16 at these blocks run the tensor-core kernel (the _tc file)
      if constexpr (std::is_same<T, float>::value) return launch<T, D, 64>(a);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int D, const Args& a) {
  if (D == 64) return dispatch_tile<T, 64>(a);
  if (D == 96) return dispatch_tile<T, 96>(a);
  if (D == 128) return dispatch_tile<T, 128>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q/k/v [B, T, H, D] given by element strides (batch, seq, head; the last
// dimension contiguous, rows 16-byte aligned); o [B, T, H, D] contiguous in
// the input dtype; lse [B*H, T] fp32; kidx [H, T/block, A] and kcnt
// [H, T/block] int32 contiguous on the device. T is a multiple of `block`
// (16, 32, 64 or 128). Returns the CUDA error code of the launch (0 on
// success).
extern "C" int ds_blocksparse_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                            float* lse, const int* kidx, const int* kcnt,
                                            int B, int H, int T, int D, int dtype, int block,
                                            int A,
                                            long long q_sb, long long q_st, long long q_sh,
                                            long long k_sb, long long k_st, long long k_sh,
                                            long long v_sb, long long v_st, long long v_sh,
                                            float scale, int causal, void* stream) {
  Args a{q, k, v, o, lse, kidx, kcnt, B, H, T, block, A,
         q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
         scale, causal, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case ds::kF32: return dispatch_dim<float>(D, a);
    case ds::kBF16: return dispatch_dim<__nv_bfloat16>(D, a);
    case ds::kF16: return dispatch_dim<__half>(D, a);
    default: return cudaErrorInvalidValue;
  }
}
