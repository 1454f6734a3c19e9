// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention.py:
// _fwd / _fwd_kernel (the forward of flash_attention). Same function: for
// each (batch, head), o = softmax(scale * q k^T + causal mask) v with the mask
// aligned bottom-right (query row t sits at absolute position t + S - T), fp32
// online-softmax state, l == 0 -> l_safe = 1, and the fp32 logsumexp of every
// row stored as [B*H, T] for the backward pass.
//
// Work split: one thread block (4 warps) per (b*h, 64-row q tile). The block
// stages its q tile once, then loops over 64-row k/v tiles staged in shared
// memory as fp32. Each warp owns 16 query rows and keeps their (m, l, acc)
// state in registers: lane j scores keys j and j+32 of the tile for all 16
// rows, the row max and sum come from warp shuffles, the probabilities go
// through a per-warp shared-memory strip, and lane j accumulates output
// dimensions j, j+32, ... of P V. Causal runs stop at the last k tile that
// intersects the tile's lower triangle (the pl.when skip of _fwd_kernel).
// Inputs are read through their strides (last dimension contiguous), so the
// q/k/v views of the fused qkv projection need no copy.
//
// Numerics match stochastic_mode=False: every operand is widened to fp32 and
// both products accumulate in fp32 on the CUDA cores (no tensor cores).
//
// What bounds it on the H100: at the GPT-2-125M scoring shape (B4, T=S=512,
// H12, D64, causal) it must do 2 products x 2*D flops for T(T+1)/2 score
// entries per (b, h), about 1.6 GFLOP, and move q, k, v and o once, about
// 25 MB in fp32. In fp32 without tensor cores (67 TFLOP/s) that is
// compute-bound at about 24 us; in bf16 the bytes halve and tensor cores
// would make it memory-bound at a few us. This first kernel does the fp32
// arithmetic on the CUDA cores in every dtype and reads q and each k/v tile
// through shared memory, so it is bound by fp32 FMA issue and shared-memory
// bandwidth, well above both bounds in bf16. The fast design (wgmma on bf16
// tiles fed by TMA, warp-specialised) is left to a kernel-redesign PR.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 64;                  // keys per k/v tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;      // query rows per warp

template <int D> struct Layout {
  static constexpr int kStride = D + 4;  // padded k rows: lane-per-key float4 reads hit distinct banks
  static constexpr int q = 0;                          // [kBQ][D], pre-scaled
  static constexpr int k = q + kBQ * D;                // [kBK][kStride]
  static constexpr int v = k + kBK * kStride;          // [kBK][D]
  static constexpr int p = v + kBK * D;                // [kWarps][kRows][kBK]
  static constexpr int floats = p + kWarps * kRows * kBK;
  static constexpr size_t bytes = floats * sizeof(float);
};

// Copy rows [r0, r0 + rows) of one head (row stride `st` elements) into a
// shared fp32 tile with row stride `dst_stride`, scaled; rows at or past `n`
// are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* src,
                                          long long st, int r0, int n, float scale) {
  constexpr int V = ds::Vec16<T>::n;
  constexpr int chunks = D / V;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBQ * chunks; c += kThreads) {
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int T_, int S,
                 long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_st, long long k_sh,
                 long long v_sb, long long v_st, long long v_sh,
                 float scale, int causal) {
  using L = Layout<D>;
  constexpr int DL = D / 32;  // output dimensions per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem + L::q;
  float* sK = smem + L::k;
  float* sV = smem + L::v;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_offset = S - T_;  // bottom-right causal alignment
  const int row0 = q0 + warp * kRows;
  float* sP = smem + L::p + warp * kRows * kBK;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  load_tile<T, D>(sQ, D, qb, q_st, q0, T_, scale);

  float m[kRows], l[kRows], acc[kRows][DL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = ds::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[i][dd] = 0.f;
  }

  int num_k_tiles = (S + kBK - 1) / kBK;
  if (causal) {
    // the tile's last real row sees keys up to q_offset + that row
    const int last_key = q_offset + min(q0 + kBQ, T_) - 1;
    num_k_tiles = last_key < 0 ? 0 : min(num_k_tiles, last_key / kBK + 1);
  }

  for (int kt = 0; kt < num_k_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and sQ is written on the first pass)
    load_tile<T, D>(sK, L::kStride, kb, k_st, k0, S, 1.f);
    load_tile<T, D>(sV, D, vb, v_st, k0, S, 1.f);
    __syncthreads();

    // scores of this warp's rows against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k_lo = sK + lane * L::kStride;
    const float* k_hi = sK + (lane + 32) * L::kStride;
    const float* qw = sQ + warp * kRows * D;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(k_lo + d);
      const float4 c = *reinterpret_cast<const float4*>(k_hi + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(qw + i * D + d);
        s[i][0] = fmaf(x.x, a.x, fmaf(x.y, a.y, fmaf(x.z, a.z, fmaf(x.w, a.w, s[i][0]))));
        s[i][1] = fmaf(x.x, c.x, fmaf(x.y, c.y, fmaf(x.z, c.z, fmaf(x.w, c.w, s[i][1]))));
      }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = row0 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + lane + 32 * j;
        if (key >= S || (causal && key > q_offset + t)) s[i][j] = ds::kNegInf;
      }
      const float m_new = fmaxf(m[i], ds::warp_max(fmaxf(s[i][0], s[i][1])));
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      l[i] = alpha * l[i] + ds::warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) acc[i][dd] *= alpha;
      sP[i * kBK + lane] = p0;
      sP[i * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V: lane owns output dimensions lane + 32 * dd
#pragma unroll 1
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][DL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) vv[u][dd] = sV[(j + u) * D + lane + 32 * dd];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(sP + i * kBK + j);
#pragma unroll
        for (int dd = 0; dd < DL; ++dd)
          acc[i][dd] = fmaf(p.x, vv[0][dd], fmaf(p.y, vv[1][dd],
                       fmaf(p.z, vv[2][dd], fmaf(p.w, vv[3][dd], acc[i][dd]))));
      }
    }
    __syncwarp();  // sP is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = row0 + i;
    if (t >= T_) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (((long long)b * T_ + t) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) orow[lane + 32 * dd] = ds::from_float<T>(acc[i][dd] / l_safe);
    if (lane == 0) lse[(long long)bh * T_ + t] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int H, int T_, int S,
                   long long q_sb, long long q_st, long long q_sh,
                   long long k_sb, long long k_st, long long k_sh,
                   long long v_sb, long long v_st, long long v_sh,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T_ + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, T_, S, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
      v_sb, v_st, v_sh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int T_, int S,
                         long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh,
                         float scale, int causal, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, lse, B, H, T_, S, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                         v_sb, v_st, v_sh, scale, causal, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, lse, B, H, T_, S, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                          v_sb, v_st, v_sh, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, T, H, D], k/v [B, S, H, D] given by element strides (batch, seq, head;
// the last dimension contiguous, rows 16-byte aligned); o [B, T, H, D]
// contiguous in the input dtype; lse [B*H, T] fp32. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int ds_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int B, int H, int T, int S, int D, int dtype,
                                      long long q_sb, long long q_st, long long q_sh,
                                      long long k_sb, long long k_st, long long k_sh,
                                      long long v_sb, long long v_st, long long v_sh,
                                      float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ds::kF32:
      return dispatch_dim<float>(D, q, k, v, o, lse, B, H, T, S, q_sb, q_st, q_sh, k_sb, k_st,
                                 k_sh, v_sb, v_st, v_sh, scale, causal, st);
    case ds::kBF16:
      return dispatch_dim<__nv_bfloat16>(D, q, k, v, o, lse, B, H, T, S, q_sb, q_st, q_sh,
                                         k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal, st);
    case ds::kF16:
      return dispatch_dim<__half>(D, q, k, v, o, lse, B, H, T, S, q_sb, q_st, q_sh, k_sb, k_st,
                                  k_sh, v_sb, v_st, v_sh, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}
