// Single-token decode attention over a contiguous KV cache for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py:
// decode_attention / _decode_kernel. Same function: one query token per batch
// row attends over cache positions [0, lengths[b]) of a [B, H, S, Dh] cache
// with an fp32 online softmax; positions at or past the length are never read
// (the pl.when(ki * block_k < cur) skip), l == 0 -> l_safe = 1, and the output
// is in q's dtype. A scalar length is broadcast over the batch, as
// _as_lengths does.
//
// Work split: one thread block (4 warps) per (b, h). The block widens the
// scaled query to fp32 in shared memory; warp w walks the 32-position tiles
// w, w + 4, ... below the row's length. In a tile, lane j scores position
// t0 + j with 16-byte loads of its key row, the tile max and sum come from
// warp shuffles, and the warp accumulates P V with lane j owning output
// dimensions j, j + 32, ... (coalesced value-row reads, probabilities
// broadcast by shuffle). Each warp keeps its own fp32 (m, l, acc); the four
// states are merged in shared memory at the end.
//
// What bounds it on the H100: the bytes of K and V it must read,
// 2 * B * H * len * Dh * sizeof(dtype); its flops (4 * Dh per position) are
// far below the fp32 rate. At GPT-2-125M decode shapes (B4, H12, len <= 576,
// Dh 64) that is at most about 3.5 MB in bf16, about 1 us at 3.35 TB/s, while
// the grid has only B * H = 48 blocks for 132 SMs and each block walks its
// positions serially: the kernel is bound by launch overhead and per-block
// latency, not by bytes. The fix, splitting each (b, h) over the cache
// (split-K) with a second merge pass, is left to a later PR.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // positions per warp tile: one per lane

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, const int* __restrict__ lengths, int scalar_len, int H,
              int S, long long q_sb, long long q_sh, float scale) {
  constexpr int DL = D / 32;           // output dimensions per lane
  constexpr int V = ds::Vec16<T>::n;   // elements per 16-byte load
  __shared__ __align__(16) float sq[D];
  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ float sacc[kWarps][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int len = lengths != nullptr ? lengths[b] : scalar_len;
  len = min(max(len, 0), S);

  const T* qb = q + b * q_sb + h * q_sh;
  for (int d = threadIdx.x; d < D; d += kThreads) sq[d] = ds::to_float(qb[d]) * scale;
  __syncthreads();

  const T* kb = k + (long long)bh * S * D;
  const T* vb = v + (long long)bh * S * D;
  float m = ds::kNegInf, l = 0.f, acc[DL];
#pragma unroll
  for (int dd = 0; dd < DL; ++dd) acc[dd] = 0.f;

  for (int t0 = warp * kTile; t0 < len; t0 += kWarps * kTile) {
    const int pos = t0 + lane;
    float s = ds::kNegInf;
    if (pos < len) {
      const T* kr = kb + (long long)pos * D;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += V) {
        float x[V];
        ds::load16<T>(kr + d, x);
#pragma unroll
        for (int u = 0; u < V; ++u) dot = fmaf(sq[d + u], x[u], dot);
      }
      s = dot;
    }
    // t0 < len, so lane 0's position is valid and m_new is finite
    const float m_new = fmaxf(m, ds::warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = alpha * l + ds::warp_sum(p);
    m = m_new;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[dd] *= alpha;
    const int n = min(kTile, len - t0);
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const T* vr = vb + (long long)(t0 + j) * D + lane;
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) acc[dd] = fmaf(pj, ds::to_float(vr[32 * dd]), acc[dd]);
    }
  }

  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
#pragma unroll
  for (int dd = 0; dd < DL; ++dd) sacc[warp][lane + 32 * dd] = acc[dd];
  __syncthreads();

  float m_all = ds::kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm[w]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float l_all = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm[w] - m_all);  // 0 for a warp that saw no position
      l_all = fmaf(sl[w], f, l_all);
      a = fmaf(sacc[w][d], f, a);
    }
    const float l_safe = l_all == 0.f ? 1.f : l_all;
    o[(long long)bh * D + d] = ds::from_float<T>(a / l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* lengths,
                   int scalar_len, int B, int H, int S, long long q_sb, long long q_sh,
                   float scale, cudaStream_t stream) {
  decode_kernel<T, D><<<B * H, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lengths, scalar_len, H, S, q_sb, q_sh, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, void* o,
                         const int* lengths, int scalar_len, int B, int H, int S,
                         long long q_sb, long long q_sh, float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, lengths, scalar_len, B, H, S, q_sb, q_sh, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, lengths, scalar_len, B, H, S, q_sb, q_sh, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, 1, H, Dh] given by element strides (batch, head; last dimension
// contiguous); k/v cache [B, H, S, Dh] contiguous and 16-byte aligned; o
// [B, 1, H, Dh] contiguous in q's dtype. `lengths` is a device int32 [B]
// vector, or null to use `scalar_len` for every row. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int ds_decode_attention(const void* q, const void* k, const void* v, void* o,
                                   const int* lengths, int scalar_len, int B, int H, int S,
                                   int D, int dtype, long long q_sb, long long q_sh,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ds::kF32:
      return dispatch_dim<float>(D, q, k, v, o, lengths, scalar_len, B, H, S, q_sb, q_sh,
                                 scale, st);
    case ds::kBF16:
      return dispatch_dim<__nv_bfloat16>(D, q, k, v, o, lengths, scalar_len, B, H, S, q_sb,
                                         q_sh, scale, st);
    case ds::kF16:
      return dispatch_dim<__half>(D, q, k, v, o, lengths, scalar_len, B, H, S, q_sb, q_sh,
                                  scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
