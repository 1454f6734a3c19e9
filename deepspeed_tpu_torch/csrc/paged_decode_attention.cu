// Single-token decode attention through a block table over a shared KV page
// pool, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py:
// paged_decode_attention, both of its bodies behind the one pallas_call:
// _paged_kernel (dense pools) and _paged_q_kernel (int8 pools, and
// nibble-packed int4 pools, with one fp32 scale per (head, page)). Same
// function: one query token per batch row attends over positions
// [0, lengths[b]) of its cache, position p living in pool page
// tables[b, p / page_size] at offset p % page_size; an fp32 online softmax;
// positions at or past the length are never read (a page wholly past it is
// skipped, as the pl.when(ki * page_size < cur) guard skips it); l == 0 ->
// l_safe = 1, so a row of length 0 gives zeros; the output is in q's dtype.
// A quantized K/V row is dequantized in fp32 against its page's scale on its
// way into the dot products (k = k_q * k_scales[h, page]); an int4 byte j
// holds dim j in its low nibble and dim j + Dh/2 in its high one
// (ops/cuda/int8_matmul.py pack_int4), sign-extended by xor-sub.
//
// Work split, as B3's (decode_attention.cu): one thread block (4 warps) per
// (b, h) over the per-layer pool [H, P, page_size, Dq] (Dq = Dh, or Dh/2 for
// int4). The block widens the scaled query to fp32 in shared memory; warp w
// walks the 32-position tiles w, w + 4, ... below the row's length. In a
// tile, lane j resolves its position's page from the table (any page_size
// works: a tile may span pages, or lie inside one), scores it against its
// key row, and the tile max and sum come from warp shuffles. The warp then
// accumulates P V with lane j owning output dims j, j + 32, ...; each
// position's row address and value scale are broadcast from the lane that
// resolved it. Each warp keeps its own fp32 (m, l, acc); the four states are
// merged in shared memory at the end.
//
// What bounds it on the H100: bytes. It must read the K and V rows below
// each length at the pool's element size (half a byte for int4), the scales
// and table entries of those pages, and q, and write o; its flops (4 * Dh per
// position) are far below any peak. At the serving shape (8 slots, H12,
// Dh 64, lengths up to 512) that is at most 12.6 MB in bf16, about 3.8 us at
// 3.35 TB/s, while the grid has only B * H = 96 blocks for 132 SMs and each
// block walks its positions serially: like B3, the kernel is bound by
// per-block latency, not by bytes. Splitting each (b, h) over its pages
// (split-K) with a merge pass is the redesign, left to a later PR.

#include <cstdint>

#include "common.cuh"
#include "paged_kv.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // positions per warp tile: one per lane

// q . k for one key row (element offset `row` into the pool), k dequantized
// against `ks` for the quantized layouts; sq is the scaled fp32 query.
template <typename T, int D, int MODE>
__device__ __forceinline__ float key_dot(const float* __restrict__ sq, const void* pool,
                                         long long row, float ks) {
  float dot = 0.f;
  if constexpr (MODE == kDense) {
    constexpr int V = ds::Vec16<T>::n;
    const T* kr = static_cast<const T*>(pool) + row * D;
#pragma unroll
    for (int d = 0; d < D; d += V) {
      float x[V];
      ds::load16<T>(kr + d, x);
#pragma unroll
      for (int u = 0; u < V; ++u) dot = fmaf(sq[d + u], x[u], dot);
    }
  } else if constexpr (MODE == kInt8) {
    const int8_t* kr = static_cast<const int8_t*>(pool) + row * D;
#pragma unroll
    for (int d = 0; d < D; d += 16) {
      int x[16];
      load16_s8(kr + d, x);
#pragma unroll
      for (int u = 0; u < 16; ++u) dot = fmaf(sq[d + u], static_cast<float>(x[u]) * ks, dot);
    }
  } else {
    constexpr int Half = D / 2;
    const int8_t* kr = static_cast<const int8_t*>(pool) + row * Half;
#pragma unroll
    for (int c = 0; c < Half; c += 16) {
      int x[16];
      load16_s8(kr + c, x);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        dot = fmaf(sq[c + u], static_cast<float>(low_nibble(x[u])) * ks, dot);
        dot = fmaf(sq[Half + c + u], static_cast<float>(high_nibble(x[u])) * ks, dot);
      }
    }
  }
  return dot;
}

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, const void* __restrict__ k_pages,
             const void* __restrict__ v_pages, const float* __restrict__ k_scales,
             const float* __restrict__ v_scales, T* __restrict__ o,
             const int* __restrict__ lengths, const int* __restrict__ tables, int H, int P,
             int ps, int pps, long long q_sb, long long q_sh, float scale) {
  constexpr int DL = D / 32;  // output dimensions per lane
  __shared__ __align__(16) float sq[D];
  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ float sacc[kWarps][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(lengths[b], 0), pps * ps);
  const int* tbl = tables + (long long)b * pps;

  const T* qb = q + b * q_sb + h * q_sh;
  for (int d = threadIdx.x; d < D; d += kThreads) sq[d] = ds::to_float(qb[d]) * scale;
  __syncthreads();

  float m = ds::kNegInf, l = 0.f, acc[DL];
#pragma unroll
  for (int dd = 0; dd < DL; ++dd) acc[dd] = 0.f;

  for (int t0 = warp * kTile; t0 < len; t0 += kWarps * kTile) {
    const int pos = t0 + lane;
    float s = ds::kNegInf, vs = 1.f;
    long long row = 0;  // element row of this lane's position in the head's pool
    if (pos < len) {
      const int page = tbl[pos / ps];
      row = ((long long)h * P + page) * ps + pos % ps;
      float ks = 1.f;
      if constexpr (MODE != kDense) {
        ks = k_scales[(long long)h * P + page];
        vs = v_scales[(long long)h * P + page];
      }
      s = key_dot<T, D, MODE>(sq, k_pages, row, ks);
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
      const long long rj = __shfl_sync(0xffffffffu, row, j);
      if constexpr (MODE == kDense) {
        const T* vr = static_cast<const T*>(v_pages) + rj * D + lane;
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) acc[dd] = fmaf(pj, ds::to_float(vr[32 * dd]), acc[dd]);
      } else if constexpr (MODE == kInt8) {
        const float vsj = __shfl_sync(0xffffffffu, vs, j);
        const int8_t* vr = static_cast<const int8_t*>(v_pages) + rj * D + lane;
#pragma unroll
        for (int dd = 0; dd < DL; ++dd)
          acc[dd] = fmaf(pj, static_cast<float>(vr[32 * dd]) * vsj, acc[dd]);
      } else {
        // output dim d = lane + 32 * dd below Dh/2 is the low nibble of byte
        // d, a dim at or past Dh/2 the high nibble of byte d - Dh/2 (at Dh 96
        // a lane's second dim is either, so the test is per dim)
        const float vsj = __shfl_sync(0xffffffffu, vs, j);
        const int8_t* vr = static_cast<const int8_t*>(v_pages) + rj * (D / 2);
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) {
          const int d = lane + 32 * dd;
          const int x = d < D / 2 ? low_nibble(vr[d]) : high_nibble(vr[d - D / 2]);
          acc[dd] = fmaf(pj, static_cast<float>(x) * vsj, acc[dd]);
        }
      }
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

struct Args {
  const void *q, *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  void* o;
  const int *lengths, *tables;
  int B, H, P, ps, pps;
  long long q_sb, q_sh;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int MODE>
cudaError_t launch(const Args& a) {
  paged_kernel<T, D, MODE><<<a.B * a.H, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), a.k_pages, a.v_pages, a.k_scales, a.v_scales,
      static_cast<T*>(a.o), a.lengths, a.tables, a.H, a.P, a.ps, a.pps, a.q_sb, a.q_sh,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_mode(int kv_mode, const Args& a) {
  switch (kv_mode) {
    case kDense: return launch<T, D, kDense>(a);
    case kInt8: return launch<T, D, kInt8>(a);
    case kInt4: return launch<T, D, kInt4>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int D, int kv_mode, const Args& a) {
  if (D == 64) return dispatch_mode<T, 64>(kv_mode, a);
  if (D == 96) return dispatch_mode<T, 96>(kv_mode, a);
  if (D == 128) return dispatch_mode<T, 128>(kv_mode, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, 1, H, D] given by element strides (batch, head; last dimension
// contiguous) in `dtype`; k/v pools one layer's [H, P, ps, Dq], contiguous
// and 16-byte aligned: in q's dtype for kv_mode 0 (dense, Dq = D), int8 for
// kv_mode 8 (Dq = D) and 4 (nibble-packed, Dq = D / 2), with fp32 [H, P]
// k/v scales for the two quantized modes (null for dense); o [B, 1, H, D]
// contiguous in q's dtype; lengths a device int32 [B] vector; tables a device
// int32 [B, pps] matrix of valid page ids. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int ds_paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                         const float* k_scales, const float* v_scales, void* o,
                                         const int* lengths, const int* tables, int B, int H,
                                         int P, int ps, int pps, int D, int dtype, int kv_mode,
                                         long long q_sb, long long q_sh, float scale,
                                         void* stream) {
  const Args a{q, k_pages, v_pages, k_scales, v_scales, o, lengths, tables, B, H, P, ps, pps,
               q_sb, q_sh, scale, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case ds::kF32: return dispatch_dim<float>(D, kv_mode, a);
    case ds::kBF16: return dispatch_dim<__nv_bfloat16>(D, kv_mode, a);
    case ds::kF16: return dispatch_dim<__half>(D, kv_mode, a);
    default: return cudaErrorInvalidValue;
  }
}
