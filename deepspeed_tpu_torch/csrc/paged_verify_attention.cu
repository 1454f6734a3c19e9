// Speculative-decoding verify attention through a block table over a shared
// KV page pool, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py:
// paged_verify_attention -> _verify_kernel. Same function: a window of W
// query tokens per batch row; query i sits at absolute position
// lengths[b] + i and attends (1) the pool history, positions
// [0, lengths[b]), position p living in pool page tables[b, p / page_size]
// at offset p % page_size, dense in q's dtype or int8 / nibble-packed int4
// with one fp32 scale per (head, page), dequantized exactly as B4 does
// (paged_decode_attention.cu, layouts in paged_kv.cuh); and (2) the dense
// window keys and values win_k / win_v at window positions 0..i (causal
// within the window). The window never lives in the pool here. An fp32 online
// softmax over the pool tiles and then the window tile, l == 0 -> l_safe = 1,
// the output in q's dtype. Like the Pallas kernel, every window position is
// attended whatever the table's capacity (the plain version drops window
// positions at or past pages_per_seq * page_size; those outputs are never
// committed).
//
// Work split: one thread block (4 warps) per (b, h). The W scaled queries
// sit in shared memory as fp32. The block walks the history in tiles of 32
// positions: each tile's K and V rows are staged in shared memory once,
// dequantized to fp32 (16-byte loads; each thread resolves its row's page
// from the table, so any page size works), and scored by all W queries, so a
// pool row is read once per (b, h) however wide the window -- the point of
// one verify call over W calls of B4. Scores: warp w takes window rows w,
// w + 4, ..., lane j tile position j (K rows padded to D + 1 floats, so the
// lanes hit distinct banks); the row max and sum come from warp shuffles and
// each row's (m, l) lives in shared memory. P V: thread t owns output dim
// t % D of window rows t / D, t / D + 128 / D, ..., its fp32 accumulators in
// registers. The window tile (W <= 17 rows, read through its strides) is
// one more tile with the causal mask.
//
// What bounds it on the H100: bytes. It must read the K and V rows below
// each length at the pool's element size, the scales and table entries of
// their pages, q and the window, and write o; its flops (4 * Dh * W per
// position) are far below any peak. At the serving shape (8 slots, H12, Dh
// 64, lengths up to 512, W 5) that is at most ~12.6 MB in bf16, ~3.8 us at
// 3.35 TB/s, while the grid has only B * H = 96 blocks for 132 SMs, each
// walking its tiles serially with four barriers a tile: like B4 it is bound
// by per-block latency, not bytes. Split-K over pages and tensor-core
// products wait for the kernel-redesign queue.

#include <cstdint>

#include "common.cuh"
#include "paged_kv.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // pool positions per tile
constexpr int kMaxW = 17;  // the widest window: spec_k 16 + the verified token

// Stage pool positions t0 .. t0 + n - 1 of head h into dst [kTile][D + 1] as
// fp32, dequantized against their pages' scales for the quantized layouts.
template <typename T, int D, int MODE>
__device__ __forceinline__ void stage_pool_tile(float* __restrict__ dst, const void* pool,
                                                const float* __restrict__ scales,
                                                const int* __restrict__ tbl, int h, int P,
                                                int ps, int t0, int n) {
  constexpr int kRowBytes = MODE == kDense ? D * int(sizeof(T)) : (MODE == kInt8 ? D : D / 2);
  constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks per pool row
  for (int idx = threadIdx.x; idx < n * kChunks; idx += kThreads) {
    const int j = idx / kChunks, c = idx % kChunks;
    const int pos = t0 + j;
    const int page = tbl[pos / ps];
    const long long row = ((long long)h * P + page) * ps + pos % ps;
    float* out = dst + j * (D + 1);
    if constexpr (MODE == kDense) {
      constexpr int V = ds::Vec16<T>::n;
      float x[V];
      ds::load16<T>(static_cast<const T*>(pool) + row * D + c * V, x);
#pragma unroll
      for (int u = 0; u < V; ++u) out[c * V + u] = x[u];
    } else {
      const float s = scales[(long long)h * P + page];
      int x[16];
      load16_s8(static_cast<const int8_t*>(pool) + row * kRowBytes + c * 16, x);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if constexpr (MODE == kInt8) {
          out[c * 16 + u] = static_cast<float>(x[u]) * s;
        } else {
          out[c * 16 + u] = static_cast<float>(low_nibble(x[u])) * s;
          out[D / 2 + c * 16 + u] = static_cast<float>(high_nibble(x[u])) * s;
        }
      }
    }
  }
}

// Stage the W window rows of one (b, h), row i at win + i * s_w, into dst.
template <typename T, int D>
__device__ __forceinline__ void stage_window(float* __restrict__ dst, const T* __restrict__ win,
                                             long long s_w, int W) {
  for (int idx = threadIdx.x; idx < W * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    dst[j * (D + 1) + d] = ds::to_float(win[j * s_w + d]);
  }
}

struct Strides {  // element strides of q, win_k, win_v [B, W, H, D] (batch, window, head)
  long long q_sb, q_sw, q_sh, k_sb, k_sw, k_sh, v_sb, v_sw, v_sh;
};

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
verify_kernel(const T* __restrict__ q, const T* __restrict__ win_k, const T* __restrict__ win_v,
              const void* __restrict__ k_pages, const void* __restrict__ v_pages,
              const float* __restrict__ k_scales, const float* __restrict__ v_scales,
              T* __restrict__ o, const int* __restrict__ lengths, const int* __restrict__ tables,
              int W, int H, int P, int ps, int pps, Strides st, float scale) {
  constexpr int G = kThreads / D;              // window rows that share an output dim
  constexpr int kRows = (kMaxW + G - 1) / G;   // window rows per thread, at most
  __shared__ float sq[kMaxW][D];
  __shared__ float sk[kTile][D + 1];
  __shared__ float sv[kTile][D + 1];
  __shared__ float sp[kMaxW][kTile];
  __shared__ float sm[kMaxW], sl[kMaxW], sa[kMaxW];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(lengths[b], 0), pps * ps);
  const int* tbl = tables + (long long)b * pps;

  const T* qb = q + b * st.q_sb + h * st.q_sh;
  for (int idx = threadIdx.x; idx < W * D; idx += kThreads) {
    const int w = idx / D, d = idx % D;
    sq[w][d] = ds::to_float(qb[w * st.q_sw + d]) * scale;
  }
  for (int w = threadIdx.x; w < W; w += kThreads) {
    sm[w] = ds::kNegInf;
    sl[w] = 0.f;
  }
  const int d = threadIdx.x % D, r0 = threadIdx.x / D;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  __syncthreads();

  // the pool tiles below len, then the window tile
  for (int t0 = 0;; t0 += kTile) {
    const bool window = t0 >= len;
    const int n = window ? W : min(kTile, len - t0);
    if (window) {
      stage_window<T, D>(&sk[0][0], win_k + b * st.k_sb + h * st.k_sh, st.k_sw, W);
      stage_window<T, D>(&sv[0][0], win_v + b * st.v_sb + h * st.v_sh, st.v_sw, W);
    } else {
      stage_pool_tile<T, D, MODE>(&sk[0][0], k_pages, k_scales, tbl, h, P, ps, t0, n);
      stage_pool_tile<T, D, MODE>(&sv[0][0], v_pages, v_scales, tbl, h, P, ps, t0, n);
    }
    __syncthreads();

    for (int w = warp; w < W; w += kWarps) {
      // the window tile is causal: row w sees window positions 0..w
      const bool valid = lane < n && (!window || lane <= w);
      float s = ds::kNegInf;
      if (valid) {
        float dot = 0.f;
#pragma unroll 16
        for (int k = 0; k < D; ++k) dot = fmaf(sq[w][k], sk[lane][k], dot);
        s = dot;
      }
      // lane 0's position is valid, so m_new is finite
      const float m_old = sm[w];
      const float m_new = fmaxf(m_old, ds::warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float psum = ds::warp_sum(p);
      sp[w][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sa[w] = alpha;
        sl[w] = alpha * sl[w] + psum;
        sm[w] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int w = r0 + i * G;
      if (w < W) {
        float a = acc[i] * sa[w];
        for (int j = 0; j < n; ++j) a = fmaf(sp[w][j], sv[j][d], a);
        acc[i] = a;
      }
    }
    if (window) break;
    __syncthreads();  // the next tile overwrites sk, sv and sp
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int w = r0 + i * G;
    if (w < W) {
      const float l = sl[w];
      const float l_safe = l == 0.f ? 1.f : l;
      o[(((long long)b * W + w) * H + h) * D + d] = ds::from_float<T>(acc[i] / l_safe);
    }
  }
}

struct Args {
  const void *q, *win_k, *win_v, *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  void* o;
  const int *lengths, *tables;
  int B, W, H, P, ps, pps;
  Strides st;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int MODE>
cudaError_t launch(const Args& a) {
  verify_kernel<T, D, MODE><<<a.B * a.H, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.win_k), static_cast<const T*>(a.win_v),
      a.k_pages, a.v_pages, a.k_scales, a.v_scales, static_cast<T*>(a.o), a.lengths, a.tables,
      a.W, a.H, a.P, a.ps, a.pps, a.st, a.scale);
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
  if (D == 128) return dispatch_mode<T, 128>(kv_mode, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, win_k, win_v [B, W, H, D] (1 <= W <= 17) given by element strides
// (batch, window, head; last dimension contiguous), all three in `dtype`;
// k/v pools one layer's [H, P, ps, Dq], contiguous and 16-byte aligned: in
// q's dtype for kv_mode 0 (dense, Dq = D), int8 for kv_mode 8 (Dq = D) and 4
// (nibble-packed, Dq = D / 2), with fp32 [H, P] k/v scales for the two
// quantized modes (null for dense); o [B, W, H, D] contiguous in q's dtype;
// lengths a device int32 [B] vector of pool tokens before the window; tables
// a device int32 [B, pps] matrix of valid page ids. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int ds_paged_verify_attention(
    const void* q, const void* win_k, const void* win_v, const void* k_pages,
    const void* v_pages, const float* k_scales, const float* v_scales, void* o,
    const int* lengths, const int* tables, int B, int W, int H, int P, int ps, int pps, int D,
    int dtype, int kv_mode, long long q_sb, long long q_sw, long long q_sh, long long k_sb,
    long long k_sw, long long k_sh, long long v_sb, long long v_sw, long long v_sh, float scale,
    void* stream) {
  if (W < 1 || W > kMaxW) return cudaErrorInvalidValue;
  const Args a{q, win_k, win_v, k_pages, v_pages, k_scales, v_scales, o, lengths, tables, B, W,
               H, P, ps, pps, Strides{q_sb, q_sw, q_sh, k_sb, k_sw, k_sh, v_sb, v_sw, v_sh},
               scale, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case ds::kF32: return dispatch_dim<float>(D, kv_mode, a);
    case ds::kBF16: return dispatch_dim<__nv_bfloat16>(D, kv_mode, a);
    case ds::kF16: return dispatch_dim<__half>(D, kv_mode, a);
    default: return cudaErrorInvalidValue;
  }
}
