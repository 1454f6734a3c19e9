// Speculative-decoding verify attention through a block table over a shared
// KV page pool, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/decode_attention.py:
// paged_verify_attention -> _verify_kernel. Same function: a window of W
// query tokens per batch row; query i sits at absolute position
// lengths[b] + i and attends (1) the pool history, positions
// [0, lengths[b]), position p living in pool page tables[b, p / page_size]
// at offset p % page_size, dense in q's dtype or int8 / nibble-packed int4
// with one fp32 scale per (head, page) (layouts in paged_kv.cuh); and (2)
// the dense window keys and values win_k / win_v at window positions 0..i
// (causal within the window). The window never lives in the pool here. An
// fp32 online softmax over the pool tiles and the window tile, l == 0 ->
// l_safe = 1, the output in q's dtype. Like the Pallas kernel, every window
// position is attended whatever the table's capacity (the plain version
// drops window positions at or past pages_per_seq * page_size; those outputs
// are never committed).
//
// What bounds it on the H100: bytes. It must read the K and V rows below
// each length at the pool's element size, the scales and table entries of
// their pages, q and the window, and write o; its flops (4 * Dh * W per
// position) are far below any peak. At the serving shape (8 slots, H12, Dh
// 64, lengths up to 512, W 5, bf16) that is at most ~12.6 MB, ~3.8 us at
// 3.35 TB/s. One block per (b, h) walking its pages serially (96 blocks for
// 132 SMs, four barriers a tile) left it bound by one block's latency.
//
// Work split (split-KV, one launch), as B3's (decode_attention.cu): the grid
// is (B * H, n_split), block (bh, s) owning history positions
// [s * span, (s + 1) * span), n_split and span chosen by the wrapper from the
// table's capacity and the SM count alone (decode_attention.py split_plan:
// at the serving shape 4 splits of 128 for 384 blocks). A split wholly at or
// past the row's length is skipped, not masked; split 0 also attends the
// window tile, so the window is attended exactly once whatever the length
// (alone when the length is 0). Inside a split, 64-position tiles (32 for
// fp32) of raw pool rows come into a double-buffered shared ring through
// 16-byte cp.async copies, each row's page resolved from the table, the
// next tile in flight while this one is scored; the window's rows arrive
// with the first tile. Quantized rows arrive as raw bytes: a page's K scale
// multiplies each position's score and its V scale each position's
// probability, in fp32, so dequantizing costs no multiply per element. Each
// split's partial (m, l, acc) per window row merges in the same launch, as
// B3's: directly when the row needs one split, else through a workspace,
// the last split to take the row's ticket merging all in split order
// (bitwise on a re-run) and resetting the ticket.
//
// Two routes, one template:
// - bf16 / fp16 on the tensor cores, mma.sync.m16n8k16 with the window as M
//   (one 16-row m tile for W <= 16, two for W = 17). wgmma's 64-row M would
//   need the transposed products (keys as M) and a reduction of each window
//   row's softmax across the four warps every tile; with the window as M a
//   row's scores sit in the four lanes of one warp, and Dh 96 is twelve n8
//   tiles with no padding. The warps split each tile's keys (16 each, or 32
//   each per m tile at W = 17) and keep their own (m, l, O), merged at the
//   end of the split. S = Q K^T takes Q's fragments as they lie (loaded once)
//   and K from the ring (int8 / int4 widened: integers up to 256 are exact in
//   both types); the softmax scale (and the page's K scale) multiplies the
//   fp32 scores. P (times the page's V scale) enters O += P V as hi + lo
//   halves of the input type, as B1 does (flash_attention_fwd_tc.cu), so the
//   result stays the fp32 function; fp16 holds P times 2^E with E = 14 less
//   the exponent of the tile's largest V scale, exact to apply and undo.
// - fp32 on the CUDA cores: warp w owns window rows w, w + 4, ..., lane j
//   scores tile position j against all of the warp's rows (one read of its
//   K row), probabilities broadcast by shuffle into P V, a lane owning
//   output dims lane, lane + 32, ...

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "paged_kv.cuh"
#include "tc_tile.cuh"

namespace {

using ds::tc::cp_async16;
using ds::tc::cp_async4;
using ds::tc::cp_async_commit;
using ds::tc::cp_async_wait;
using ds::tc::pack2;
using ds::tc::smem_u32;
using ds::tc::unpack2;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;
constexpr int kMaxW = 17;     // the widest window: spec_k 16 + the verified token
constexpr int kWinRows = 32;  // window rows in shared memory (zero past W)
constexpr float kLog2e = 1.4426950408889634f;

// A pool or window row in shared memory: `bytes` of payload padded to an odd
// number of 16-byte slots (lanes reading one chunk of eight rows hit eight
// distinct slots).
template <typename E, int D, int MODE> struct RowOf {
  static constexpr int bytes =
      MODE == kDense ? D * static_cast<int>(sizeof(E)) : (MODE == kInt8 ? D : D / 2);
  static constexpr int chunks = bytes / 16;
  static constexpr int stride = (chunks | 1) * 16;
};

// Shared layout: kStages x (K tile, V tile, K scales, V scales), then the
// window's K and V rows; the end-of-split merge reuses it from the start.
template <typename T, int D, int MODE, int TP> struct Layout {
  using P = RowOf<T, D, MODE>;
  using Wn = RowOf<T, D, kDense>;
  static constexpr int tile = TP * P::stride;
  static constexpr int scales = MODE == kDense ? 0 : 2 * TP * 4;
  static constexpr int stage = 2 * tile + scales;
  static constexpr int win = kStages * stage;
  static constexpr int win_tile = kWinRows * Wn::stride;
  // the end-of-split merge: the partial [kMaxW][D], then (tensor cores)
  // each warp's m and l [2][kWarps][16] and O [kWarps][16][D]
  static constexpr int merge = (kMaxW * D + 2 * kWarps * 16 + kWarps * 16 * D) * 4;
  static constexpr int bytes =
      (win + 2 * win_tile) > merge ? (win + 2 * win_tile) : merge;
};

struct Strides {  // element strides of q, win_k, win_v [B, W, H, D] (batch, window, head)
  long long q_sb, q_sw, q_sh, k_sb, k_sw, k_sh, v_sb, v_sw, v_sh;
};

struct Args {
  const void *q, *win_k, *win_v, *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  void* o;
  const int *lengths, *tables;
  int B, W, H, P, ps, pps;
  Strides st;
  float scale;
  int n_split, span;
  float *ws_ml, *ws_acc;
  int* tickets;
  cudaStream_t stream;
};

// ------------------------------------------------------------ element access
// Element d of a row of format (T, MODE) in shared memory, widened to fp32
// (int8 / int4 as the integer: the page's scale is applied elsewhere).
template <typename T, int D, int MODE>
__device__ __forceinline__ float elem(const unsigned char* row, int d) {
  if constexpr (MODE == kDense) {
    return ds::to_float(reinterpret_cast<const T*>(row)[d]);
  } else if constexpr (MODE == kInt8) {
    return static_cast<float>(reinterpret_cast<const int8_t*>(row)[d]);
  } else {  // dim d < D/2: low nibble of byte d; else high nibble of byte d - D/2
    const int8_t* r = reinterpret_cast<const int8_t*>(row);
    return static_cast<float>(d < D / 2 ? low_nibble(r[d]) : high_nibble(r[d - D / 2]));
  }
}

// Dims d, d + 1 (d even) of a row as a packed pair of T (d in the low half).
template <typename T, int D, int MODE>
__device__ __forceinline__ uint32_t pair(const unsigned char* row, int d) {
  if constexpr (MODE == kDense) {
    return *reinterpret_cast<const uint32_t*>(row + 2 * d);
  } else {
    return pack2<T>(elem<T, D, MODE>(row, d), elem<T, D, MODE>(row, d + 1));
  }
}

// Element d of two rows as a packed pair of T (row a in the low half).
template <typename T, int D, int MODE>
__device__ __forceinline__ uint32_t pair2(const unsigned char* a, const unsigned char* b, int d) {
  if constexpr (MODE == kDense) {
    const uint32_t lo = reinterpret_cast<const uint16_t*>(a)[d];
    const uint32_t hi = reinterpret_cast<const uint16_t*>(b)[d];
    return lo | (hi << 16);
  } else {
    return pack2<T>(elem<T, D, MODE>(a, d), elem<T, D, MODE>(b, d));
  }
}

// Start the copies of history positions [t0, t0 + TP) of head h (those at
// or past p1 zero-filled) into a ring stage: K and V rows, and for the
// quantized layouts each position's K and V page scale.
template <typename T, int D, int MODE, int TP>
__device__ __forceinline__ void load_pool_tile(unsigned char* stage, const void* k_pages,
                                               const void* v_pages, const float* k_scales,
                                               const float* v_scales, const int* tbl, int h,
                                               int P, int ps, int t0, int p1) {
  using L = Layout<T, D, MODE, TP>;
  using R = RowOf<T, D, MODE>;
  const uint32_t st = smem_u32(stage);
  for (int idx = threadIdx.x; idx < TP * R::chunks; idx += kThreads) {
    const int j = idx / R::chunks, c = idx % R::chunks;
    const int pos = t0 + j;
    const bool in = pos < p1;
    const int page = in ? tbl[pos / ps] : tbl[0];
    const long long row = ((long long)h * P + page) * ps + (in ? pos % ps : 0);
    const long long off = row * R::bytes + c * 16;
    cp_async16(st + j * R::stride + c * 16, static_cast<const unsigned char*>(k_pages) + off, in);
    cp_async16(st + L::tile + j * R::stride + c * 16,
               static_cast<const unsigned char*>(v_pages) + off, in);
  }
  if constexpr (MODE != kDense) {
    for (int j = threadIdx.x; j < TP; j += kThreads) {
      const int pos = t0 + j;
      const bool in = pos < p1;
      const long long s = (long long)h * P + (in ? tbl[pos / ps] : tbl[0]);
      cp_async4(st + 2 * L::tile + 4 * j, k_scales + s, in);
      cp_async4(st + 2 * L::tile + 4 * (TP + j), v_scales + s, in);
    }
  }
}

// Start the copies of the W window rows (K then V) of one (b, h); rows
// W .. kWinRows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_window(unsigned char* dst, const T* wk, const T* wv,
                                            long long k_sw, long long v_sw, int W) {
  using R = RowOf<T, D, kDense>;
  const uint32_t st = smem_u32(dst);
  for (int idx = threadIdx.x; idx < kWinRows * R::chunks; idx += kThreads) {
    const int j = idx / R::chunks, c = idx % R::chunks;
    const bool in = j < W;
    const int e = c * (16 / static_cast<int>(sizeof(T)));
    cp_async16(st + j * R::stride + c * 16, in ? wk + j * k_sw + e : wk, in);
    cp_async16(st + kWinRows * R::stride + j * R::stride + c * 16, in ? wv + j * v_sw + e : wv,
               in);
  }
}

// ------------------------------------------------------ tensor-core route
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi = T(x), lo = T(x - hi) of two fp32 values, as packed pairs
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(x0, x1);
  const float2 h = unpack2<T>(hi);
  lo = pack2<T>(x0 - h.x, x1 - h.y);
}

// One warp's running state on the tensor-core route: its two rows (g, g + 8
// of its m tile) per lane; m in the log2 domain, l this lane's share, O as
// Dh / 8 m16n8 accumulators, e fp16's exponent of P (kNoScale before the
// first tile).
template <int D> struct TcState {
  float m[2], l[2], o[D / 8][4];
  int e;
};

constexpr int kNoE = 1 << 30;

// Score one tile (keys kb .. kb + KW of it, this warp's) against the warp's
// m tile and fold it into the state. `rows` points at the tile's K rows (V
// rows `vofs` bytes further), `ks` / `vs` at its per-position scales (null:
// 1), `nv` valid positions; `causal_row0` >= 0 for the window tile (key j
// visible to window row r iff j <= r), -1 for a history tile.
template <typename T, int D, int FMT, int KW>
__device__ __forceinline__ void tc_tile(TcState<D>& s, const uint32_t (&qa)[D / 16][4],
                                        const unsigned char* rows, int stride, int vofs,
                                        const float* ks, const float* vs, int nv, int kb,
                                        int row0, bool window, float score2) {
  constexpr bool kF16 = std::is_same<T, __half>::value;
  constexpr int NT = KW / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float sc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const unsigned char* kr = rows + (kb + nt * 8 + g) * stride;
      mma16816<T>(sc[nt], qa[kk], pair<T, D, FMT>(kr, 16 * kk + 2 * t4),
                  pair<T, D, FMT>(kr, 16 * kk + 8 + 2 * t4));
    }
  // scores (log2 domain) and the rows' maxima; hidden keys give p = 0
  float mx[2] = {s.m[0], s.m[1]};
  bool vis[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kb + nt * 8 + 2 * t4 + (e & 1), r = e >> 1;
      vis[nt][e] = key < nv && (!window || key <= row0 + g + 8 * r);
      const float x = sc[nt][e] * score2 * (ks != nullptr ? ks[key] : 1.f);
      sc[nt][e] = x;
      if (vis[nt][e]) mx[r] = fmaxf(mx[r], x);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f(s.m[r] - mx[r]);
    s.m[r] = mx[r];
    s.l[r] *= alpha[r];
  }
  // fp16: P (times the V scale) is held times 2^e, e = 14 less the exponent
  // of the warp's largest V scale this tile, so P vs 2^e < 2^14
  float up = 1.f;
  if constexpr (kF16) {
    float vmax = 0.f;
    if (vs != nullptr)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + nt * 8 + 2 * t4 + e;
          if (key < nv) vmax = fmaxf(vmax, fabsf(vs[key]));
        }
    const float wmax = ds::warp_max(vmax);
    const int en = vs == nullptr || wmax == 0.f ? 14 : max(-100, min(100, 13 - ilogbf(wmax)));
    if (s.e != kNoE && en != s.e) up = ds::tc::pow2(en - s.e);
    s.e = en;
  }
  const float pscale = kF16 ? ds::tc::pow2(s.e) : 1.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kb + nt * 8 + 2 * t4 + (e & 1), r = e >> 1;
      const float p = vis[nt][e] ? exp2f(sc[nt][e] - s.m[r]) : 0.f;
      s.l[r] += p;
      sc[nt][e] = p * (vs != nullptr ? vs[key] : 1.f) * pscale;
    }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) s.o[nd][e] *= alpha[e >> 1] * up;
  // O += P_hi V + P_lo V, one k16 step per 16 keys
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split2<T>(sc[2 * kk][0], sc[2 * kk][1], hi[0], lo[0]);
    split2<T>(sc[2 * kk][2], sc[2 * kk][3], hi[1], lo[1]);
    split2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1], hi[2], lo[2]);
    split2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3], hi[3], lo[3]);
    const unsigned char* v0 = rows + vofs + (kb + 16 * kk + 2 * t4) * stride;
    const unsigned char* v8 = v0 + 8 * stride;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int d = nd * 8 + g;
      const uint32_t b0 = pair2<T, D, FMT>(v0, v0 + stride, d);
      const uint32_t b1 = pair2<T, D, FMT>(v8, v8 + stride, d);
      mma16816<T>(s.o[nd], hi, b0, b1);
      mma16816<T>(s.o[nd], lo, b0, b1);
    }
  }
}

// ------------------------------------------------------ CUDA-core route
constexpr int kCoreRows = (kMaxW + kWarps - 1) / kWarps;  // window rows a warp owns
constexpr int kQRows = kCoreRows * kWarps;                 // q rows staged (zero past W)

// Fold one tile (lane j = position j of up to 32) into the warp's rows.
template <typename T, int D, int FMT>
__device__ __forceinline__ void core_tile(float (&m)[kCoreRows], float (&l)[kCoreRows],
                                          float (&acc)[kCoreRows][D / 32],
                                          const float* __restrict__ sq, int W,
                                          const unsigned char* rows, int stride, int vofs,
                                          const float* ks, const float* vs, int nv, bool window,
                                          float score2) {
  using R = RowOf<T, D, FMT>;
  constexpr int DL = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned char* kr = rows + lane * stride;
  float dot[kCoreRows];
#pragma unroll
  for (int i = 0; i < kCoreRows; ++i) dot[i] = 0.f;
  // one read of this lane's K row, against every row of the warp
#pragma unroll 2
  for (int c = 0; c < R::chunks; ++c) {
    if constexpr (FMT == kDense) {
      constexpr int V = ds::Vec16<T>::n;
      float x[V];
      ds::load16<T>(reinterpret_cast<const T*>(kr + c * 16), x);
#pragma unroll
      for (int i = 0; i < kCoreRows; ++i) {
        const float* qi = sq + (warp + kWarps * i) * D + c * V;
#pragma unroll
        for (int u = 0; u < V; ++u) dot[i] = fmaf(qi[u], x[u], dot[i]);
      }
    } else {
      int x[16];
      load16_s8(reinterpret_cast<const int8_t*>(kr + c * 16), x);
#pragma unroll
      for (int i = 0; i < kCoreRows; ++i) {
        const float* qi = sq + (warp + kWarps * i) * D;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if constexpr (FMT == kInt8) {
            dot[i] = fmaf(qi[c * 16 + u], static_cast<float>(x[u]), dot[i]);
          } else {
            dot[i] = fmaf(qi[c * 16 + u], static_cast<float>(low_nibble(x[u])), dot[i]);
            dot[i] = fmaf(qi[D / 2 + c * 16 + u], static_cast<float>(high_nibble(x[u])), dot[i]);
          }
        }
      }
    }
  }
  const float kscale = score2 * (ks != nullptr && lane < nv ? ks[lane] : 1.f);
  const float vscale = vs != nullptr && lane < nv ? vs[lane] : 1.f;
  float pv[kCoreRows];
#pragma unroll
  for (int i = 0; i < kCoreRows; ++i) {
    const int w = warp + kWarps * i;
    pv[i] = 0.f;
    if (w >= W) continue;  // warp-uniform
    const bool valid = lane < nv && (!window || lane <= w);
    const float x = dot[i] * kscale;
    // position 0 is visible to every row, so m_new is finite
    const float m_new = fmaxf(m[i], ds::warp_max(valid ? x : ds::kNegInf));
    const float alpha = exp2f(m[i] - m_new);
    const float p = valid ? exp2f(x - m_new) : 0.f;
    l[i] = alpha * l[i] + ds::warp_sum(p);
    m[i] = m_new;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[i][dd] *= alpha;
    pv[i] = p * vscale;
  }
  for (int j = 0; j < nv; ++j) {
    const unsigned char* vr = rows + vofs + j * stride;
    float x[DL];
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) x[dd] = elem<T, D, FMT>(vr, lane + 32 * dd);
#pragma unroll
    for (int i = 0; i < kCoreRows; ++i) {
      const float pj = __shfl_sync(0xffffffffu, pv[i], j);
      if (warp + kWarps * i < W)
#pragma unroll
        for (int dd = 0; dd < DL; ++dd) acc[i][dd] = fmaf(pj, x[dd], acc[i][dd]);
    }
  }
}

// ------------------------------------------------------------ the kernel
// MT: 0 for the CUDA-core route (fp32), else the m tiles of the window (1
// for W <= 16, 2 for W = 17) on the tensor cores.
template <typename T, int D, int MODE, int MT>
__global__ void __launch_bounds__(kThreads)
verify_split_kernel(const T* __restrict__ q, const T* __restrict__ win_k,
                    const T* __restrict__ win_v, const void* __restrict__ k_pages,
                    const void* __restrict__ v_pages, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, T* __restrict__ o,
                    const int* __restrict__ lengths, const int* __restrict__ tables, int W,
                    int H, int P, int ps, int pps, Strides st, float scale, int span,
                    float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                    int* __restrict__ tickets) {
  constexpr bool kTc = MT > 0;
  constexpr int TP = kTc ? 64 : 32;  // positions per tile
  using L = Layout<T, D, MODE, TP>;
  using PR = RowOf<T, D, MODE>;
  using WR = RowOf<T, D, kDense>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float sq[kTc ? 1 : kQRows * D];  // the CUDA-core route's q
  __shared__ float s_m[kMaxW], s_l[kMaxW];
  __shared__ int s_last;

  const int bh = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), pps * ps);
  const int n_part = max((len + span - 1) / span, 1);  // split 0 runs even at length 0
  if (split >= n_part) return;  // wholly past the length: skipped, never masked
  const int* tbl = tables + (long long)b * pps;
  const int p0 = split * span, p1 = min(p0 + span, len);
  const int n_hist = p1 > p0 ? (p1 - p0 + TP - 1) / TP : 0;
  const bool owner = split == 0;  // attends the window tile, after its history
  const int n_tiles = n_hist + (owner ? 1 : 0);
  unsigned char* win = smem + L::win;

  // prologue: the window (owner) and the first history tile, one group
  if (owner)
    load_window<T, D>(win, win_k + b * st.k_sb + h * st.k_sh, win_v + b * st.v_sb + h * st.v_sh,
                      st.k_sw, st.v_sw, W);
  if (n_hist > 0)
    load_pool_tile<T, D, MODE, TP>(smem, k_pages, v_pages, k_scales, v_scales, tbl, h, P, ps,
                                   p0, p1);
  cp_async_commit();

  const T* qb = q + b * st.q_sb + h * st.q_sh;
  const float score2 = scale * kLog2e;
  constexpr int DL = D / 32;
  // the CUDA-core route's state (rows warp + 4 i)
  float cm[kCoreRows], cl[kCoreRows], cacc[kCoreRows][kTc ? 1 : DL];
  // the tensor-core route's: this warp's m tile and key group
  constexpr int KG = kWarps / (kTc ? MT : kWarps), KW = TP / KG;
  const int mt = warp / KG, kg = warp % KG;
  const int g = lane >> 2, t4 = lane & 3;
  TcState<kTc ? D : 8> ts;
  uint32_t qa[kTc ? D / 16 : 1][4];
  if constexpr (kTc) {
    // Q's A fragments as they lie (rows at or past W zero)
    const int r0 = 16 * mt + g, r1 = r0 + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int d0 = 16 * kk + 2 * t4;
      auto ld = [&](int r, int d) -> uint32_t {
        return r < W ? *reinterpret_cast<const uint32_t*>(qb + r * st.q_sw + d) : 0u;
      };
      qa[kk][0] = ld(r0, d0);
      qa[kk][1] = ld(r1, d0);
      qa[kk][2] = ld(r0, d0 + 8);
      qa[kk][3] = ld(r1, d0 + 8);
    }
    ts.m[0] = ts.m[1] = ds::kNegInf;
    ts.l[0] = ts.l[1] = 0.f;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) ts.o[nd][e] = 0.f;
    ts.e = kNoE;
  } else {
    for (int idx = tid; idx < kQRows * D; idx += kThreads) {
      const int w = idx / D, d = idx % D;
      sq[idx] = w < W ? ds::to_float(qb[w * st.q_sw + d]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kCoreRows; ++i) {
      cm[i] = ds::kNegInf;
      cl[i] = 0.f;
#pragma unroll
      for (int dd = 0; dd < (kTc ? 1 : DL); ++dd) cacc[i][dd] = 0.f;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_hist)
      load_pool_tile<T, D, MODE, TP>(smem + ((t + 1) % kStages) * L::stage, k_pages, v_pages,
                                     k_scales, v_scales, tbl, h, P, ps, p0 + (t + 1) * TP, p1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and the window) have landed
    __syncthreads();
    const bool window = t == n_hist;
    const int nv = window ? W : min(TP, p1 - (p0 + t * TP));
    unsigned char* stage = smem + (t % kStages) * L::stage;
    const float* ks = nullptr;
    const float* vs = nullptr;
    if (MODE != kDense && !window) {
      ks = reinterpret_cast<const float*>(stage + 2 * L::tile);
      vs = ks + TP;
    }
    if constexpr (kTc) {
      if (kg * KW < nv) {  // warp-uniform: this warp's keys hold a valid one
        if (window)
          tc_tile<T, D, kDense, KW>(ts, qa, win, WR::stride, kWinRows * WR::stride, nullptr,
                                    nullptr, nv, kg * KW, 16 * mt, true, score2);
        else
          tc_tile<T, D, MODE, KW>(ts, qa, stage, PR::stride, L::tile, ks, vs, nv, kg * KW,
                                  16 * mt, false, score2);
      }
    } else {
      if (window)
        core_tile<T, D, kDense>(cm, cl, cacc, sq, W, win, WR::stride, kWinRows * WR::stride,
                                nullptr, nullptr, nv, true, score2);
      else
        core_tile<T, D, MODE>(cm, cl, cacc, sq, W, stage, PR::stride, L::tile, ks, vs, nv,
                              false, score2);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // the split's partial per window row: m (log2 domain), l, a[D] (unnormalized)
  float* part = reinterpret_cast<float*>(smem);  // [kMaxW][D], the ring is free now
  if constexpr (kTc) {
    // each warp's state to shared memory, then the key groups of an m tile
    // merge in warp order
    float* wm = part + kMaxW * D;                 // [kWarps][16] m, then l
    float* wo = wm + 2 * kWarps * 16;             // [kWarps][16][D]
    const float undo = ts.e == kNoE ? 1.f : ds::tc::pow2(-ts.e);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ts.l[r] += __shfl_xor_sync(0xffffffffu, ts.l[r], 1);
      ts.l[r] += __shfl_xor_sync(0xffffffffu, ts.l[r], 2);
      if (t4 == 0) {
        wm[warp * 16 + g + 8 * r] = ts.m[r];
        wm[(kWarps + warp) * 16 + g + 8 * r] = ts.l[r];
      }
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wo[(warp * 16 + g + 8 * (e >> 1)) * D + nd * 8 + 2 * t4 + (e & 1)] = ts.o[nd][e] * undo;
    __syncthreads();
    for (int w = tid; w < W; w += kThreads) {
      const int wt = w / 16, lr = w % 16;
      float mm = ds::kNegInf, ll = 0.f;
      for (int k = 0; k < KG; ++k) mm = fmaxf(mm, wm[(wt * KG + k) * 16 + lr]);
      for (int k = 0; k < KG; ++k)
        ll = fmaf(wm[(kWarps + wt * KG + k) * 16 + lr], exp2f(wm[(wt * KG + k) * 16 + lr] - mm),
                  ll);
      s_m[w] = mm;
      s_l[w] = ll;
    }
    __syncthreads();
    for (int idx = tid; idx < W * D; idx += kThreads) {
      const int w = idx / D, d = idx % D, wt = w / 16, lr = w % 16;
      float a = 0.f;
      for (int k = 0; k < KG; ++k) {
        const int src = wt * KG + k;
        a = fmaf(wo[(src * 16 + lr) * D + d], exp2f(wm[src * 16 + lr] - s_m[w]), a);
      }
      part[idx] = a;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kCoreRows; ++i) {
      const int w = warp + kWarps * i;
      if (w < W) {
        if (lane == 0) {
          s_m[w] = cm[i];
          s_l[w] = cl[i];
        }
#pragma unroll
        for (int dd = 0; dd < (kTc ? 1 : DL); ++dd) part[w * D + lane + 32 * dd] = cacc[i][dd];
      }
    }
  }
  __syncthreads();

  if (n_part == 1) {  // the whole row in this split: every window row saw position 0
    for (int idx = tid; idx < W * D; idx += kThreads) {
      const int w = idx / D, d = idx % D;
      const float lw = s_l[w];
      o[(((long long)b * W + w) * H + h) * D + d] =
          ds::from_float<T>(part[idx] / (lw == 0.f ? 1.f : lw));
    }
    return;
  }
  const long long slot = (long long)bh * n_split + split;
  for (int idx = tid; idx < W * D; idx += kThreads) ws_acc[slot * kMaxW * D + idx] = part[idx];
  for (int w = tid; w < W; w += kThreads) {
    ws_ml[(slot * kMaxW + w) * 2] = s_m[w];
    ws_ml[(slot * kMaxW + w) * 2 + 1] = s_l[w];
  }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + bh, 1) == n_part - 1;
  __syncthreads();
  if (!s_last) return;

  // the last split of the row: merge the n_part partials in split order
  __threadfence();
  const float* ml = ws_ml + (long long)bh * n_split * kMaxW * 2;
  const float* pa = ws_acc + (long long)bh * n_split * kMaxW * D;
  for (int w = tid; w < W; w += kThreads) {
    float mm = ds::kNegInf, ll = 0.f;
    for (int s = 0; s < n_part; ++s) mm = fmaxf(mm, __ldcg(ml + (s * kMaxW + w) * 2));
    for (int s = 0; s < n_part; ++s)
      ll = fmaf(__ldcg(ml + (s * kMaxW + w) * 2 + 1),
                exp2f(__ldcg(ml + (s * kMaxW + w) * 2) - mm), ll);
    s_m[w] = mm;
    s_l[w] = ll == 0.f ? 1.f : ll;
  }
  __syncthreads();
  for (int idx = tid; idx < W * D; idx += kThreads) {
    const int w = idx / D, d = idx % D;
    float a = 0.f;
    for (int s = 0; s < n_part; ++s)
      a = fmaf(__ldcg(pa + (long long)s * kMaxW * D + idx),
               exp2f(__ldcg(ml + (s * kMaxW + w) * 2) - s_m[w]), a);
    o[(((long long)b * W + w) * H + h) * D + d] = ds::from_float<T>(a / s_l[w]);
  }
  if (tid == 0) tickets[bh] = 0;  // ready for the next launch
}

template <typename T, int D, int MODE, int MT>
cudaError_t launch(const Args& a) {
  constexpr int smem = Layout<T, D, MODE, (MT > 0 ? 64 : 32)>::bytes;
  static ds::SmemOptIn opt;  // once per device and instance
  if (const cudaError_t err = opt.set(verify_split_kernel<T, D, MODE, MT>, smem)) return err;
  verify_split_kernel<T, D, MODE, MT><<<dim3(a.B * a.H, a.n_split), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.win_k), static_cast<const T*>(a.win_v),
      a.k_pages, a.v_pages, a.k_scales, a.v_scales, static_cast<T*>(a.o), a.lengths, a.tables,
      a.W, a.H, a.P, a.ps, a.pps, a.st, a.scale, a.span, a.ws_ml, a.ws_acc, a.tickets);
  return cudaGetLastError();
}

template <typename T, int D, int MODE>
cudaError_t dispatch_route(const Args& a) {
  if constexpr (std::is_same<T, float>::value) {
    return launch<T, D, MODE, 0>(a);
  } else {
    return a.W > 16 ? launch<T, D, MODE, 2>(a) : launch<T, D, MODE, 1>(a);
  }
}

template <typename T, int D>
cudaError_t dispatch_mode(int kv_mode, const Args& a) {
  switch (kv_mode) {
    case kDense: return dispatch_route<T, D, kDense>(a);
    case kInt8: return dispatch_route<T, D, kInt8>(a);
    case kInt4: return dispatch_route<T, D, kInt4>(a);
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

// q, win_k, win_v [B, W, H, D] (1 <= W <= 17) given by element strides
// (batch, window, head; last dimension contiguous; the window's rows 16-byte
// aligned), all three in `dtype`; k/v pools one layer's [H, P, ps, Dq],
// contiguous and 16-byte aligned: in q's dtype for kv_mode 0 (dense,
// Dq = D), int8 for kv_mode 8 (Dq = D) and 4 (nibble-packed, Dq = D / 2),
// with fp32 [H, P] k/v scales for the two quantized modes (null for dense);
// o [B, W, H, D] contiguous in q's dtype; lengths a device int32 [B] vector
// of pool tokens before the window; tables a device int32 [B, pps] matrix of
// valid page ids. The grid has n_split splits of `span` history positions a
// row (span a multiple of 64, n_split * span >= pps * ps); ws_ml
// [B*H*n_split*17*2] and ws_acc [B*H*n_split*17*D] fp32 are the partials'
// workspace, tickets [B*H] int32 zero before the launch and after it.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ds_paged_verify_attention(
    const void* q, const void* win_k, const void* win_v, const void* k_pages,
    const void* v_pages, const float* k_scales, const float* v_scales, void* o,
    const int* lengths, const int* tables, int B, int W, int H, int P, int ps, int pps, int D,
    int dtype, int kv_mode, long long q_sb, long long q_sw, long long q_sh, long long k_sb,
    long long k_sw, long long k_sh, long long v_sb, long long v_sw, long long v_sh, float scale,
    int n_split, int span, float* ws_ml, float* ws_acc, int* tickets, void* stream) {
  if (W < 1 || W > kMaxW || n_split < 1 || span < 64 || span % 64 ||
      (long long)n_split * span < (long long)pps * ps)
    return cudaErrorInvalidValue;
  const Args a{q, win_k, win_v, k_pages, v_pages, k_scales, v_scales, o, lengths, tables, B, W,
               H, P, ps, pps, Strides{q_sb, q_sw, q_sh, k_sb, k_sw, k_sh, v_sb, v_sw, v_sh},
               scale, n_split, span, ws_ml, ws_acc, tickets, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case ds::kF32: return dispatch_dim<float>(D, kv_mode, a);
    case ds::kBF16: return dispatch_dim<__nv_bfloat16>(D, kv_mode, a);
    case ds::kF16: return dispatch_dim<__half>(D, kv_mode, a);
    default: return cudaErrorInvalidValue;
  }
}
