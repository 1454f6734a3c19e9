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
// A quantized K/V row enters as its integers (layouts in paged_kv.cuh): the
// page's K scale multiplies each position's score and its V scale each
// position's probability, in fp32, which is k = k_q * k_scales[h, page] and
// v = v_q * v_scales[h, page] of the reference with the multiply moved.
//
// What bounds it on the H100: bytes. It must read the K and V rows below
// each length at the pool's element size (half a byte for int4), the scales
// and table entries of those pages, and q, and write o; its flops (4 * Dh per
// position) are far below any peak, and one query row per (b, h) has nothing
// to fill a tensor-core tile. At the serving shape (8 slots, H12, Dh 64,
// lengths up to 512) that is at most 12.6 MB in bf16, about 3.8 us at 3.35
// TB/s. One block per (b, h) walking its row serially (96 blocks for 132
// SMs, one scalar V load a lane) left the kernel bound by one block's
// latency; so each row is split, as B3's (decode_attention.cu) and B5's
// (paged_verify_attention.cu) are.
//
// Work split (split-KV, one launch). The grid is (B * H, n_split): block
// (bh, s) owns positions [s * span, (s + 1) * span) of its row, the wrapper
// choosing n_split and span from the table's capacity and the SM count alone
// (it never reads the lengths: decode_attention.py split_plan; at the
// serving shape 4 splits of 128 for 384 blocks, at 16 pages 6 of 192). A
// split wholly at or past its row's length is skipped, never masked: a
// masked position would add exp(-1e30 - (-1e30)) = 1 to l, and a row of
// length 0 would return the mean of V. Inside a split the block streams
// 32-position tiles of raw pool rows (any pool type) through a
// double-buffered shared ring of 16-byte cp.async copies, each copy's page
// resolved from the table (a split, or a tile, may start inside a page or
// span pages), with the positions' K and V scales beside them; the next
// tile is in flight while this one is scored. Rows are padded so that a
// row's stride is 4 mod 8 16-byte slots. Warp w takes positions 8w .. 8w + 7
// of each tile: four lanes score one position (16-byte reads of the
// interleaved chunks g, g + 4, ... of its row; two shuffles sum them), and
// each warp keeps its own fp32 (m, l, acc); P V reads V rows as 16-byte
// vectors in every pool type, a lane owning one chunk of a row (an int4
// chunk is 16 packed bytes: dims j and j + Dh/2 of each byte). The four
// warps' states merge in shared memory into the split's partial
// (m, l, acc[Dh]).
//
// Merge in the same launch, as B3's: a row whose length falls in one split
// writes its output directly. Otherwise each split writes its partial to a
// workspace, fences, and takes a ticket (atomicAdd) counting the row's
// non-empty splits; the last to arrive merges all partials in split order
// (so a re-run is bitwise equal, whichever block is last) and resets the
// ticket to 0. The wrapper allocates the workspace and the zeroed tickets
// once per device and shape; the kernel allocates nothing.

#include <cstdint>

#include "common.cuh"
#include "paged_kv.cuh"
#include "tc_tile.cuh"

namespace {

using ds::tc::cp_async16;
using ds::tc::cp_async4;
using ds::tc::cp_async_commit;
using ds::tc::cp_async_wait;
using ds::tc::smem_u32;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                 // positions per ring tile
constexpr int kPerWarp = kTile / kWarps;  // positions a warp scores per tile
constexpr int kStages = 2;

// One pool row of format (T, MODE): RB bytes in C 16-byte chunks of E
// elements each; dim(c, u) is the head dim of element u of chunk c.
template <typename T, int D, int MODE> struct Fmt {
  static constexpr int RB =
      MODE == kDense ? D * static_cast<int>(sizeof(T)) : (MODE == kInt8 ? D : D / 2);
  static constexpr int C = RB / 16;
  static constexpr int E = MODE == kDense ? 16 / static_cast<int>(sizeof(T))
                                          : (MODE == kInt8 ? 16 : 32);
  static_assert(RB % 16 == 0, "whole 16-byte chunks a row");

  static __device__ __forceinline__ int dim(int c, int u) {
    if constexpr (MODE == kInt4) return u < 16 ? 16 * c + u : D / 2 + 16 * c + (u - 16);
    return E * c + u;
  }

  // chunk at p (16-byte aligned, shared memory) widened to fp32 (the
  // integers for the quantized layouts)
  static __device__ __forceinline__ void decode(const unsigned char* p, float (&x)[E]) {
    if constexpr (MODE == kDense) {
      ds::load16<T>(reinterpret_cast<const T*>(p), x);
    } else {
      int b[16];
      load16_s8(reinterpret_cast<const int8_t*>(p), b);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if constexpr (MODE == kInt8) {
          x[u] = static_cast<float>(b[u]);
        } else {
          x[u] = static_cast<float>(low_nibble(b[u]));
          x[16 + u] = static_cast<float>(high_nibble(b[u]));
        }
      }
    }
  }
};

// Shared geometry of one ring stage: the [kTile] rows of K, then of V
// (kSlots 16-byte slots a row, 4 mod 8: the eight lanes of a quarter-warp,
// two positions x four chunks, hit eight distinct slots), then the
// positions' K and V scales (quantized layouts). RPI rows (at most the
// warp's eight) a warp's 16-byte V load covers.
template <typename T, int D, int MODE> struct Geo {
  using F = Fmt<T, D, MODE>;
  static constexpr int C = F::C;
  static constexpr int kSlots = C + ((12 - C % 8) % 8);
  static constexpr int row = kSlots * 16;
  static constexpr int tile = kTile * row;
  static constexpr int scales = MODE == kDense ? 0 : 2 * kTile * 4;
  static constexpr int stage = 2 * tile + scales;
  static constexpr int bytes = kStages * stage;
  static constexpr int RPI = C >= 32 ? 1 : (32 / C < kPerWarp ? 32 / C : kPerWarp);
  static constexpr int CPL = (C + 3) / 4;  // chunks a scoring lane reads
  static_assert(kSlots % 8 == 4 && stage % 16 == 0, "slots 4 mod 8, aligned stages");
};

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const unsigned char* __restrict__ k_pages,
                   const unsigned char* __restrict__ v_pages, const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales, T* __restrict__ o,
                   const int* __restrict__ lengths, const int* __restrict__ tables, int H, int P,
                   int ps, int pps, long long q_sb, long long q_sh, float scale, int span,
                   float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                   int* __restrict__ tickets) {
  using G = Geo<T, D, MODE>;
  using F = Fmt<T, D, MODE>;
  constexpr int C = G::C, E = F::E, RPI = G::RPI, CPL = G::CPL;
  constexpr bool kQuant = MODE != kDense;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(16) float sq[D];
  __shared__ float sacc[kWarps][RPI * D];
  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ int s_last;

  const int bh = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), pps * ps);
  const int n_ne = (len + span - 1) / span;  // the splits holding a position below len
  T* ob = o + (long long)bh * D;
  if (split >= n_ne) {  // wholly past the length: skipped (split 0 of a length-0 row writes 0)
    if (split == 0)
      for (int d = tid; d < D; d += kThreads) ob[d] = ds::from_float<T>(0.f);
    return;
  }
  const int p0 = split * span, p1 = min(p0 + span, len);
  const int n_tiles = (p1 - p0 + kTile - 1) / kTile;
  const int* tbl = tables + (long long)b * pps;
  const uint32_t base = smem_u32(ring);

  // tile t of the split into stage t % kStages: each position's page from
  // the table; positions at or past p1 zero-filled, never read
  auto load = [&](int t) {
    const int t0 = p0 + t * kTile;
    const uint32_t st = base + (t % kStages) * G::stage;
    for (int idx = tid; idx < kTile * C; idx += kThreads) {
      const int j = idx / C, c = idx % C;
      const int pos = t0 + j;
      const bool in = pos < p1;
      const int page = tbl[(in ? pos : p0) / ps];
      const long long row = ((long long)h * P + page) * ps + (in ? pos : p0) % ps;
      const long long off = row * F::RB + c * 16;
      cp_async16(st + j * G::row + c * 16, k_pages + off, in);
      cp_async16(st + G::tile + j * G::row + c * 16, v_pages + off, in);
    }
    if constexpr (kQuant) {
      for (int j = tid; j < kTile; j += kThreads) {
        const int pos = t0 + j;
        const bool in = pos < p1;
        const long long s = (long long)h * P + tbl[(in ? pos : p0) / ps];
        cp_async4(st + 2 * G::tile + 4 * j, k_scales + s, in);
        cp_async4(st + 2 * G::tile + 4 * (kTile + j), v_scales + s, in);
      }
    }
  };
  load(0);
  cp_async_commit();

  const T* qb = q + b * q_sb + h * q_sh;
  for (int d = tid; d < D; d += kThreads) sq[d] = ds::to_float(qb[d]) * scale;
  __syncthreads();
  // lane = 4 * (position in the warp's eight) + g; g scores chunks g, g + 4, ...
  const int g = lane & 3, pw = lane >> 2;
  float qr[CPL][E];
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int u = 0; u < E; ++u) qr[i][u] = g + 4 * i < C ? sq[F::dim(g + 4 * i, u)] : 0.f;
  // P V: lane (r, c) owns chunk c of the warp's rows r, r + RPI, ...
  const int vr = lane / C, vc = lane % C;
  float m = ds::kNegInf, l = 0.f, acc[E];
#pragma unroll
  for (int u = 0; u < E; ++u) acc[u] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const unsigned char* st = ring + (t % kStages) * G::stage;
    const float* ks = reinterpret_cast<const float*>(st + 2 * G::tile);
    const float* vs = ks + kTile;
    // this warp's valid positions (of its eight; RPI need not divide eight)
    const int nv = min(min(kTile, p1 - (p0 + t * kTile)) - warp * kPerWarp, kPerWarp);
    if (nv > 0) {  // warp-uniform; position 0 of the warp is valid, so m_new is finite
      const int jw = warp * kPerWarp + pw;  // this lane's position in the tile
      const unsigned char* krow = st + jw * G::row;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        if (g + 4 * i < C) {
          float x[E];
          F::decode(krow + (g + 4 * i) * 16, x);
#pragma unroll
          for (int u = 0; u < E; ++u) dot = fmaf(qr[i][u], x[u], dot);
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const bool valid = pw < nv;
      if constexpr (kQuant) dot *= ks[jw];
      const float m_new = fmaxf(m, ds::warp_max(valid ? dot : ds::kNegInf));
      const float alpha = expf(m - m_new);
      const float p = valid ? expf(dot - m_new) : 0.f;
      l = alpha * l + ds::warp_sum(g == 0 ? p : 0.f);
      m = m_new;
      float pv = p;
      if constexpr (kQuant) pv *= vs[jw];  // the page's V scale rides the probability
#pragma unroll
      for (int u = 0; u < E; ++u) acc[u] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kPerWarp; jj += RPI) {
        const int j = jj + vr;
        const float pj = __shfl_sync(0xffffffffu, pv, 4 * min(j, kPerWarp - 1));
        if (vr < RPI && j < nv) {
          float x[E];
          F::decode(st + G::tile + (warp * kPerWarp + j) * G::row + vc * 16, x);
#pragma unroll
          for (int u = 0; u < E; ++u) acc[u] = fmaf(pj, x[u], acc[u]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // the four warps' states -> the split's partial (m_s, l_s, a_s)
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  if (vr < RPI)
#pragma unroll
    for (int u = 0; u < E; ++u) sacc[warp][vr * D + F::dim(vc, u)] = acc[u];
  __syncthreads();
  float m_s = ds::kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_s = fmaxf(m_s, sm[w]);
  float f[kWarps], l_s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = expf(sm[w] - m_s);  // 0 for a warp that saw no position
    l_s = fmaf(sl[w], f[w], l_s);
  }
  if (n_ne == 1) {  // the whole row in this split (l_s >= 1)
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int r = 0; r < RPI; ++r) a = fmaf(sacc[w][r * D + d], f[w], a);
      ob[d] = ds::from_float<T>(a / l_s);
    }
    return;
  }
  const long long slot = (long long)bh * n_split + split;
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
#pragma unroll
      for (int r = 0; r < RPI; ++r) a = fmaf(sacc[w][r * D + d], f[w], a);
    ws_acc[slot * D + d] = a;
  }
  if (tid == 0) {
    ws_ml[2 * slot] = m_s;
    ws_ml[2 * slot + 1] = l_s;
  }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + bh, 1) == n_ne - 1;
  __syncthreads();
  if (!s_last) return;

  // the last split of the row: merge the n_ne partials in split order
  __threadfence();
  const float* ml = ws_ml + 2 * (long long)bh * n_split;
  const float* pa = ws_acc + (long long)bh * n_split * D;
  float m_all = ds::kNegInf;
  for (int s = 0; s < n_ne; ++s) m_all = fmaxf(m_all, __ldcg(ml + 2 * s));
  for (int d = tid; d < D; d += kThreads) {
    float l_all = 0.f, a = 0.f;
    for (int s = 0; s < n_ne; ++s) {
      const float fs = expf(__ldcg(ml + 2 * s) - m_all);
      l_all = fmaf(__ldcg(ml + 2 * s + 1), fs, l_all);
      a = fmaf(__ldcg(pa + (long long)s * D + d), fs, a);
    }
    ob[d] = ds::from_float<T>(a / (l_all == 0.f ? 1.f : l_all));
  }
  if (tid == 0) tickets[bh] = 0;  // ready for the next launch
}

struct Args {
  const void *q, *k_pages, *v_pages;
  const float *k_scales, *v_scales;
  void* o;
  const int *lengths, *tables;
  int B, H, P, ps, pps;
  long long q_sb, q_sh;
  float scale;
  int n_split, span;
  float *ws_ml, *ws_acc;
  int* tickets;
  cudaStream_t stream;
};

template <typename T, int D, int MODE>
cudaError_t launch(const Args& a) {
  constexpr int smem = Geo<T, D, MODE>::bytes;
  static ds::SmemOptIn opt;  // once per device and instance
  if (const cudaError_t err = opt.set(paged_split_kernel<T, D, MODE>, smem)) return err;
  paged_split_kernel<T, D, MODE><<<dim3(a.B * a.H, a.n_split), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const unsigned char*>(a.k_pages),
      static_cast<const unsigned char*>(a.v_pages), a.k_scales, a.v_scales,
      static_cast<T*>(a.o), a.lengths, a.tables, a.H, a.P, a.ps, a.pps, a.q_sb, a.q_sh, a.scale,
      a.span, a.ws_ml, a.ws_acc, a.tickets);
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
// int32 [B, pps] matrix of valid page ids. The grid has n_split splits of
// `span` positions a row (span a multiple of 32, n_split * span >= pps *
// ps); ws_ml [B*H*n_split*2] and ws_acc [B*H*n_split*D] fp32 are the
// partials' workspace, tickets [B*H] int32 zero before the launch and after
// it. Returns the CUDA error code of the launch (0 on success).
extern "C" int ds_paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                         const float* k_scales, const float* v_scales, void* o,
                                         const int* lengths, const int* tables, int B, int H,
                                         int P, int ps, int pps, int D, int dtype, int kv_mode,
                                         long long q_sb, long long q_sh, float scale,
                                         int n_split, int span, float* ws_ml, float* ws_acc,
                                         int* tickets, void* stream) {
  if (n_split < 1 || span < kTile || span % kTile ||
      (long long)n_split * span < (long long)pps * ps)
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, o, lengths, tables, B, H, P, ps, pps,
               q_sb, q_sh, scale, n_split, span, ws_ml, ws_acc, tickets,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case ds::kF32: return dispatch_dim<float>(D, kv_mode, a);
    case ds::kBF16: return dispatch_dim<__nv_bfloat16>(D, kv_mode, a);
    case ds::kF16: return dispatch_dim<__half>(D, kv_mode, a);
    default: return cudaErrorInvalidValue;
  }
}
