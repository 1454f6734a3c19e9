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
// What bounds it on the H100: the bytes of K and V it must read,
// 2 * B * H * len * Dh * sizeof(dtype); its flops (4 * Dh per position) are
// far below the fp32 rate, and the tensor cores buy nothing for one query row
// (4 Dh flops per 4 Dh bytes in bf16). At GPT-2-125M decode shapes (B4, H12,
// len 544, Dh 64, bf16) that is 6.7 MB, about 2 us at 3.35 TB/s. A block per
// (b, h) walking its cache serially gave 48 blocks for 132 SMs and left the
// kernel bound by one block's latency; so the cache is split.
//
// Work split (split-KV, one launch). The grid is (B * H, n_split): block
// (bh, s) owns cache positions [s * span, (s + 1) * span), the wrapper
// choosing n_split and span from S and the SM count alone (it never reads the
// lengths: decode_attention.py split_plan; at the B4 H12 S640 row, 5 splits
// of 128 for 240 blocks). A split wholly at or past its row's length is
// skipped, never masked: a masked position would add exp(-1e30 - (-1e30)) = 1
// to l, and a row of length 0 would return the mean of V. Inside a split the
// block streams 32-position tiles of K and V through a double-buffered
// shared ring of 16-byte cp.async copies (the next tile in flight while this
// one is scored), rows padded so that a row's stride is 4 mod 8 16-byte
// slots. Warp w takes positions 8w .. 8w + 7 of each tile: four lanes score
// one position (16-byte reads of the interleaved chunks g, g + 4, ...; two
// shuffles sum them), and each warp keeps its own fp32 (m, l, acc); P V reads
// V rows as 16-byte vectors, a lane owning one chunk of a row (rows r, r +
// 32 / chunks, ... of the warp's eight). The four warps' states merge in
// shared memory into the split's partial (m, l, acc[Dh]).
//
// Merge in the same launch: a row whose length falls in one split writes its
// output directly. Otherwise each split writes its partial to a workspace,
// fences, and takes a ticket (atomicAdd) counting the row's non-empty splits;
// the last to arrive merges all partials in split order (so a re-run is
// bitwise equal, whichever block is last) and resets the ticket to 0. The
// wrapper allocates the workspace and the zeroed tickets once per device and
// shape; the kernel allocates nothing.

#include "common.cuh"
#include "tc_tile.cuh"

namespace {

using ds::tc::cp_async16;
using ds::tc::cp_async_commit;
using ds::tc::cp_async_wait;
using ds::tc::smem_u32;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                   // positions per ring tile
constexpr int kPerWarp = kTile / kWarps;    // positions a warp scores per tile
constexpr int kStages = 2;

// Shared geometry of one [kTile][Dh] tile of T: C 16-byte chunks a row, rows
// kSlots slots apart (4 mod 8: the eight lanes of a quarter-warp, two
// positions x four chunks, hit eight distinct slots); RPI rows a warp's
// 16-byte V load covers.
template <typename T, int D> struct Geo {
  static constexpr int V = ds::Vec16<T>::n;
  static constexpr int C = D / V;
  static constexpr int kSlots = C + ((12 - C % 8) % 8);
  static constexpr int row = kSlots * 16;
  static constexpr int tile = kTile * row;
  static constexpr int stage = 2 * tile;  // K then V
  static constexpr int bytes = kStages * stage;
  static constexpr int RPI = C >= 32 ? 1 : 32 / C;
  static_assert(C % 4 == 0 && kSlots % 8 == 4, "four lanes a position, slots 4 mod 8");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, const int* __restrict__ lengths, int scalar_len, int H,
                    int S, long long q_sb, long long q_sh, float scale, int span,
                    float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                    int* __restrict__ tickets) {
  using G = Geo<T, D>;
  constexpr int V = G::V, C = G::C, RPI = G::RPI, CPL = C / 4;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(16) float sq[D];
  __shared__ float sacc[kWarps][RPI * D];
  __shared__ float sm[kWarps], sl[kWarps];
  __shared__ int s_last;

  const int bh = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int len = lengths != nullptr ? lengths[b] : scalar_len;
  len = min(max(len, 0), S);
  const int n_ne = (len + span - 1) / span;  // the splits holding a position below len
  T* ob = o + (long long)bh * D;
  if (split >= n_ne) {  // wholly past the length: skipped (split 0 of a length-0 row writes 0)
    if (split == 0)
      for (int d = tid; d < D; d += kThreads) ob[d] = ds::from_float<T>(0.f);
    return;
  }
  const int p0 = split * span, p1 = min(p0 + span, len);
  const int n_tiles = (p1 - p0 + kTile - 1) / kTile;
  const T* kb = k + (long long)bh * S * D;
  const T* vb = v + (long long)bh * S * D;
  const uint32_t base = smem_u32(ring);

  auto load = [&](int t) {  // tile t of the split into stage t % kStages; rows past p1 zero
    const int t0 = p0 + t * kTile;
    const uint32_t st = base + (t % kStages) * G::stage;
    for (int idx = tid; idx < kTile * C; idx += kThreads) {
      const int r = idx / C, c = idx % C;
      const bool in = t0 + r < p1;
      const long long off = (long long)(in ? t0 + r : p0) * D + c * V;
      cp_async16(st + r * G::row + c * 16, kb + off, in);
      cp_async16(st + G::tile + r * G::row + c * 16, vb + off, in);
    }
  };
  load(0);
  cp_async_commit();

  const T* qb = q + b * q_sb + h * q_sh;
  for (int d = tid; d < D; d += kThreads) sq[d] = ds::to_float(qb[d]) * scale;
  __syncthreads();
  // lane = 4 * (position in the warp's eight) + g; g scores chunks g, g + 4, ...
  const int g = lane & 3, pw = lane >> 2;
  float qr[CPL][V];
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int u = 0; u < V; ++u) qr[i][u] = sq[(g + 4 * i) * V + u];
  // P V: lane (r, c) owns chunk c of the warp's rows r, r + RPI, ...
  const int vr = lane / C, vc = lane % C;
  float m = ds::kNegInf, l = 0.f, acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const unsigned char* st = ring + (t % kStages) * G::stage;
    const int nv = min(kTile, p1 - (p0 + t * kTile)) - warp * kPerWarp;  // this warp's valid
    if (nv > 0) {  // warp-uniform; position 0 of the warp is valid, so m_new is finite
      const unsigned char* krow = st + (warp * kPerWarp + pw) * G::row;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float x[V];
        ds::load16<T>(reinterpret_cast<const T*>(krow + (g + 4 * i) * 16), x);
#pragma unroll
        for (int u = 0; u < V; ++u) dot = fmaf(qr[i][u], x[u], dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const bool valid = pw < nv;
      const float m_new = fmaxf(m, ds::warp_max(valid ? dot : ds::kNegInf));
      const float alpha = expf(m - m_new);
      const float p = valid ? expf(dot - m_new) : 0.f;
      l = alpha * l + ds::warp_sum(g == 0 ? p : 0.f);
      m = m_new;
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kPerWarp; jj += RPI) {
        const int j = jj + vr;
        const float pj = __shfl_sync(0xffffffffu, p, 4 * min(j, kPerWarp - 1));
        if (vr < RPI && j < nv) {
          float x[V];
          ds::load16<T>(reinterpret_cast<const T*>(st + G::tile + (warp * kPerWarp + j) * G::row +
                                                   vc * 16), x);
#pragma unroll
          for (int u = 0; u < V; ++u) acc[u] = fmaf(pj, x[u], acc[u]);
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
    for (int u = 0; u < V; ++u) sacc[warp][vr * D + vc * V + u] = acc[u];
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* lengths,
                   int scalar_len, int B, int H, int S, long long q_sb, long long q_sh,
                   float scale, int n_split, int span, float* ws_ml, float* ws_acc,
                   int* tickets, cudaStream_t stream) {
  constexpr int smem = Geo<T, D>::bytes;
  static ds::SmemOptIn opt;  // once per device and instance
  if (const cudaError_t err = opt.set(decode_split_kernel<T, D>, smem)) return err;
  decode_split_kernel<T, D><<<dim3(B * H, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lengths, scalar_len, H, S, q_sb, q_sh, scale, span, ws_ml, ws_acc,
      tickets);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, void* o,
                         const int* lengths, int scalar_len, int B, int H, int S,
                         long long q_sb, long long q_sh, float scale, int n_split, int span,
                         float* ws_ml, float* ws_acc, int* tickets, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, lengths, scalar_len, B, H, S, q_sb, q_sh, scale, n_split,
                         span, ws_ml, ws_acc, tickets, stream);
  if (D == 96)
    return launch<T, 96>(q, k, v, o, lengths, scalar_len, B, H, S, q_sb, q_sh, scale, n_split,
                         span, ws_ml, ws_acc, tickets, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, lengths, scalar_len, B, H, S, q_sb, q_sh, scale, n_split,
                          span, ws_ml, ws_acc, tickets, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, 1, H, Dh] given by element strides (batch, head; last dimension
// contiguous); k/v cache [B, H, S, Dh] contiguous and 16-byte aligned; o
// [B, 1, H, Dh] contiguous in q's dtype. `lengths` is a device int32 [B]
// vector, or null to use `scalar_len` for every row. The grid has n_split
// splits of `span` positions a row (span a multiple of 32, n_split * span >=
// S); ws_ml [B*H*n_split*2] and ws_acc [B*H*n_split*Dh] fp32 are the
// partials' workspace, tickets [B*H] int32 zero before the launch and after
// it. Returns the CUDA error code of the launch (0 on success).
extern "C" int ds_decode_attention(const void* q, const void* k, const void* v, void* o,
                                   const int* lengths, int scalar_len, int B, int H, int S,
                                   int D, int dtype, long long q_sb, long long q_sh,
                                   float scale, int n_split, int span, float* ws_ml,
                                   float* ws_acc, int* tickets, void* stream) {
  if (n_split < 1 || span < kTile || span % kTile || (long long)n_split * span < S)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ds::kF32:
      return dispatch_dim<float>(D, q, k, v, o, lengths, scalar_len, B, H, S, q_sb, q_sh,
                                 scale, n_split, span, ws_ml, ws_acc, tickets, st);
    case ds::kBF16:
      return dispatch_dim<__nv_bfloat16>(D, q, k, v, o, lengths, scalar_len, B, H, S, q_sb,
                                         q_sh, scale, n_split, span, ws_ml, ws_acc, tickets, st);
    case ds::kF16:
      return dispatch_dim<__half>(D, q, k, v, o, lengths, scalar_len, B, H, S, q_sb, q_sh,
                                  scale, n_split, span, ws_ml, ws_acc, tickets, st);
    default:
      return cudaErrorInvalidValue;
  }
}
