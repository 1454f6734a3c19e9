// Quantized-weight matrix products at decode rows (1-8 rows of x, fp32,
// bf16 or fp16) on Hopper's tensor cores (sm_90a, mma.sync); plain C
// interface.
//
// Replaces, for x of at most 8 rows (a decode step of up to 8 slots, a
// single-token draft), the TPU kernels of
// deepspeed_tpu/ops/pallas/int8_matmul.py: _kernel (B6, int8, reached from
// int8_matmul :246) and _kernel4 (B7, nibble-packed int4, from int4_matmul
// :218). Same function: out = x @ W with W[d, f] = float(q[d, f]) * s[(d F
// + f) / group] in fp32, x widened to fp32, fp32 sums, one rounding to x's
// dtype. For B7, byte j of a packed row holds column j in its low nibble and
// column j + F/2 in its high nibble. The layouts taken: groups of a
// multiple of 64 columns that do not cross rows (F % group == 0), D % 64 ==
// 0, F % 64 == 0 (int8) or F % 128 == 0 (int4): every layout that
// models/gpt.quantize_for_inference gives a preset at groups 64 and 128.
// Other layouts keep the CUDA-core kernel of csrc/int8_matmul.cu
// (ops/cuda/int8_matmul.py qmm_route picks).
//
// What bounds it on the H100: a decode projection of GPT-2-125M or
// gpt2-350m holds 0.3-4.2 MB of weights, 0.1-1.3 us at 3.35 TB/s, and its
// products are a few flops a byte, so latency bounds it: by Little's law
// about 3 MB must be in flight to fill the card, nearly the whole weight.
// So every warp requests all the weight bytes it will use (two 32-row slabs,
// 4 KB) in registers before it computes, and the grid spreads the weight
// evenly over the SMs. The products leave the CUDA cores: at 8 rows int8
// needs 8 fp32 FMAs a weight byte and int4 16, against about 10 a byte that
// the card's fp32 rate allows at its memory rate.
//
// Arithmetic (every dtype): out^T = W^T x^T on mma.sync m16n8k16 with fp32
// accumulators, x's 8 rows (rows past M zero) the n8 side. The A operand is
// the weight's exact integers (int8 and int4 are exact in bf16); the B
// operand is v = x s_g (x times the scale of the tile's group, per row of
// D) rounded once in fp32 and cut by truncation into three exact bf16 parts
// (tc_tile.cuh split3: hi + mid + lo == v), three mmas against one A. That
// is the fp32 tensor-core kernel's arithmetic (qmatmul_fp32_split_ref models
// it), and for 16-bit x the same: x s is an fp32 product of x widened.
//
// Loads, and no shuffle: a warp covers 64 q bytes of a row (int8: 64
// output columns; int4: 64 low-nibble columns and the 64 high-nibble
// columns F/2 further) and 32 rows of D a slab. Lane (g = lane / 4, t =
// lane % 4) loads 8 bytes, columns 8 g .. 8 g + 7, of rows 2t, 2t + 1, 2t +
// 8, 2t + 9 and the same 16 rows further: the eight lanes of a row read 64
// neighbouring bytes. Those are exactly the A fragment elements the lane
// owns if the m index g of mma j stands for column 8 g + 2 j, g + 8 for 8 g
// + 2 j + 1, and k runs along D in order: a fragment register pairs two
// rows of D at one column, built from two loaded words by byte permutes (the
// biased byte under the exponent of 2^23, one subtraction, the top halves of
// two floats). The sum over D and the columns' order in the tile are free,
// so nothing moves between lanes. A warp's 64 columns lie in one group, so
// the B fragment of a k16 step is one group's x s: lane (g, t) holds x row
// g at its own four rows of D, times their four scales.
//
// Work split: a block of `warps` warps owns one 64-byte column tile and one
// chunk of D; each warp `per_warp` consecutive slabs of it. The warps add
// their sums in shared memory in warp order, and the `cluster` blocks of one
// column tile (a thread block cluster along D) push their block sums into
// the first block's shared memory (distributed shared memory), arrive at
// the cluster barrier and leave; the first block waits there once, adds the
// sums in rank order and stores the tile. One launch, no atomics, no scratch
// in device memory: a result is bitwise repeatable. The plan is a pure
// function of the shapes (int8_matmul.py decode_plan).

#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "tc_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileBytes = 64;  // q bytes of a row a warp covers (8 lanes x 8 bytes)
constexpr int kSlab = 32;       // rows of D a warp's lanes load at once (two k16 steps)
constexpr int kBatch = 2;       // slabs a warp requests before it computes
constexpr int kRows = 8;        // rows of x: mma's n8
constexpr int kMaxWarps = 8;
constexpr int kMaxCluster = 8;  // blocks along D in one cluster (the portable maximum)

// The cluster barrier in two halves: arrive (release: this thread's earlier
// writes, distributed shared memory included, are seen by whoever waits),
// or arrive relaxed (nothing to publish), and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte u of two biased words (rows r and r + 1 of D, one column) as an
// exact bf16 pair (row r in the low half): the biased value under the
// exponent of 2^23, less 2^23 and the bias, is an integer of at most 8
// bits, which is its float's top 16 bits.
__device__ __forceinline__ uint32_t int_pair(uint32_t t0, uint32_t t1, int u, float bias) {
  const float f0 = __uint_as_float(__byte_perm(t0, 0x4B000000u, 0x7540u | u)) - bias;
  const float f1 = __uint_as_float(__byte_perm(t1, 0x4B000000u, 0x7540u | u)) - bias;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// Two neighbouring elements of an x row as fp32.
template <typename T> __device__ __forceinline__ float2 load_x2(const T* p);
template <> __device__ __forceinline__ float2 load_x2<float>(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
template <> __device__ __forceinline__ float2 load_x2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <> __device__ __forceinline__ float2 load_x2<__half>(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

template <typename T> __device__ __forceinline__ void store_x2(T* p, float a, float b);
template <> __device__ __forceinline__ void store_x2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store_x2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                    float b) {
  *reinterpret_cast<uint32_t*>(p) = ds::tc::pack2<__nv_bfloat16>(a, b);
}
template <> __device__ __forceinline__ void store_x2<__half>(__half* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = ds::tc::pack2<__half>(a, b);
}

// NS column sets (int8: 1; int4: the low and the high nibbles), each 64
// output columns in one group
template <typename T, int BITS>
__global__ void __launch_bounds__(kMaxWarps * 32)
qmatmul_decode_kernel(const T* __restrict__ x, long long ldx, const int8_t* __restrict__ q,
                      const float* __restrict__ s, T* __restrict__ out, int M, int D, int F,
                      int group, int per_warp) {
  constexpr int NS = BITS == 4 ? 2 : 1;
  constexpr int kCols = NS * kTileBytes;  // output columns of a tile
  constexpr float kBias = BITS == 8 ? 8388736.0f : 8388616.0f;  // 2^23 + 128 (int4: + 8)
  constexpr int kPairs = kRows * kCols / 2;  // output pairs of a tile
  __shared__ __align__(16) float red[kMaxWarps][kRows][kCols];
  // the first block's: each block's sums of the tile, [cluster][kPairs]
  extern __shared__ __align__(16) float2 part[];

  // every block of the cluster has started before any writes into the
  // first one's shared memory: arrive now, wait before the pushes
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = gridDim.z, rank = blockIdx.z;
  const int warps = blockDim.x >> 5, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int Fq = BITS == 4 ? F / 2 : F;
  const int c0 = blockIdx.x * kTileBytes;  // the tile's first q byte of a row
  const int gpr = F / group;               // groups per row
  int grp[NS];
  grp[0] = c0 / group;
  if constexpr (NS == 2) grp[NS - 1] = (Fq + c0) / group;
  const int n_slabs = D / kSlab;
  const int slab0 = (rank * warps + warp) * per_warp;  // the warp's first slab
  const bool live_row = g < M;
  const T* xrow = x + (long long)g * ldx;
  const int8_t* qcol = q + c0 + 8 * g;

  float acc[NS * 4][4];
#pragma unroll
  for (int j = 0; j < NS * 4; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[j][u] = 0.f;

  // lane (g, t)'s row i (0-7) of a slab: 2t, 2t + 1, 2t + 8, 2t + 9, then
  // the same 16 further (k indices 2t, 2t + 1, 2t + 8, 2t + 9 of two k16 steps)
  auto row_of = [&](int i) { return 16 * (i >> 2) + 8 * ((i >> 1) & 1) + 2 * t + (i & 1); };

  for (int b = 0; b < per_warp; b += kBatch) {
    // request every byte of the batch first: the weight words, x's pairs
    // and the scales (zeros past the warp's slabs, past D, or past M)
    uint2 w[kBatch][8];
    float2 xv[kBatch][4];
    float sc[kBatch][NS][8];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int slab = slab0 + b + k;
      const bool live = b + k < per_warp && slab < n_slabs;
      const long long d0 = (long long)slab * kSlab;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        w[k][i] = make_uint2(0u, 0u);
        if (live) w[k][i] = __ldg(reinterpret_cast<const uint2*>(qcol + (d0 + row_of(i)) * Fq));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[k][i] = make_float2(0.f, 0.f);
        if (live && live_row) xv[k][i] = load_x2<T>(xrow + d0 + row_of(2 * i));
      }
#pragma unroll
      for (int h = 0; h < NS; ++h)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sc[k][h][i] = live ? __ldg(s + (d0 + row_of(i)) * gpr + grp[h]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (!(b + k < per_warp && slab0 + b + k < n_slabs)) continue;
      // the weights' biased words: int8 bytes + 128; int4 nibbles + 8 (low
      // nibbles, then high), per row i and word
      uint32_t bw[NS][8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t lo = w[k][i].x, hi = w[k][i].y;
        if constexpr (BITS == 8) {
          bw[0][i][0] = lo ^ 0x80808080u;
          bw[0][i][1] = hi ^ 0x80808080u;
        } else {
          const uint32_t tl = lo ^ 0x88888888u, th = hi ^ 0x88888888u;
          bw[0][i][0] = tl & 0x0F0F0F0Fu;
          bw[0][i][1] = th & 0x0F0F0F0Fu;
          bw[NS - 1][i][0] = (tl >> 4) & 0x0F0F0F0Fu;
          bw[NS - 1][i][1] = (th >> 4) & 0x0F0F0F0Fu;
        }
      }
#pragma unroll
      for (int step = 0; step < 2; ++step) {  // the slab's two k16 steps
#pragma unroll
        for (int h = 0; h < NS; ++h) {
          // B: x s of this set's group at the lane's four rows, three parts
          const int i0 = 4 * step;
          const float2 xa = xv[k][2 * step], xb = xv[k][2 * step + 1];
          uint32_t bh[2], bm[2], bl[2];
          ds::tc::split3(__fmul_rn(xa.x, sc[k][h][i0]), __fmul_rn(xa.y, sc[k][h][i0 + 1]),
                         bh[0], bm[0], bl[0]);
          ds::tc::split3(__fmul_rn(xb.x, sc[k][h][i0 + 2]), __fmul_rn(xb.y, sc[k][h][i0 + 3]),
                         bh[1], bm[1], bl[1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // mma j: columns 8 g + 2 j (m g), + 1 (m g + 8)
            const int wd = j >> 1, u = (2 * j) & 3;
            uint32_t a[4];
            a[0] = int_pair(bw[h][i0][wd], bw[h][i0 + 1][wd], u, kBias);
            a[1] = int_pair(bw[h][i0][wd], bw[h][i0 + 1][wd], u + 1, kBias);
            a[2] = int_pair(bw[h][i0 + 2][wd], bw[h][i0 + 3][wd], u, kBias);
            a[3] = int_pair(bw[h][i0 + 2][wd], bw[h][i0 + 3][wd], u + 1, kBias);
            float(&d)[4] = acc[4 * h + j];
            mma_bf16(d, a, bh[0], bh[1]);
            mma_bf16(d, a, bm[0], bm[1]);
            mma_bf16(d, a, bl[0], bl[1]);
          }
        }
      }
    }
  }

  // the warp's sums: mma j of set h holds rows 2t, 2t + 1 of x at columns
  // 64 h + 8 g + 2 j (d0, d1) and + 1 (d2, d3)
#pragma unroll
  for (int h = 0; h < NS; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = kTileBytes * h + 8 * g + 2 * j;
      const float(&d)[4] = acc[4 * h + j];
      *reinterpret_cast<float2*>(&red[warp][2 * t][c]) = make_float2(d[0], d[2]);
      *reinterpret_cast<float2*>(&red[warp][2 * t + 1][c]) = make_float2(d[1], d[3]);
    }
  __syncthreads();
  // the block's sum over its warps, in warp order, pushed into slot `rank`
  // of the first block's part
  cluster_wait();
  float2* const lead = cluster.map_shared_rank(part, 0) + rank * kPairs;
  for (int p = tid; p < kPairs; p += blockDim.x) {
    float2 v = reinterpret_cast<const float2*>(&red[0][0][0])[p];
    for (int wp = 1; wp < warps; ++wp) {
      const float2 o = reinterpret_cast<const float2*>(&red[wp][0][0])[p];
      v.x += o.x;
      v.y += o.y;
    }
    lead[p] = v;
  }
  cluster_arrive();
  if (rank != 0) return;  // its sums are the first block's now
  cluster_wait();
  // the first block adds the cluster's sums in rank order and stores the tile
  for (int p = tid; p < kPairs; p += blockDim.x) {
    const int row = 2 * p / kCols, c = 2 * p % kCols;
    if (row >= M) continue;
    float2 v = part[p];
    for (int r = 1; r < cs; ++r) {
      const float2 o = part[r * kPairs + p];
      v.x += o.x;
      v.y += o.y;
    }
    const int col = c < kTileBytes ? c0 + c : Fq + c0 + c - kTileBytes;
    store_x2<T>(out + (long long)row * F + col, v.x, v.y);
  }
}

template <typename T, int BITS>
cudaError_t launch(const void* x, long long ldx, const void* q, const float* s, void* out,
                   int M, int D, int F, int group, int warps, int per_warp, int cluster,
                   cudaStream_t stream) {
  const int Fq = BITS == 4 ? F / 2 : F;
  // the first block's slots for the cluster's sums (kPairs float2 a block)
  const int part = cluster * kRows * (BITS == 4 ? 2 : 1) * kTileBytes / 2 * 8;
  static ds::SmemOptIn opt;  // once per device and instance
  if (const cudaError_t err = opt.set(qmatmul_decode_kernel<T, BITS>,
                                      kMaxCluster * kRows * 2 * kTileBytes / 2 * 8))
    return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(Fq / kTileBytes, 1, cluster);
  config.blockDim = dim3(32 * warps);
  config.dynamicSmemBytes = part;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, qmatmul_decode_kernel<T, BITS>, static_cast<const T*>(x), ldx,
      static_cast<const int8_t*>(q), s, static_cast<T*>(out), M, D, F, group, per_warp);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bits(int bits, const void* x, long long ldx, const void* q, const float* s,
                          void* out, int M, int D, int F, int group, int warps, int per_warp,
                          int cluster, cudaStream_t st) {
  if (bits == 8)
    return launch<T, 8>(x, ldx, q, s, out, M, D, F, group, warps, per_warp, cluster, st);
  if (bits == 4)
    return launch<T, 4>(x, ldx, q, s, out, M, D, F, group, warps, per_warp, cluster, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M, D] with row stride ldx (elements; last dimension contiguous, rows
// 16-byte aligned) in `dtype` 0 (fp32), 1 (bf16) or 2 (fp16), 1 <= M <= 8;
// q int8 [D, F] (bits 8) or packed [D, F / 2] (bits 4), contiguous and
// 16-byte aligned; s fp32 [D * F / group]; out [M, F] contiguous in x's
// dtype. The layouts taken: D % 64 == 0, group % 64 == 0, F % group == 0,
// F % 64 == 0 (int8) or F % 128 == 0 (int4). The plan: a block of `warps`
// warps a 64-byte column tile and a chunk of D, each warp `per_warp` slabs
// of 32 rows; `cluster` blocks along D (warps * per_warp * cluster * 32 >=
// D). Returns the CUDA error code of the launch (0 on success).
extern "C" int ds_quant_matmul_decode(const void* x, long long ldx, const void* q,
                                      const float* s, void* out, int M, int D, int F, int group,
                                      int warps, int per_warp, int cluster, int bits, int dtype,
                                      void* stream) {
  const int elt = dtype == ds::kF32 ? 4 : 2;
  const bool layout = D > 0 && D % 64 == 0 && group > 0 && group % 64 == 0 && F > 0 &&
                      F % group == 0 && F % (bits == 4 ? 128 : 64) == 0;
  const bool aligned = (ldx * elt) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (M < 1 || M > kRows || !layout || !aligned || warps < 1 || warps > kMaxWarps ||
      per_warp < 1 || cluster < 1 || cluster > kMaxCluster ||
      (long long)warps * per_warp * cluster * kSlab < D)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ds::kF32:
      return dispatch_bits<float>(bits, x, ldx, q, s, out, M, D, F, group, warps, per_warp,
                                  cluster, st);
    case ds::kBF16:
      return dispatch_bits<__nv_bfloat16>(bits, x, ldx, q, s, out, M, D, F, group, warps,
                                          per_warp, cluster, st);
    case ds::kF16:
      return dispatch_bits<__half>(bits, x, ldx, q, s, out, M, D, F, group, warps, per_warp,
                                   cluster, st);
    default:
      return cudaErrorInvalidValue;
  }
}
