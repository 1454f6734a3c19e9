// Quantized-weight matrix products for Hopper (sm_90a), plain C interface:
// out[M, F] = x[M, D] @ W with W stored as int8 (B6) or as nibble-packed
// int4 (B7) plus one fp32 scale per `group` consecutive weights.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/int8_matmul.py:
// int8_matmul / _kernel (B6) and int4_matmul / _kernel4 (B7). Same function:
// W[d, f] = float(q[d, f]) * s[(d * F + f) / group], the scales covering
// row-major runs of the flattened [D, F] weight (a run may cross rows when
// F % group != 0); x (fp32, bf16 or fp16) is widened to fp32, the products
// accumulate in fp32, and the output is rounded once to x's dtype. For B7,
// q4[D, F/2] holds column j in the low nibble of byte j and column j + F/2
// in its high nibble, each sign-extended by (nib ^ 8) - 8, and the scale of
// column j + F/2 is that of its unpacked flat index. Each packed byte is
// read once and feeds both output halves, as in _kernel4.
//
// What bounds it on the H100: the weight bytes, D * F (int8) or D * F / 2
// (int4), plus 4 * D * F / group of scales; at decode (M <= 8) the flops are
// a few per byte. A decode projection of GPT-2-125M or gpt2-350m holds
// 0.3-4 MB of weights, about a microsecond at 3.35 TB/s, so what bounds the
// kernel in practice is latency: every weight row has to be requested at
// once, and a second launch or a round trip through device memory for the
// split sums costs as much as the bytes.
//
// Work split: a block of 8 warps owns a tile of q columns, TM rows of x
// (TM = 1, 2, 4 or 8, the smallest that covers M; more rows take more
// blocks) and one chunk of D. A lane loads 4 consecutive q bytes of a row;
// `lanes_per_row` lanes (32, 16 or 8) cover a row of the tile, so a warp
// takes 1, 2 or 4 rows at once and a narrow matrix still spreads over
// enough blocks. The blocks of one (column tile, row tile) form a thread
// block cluster of up to 8 along D. A block stages its x rows in shared
// memory as fp32, 256 D-rows at a time; each lane loads a batch of rows'
// bytes (and their scales) before it dequantizes them in registers (a byte
// permute builds each float, no int-to-float conversion) and accumulates TM
// x 4 (x 2 for int4) fp32 sums. The lanes that share columns add their sums
// by a shuffle butterfly, the 8 warps in a fixed tree through shared
// memory, and the cluster's blocks through distributed shared memory, each
// block a share of the tile, in rank order. One launch, no scratch in
// device memory, no atomics: a result is bitwise repeatable.
//
// Which products still come here (ops/cuda/int8_matmul.py qmm_route): only
// layouts that neither tensor-core kernel takes. Decode rows (1-8) in every
// dtype take csrc/int8_matmul_decode.cu where groups are whole 64-column
// panels that do not cross rows and D is in 64-row steps; 9-256 rows take
// csrc/int8_matmul_tc.cu in its layouts (fp32 x: groups of whole 64-column
// panels; bf16 / fp16 x: also groups that divide 64). So this kernel serves
// groups that cross rows (F % group != 0), groups that split a 64-column
// panel (96; at decode rows and for fp32 x also 8-32), D off 64-row steps,
// and F off whole panels: no preset's layout at groups 64 and 128.

#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4 * 32;     // q bytes of the widest tile: 4 per lane
constexpr int kStage = 256;       // rows of x staged in shared memory at a time
constexpr int kMaxCluster = 8;    // blocks along D in one cluster (the portable maximum)

template <typename T, int TM, int BITS>
__global__ void __launch_bounds__(kThreads)
qmatmul_kernel(const T* __restrict__ x, long long ldx, const int8_t* __restrict__ q,
               const float* __restrict__ s, T* __restrict__ out, int M, int D, int F,
               int group, int chunk, int lanes_per_row) {
  constexpr int NH = BITS == 4 ? 2 : 1;       // output columns per q byte
  constexpr int WMAX = NH * kCols;            // output columns of the widest tile
  constexpr int kBatch = BITS == 4 ? 8 : 16;  // rows a lane loads before it computes
  __shared__ float xs[TM][kStage];
  __shared__ __align__(16) float red[kWarps / 2][TM][WMAX];

  // one cluster spans grid z (the D chunks), so its rank is blockIdx.z
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = gridDim.z, rank = blockIdx.z;

  const int Fq = BITS == 4 ? F / 2 : F;  // q bytes per row
  const int tile = 4 * lanes_per_row;    // q bytes of this tile
  const int rpw = 32 / lanes_per_row;    // rows a warp takes at once
  const int c0 = blockIdx.x * tile;
  const int m0 = blockIdx.y * TM;
  const int d0 = blockIdx.z * chunk;
  const int dn = max(0, min(chunk, D - d0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / lanes_per_row;            // which of the warp's rows
  const int col = c0 + 4 * (lane % lanes_per_row);  // the lane's first q column
  // 4-byte loads need 4-aligned rows; one scale per 4-column run needs
  // whole groups in a row and runs that never cross a group
  const bool vec = Fq % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  const bool run_scale = F % group == 0 && group % 4 == 0 && Fq % 4 == 0;
  const int groups_per_row = run_scale ? F / group : 0;
  int scale_col[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) scale_col[h] = run_scale ? (col + h * Fq) / group : 0;

  float acc[NH][TM][4];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[h][m][u] = 0.f;

  const int row_step = kWarps * rpw;  // rows between a lane's consecutive rows
  for (int s0 = 0; s0 < dn; s0 += kStage) {
    const int sn = min(kStage, dn - s0);
    __syncthreads();  // the previous stage's readers are done
#pragma unroll
    for (int m = 0; m < TM; ++m)
      for (int i = threadIdx.x; i < sn; i += kThreads)
        xs[m][i] = m0 + m < M ? ds::to_float(x[(long long)(m0 + m) * ldx + d0 + s0 + i]) : 0.f;
    __syncthreads();
    if (col >= Fq) continue;
    for (int b0 = warp * rpw + sub; b0 < sn; b0 += row_step * kBatch) {
      unsigned words[kBatch];
      float sc[kBatch][NH];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int dl = b0 + r * row_step;
        words[r] = 0u;  // decodes to zeros
#pragma unroll
        for (int h = 0; h < NH; ++h) sc[r][h] = 0.f;
        if (dl < sn) {
          const long long d = d0 + s0 + dl;
          const int8_t* qr = q + d * Fq + col;
          if (vec) {
            words[r] = *reinterpret_cast<const unsigned*>(qr);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (col + u < Fq)
                words[r] |= static_cast<unsigned>(static_cast<uint8_t>(qr[u])) << (8 * u);
          }
          if (run_scale) {
#pragma unroll
            for (int h = 0; h < NH; ++h) sc[r][h] = s[d * groups_per_row + scale_col[h]];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int dl = b0 + r * row_step;
        if (dl >= sn) continue;
        float w[NH][4];
        ds::dequant_word<BITS>(words[r], w);
        if (run_scale) {
#pragma unroll
          for (int h = 0; h < NH; ++h)
#pragma unroll
            for (int u = 0; u < 4; ++u) w[h][u] *= sc[r][h];
        } else {
          const long long flat = (long long)(d0 + s0 + dl) * F + col;
#pragma unroll
          for (int h = 0; h < NH; ++h)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (col + u < Fq) w[h][u] *= s[(flat + u + h * Fq) / group];
        }
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float xv = xs[m][dl];
#pragma unroll
          for (int h = 0; h < NH; ++h)
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[h][m][u] = fmaf(xv, w[h][u], acc[h][m][u]);
        }
      }
    }
  }

  // the lanes of a warp that share columns add their sums: a shuffle
  // butterfly (addition commutes, so every lane gets the same bits)
  for (int off = lanes_per_row; off < 32; off <<= 1)
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[h][m][u] += __shfl_xor_sync(0xffffffffu, acc[h][m][u], off);
  const bool writer = sub == 0;
  const int wc = 4 * (lane % lanes_per_row);  // the lane's first column in the tile

  // warps [half, 2 * half) hand their sums to warps [0, half): a fixed tree
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half >>= 1) {
    if (writer && warp >= half && warp < 2 * half) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int m = 0; m < TM; ++m)
          *reinterpret_cast<float4*>(&red[warp - half][m][h * tile + wc]) =
              make_float4(acc[h][m][0], acc[h][m][1], acc[h][m][2], acc[h][m][3]);
    }
    __syncthreads();
    if (writer && warp < half) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float4 v = *reinterpret_cast<const float4*>(&red[warp][m][h * tile + wc]);
          acc[h][m][0] += v.x;
          acc[h][m][1] += v.y;
          acc[h][m][2] += v.z;
          acc[h][m][3] += v.w;
        }
    }
    __syncthreads();
  }
  // warp 0 holds this block's sums over its chunk: publish them to the cluster
  if (writer && warp == 0) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int m = 0; m < TM; ++m)
        *reinterpret_cast<float4*>(&red[0][m][h * tile + wc]) =
            make_float4(acc[h][m][0], acc[h][m][1], acc[h][m][2], acc[h][m][3]);
  }
  cluster.sync();
  // each block adds its share of the tile over the cluster's chunks, in rank order
  const int width = NH * tile;
  for (int e = rank * kThreads + threadIdx.x; e < TM * width; e += cs * kThreads) {
    const int m = e / width, c = e % width;
    const int h = c / tile, qc = c0 + c % tile;
    if (m0 + m >= M || qc >= Fq) continue;
    float v = 0.f;
    for (int r = 0; r < cs; ++r) v += cluster.map_shared_rank(&red[0][m][c], r)[0];
    out[(long long)(m0 + m) * F + qc + h * Fq] = ds::from_float<T>(v);
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <typename T, int TM, int BITS>
cudaError_t launch(const void* x, long long ldx, const void* q, const float* s, void* out,
                   int M, int D, int F, int group, int chunk, int cluster, int lanes,
                   cudaStream_t stream) {
  const int Fq = BITS == 4 ? F / 2 : F;
  const int tile = 4 * lanes;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((Fq + tile - 1) / tile, (M + TM - 1) / TM, cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, qmatmul_kernel<T, TM, BITS>, static_cast<const T*>(x), ldx,
      static_cast<const int8_t*>(q), s, static_cast<T*>(out), M, D, F, group, chunk, lanes);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t dispatch_rows(const void* x, long long ldx, const void* q, const float* s,
                          void* out, int M, int D, int F, int group, int chunk, int cluster,
                          int lanes, cudaStream_t st) {
  if (M == 1)
    return launch<T, 1, BITS>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, lanes, st);
  if (M == 2)
    return launch<T, 2, BITS>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, lanes, st);
  if (M <= 4)
    return launch<T, 4, BITS>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, lanes, st);
  return launch<T, 8, BITS>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, lanes, st);
}

template <typename T>
cudaError_t dispatch_bits(int bits, const void* x, long long ldx, const void* q,
                          const float* s, void* out, int M, int D, int F, int group, int chunk,
                          int cluster, int lanes, cudaStream_t st) {
  if (bits == 8)
    return dispatch_rows<T, 8>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, lanes, st);
  if (bits == 4)
    return dispatch_rows<T, 4>(x, ldx, q, s, out, M, D, F, group, chunk, cluster, lanes, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M, D] with row stride ldx (elements; last dimension contiguous) in
// `dtype`; q int8 [D, F] (bits 8) or [D, F / 2] (bits 4, F even),
// contiguous; s fp32 [D * F / group], contiguous; out [M, F] contiguous in
// x's dtype. D is cut into `cluster` chunks of `chunk` rows (the last may
// be shorter), one block of a cluster each; `lanes` (32, 16 or 8) lanes
// cover a row of a block's column tile. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int ds_quant_matmul(const void* x, long long ldx, const void* q, const float* s,
                               void* out, int M, int D, int F, int group, int chunk,
                               int cluster, int lanes, int bits, int dtype, void* stream) {
  if (M < 1 || D < 1 || F < 1 || group < 1 || chunk < 1 || cluster < 1 ||
      cluster > kMaxCluster || (long long)chunk * cluster < D || (bits == 4 && F % 2 != 0) ||
      (lanes != 32 && lanes != 16 && lanes != 8))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ds::kF32:
      return dispatch_bits<float>(bits, x, ldx, q, s, out, M, D, F, group, chunk, cluster,
                                  lanes, st);
    case ds::kBF16:
      return dispatch_bits<__nv_bfloat16>(bits, x, ldx, q, s, out, M, D, F, group, chunk,
                                          cluster, lanes, st);
    case ds::kF16:
      return dispatch_bits<__half>(bits, x, ldx, q, s, out, M, D, F, group, chunk, cluster,
                                   lanes, st);
    default:
      return cudaErrorInvalidValue;
  }
}
