// Flash-attention backward's delta pass for Hopper (sm_90a), every dtype;
// plain C interface.
//
// Replaces the TPU kernel _bwd_delta_kernel of
// deepspeed_tpu/ops/pallas/flash_attention.py (_bwd, the pallas_call at
// :277): delta = rowsum(dO * O) in fp32, [B*H, T], which the dq and dk/dv
// passes read (csrc/flash_attention_bwd_tf32.cu for fp32 inputs, on the
// tensor cores as 3xTF32; csrc/flash_attention_bwd_tc.cu for bf16 / fp16).
//
// What bounds it on the H100: it reads o and dO once and writes delta (at
// the GPT-2-125M training shape B8, T512, H12, D64 in bf16 ~12.8 MB, 3.8 us
// at 3.35 TB/s; two flops an element are nothing beside): byte-bound, and a
// reduction this small needs no tensor cores. The design keeps enough bytes
// in flight to stream at that rate:
// - a row (D * elt bytes: 128 for bf16 at D 64, 192 at D 96, 256 for fp32
//   at D 64) is read with 16-byte loads by a group of G lanes, each taking
//   CPL chunks G apart, G x CPL = 8 x 1, 4 x 3 and 16 x 1 for bf16 / fp16 at
//   D 64 / 96 / 128 and 16 x 1, 8 x 3 and 32 x 1 for fp32: every lane busy,
//   no predication;
// - each thread holds R rows in flight (all their loads issued before any
//   sum: 8-12 loads of 16 bytes a thread), and a block of 256 threads covers
//   8 (32 / G) R rows of delta, so the grid fills the card's SMs several
//   blocks deep (384 blocks of 128 rows at the training shape);
// - rows are taken in delta's order ((b, h) major, t minor): the stores are
//   coalesced, and each row's reads are whole 32-byte sectors wherever it
//   lies; o and dO are read through their strides (last dimension
//   contiguous, rows 16-byte aligned).
// Each lane sums its chunks in a fixed order and the group combines by
// log2(G) shuffles, so delta is bitwise equal on a re-run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The split of a row of D elements of T over a lane group: chunks (16 bytes)
// a row, lanes a row (the largest power of two up to 32 dividing the
// chunks), chunks a lane, rows a warp at once, and rows a thread in flight.
template <typename T, int D> struct RowSplit {
  static constexpr int chunks = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int lanes = chunks % 32 == 0 ? 32 : chunks % 16 == 0 ? 16
                               : chunks % 8 == 0 ? 8 : 4;
  static constexpr int per_lane = chunks / lanes;
  static constexpr int groups = 32 / lanes;
  static constexpr int rows = per_lane == 1 ? 4 : 2;
  static constexpr int block_rows = kWarps * groups * rows;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int H, int T_, int n_rows,
                       long long o_sb, long long o_st, long long o_sh,
                       long long d_sb, long long d_st, long long d_sh) {
  using S = RowSplit<T, D>;
  constexpr int V = ds::Vec16<T>::n;  // elements a chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int li = lane % S::lanes;                       // lane within its row's group
  const int gi = warp * S::groups + lane / S::lanes;    // the group within the block
  const int r0 = blockIdx.x * S::block_rows + gi;       // its first row; then every
  constexpr int stride = kWarps * S::groups;            // `stride` rows further

  // every load of the thread's rows first (raw 16-byte chunks), then the sums
  uint4 x[S::rows][S::per_lane], y[S::rows][S::per_lane];
#pragma unroll
  for (int j = 0; j < S::rows; ++j) {
    const int r = r0 + j * stride;
#pragma unroll
    for (int c = 0; c < S::per_lane; ++c) x[j][c] = y[j][c] = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) {
      const int bh = r / T_, t = r % T_, b = bh / H, h = bh % H;
      const T* orow = o + b * o_sb + t * o_st + h * o_sh;
      const T* drow = dout + b * d_sb + t * d_st + h * d_sh;
#pragma unroll
      for (int c = 0; c < S::per_lane; ++c) {
        x[j][c] = *reinterpret_cast<const uint4*>(orow + (li + c * S::lanes) * V);
        y[j][c] = *reinterpret_cast<const uint4*>(drow + (li + c * S::lanes) * V);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < S::rows; ++j) {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < S::per_lane; ++c) {
      float a[V], d[V];
      ds::load16<T>(reinterpret_cast<const T*>(&x[j][c]), a);
      ds::load16<T>(reinterpret_cast<const T*>(&y[j][c]), d);
#pragma unroll
      for (int e = 0; e < V; ++e) sum = fmaf(a[e], d[e], sum);
    }
#pragma unroll
    for (int off = S::lanes / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int r = r0 + j * stride;
    if (li == 0 && r < n_rows) delta[r] = sum;
  }
}

struct Args {
  const void *o, *dout;
  float* delta;
  int B, H, T;
  long long o_sb, o_st, o_sh, d_sb, d_st, d_sh;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_delta(const Args& a) {
  const int n_rows = a.B * a.H * a.T;
  const int grid = (n_rows + RowSplit<T, D>::block_rows - 1) / RowSplit<T, D>::block_rows;
  flash_bwd_delta_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.H, a.T, n_rows,
      a.o_sb, a.o_st, a.o_sh, a.d_sb, a.d_st, a.d_sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const Args& a) {
  if (D == 64) return launch_delta<T, 64>(a);
  if (D == 96) return launch_delta<T, 96>(a);
  if (D == 128) return launch_delta<T, 128>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// delta = rowsum(dO * O) (the counterpart of _bwd_delta_kernel): o and dO
// [B, T, H, D] given by element strides (batch, seq, head; the last dimension
// contiguous, rows 16-byte aligned), dtype 0 (fp32), 1 (bf16) or 2 (fp16), D
// 64, 96 or 128; delta [B*H, T] fp32 contiguous. Launches one kernel on
// `stream` and returns the CUDA error code of the launch (0 on success).
extern "C" int ds_flash_attention_bwd_delta(const void* o, const void* dout, float* delta,
                                            int B, int H, int T, int D, int dtype,
                                            long long o_sb, long long o_st, long long o_sh,
                                            long long d_sb, long long d_st, long long d_sh,
                                            void* stream) {
  const Args a{o, dout, delta, B, H, T, o_sb, o_st, o_sh, d_sb, d_st, d_sh,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case ds::kF32: return dispatch_dim<float>(D, a);
    case ds::kBF16: return dispatch_dim<__nv_bfloat16>(D, a);
    case ds::kF16: return dispatch_dim<__half>(D, a);
    default: return cudaErrorInvalidValue;
  }
}
