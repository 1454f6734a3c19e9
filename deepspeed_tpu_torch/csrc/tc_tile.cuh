// Tensor-core building blocks for Hopper (sm_90a) kernels: swizzled shared
// tiles, the cp.async copies that fill a ring of them, wgmma shared-memory
// descriptors, the wgmma instructions themselves and the accumulator ->
// A-fragment conversion (with the hi/lo split that keeps an fp32 operand to
// ~2^-16, and for fp16 the running row scale that keeps the split above
// fp16's subnormal range).
//
// Tile layout. A [R][D] tile of 16-bit elements (R a multiple of 8, D a
// multiple of 64) is kept as D / 64 column panels of R rows x 128 bytes,
// panel after panel. Inside a panel, the 16-byte chunk c of row r sits at
// chunk c ^ (r % 8): the 128-byte swizzle that wgmma's descriptors name as
// layout type B128. Every panel starts on a 1024-byte boundary (8 rows), so
// one panel serves both as a K-major operand (rows are M or N, the 64
// columns are K: S = q k^T reads q and k so) and as an MN-major operand
// (rows are K, the 64 columns are N: dQ = dS k reads k so), without a copy.
//
// Accumulators of wgmma m64nNk16 with fp32 sums: thread (warp w of the
// warpgroup, lane l) holds entry i of its 32 (N = 64) at
//   row = 16 w + l / 4 + 8 ((i / 2) % 2),   col = 8 (i / 4) + 2 (l % 4) + i % 2,
// and the A fragment of one k16 step holds the same rows and columns of a
// 16-wide slice, so accumulator entries 8 kk .. 8 kk + 7 are the A operand of
// k step kk as they lie (acc_to_a).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ds {
namespace tc {

constexpr int kPanelCols = 64;         // 16-bit elements in one 128-byte panel row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 8 * kRowBytes;  // 8 rows: one swizzle atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------------- cp.async ring
// 16 bytes from global to shared; with `pred` false nothing is read and the
// 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

// 4 bytes (an fp32 row value), zero-filled when `pred` is false.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Make this thread's generic-proxy writes to shared memory (cp.async, plain
// stores) visible to the async proxy that wgmma reads through. Each writer
// fences before the barrier that publishes the tile.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` (0 .. D/8) of row `row` in a
// panel-major swizzled tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t tile_offset(int row, int chunk) {
  const int panel = chunk >> 3, c = chunk & 7;
  return panel * (R * kRowBytes) + row * kRowBytes + ((c ^ (row & 7)) << 4);
}

// Start the copy of rows [r0, r0 + R) of one head into the tile at `dst`:
// `src` is the head's row 0, `stride` its row stride in elements (the last
// dimension contiguous, rows 16-byte aligned); rows at or past `n` are
// zero-filled. Threads `tid` of `nthreads` share the chunks.
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const T* src, long long stride,
                                                int r0, int n, int tid, int nthreads) {
  constexpr int chunks = D * static_cast<int>(sizeof(T)) / 16;  // per row
  for (int idx = tid; idx < R * chunks; idx += nthreads) {
    const int r = idx / chunks, c = idx % chunks;
    const bool in = r0 + r < n;
    const T* p = in ? src + (long long)(r0 + r) * stride + c * (16 / sizeof(T)) : src;
    cp_async16(dst + tile_offset<R>(r, c), p, in);
  }
}

// Start the copy of `n_rows` fp32 values src[r0 ..] into dst[0 ..]; values at
// or past `n` are zero.
__device__ __forceinline__ void load_row_async(uint32_t dst, const float* src, int r0, int n,
                                               int n_rows, int tid, int nthreads) {
  for (int i = tid; i < n_rows; i += nthreads) {
    const bool in = r0 + i < n;
    cp_async4(dst + 4 * i, in ? src + r0 + i : src, in);
  }
}

// ----------------------------------------------------------------- descriptors
// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout type B128 (bits 62-63 = 1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}

// K-major operand (A or B): the tile's rows are M (or N), K runs along D.
// k step `ks` covers elements [16 ks, 16 ks + 16) of D: panel ks / 4, 32
// bytes further per step inside it (the swizzle is applied by the hardware
// from the address bits, so the start may sit inside an atom). 8-row groups
// are one atom apart (SBO); LBO is unused for swizzled K-major layouts.
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int ks) {
  return make_desc(tile + (ks >> 2) * (R * kRowBytes) + (ks & 3) * 32, 16, kAtomBytes);
}

// MN-major B operand: the tile's rows are K, N runs along D. k step `kk`
// covers rows [16 kk, 16 kk + 16) (two atoms, SBO apart), N panel `p` covers
// columns [64 p, 64 p + 64); LBO is the panel stride (the next 64 of N).
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int p, int kk) {
  return make_desc(tile + p * (R * kRowBytes) + kk * 16 * kRowBytes, R * kRowBytes, kAtomBytes);
}

// ----------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence / wait that bracket it.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define DS_TC_ACC32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DS_TC_OUT32(d)                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
  "+f"(d[31])

// d (64 x 64 fp32) = [d +] A B, A and B K-major in shared memory.
// `accumulate` 0 ignores d's old value.
template <typename T> __device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                                               uint64_t db, int accumulate);

template <> __device__ __forceinline__ void wgmma_ss<__nv_bfloat16>(float (&d)[32], uint64_t da,
                                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DS_TC_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DS_TC_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_ss<__half>(float (&d)[32], uint64_t da,
                                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DS_TC_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DS_TC_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += A B with A (64 x 16) in registers and B MN-major in
// shared memory (transpose flag 1).
template <typename T> __device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                                                  const uint32_t (&a)[4],
                                                                  uint64_t db);

template <> __device__ __forceinline__ void wgmma_rs_mn<__nv_bfloat16>(float (&d)[32],
                                                                       const uint32_t (&a)[4],
                                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DS_TC_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DS_TC_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs_mn<__half>(float (&d)[32],
                                                                const uint32_t (&a)[4],
                                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DS_TC_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DS_TC_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef DS_TC_ACC32
#undef DS_TC_OUT32

// ----------------------------------------------------------------- fragments
// Two fp32 values as one 32-bit pair of T (a in the low half), rounded to
// nearest; and back.
template <typename T> __device__ __forceinline__ uint32_t pack2(float a, float b);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t x);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
}

// The A fragment of k step `kk` (accumulator columns [16 kk, 16 kk + 16)) of
// an fp32 accumulator times its rows' scales `sc` (1 but for fp16, see
// scale_rows), as hi = T(y) and lo = T(y - hi) of y = x sc: hi + lo equals y
// to about 2^-16 relative for bf16, where one cast would keep 2^-8. For fp16
// (2^-22 against 2^-11) y must lie above fp16's subnormal range, where hi and
// lo keep fewer bits: scale_rows chooses sc so.
template <typename T>
__device__ __forceinline__ void acc_to_a(const float (&x)[32], int kk, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4], const float (&sc)[2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // entries 8 kk + 2 j (+1) lie on row j % 2
    const float a = x[8 * kk + 2 * j] * sc[j & 1], b = x[8 * kk + 2 * j + 1] * sc[j & 1];
    hi[j] = pack2<T>(a, b);
    const float2 h = unpack2<T>(hi[j]);
    lo[j] = pack2<T>(a - h.x, b - h.y);
  }
}

// ------------------------------------------------- fp16 running row scale
// fp16's normal range ends at 2^-14, so the lo half of an fp32 x is
// subnormal for |x| below ~2^-3 and hi for |x| below 2^-14, with an absolute
// step of 2^-24: probabilities of long rows and the dS of small gradients
// would keep a few bits. scale_rows keeps a power-of-two scale 2^e per
// accumulator row, exact to apply and to undo.
constexpr int kNoScale = 1 << 30;  // e of a row with no nonzero entry yet

// 2^e for e <= 127 (0 below fp32's normal range, where only factors that
// bring an accumulator far below the new scale's entries land).
__device__ __forceinline__ float pow2(int e) {
  return e < -126 ? 0.f : __int_as_float((e + 127) << 23);
}

// For each of this thread's two accumulator rows: e[r] falls to the largest
// exponent that keeps every entry of the row seen so far (this tile's x and
// the earlier tiles') below 2^15, so the row's largest entry times 2^e sits
// in [2^14, 2^15) and hi and lo stay normal down to 2^-18 of it (e clamped
// to [-126, 126]). sc[r] = 2^e[r] is the row's scale for acc_to_a; f[r] =
// 2^(e_new - e_old) brings the row's accumulators, summed at the old scale,
// to the new one (1 when e is unchanged; see rescale_rows). The four lanes of
// a row (4g .. 4g + 3) agree on e through two shuffles, so every warp calls it.
__device__ __forceinline__ void scale_rows(const float (&x)[32], int (&e)[2], float (&sc)[2],
                                           float (&f)[2]) {
  float m[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], fabsf(x[i]));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    const int need = m[r] > 0.f ? max(-126, min(126, 14 - ilogbf(m[r]))) : kNoScale;
    const int en = min(e[r], need);
    f[r] = e[r] == kNoScale ? 1.f : pow2(en - e[r]);
    e[r] = en;
    sc[r] = en == kNoScale ? 1.f : pow2(en);
  }
}

// An accumulator's rows times scale_rows' factors f (exact: powers of two);
// nothing to do while no row of the warp has a fallen scale, as on most
// tiles (the test is warp-uniform, so the warp stays converged for wgmma).
__device__ __forceinline__ void rescale_rows(float (&acc)[32], const float (&f)[2]) {
  if (!__any_sync(0xffffffffu, f[0] != 1.f || f[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= f[(i >> 1) & 1];
}

// 2^-e: the factor that undoes row scale e at the end (1 for kNoScale).
__device__ __forceinline__ float unscale(int e) { return e == kNoScale ? 1.f : pow2(-e); }

}  // namespace tc
}  // namespace ds
